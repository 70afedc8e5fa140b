"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (built for
an H100, sm_90a).  Phases, each printed as it finishes:

  1. the card (`nvidia-smi` name and power limit), torch and CUDA versions;
  2. build every kernel source in `src/repro_torch/kernels/csrc/` (one
     `nvcc` per source, started together), print each kernel instance's
     `-Xptxas=-v` line (registers, static shared memory, spills) and
     kernel 8's dynamic shared memory at D = 128 and 64 and the instance
     each head size and sequence length take (the
     library's `flash_attn_instance` equal to the wrapper's `instance`);
     kernel 8 (its short-sequence instances too), kernel 2's
     `encode_kernel` and kernel 3's `encode_prng_kernel` instances, the
     round-gradient kernels (1, 4, 5, 6) and kernel 7's
     `ssd_chunk_kernel` instances must not spill (a library found built
     is compiled once more for its report), and where the toolkit has
     `cuobjdump` kernels 8, 2, 3 and 7 must hold HMMA (tensor-core)
     instructions in their SASS, whose counts are printed;
  3. hold each kernel against its plain PyTorch version on the card at
     the main paths' shapes: the flat round gradient at (5632, 500) with
     random weights and at (7200, 500) with w = None (rtol 1e-3 / atol
     1e-6, and two launches bit-identical), the encode at (2016, 300, 501)
     (2e-4 * max|ref|, and kernel and plain version both within the float64
     bound of `kernels.encode.ops.float64_reference_and_bound`, stated
     before the first run of the 3xTF32 kernel; relaunches bit-identical);
     the coded round gradient at 7200 + 2016 rows of
     500 with zero-weight rows, per-row (of order 1) and scalar parity
     weights, the parity stream alone (systematic weights 0), and an
     empty parity block (which runs the flat kernel), and the tier-masked
     one at (5632, 500) for T = 3 and T = 8 — each held, with the plain
     version, against the float64 expression within rtol 1e-3 plus
     1e-6 x the magnitude of the summed terms (the bound
     `tests/test_torch_cuda.py` holds the flat kernel to), relaunches
     bit-identical, and the tier kernel at T = 1 with an all-ones mask
     `torch.equal` to the flat kernel; the in-kernel-generator encode at
     X = I, w = 1 (c = 2016, ell = 300, a key of `split_keys`), which
     returns G itself: Rademacher `torch.equal` to the plain
     `prng.generator_values`, normal within rtol 1e-6 / atol 1e-7 (the
     3xTF32 products return big + small of each entry, so the bit-equal
     share is printed but not held to 1); at (2016, 300, 501) and at an
     odd c * ell, both kinds, within 2e-4 * max|ref|, relaunches
     bit-identical, and at (2016, 300, 501) kernel and plain version
     both within the float64 bound of the encode (G the plain
     generator), stated before the first run of the 3xTF32 kernel 3; the least-squares gradient at
     (2016, 500) within the float64 bound, relaunches bit-identical and
     `torch.equal` to the flat kernel at w = None; the SSD intra-chunk
     step (kernel 7) at the serving shape of mamba2-1.3b (B, nc, Q, H,
     P, N) = (1, 8, 256, 64, 64, 128) with one group and with per-head B
     and C, at zamba2-1.2b's (1, 8, 256, 64, 64, 64) with one group (also
     within the float64 rounding bound of
     `kernels.ssd.ref.float64_reference_and_bound`), at the reduced
     mamba2's (Q 16, P 32, N 16) and at an odd Q,
     within rtol 1e-4 / atol 1e-4 * max(1, max|ref|)
     (`tests/test_kernels.py`), relaunches bit-identical; causal flash
     attention (kernel 8) at the serving shape of granite-8b (B, Hq, Hkv,
     S, D) = (1, 32, 8, 2048, 128), at S = 100 and 1537, at D = 64, at
     one and three query heads per key/value head, and at the 2048-token
     prefills of zamba2-1.2b (1, 32, 32, 2048, 64) and mistral-large-123b
     (1, 96, 8, 2048, 128), whisper-tiny's 440-token decoder prefill
     (1, 6, 6, 440, 64) (llama-3.2-vision-11b's is granite's), and, on
     the short-sequence instance, the coded-head probe's backbone (768,
     32, 8, 32, 128) and two ragged short shapes: kernel and plain
     version both within the float32 rounding bound of the float64 value
     (`kernels.flash_attn.ref.float64_reference_and_bound`, derived
     before the first run), within rtol 2e-4 / atol 2e-4 of each other
     (`tests/test_kernels.py`), relaunches bit-identical, and the short
     instance `torch.equal` to the D = 128 / D = 64 instance on the same
     rows;
  4. the main path: `repro_torch.quickstart.run` — the §IV plan, the
     encode through the kernel, 600 uncoded and 600 coded epochs — with
     the launch counters set to 0 just before it and read just after;
  5. the same coded run on the reference gradient path (no kernel),
     whose NMSE trace must agree within rtol 1e-4;
  6. the StochasticCodedFL path: noise multiplier 0.5, parity sampling
     rho = 0.8, fixed_c = 2016, planned by the port's planner at
     srv_weight 0.64, encoded through the encode kernel, 600 epochs on
     the coded kernel (the counters set to 0 just before, read just
     after: 600 coded launches, 0 flat, 24 encode); the same run on the
     reference gradient path within rtol 1e-4, clocks identical;
  7. the HierarchicalCFL path over the §IV CodedFL state at T = 3: 600
     epochs on the tier-masked kernel (600 launches, 0 flat), the
     reference gradient path within rtol 1e-4; then T = 1, whose NMSE
     trace must be bit-equal to phase 4's coded trace;
  8. the fleet path at the §IV width: `fleet.encode_fleet_tiered` over
     the quickstart's data and Eq.-17 weights (24 x 300 x 500, c = 2016)
     at phase 7's T = 3 (the counters set to 0 just before, read just
     after: exactly 24 in-kernel-generator encode launches, no other
     kernel), held against the plain composite; one tier `torch.equal`
     to the flat `encode_fleet_prng`, T = 3 within rtol 1e-5 / atol
     1e-6 of it;
  9. the fleet path at fleet scale, as `benchmarks/perf_fleet.py` runs
     it: `solve_fleet` on `mega_fleet(100_000, d=32)` with shards of 4-16
     points, c_up 4096, eps_rel 1e-2 (loads within caps, the return
     target met); the tiered encode of 256 clients x 8 x 32 at c = 128,
     T = 4, against the flat one (256 launches each); `sample_tier_rounds`
     at n = 10 000 and 100 000 under a 512-client round budget, 16 tiers,
     48 epochs, its wall-time ratio at most 3.0;
 10. the legacy path: 600 epochs of `core.cfl.epoch_gradient(...,
     use_kernel=True)` -> `gd_update` -> `nmse` over phase 4's CodedFL
     state and its schedule's arrival masks (exactly 600 least-squares
     gradient launches, no other kernel), the same loop without the
     kernel within rtol 1e-4;
 11. the serve path: mamba2-1.3b at full width (48 layers, d_model 2048,
     vocab 50280, 1,446,714,368 float32 parameters drawn from a seeded
     generator on the card); kernel 7 at the model's own operands (layer
     0 of a 2048-token prefill, |cum| ~ 3e3) within the same bound and
     within the derived float64 rounding bound; `ServeEngine(n_slots=4,
     max_seq=2112)` over six requests of 100, 256, 640, 1024, 1537 and
     2048 prompt tokens, 24 new tokens each (the counters set to 0 just
     before, read just after: exactly 48 kernel-7 launches per prefill,
     288 in all, none in decode, no other kernel); each request's tokens
     equal to `greedy_generate` on its prompt alone; the kernel prefill
     of the 2048-token prompt against the plain one within 1e-3 *
     max(1, max|logit|), stated in advance, with the same greedy token;
     prefill ms per request, decode ms per engine step and tokens/s;
     its parameters are freed before the next phase;
 12. the dense serve path: granite-8b at full width (36 layers, d_model
     4096, 32 heads and 8 key/value heads of 128, d_ff 14336, vocab
     49152, 8,254,689,280 float32 parameters drawn from a seeded
     generator on the card); `ServeEngine(n_slots=4, max_seq=2112)` over
     phase 11's prompt lengths, 24 new tokens each (the counters set to 0
     just before, read just after: exactly 36 kernel-8 launches per
     prefill, 216 in all, none in decode, no other kernel); each
     request's tokens equal to `greedy_generate` on its prompt alone; the
     kernel prefill of the 2048-token prompt against the plain one
     (`use_kernel=False`, the grouped expression) within 1e-3 *
     max(1, max|logit|), stated in advance, with the same greedy token;
     prefill ms per request, decode ms per engine step, tokens/s and the
     peak device memory beside two floors (the weights read once a
     decode step, the prefill's float32 products at 67 TFLOP/s);
 13. time each kernel, its plain version and the one PyTorch call that
     computes the same product: CUDA events around a run of back-to-back
     calls that rotate over copies of the operands larger than the L2
     together (so each call finds its operands cold), enqueued while a
     sleep kernel holds the stream (so the host's enqueue cost stays
     outside the timed span), the median over repeats of the mean per
     call; and each kernel again on one copy, warm in L2, as the epoch
     loop finds its operands.  No PyTorch call generates threefry, so
     the in-kernel-generator encode's library time is `G @ (w X)` on a
     materialized G: it excludes the generation.  Kernel 7's library
     expression is `torch.matmul` on head-major views with the causal
     mask by `torch.tril`, held to the kernel first; beside it the same
     with C B^T once per group, broadcast over the group's heads
     (`library_grouped_ms`), also held to the kernel.  Kernel 8's is
     `repeat_interleave` of the key/value heads to the query heads, then
     `scaled_dot_product_attention(is_causal=True)` on the same float32
     operands, the expansion inside the timed span, held to the kernel
     first, with the backend it takes; the one call with
     `enable_gqa=True` (a slower backend on float32) is kept beside it.
     Each kernel's bound is computed from the shapes: the bytes it must
     move over 3.35 TB/s or its operations over the rate of their type;
     kernel 8's products go through the tensor cores as three TF32
     products per float32 product (3xTF32), so its bound is three times
     its flops over 495 TFLOP/s, its float32-FMA bound kept beside it;
     likewise kernel 2's (the parity encode) and kernel 7's, whose flops
     count the scores once per (chunk, group), the least work (the count
     with the scores once per head is printed beside it); kernel 3's
     operations are the larger of its 3xTF32 products and one threefry
     hash per generator entry over the card's INT32 rate, its
     float32-FMA bound printed beside it; kernels 7 and 8 also at
     zamba2-1.2b's shapes (phase 3's operands), cold and warm, with their
     plain versions, library calls and bounds (the `hybrid_shape` of
     their rows in the kernels line), kernel 8 at whisper-tiny's
     decoder prefill (1, 6, 6, 440, 64) the same way (`whisper_shape`)
     and at phase 22's prefills of codeqwen1.5-7b (32 heads, 32
     key/value heads) and minitron-4b (24, 8) at 100 and 2048 tokens and
     mistral-large-123b's (96, 8) at 2048 (`dense_shapes`, each with its
     launches on the driven paths), and kernel 3 at one launch of phase
     9's fleet-scale encode (128, 8, 33) (`fleet_shape`, with phase 9's
     launches);
 14. gradient coding through the registry (`make_strategy("gradcode",
     r=...)`) on the §IV fleet and the quickstart's data, lr 0.0085, 600
     epochs: r = 2 and r = 3 each exactly 600 round-gradient launches at
     (7200, 500) and no other kernel, the reference gradient path within
     rtol 1e-4 with identical clocks; `HierarchicalCFL` over r = 2 at
     T = 3 (600 tier-masked launches, no other kernel) and T = 1 (NMSE
     trace bit-equal to the flat r = 2 one); `run_gradient_coding` for
     the same generator bit-equal to the `Session` run;
 15. StochasticCodedFL through the registry with an (epsilon, delta)
     budget (epsilon 2.0, delta 1e-5, 600 rounds, rho 0.8, fixed_c
     2016), the noise calibrated and the plan solved on the card: the
     port's own `epsilon_spent` at the calibrated sigma at most 2.0 and
     within 1e-3 relative of it, `srv_weight == rho / (1 + sigma^2)`,
     exactly 24 encode and 600 coded round-gradient launches, the
     reference gradient path within rtol 1e-4 with identical clocks, the
     `epsilon_schedule` of shape (600,), non-decreasing and ending at
     `epsilon_spent`, and `privacy_budget() == (epsilon_spent, 1e-5)`;
 16. LowLatencyCFL through the registry on `wireless_fleet(0.2, 0.2,
     nu_erasure=0.3, seed=0)` (`benchmarks/fig_schemes.py`'s
     lowlat_session at delta = 0.28: chunks 8, fixed_c 2016) over the
     quickstart's data: the partial-return plan on the card (loads within
     their caps, the expected aggregate at its target, t* printed),
     exactly 24 encode and 600 round-gradient launches, the reference
     gradient path within rtol 1e-4 with identical clocks; chunks = 1
     against `make_strategy("cfl", ...)` with the same key and c (the
     encode through the kernel on both sides): t* equal, parity
     `torch.equal`, NMSE within rtol 1e-5 (bit-equality printed),
     `setup_time` equal; `HierarchicalCFL` over it at T = 3, 600
     tier-masked launches;
 17. CodedFedL through the registry: (a) `repro_torch.nonlinear_quickstart.
     run` (`wireless_fleet(0.3, 0.3, nu_erasure=0.3, seed=0, n=12,
     d=256)`, 12 x (100 + 50) rows of 6 raw dimensions from the RBF
     teacher, d_feat 256, rff_gamma 2/6, c = int(0.3 * 1200) = 359 as the
     example computes it, lr 0.5, 300 epochs): the MEC plan on the card
     (loads within their caps, `p_return` equal to `mec_total_cdf` at
     the plan), exactly 12 encode and 300 round-gradient launches, the
     features within 5e-6 of the float64 RFF oracle, the reference
     gradient path within rtol 1e-4 with identical clocks, the kernel
     head's held-out accuracy above the best linear model's; then
     `fed.train_coded_head` on the same data (the uncoded baseline on the
     same features, then its coded arm: 12 encode and 600 round-gradient
     launches);
     (b) `wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0, d=512)`, 24 x
     (300 + 150) rows, d_feat 512, c = 2160, lr 0.5, 600 epochs: exactly
     24 encode launches at (2160, 300, 513) and 600 round-gradient ones,
     the reference path within rtol 1e-4, `HierarchicalCFL` at T = 3 (600
     tier-masked launches, its reference path within rtol 1e-4) and T = 1
     (trace and clocks bit-equal to the flat run), held-out accuracy
     printed; (c) `CodedFedL(d_feat=None)` against
     `make_strategy("cfl", ...)` with the same key and c on phase 4's
     data: t*, parity (`torch.equal`), NMSE trace and `setup_time`
     bit-equal (24 encode and 600 round-gradient launches each).
 18. the sweep and serving engines: (a) `benchmarks/perf_sweep.py`'s
     sweep — 16 CodedFL lanes (key seeds 100 + i, c = 2016, no upload
     delay, the encode through kernel 2 as in phase 4: `use_kernel=True`)
     on `paper_fleet(nu, nu, seed=0)` for nu in linspace(0, 0.375, 16),
     phase 4's data, lr 0.0085, 600 epochs, session seed i —
     through one `plan_sweep` (each lane's plan equal to its own
     one-request plan; exactly 16 x 24 encode launches) and `run_sweep`
     (exactly 16 x 600 round-gradient launches; the bucket count equal
     to the reference's rule, the fused layout of each plan's support),
     then the 16 solo `Session.run`s over the same states (16 x 600
     launches), each lane's trace, clocks, uplink bits and extras
     bit-equal to its solo run; host seconds of each; (b)
     `benchmarks/perf_serve.py`'s workload — 8 CodedFL sessions at
     c = 2016, 4 at 3600 (`use_kernel=True` as in (a)) and 4 UncodedFL
     on `paper_fleet(0.2, 0.2,
     seed=0)`, 400 epochs, seed i, arriving on `poisson_arrivals(16,
     0.05, default_rng(0))` — through `FedServeEngine(lane_width=4,
     chunk=100, ConvergenceCriterion(nmse_target=0.35)).serve(...,
     states=plan_sweep(...))`: 12 x 24 encode launches in the plan, 3
     groups, one round-gradient launch per epoch served and one
     read-back per group-epoch, every served trace and clock a prefix of
     its solo run (the per-session loop, 16 x 400 launches); sessions/s
     and epochs/s of both; (c) phase 15's calibrated StochasticCodedFL in
     an 800-epoch session served alone: it stops at 600, not converged,
     its trace phase 15's run and its `epsilon_spent` and
     `epsilon_schedule` phase 15's, 600 coded round-gradient launches.
 19. training, which runs no kernel (the kernels have no backward; the
     reference trains through its plain expressions): (a) `python -m
     repro_torch.launch.train` at its defaults (`launch.train.run`:
     lm-100m at full width, batch 8 x 256, AdamW 3e-4, 300 steps) with a
     checkpoint every 100 steps; the mean loss of the last 10 steps below
     that of the first 10, the three checkpoint files, and steps 201-210
     run again from the step-200 checkpoint within rtol 1e-4 of the
     run's own losses; (b) `--arch mamba2-1.3b --federated` at full width
     (1,446,714,368 float32 parameters), 8 clients, batch 8 x 256, 20
     rounds: the printed t* and loads `fed_setup`'s for the same fleet,
     finite losses, the mean of the last 5 below the first 5; (c)
     `--arch granite-8b --reduced --federated` at `launch.train`'s defaults;
     (d) one float32 `make_train_step` and one `make_fed_train_step`
     step of the reduced granite-8b and mamba2-1.3b on the card against
     the CPU from the same parameters and batch: losses within rtol 1e-5,
     gradient leaves (and the SGD change at lr 1) within rtol 1e-4 / atol
     1e-6 * max(1, max|CPU leaf|); (e) kernels 1-8 launch 0 times in each
     run, and the kernel 7 and 8 wrappers refuse operands that require
     grad on the card; (f) `--arch zamba2-1.2b --reduced` and `--arch
     phi3.5-moe-42b-a6.6b --reduced`, 30 steps each at `launch.train`'s
     defaults: the mean loss of the last 5 below the first 5's, phi's
     last metrics carrying a finite `moe_aux_loss`; each run's seconds a
     step (median after the first), tokens/s and peak allocated memory
     beside the card's `nvidia-smi` name and power limit.
 20. the tile autotuner: (a) `tune.autotune` of each family at one CI
     shape into a temporary cache (candidates, pruned, times, winner);
     (b) every candidate tile against its kernel's plain version by
     phase 3's bounds: kernels 1, 4 and 5 at each "round_grad" row tile
     and 6 at each "coded_grad" one within the float64 bound of
     `held_to_float64` (relaunches bit-identical, T = 1 `torch.equal` to
     flat, kernel 6 to flat at w = None), kernel 2 at each CTA tile
     within 2e-4 * max|ref| and the encode's float64 bound (kernel 3
     launches one tile, checked in phase 3, and has no family); (c) at
     shapes whose bucket the committed defaults do not hold, `"auto"`
     `torch.equal` to the explicit default tile (the round gradients' own
     partition, kernel 2's (128, 64, 32), kernel 3's one tile), the tile
     every kernel launched before it took tiles; (d) a stored tile is
     what `"auto"` launches (the counters' launches by tile); (e) the
     keyed `kernels.encode.ops.encode_fleet` at §IV width (24 x 300 x
     500, c = 2016) within 2e-4 * max|ref| of the plain streamed encode;
     (f) the host's time of one memoized `resolve_block("auto")`, which
     every launch of kernels 1, 2, 4, 5 and 6 pays; exact launch counts
     throughout.
 21. the hybrid serve path: zamba2-1.2b at full width and depth (38
     Mamba2 layers, d_model 2048, d_state 64, one shared attention + MLP
     block of 32 heads of 64 after every 6th layer, vocab 32000;
     1,170,473,856 float32 parameters drawn from a seeded generator on
     the card); `ServeEngine(n_slots=4, max_seq=2112)` over phase 11's
     prompt lengths, 24 new tokens each (the counters set to 0 just
     before, read just after: exactly 38 kernel-7 and 6 kernel-8 launches
     per prefill, 228 and 36 in all, none in decode, no other kernel);
     each request's tokens equal to `greedy_generate`'s; the kernel
     prefill of the 2048-token prompt against the plain one within 1e-3 *
     max(1, max|logit|), stated in advance, with the same greedy token;
     prefill ms, decode ms a step, tokens/s and peak memory;
 22. the other dense configs: codeqwen1.5-7b (8,190,038,016 parameters)
     and minitron-4b (5,096,279,040) at full width and depth, each
     through `ServeEngine(n_slots=2, max_seq=2112)` over prompts of 100
     and 2048 tokens, 8 new tokens each (32 kernel-8 launches per
     prefill, none in decode), tokens equal to `greedy_generate`'s, the
     kernel prefill against the plain one as in phase 12 (32 launches,
     counted);
     mistral-large-123b's full-width tree on the meta device
     (122,610,069,504 parameters, JAX's `eval_shape` total), and on the
     card at full width cut to 4 of its 88 layers (6,341,898,240
     parameters): one 2048-token kernel prefill against the plain one (4
     launches) and a greedy 8-token generation (4 launches); each
     config's parameters freed before the next; kernel 8's launches in
     these counted runs, by shape;
 23. the moe path: phi3.5-moe at full width cut to 4 of its 32 layers
     (5,463,904,256 parameters; 41,872,527,360 at full depth, on the
     meta device) through `ServeEngine(n_slots=4, max_seq=2112)` over
     prompts of 100, 1537 and 2048 tokens, 8 new tokens each (4 kernel-8
     launches per prefill, none in decode; the MoE FFN is the plain
     one-hot expression, decoded at a capacity that drops nothing),
     tokens equal to `greedy_generate`'s, each layer's dropped share of
     the 2048-token prefill (capacity 512) printed, the kernel prefill
     against the plain one as in phase 12; llama4-maverick on the meta
     device only (394,672,051,200 parameters; one MoE layer, one dense
     layer and the embeddings hold 18,427,438,080, 68.6 GiB at float32).
 24. the vlm and audio paths, every cross block's `gate` set to 0.5 +
     U(0, 1) (at init tanh(0) zeroes the cross path): (a)
     llama-3.2-vision-11b at full width and depth (40 layers in 8 groups
     of 4 self blocks and one cross block over 1601 stub patches of
     d_vision 4096; 9,775,157,256 float32 parameters): its 2048-token
     kernel prefill (exactly 32 kernel-8 launches) against the plain one
     within 1e-3 * max(1, max|logit|), stated in advance, with the same
     greedy token, the logits moved by other patches, then
     `greedy_generate` of 8 tokens (32 launches: none in decode); (b)
     whisper-tiny at full width and depth (4 encoder and 4 decoder
     layers over 1500 stub frames; 61,085,956 parameters): the same for a
     440-token prompt and 8 new tokens (its 448 decode positions; 4
     launches a prefill, none in the encoder or decode); prefill ms, ms a
     step and peak memory of each; (c) training through `launch.train`
     with its stub patches or frames drawn per step: whisper-tiny at full
     width and depth, and llama-3.2-vision-11b at full width cut to one
     group (5 of 40 layers), a few steps each: losses finite and falling,
     0 kernel launches, peak memory; each config's parameters freed
     before the next.
 25. the launch layer: (a) the dry run, `python -m
     repro_torch.launch.dryrun --all --both-meshes`, plain and
     `--optimized` (two processes started together): the 39
     (arch x shape) combinations and the one skip on the 16 x 16 and
     2 x 16 x 16 meshes of a fake world, every leaf a meta-device DTensor,
     78 runs ok in each, whisper-tiny's train_4k argument bytes on 16 x 16
     equal to XLA's 430,750,252, every run's per-device argument GiB and
     each process's wall time; (b) in phases 12 and 21, on their weights:
     granite-8b's 2048-token prefill with `attn_impl="repeat"` at a
     float32 softmax and under `optimize_config(cfg, "prefill")` (whose
     bf16 softmax the prefill's causal self-attention does not read, as
     the reference's) — 36 kernel-8 launches each, logits `torch.equal`
     to the grouped kernel prefill — and its full-sequence forward under
     `optimize_config(cfg, "train")`, whose bf16 softmax takes the plain
     expression (no launch), its last position within 2^-6 *
     max(1, max|logit|), stated in advance, of the float32 prefill, the
     greedy tokens printed; zamba2-1.2b's prefill under
     `optimize_config(cfg, "prefill")` (`ssm.head_shard`): 38 kernel-7
     and 6 kernel-8 launches, logits `torch.equal` to phase 21's; (c)
     `launch.train --distributed` (lm-100m, 20 steps) with
     COORDINATOR_ADDRESS=127.0.0.1:<free port>, NUM_PROCESSES=1 and
     PROCESS_ID=0 over NCCL: losses equal to the same seed's run without
     it, then a one-rank NCCL all-reduce and `sync_hosts`.
 26. the coded-head probe: `python -m repro_torch.coded_head_probe`'s
     `run` at full width and depth (granite-8b, 36 layers at d_model
     4096, 12 clients x 64 sequences of 32 tokens, 300 epochs, c = 230):
     exactly 36 kernel-8 launches (the backbone, all 768 sequences in
     one batch), every one on the short-sequence instance by the
     counter's record of instances, 12 kernel-2 (one parity encode a client, (230, 64,
     4097)) and 600 kernel-1 (both heads at D = 4096), NMSE traces
     finite and falling, the coding gain printed; client 0's kernel
     features within 1e-3 * max(1, max|feature|) of the plain
     backbone's; kernel 1 on the probe's rows within the float64 bound;
     kernels 1 and 8 timed at the probe's shapes ((768, 4096) and (768,
     32, 8, 32, 128)) with their plain versions, library calls and
     bounds (the kernels line's `probe_shape`).  Phase 3 also holds
     kernels 1, 4, 5 and 6 at 768 rows and D = 4096 and 8192 (the
     cluster route; kernel 4 at 8192 the residual pass and the
     column-chunked launch) to the float64 bound.
 27. the lane and shard meshes over every local card (k =
     `torch.cuda.device_count()`): 8 CodedFL lanes of phase 18's sweep
     through `run_sweep` and `FedServeEngine(lane_width=4)` over the k
     cards and over this one card, lanes bit-equal and 800 kernel-1
     launches each; phase 9's 100 000-client `solve_fleet` over the
     shard mesh, t*, c and loads equal to the one-card solve.  On a
     machine with one card k = 1.

The user tile cache is an empty temporary directory for the whole run,
so `block="auto"` reads the committed `src/repro_torch/tune/
defaults.json` alone, and each kernel's bound comes from
`repro_torch.roofline.kernel_terms`.  Every run of phases 4-27 is
counted from 0 just before it.  The kernels
line's `launches` sums the driven runs: kernel 1 over phases 4, 14 (r = 2
and 3), 16, 17, 18 (the sweep, its solo runs, the served epochs and
the per-session loop), 26 and 27; kernel 2 over phases 4, 15, 16, 17,
18's two `plan_sweep` calls, 26 and 27's `plan_sweep`; kernel 4 over
phases 6, 15 and 18c; kernel 5 over the T = 3 runs of phases 7, 14, 16
and 17; kernel 7 over phases 11 and 21 and phase 25's zamba2 prefill;
kernel 8 over phases 12, 21-24, phase 25's prefills and phase 26.
Kernels 1-6 also carry the `tile` `"auto"` launched at the timed shape
(`[0]`: a round gradient's own partition), and kernels 1, 2, 4, 5 and 6
`tuned`, phase 20's measured tuning of the kernel's family; kernels 1
and 8 `probe_shape`, phase 26's timing at the probe's shapes (kernel
8's with the instance it takes and its launches by instance).

Any failed check raises, so the exit code is non-zero.  The line before
the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`.  Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import atexit
import dataclasses
import gc
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# The H100's rates (HBM3 bandwidth, float32 outside the tensor cores,
# dense TF32, INT32) and each kernel's bound come from the package's
# roofline, `repro_torch.roofline.kernel_terms`.
from repro_torch.roofline import (FP32_FLOPS_PER_S,  # noqa: E402
                                  HASH_INT_OPS, HBM_BYTES_PER_S,
                                  kernel_terms)

SEC4_T_STAR = 11.9641
# The reference's main path (its batched grid solver) stops at
# t* = 11.96324 s and loads these; see tests/test_torch_plan.py.
SEC4_LOADS = [300, 300, 186, 123, 300, 300, 127, 300, 0, 0, 0, 300, 300,
              300, 300, 288, 300, 300, 300, 0, 300, 300, 300, 300]
MIN_GAIN = 3.0
# The StochasticCodedFL configuration driven in phase 6 (the strategy of
# benchmarks/fig_schemes.py's scfl_session on the quickstart's fleet) and
# its plan's loads at the planner's default eps_rel = 1e-3
# (t* = 17.01867 s; tests/test_torch_schemes.py).
SCFL_SIGMA, SCFL_RHO, SCFL_SRV_WEIGHT = 0.5, 0.8, 0.64
SEC4_SCFL_LOADS = [300, 300, 268, 300, 300, 300, 193, 300, 0, 300, 0, 300,
                   300, 300, 300, 300, 300, 300, 300, 0, 300, 300, 300, 300]
HIER_TIERS = 3
# the fleet layer: the fleet key of phases 3 and 8, and the scales of
# benchmarks/perf_fleet.py (phase 9)
FLEET_KEY_SEED = 1
FLEET_N, FLEET_D, POINTS_LO, POINTS_HI = 100_000, 32, 4, 16
FLEET_C_UP, FLEET_EPS_REL = 4096, 1e-2
ENC_CLIENTS, ENC_TIERS, ENC_ELL, ENC_C = 256, 4, 8, 128
SAMPLE_BUDGET, SAMPLE_TIERS, SAMPLE_EPOCHS, GROWTH_CEIL = 512, 16, 48, 3.0
# phase 11: mamba2-1.3b at full width through ServeEngine (random weights
# from a seed), six requests on four slots, 24 new tokens each
SERVE_ARCH, SERVE_SEED, SERVE_PARAMS = "mamba2-1.3b", 0, 1_446_714_368
SERVE_PROMPTS = (100, 256, 640, 1024, 1537, 2048)
SERVE_NEW, SERVE_SLOTS, SERVE_MAX_SEQ = 24, 4, 2112
# the kernel prefill of the 2048-token prompt against the plain one: max
# |logit difference| <= LOGIT_RTOL * max(1, max|logit|), stated before the
# first run on the card (on the CPU, 48 layers at d_model 512 with the
# intra-chunk step exact to rounding move the logits by ~6e-6 of max:
# tests/test_torch_lm_serve.py, test_rounding_of_the_ssd_step_...)
LOGIT_RTOL = 1e-3
# kernel 7's operands in a 2048-token prefill: (B, nc, Q, H, P, N), of
# mamba2-1.3b and of zamba2-1.2b (d_state 64; phase 21)
SSD_SHAPE = (1, 8, 256, 64, 64, 128)
SSD_HYBRID_SHAPE = (1, 8, 256, 64, 64, 64)
# phase 12: granite-8b at full width through ServeEngine, the prompts and
# slots of phase 11; the kernel-8 prefill of the 2048-token prompt
# against the plain one within DENSE_LOGIT_RTOL * max(1, max|logit|),
# stated before the first run on the card (on the CPU, 36 layers at
# d_model 512 with the attention core exact to rounding move the logits
# by ~1e-6 of max: tests/test_torch_lm_serve.py,
# test_rounding_of_the_attention_core_...)
DENSE_ARCH, DENSE_PARAMS, DENSE_LOGIT_RTOL = "granite-8b", 8_254_689_280, 1e-3
# phase 3: kernels 1, 4, 5 and 6 past the row-resident width (one launch
# over clusters along D; kernel 4 at 8192 the residual pass and the
# column-chunked launch) at the coded-head probe's 12 x 64 rows and its
# 230 parity rows, D = granite-8b's d_model and twice it, against the
# float64 bound as the §IV shapes are
WIDE_ROWS, WIDE_PARITY, WIDE_DS = 768, 230, (4096, 8192)
# phase 26: `python -m repro_torch.coded_head_probe` at full width and
# depth (examples/coded_head_probe.py's 12 clients x 64 sequences of 32
# tokens, 300 epochs, c = 230); its kernel-8 features of client 0
# against the plain backbone's within PROBE_FEATURE_RTOL * max(1,
# max|feature|), stated before the first run on the card (the
# 2048-token granite-8b kernel prefill sat at 2.7e-5 of max|logit| from
# the plain one, phase 12, and these hidden states feed the logits
# linearly); the launches it must count
PROBE_SEED, PROBE_FEATURE_RTOL = 0, 1e-3
PROBE_LAUNCHES = {"causal_attention": 36, "encode": 12, "round_grad": 600}
# phase 27: the lane and shard meshes over every local card: MESH_LANES
# CodedFL lanes of phase 18's sweep for MESH_EPOCHS epochs, served
# MESH_WIDTH a group, and phase 9's fleet-scale solve
MESH_LANES, MESH_EPOCHS, MESH_WIDTH = 8, 100, 4
# kernel 8's operands (B, Hq, Hkv, S, D): a 2048-token granite-8b prefill,
# its 100- and 1537-token prompts, D = 64 (the reduced configs' head dim),
# and one key/value head per query head (R = 1) and per three (R = 3);
# the 2048-token prefills of zamba2-1.2b (phase 21: 32 heads of 64, one
# per key/value head, the kernel's run-time-D instance) and of
# mistral-large-123b (phase 22: 12 query heads per key/value head),
# whisper-tiny's decoder prefill (phase 24: 6 heads of 64, one per
# key/value head), the coded-head probe's backbone (phase 26: 768
# sequences of 32 tokens, the short-sequence instance) and two ragged short
# ones (12 query heads a key/value head over 27 rows, so warp tiles hold
# rows of two heads and the last chunk is part full; D = 64 at 19 rows)
FLASH_SHAPE = (1, 32, 8, 2048, 128)
FLASH_HYBRID_SHAPE = (1, 32, 32, 2048, 64)
FLASH_CASES = {"serving shape": FLASH_SHAPE,
               "100-token prompt": (1, 32, 8, 100, 128),
               "1537-token prompt": (1, 32, 8, 1537, 128),
               "D = 64": (2, 4, 2, 77, 64),
               "R = 1": (1, 8, 8, 300, 128),
               "R = 3": (1, 12, 4, 257, 128),
               "zamba2 serving shape": FLASH_HYBRID_SHAPE,
               "mistral-large serving shape": (1, 96, 8, 2048, 128),
               # phase 24's AUDIO_PROMPT-token whisper-tiny prefill
               "whisper-tiny serving shape": (1, 6, 6, 440, 64),
               "probe shape": (768, 32, 8, 32, 128),
               "short ragged": (3, 12, 1, 27, 128),
               "short D = 64": (5, 6, 2, 19, 64)}
# kernel 8 timed at the other driven prefill shapes (phase 22's prompts),
# {label: (B, Hq, Hkv, S, D)}; each one's launches are phase 22's counter
# reads at that shape
FLASH_DENSE_TIMED = {
    "codeqwen1.5-7b, 100 tokens": (1, 32, 32, 100, 128),
    "codeqwen1.5-7b, 2048 tokens": (1, 32, 32, 2048, 128),
    "minitron-4b, 100 tokens": (1, 24, 8, 100, 128),
    "minitron-4b, 2048 tokens": (1, 24, 8, 2048, 128),
    "mistral-large-123b, 2048 tokens": (1, 96, 8, 2048, 128)}
# phase 14: GradientCodingFL at the replication factors of
# benchmarks/ablation_baselines.py
GC_REPLICATION = (2, 3)
# phase 15: StochasticCodedFL calibrated to an (epsilon, delta) budget over
# the run's 600 rounds (benchmarks/fig_privacy.py's sample_frac and delta)
DP_FIXED_C, DP_EPSILON, DP_DELTA, DP_RHO = 2016, 2.0, 1e-5, 0.8
# phase 16: benchmarks/fig_schemes.py's lowlat_session at delta = 0.28
LL_KEY_SEED, LL_CHUNKS, LL_DELTA = 7, 8, 0.28
# phase 17: CodedFedL. (a) the nonlinear quickstart's own configuration
# (repro_torch.nonlinear_quickstart); (b) the §IV fleet size at the widest
# width benchmarks/fig_nonlinear.py drives: 24 clients x (300 train + 150
# held-out) rows of 6 raw dimensions from the quickstart's teacher, 512
# Fourier features, c = 0.3 m, 600 epochs; (c) d_feat=None against CFL
CFEDL_N, CFEDL_ELL, CFEDL_ELL_TEST, CFEDL_D_FEAT = 24, 300, 150, 512
CFEDL_FIXED_C, CFEDL_EPOCHS, CFEDL_LR = 2160, 600, 0.5
# the reference's own bound between the float32 RFF map and its float64
# oracle (tests/test_nonlinear.py): TF32 in the product would miss it
RFF_ATOL = 5e-6
# phase 18: (a) benchmarks/perf_sweep.py's sweep (16 CodedFL lanes on
# paper_fleet(nu, nu) for nu in linspace(0, 0.375, 16), c = 0.28 m);
# (b) benchmarks/perf_serve.py's serving workload; (c) phase 15's DP
# lane in a longer session
SWEEP_LANES, SWEEP_C, SWEEP_LR, SWEEP_EPOCHS = 16, 2016, 0.0085, 600
SERVE_FL_SESSIONS, SERVE_FL_EPOCHS, SERVE_FL_RATE = 16, 400, 0.05
SERVE_FL_WIDTH, SERVE_FL_CHUNK, SERVE_FL_TARGET = 4, 100, 0.35
DP_SERVE_EPOCHS = 800
# phase 19: training. (a) `python -m repro_torch.launch.train` at its
# defaults (lm-100m, batch 8, seq 256, AdamW 3e-4, 300 steps) with a
# checkpoint every 100 steps, resumed from step 200 for 10 steps: the
# losses within TRAIN_RESUME_RTOL of the run's own (the embedding's
# backward adds with atomics, so not bit-equal); (b) mamba2-1.3b federated
# at full width (8 clients, batch 8 x FED_SEQ tokens, FED_ROUNDS rounds;
# parameters and AdamW moments take 17.4 GB, the plain SSD's (B, H, nc,
# Q, Q) float32 terms some 0.5 GB a layer: 63.2 GiB at its peak on an
# H100 80GB HBM3 at 700 W, PERF.md §6); (c) granite-8b
# reduced federated at `launch.train`'s defaults; (d) one float32 train step
# and one federated step of the reduced granite-8b and mamba2-1.3b on
# the card against the CPU (loss rtol 1e-5; gradient leaves rtol 1e-4 /
# atol 1e-6 * max(1, max|CPU leaf|), tests/test_torch_train.py's bound)
TRAIN_CKPT_EVERY, TRAIN_RESUME_AT, TRAIN_RESUME_STEPS = 100, 200, 10
TRAIN_RESUME_RTOL = 1e-4
FED_ARCH, FED_CLIENTS, FED_ROUNDS, FED_SEQ = "mamba2-1.3b", 8, 20, 256
L2_BYTES = 50 * 2**20
# phase 20: the tile autotuner.  The shape each family is tuned at (into a
# temporary cache), and the shapes of the cold-miss and hit checks, whose
# buckets the committed defaults do not hold, with the tiles stored for
# the hits; kernel 4's parity rows beside COLD_SHAPES' 3000, which the
# kernels' own partition gives the same 24 rows a CTA; the keyed fleet
# encode at §IV width (n, ell, d, c) and its clients' seeds
TUNE_SHAPES = {"round_grad": (5632, 500), "coded_grad": (2016, 500),
               "encode": (2016, 300, 501)}
COLD_SHAPES = {"round_grad": (3000, 500), "coded_grad": (3000, 500),
               "encode": (1000, 300, 501), "encode_prng": (1000, 300, 501)}
HIT_TILES = {"round_grad": (64,), "coded_grad": (32,),
             "encode": (64, 128, 32)}
COLD_PARITY_ROWS = 2900
KEYED_FLEET, KEYED_SEED0 = (24, 300, 500, 2016), 1000
# phase 21: zamba2-1.2b at full width and depth through ServeEngine, the
# prompts and slots of phase 11; its kernel prefill (kernels 7 and 8)
# against the plain one within HYBRID_LOGIT_RTOL * max(1, max|logit|),
# stated before the first run on the card (on the CPU, its 38 layers at
# d_model 512 with both steps exact to rounding move the logits by
# ~4e-6 of max: tests/test_torch_hybrid.py, test_rounding_of_both_...)
HYBRID_ARCH, HYBRID_PARAMS = "zamba2-1.2b", 1_170_473_856
HYBRID_LOGIT_RTOL = 1e-3
# phase 22: codeqwen1.5-7b and minitron-4b at full width and depth
# through ServeEngine(n_slots=2) over prompts of 100 and 2048 tokens, 8
# new tokens each; mistral-large-123b at full width on the meta device,
# and on the card at full width cut to MISTRAL_LAYERS of its 88 layers
DENSE_CONFIGS = {"codeqwen1.5-7b": 8_190_038_016, "minitron-4b": 5_096_279_040}
DENSE_PROMPTS, DENSE_NEW, DENSE_SLOTS = (100, 2048), 8, 2
MISTRAL_ARCH, MISTRAL_PARAMS = "mistral-large-123b", 122_610_069_504
MISTRAL_LAYERS, MISTRAL_CUT_PARAMS = 4, 6_341_898_240
# phase 23: phi3.5-moe at full width cut to MOE_LAYERS of its 32 layers
# through ServeEngine(n_slots=4) over prompts of 100, 1537 and 2048
# tokens, 8 new each; llama4-maverick on the meta device only: one MoE
# layer, one dense layer and the embeddings hold MAVERICK_MIN_PARAMS
MOE_ARCH, MOE_PARAMS, MOE_LAYERS, MOE_CUT_PARAMS = (
    "phi3.5-moe-42b-a6.6b", 41_872_527_360, 4, 5_463_904_256)
MOE_PROMPTS, MOE_NEW = (100, 1537, 2048), 8
MAVERICK_ARCH, MAVERICK_PARAMS = "llama4-maverick-400b-a17b", 394_672_051_200
MAVERICK_MIN_PARAMS = 18_427_438_080
# phase 24: llama-3.2-vision-11b at full width and depth, one VLM_PROMPT-
# token prompt over its 1601 stub patches, VLM_NEW greedy tokens;
# whisper-tiny at full width and depth, AUDIO_PROMPT + AUDIO_NEW = its 448
# decode positions, over its 1500 stub frames; every cross block's gate
# drawn from 0.5 + U(0, 1).  Their kernel prefills against the plain ones
# within MODAL_LOGIT_RTOL * max(1, max|logit|), stated before the first
# run on the card: kernel 8 is the only kernel on either path, and the
# dense configs' 32- to 40-layer kernel prefills sat within 3e-5 to 1.6e-4
# of the plain ones (phases 12, 22).  Training: whisper-tiny at full width
# and depth, and llama-3.2-vision-11b at full width cut to one group of
# VLM_TRAIN_LAYERS layers (AdamW holds 4 copies of its 36.4 GiB at full
# depth), MODAL_TRAIN_STEPS steps each through launch.train
VLM_ARCH, VLM_PARAMS, VLM_PROMPT, VLM_NEW = (
    "llama-3.2-vision-11b", 9_775_157_256, 2048, 8)
AUDIO_ARCH, AUDIO_PARAMS, AUDIO_PROMPT, AUDIO_NEW = (
    "whisper-tiny", 61_085_956, 440, 8)
MODAL_LOGIT_RTOL = 1e-3
VLM_TRAIN_LAYERS, MODAL_TRAIN_STEPS = 5, 12
# phase 25: (b) the 2048-token prefills of phases 12 and 21 under the
# dry run's settings; granite-8b's full-sequence forward with the bf16
# softmax against its float32 kernel prefill within BF16_LOGIT_RTOL *
# max(1, max|logit|), stated before the first run on the card: bf16
# rounds each softmax weight by up to 2^-8, and on the CPU the reduced
# granite-8b's bf16 and float32 softmaxes move its logits by 6.1e-3 of
# max|logit| (tests/test_torch_launch.py, -s), so four such steps;
# (c) `launch.train --distributed` at world size 1 over NCCL for
# DIST_STEPS steps of lm-100m against the same run without it
BF16_LOGIT_RTOL = 2.0 ** -6
DIST_STEPS = 20
# phase 19's reduced runs of the new families
NEW_FAMILY_TRAIN_STEPS = 30
RESOLVE_CALLS = 100_000  # memoized "auto" resolutions timed on the host
TIMING_REPEATS = 15   # timed runs per call; the median is kept
TIMING_CALLS = 40     # back-to-back calls per timed run
SLEEP_CYCLES = 2**23  # the first hold of the stream (~4 ms at 1.98 GHz)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase(msg: str) -> None:
    print(msg, flush=True)


def ptxas_report(name: str, log: str) -> dict:
    """Print each kernel instance's registers and spills from one source's
    `-Xptxas=-v` log; returns {instance: bytes of spill stores + loads}."""
    spills, entry = {}, "?"
    for line in log.splitlines():
        fn = re.search(r"entry function '.*?\d+([a-z_]+_kernel)"
                       r"(?:I((?:L[a-z]+\d+E)+)E)?", line)
        if fn:  # the kernel (and its template instance) reported next
            args = re.findall(r"L([a-z]+)(\d+)E", fn[2] or "")
            entry = fn[1] + (
                "<" + ", ".join(("true" if n == "1" else "false")
                                if t == "b" else n for t, n in args) + ">"
                if args else "")
        elif "registers" in line or "spill" in line:
            phase(f"  ptxas {name} {entry}: {line.strip()}")
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if found:
                spills[entry] = int(found[1]) + int(found[2])
    return spills


def ptxas_log_again(name: str) -> str:
    """The `-Xptxas=-v` report of `csrc/<name>.cu`, compiled once more into
    a throwaway library, for a source that `build.build` found built."""
    from repro_torch.kernels import build

    target = build.BUILD_DIR / f"{name}-report.{os.getpid()}.so"
    proc = build.start_nvcc(build.CSRC / f"{name}.cu", target)
    log, _ = proc.communicate()
    target.unlink(missing_ok=True)
    check(proc.returncode == 0, f"{name}.cu failed to compile:\n{log}")
    return log


def sass_count(library, opcode: str, function: str = ""):
    """How many `opcode` instructions `cuobjdump -sass` lists in the
    functions of `library` whose mangled names contain `function`, or
    None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                         text=True, check=True).stdout
    return sum(sum(opcode in line for line in body.splitlines())
               for body in out.split("Function :")[1:]
               if function in body.split("\n", 1)[0])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def float64_gradient_and_bound(x, y, w, beta, masks=None) -> tuple:
    """The round gradient in float64, ((X beta - y) w mask) @ X, and the
    bound held_to_float64 states, rtol 1e-3 + 1e-6 * S, S the magnitude
    of the summed terms (masks=None: one flat gradient, else (T, M))."""
    x64, y64, b64 = x.double(), y.double(), beta.double()
    w64 = torch.ones_like(y64) if w is None else w.double()
    ms = torch.ones((1, x.shape[0]), dtype=torch.float64, device=x.device) \
        if masks is None else masks.double()
    exact = ((x64 @ b64 - y64) * w64 * ms) @ x64
    scale = ((w64.abs() * ms.abs()) * (x64.abs() @ b64.abs() + y64.abs())) \
        @ x64.abs()
    return exact, 1e-3 * exact.abs() + 1e-6 * scale


def float64_share(got, exact, bound) -> float:
    """The largest |got - exact| / bound of a round gradient."""
    return float(((got.double().reshape(exact.shape) - exact).abs()
                  / bound).max())


def held_to_float64(name: str, got, plain, x, y, w, beta,
                    masks=None) -> float:
    """Hold the kernel's result `got` and the plain version's `plain`
    against the float64 expression within rtol 1e-3 + 1e-6 * S, S the
    magnitude of the summed terms, (|w| |mask| (|X||beta| + |y|)) @ |X|
    (masks=None: one flat gradient, else (T, M) tier masks).  Prints both
    and returns max |got - plain|."""
    exact, bound = float64_gradient_and_bound(x, y, w, beta, masks)
    worst = {label: float64_share(g, exact, bound)
             for label, g in (("kernel", got), ("plain", plain))}
    err = float((got - plain).abs().max())
    elementwise = torch.allclose(got, plain, rtol=1e-3, atol=1e-6)
    phase(f"check {name}: max_abs_err vs plain {err:.3e} (|ref| max "
          f"{float(exact.abs().max()):.3e}); worst element at "
          f"{worst['kernel']:.3f} (kernel) and {worst['plain']:.3f} "
          f"(plain) of the float64 bound; element-wise allclose to plain "
          f"(rtol 1e-3, atol 1e-6) {elementwise}")
    check(worst["kernel"] <= 1.0 and worst["plain"] <= 1.0,
          f"{name} outside its float64 bound")
    return err


def time_ms(fn, copies: list[tuple], calls: int = TIMING_CALLS) -> float:
    """Device time of one `fn(*operands)` call in ms.

    Call i (counted across runs) takes `copies[i % len(copies)]`: one
    copy stays warm in L2, copies larger than the L2 together leave each
    call's operands cold.
    Each timed run enqueues `calls` calls behind a sleep kernel and
    brackets them with CUDA events; if the sleep ended before the host
    finished enqueuing, the device may have waited on the host, so the run
    is repeated with a longer sleep.  Returns the median over
    `TIMING_REPEATS` runs of the run's time over its calls.  A function
    that enqueues hundreds of launches per call takes fewer calls per
    run, so that the hold covers the host's enqueue."""
    for i in range(2 * len(copies)):  # warm-up
        fn(*copies[i % len(copies)])
    cycles, samples, k = SLEEP_CYCLES, [], 0
    while len(samples) < TIMING_REPEATS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):  # the rotation goes on across runs
            fn(*copies[k % len(copies)])
            k += 1
        enqueue_s = time.perf_counter() - t0
        end.record()
        drained = start.query()  # the device reached the run already
        end.synchronize()
        if drained:
            cycles *= 2
            check(cycles <= 2**30, "the host cannot enqueue the timed run "
                  f"within a 0.5 s hold of the stream (last enqueue of "
                  f"{calls} calls took {enqueue_s:.3f} s)")
            continue
        samples.append(start.elapsed_time(end) / calls)
    return statistics.median(samples)


def cold_copies(operands: tuple) -> list[tuple]:
    """Clones of `operands` (None stays None) whose bytes together exceed
    twice the L2, so rotating over them finds each call's operands cold."""
    size = sum(t.numel() * t.element_size() for t in operands
               if t is not None)
    n = -(-2 * L2_BYTES // size) + 1
    return [tuple(None if t is None else t.clone() for t in operands)
            for _ in range(n)]

def allclose_report(got, want, rtol: float, atol: float) -> tuple:
    """(max |got - want|, allclose(got, want, rtol, atol))."""
    return (float((got - want).abs().max()),
            bool(torch.allclose(got, want, rtol=rtol, atol=atol)))


def check_prng_kernel(dev, gen, errs: dict) -> tuple:
    """Phase 3's checks of the in-kernel-generator encode (kernel 3);
    returns (key, w, x) at (2016, 300, 501) for the timing phase."""
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.encode import prng
    from repro_torch.kernels.encode import ref as enc_ref

    c, ell, d1 = 2016, 300, 501
    key = prng.split_keys(prng.prng_key(FLEET_KEY_SEED), 24)[0]
    ones, eye = torch.ones(ell, device=dev), torch.eye(ell, device=dev)
    for kind in prng.KINDS:  # X = I, w = 1: the kernel returns G (big +
        # small of each normal entry, within 2^-22 |g|)
        got = enc_ops.encode_parity_prng(key, ones, eye, c, kind)
        want = prng.generator_values(key, c, ell, kind, device=dev)
        torch.cuda.synchronize()
        err, close = allclose_report(got, want, 1e-6, 1e-7)
        equal = torch.equal(got, want)
        share = float((got == want).float().mean())
        phase(f"check encode_prng G ({c}, {ell}) {kind} via X = I: "
              f"max_abs_err {err:.3e}, bit-equal share {share:.6f}, "
              f"torch.equal {equal}, within rtol 1e-6 / atol 1e-7 {close}")
        check(equal if kind == "bernoulli" else close,
              f"encode_prng {kind} generator differs from the plain one")
    w = torch.rand((ell,), generator=gen, device=dev)
    x = torch.randn((ell, d1), generator=gen, device=dev)
    odd = (torch.rand((299,), generator=gen, device=dev),
           torch.randn((299, 33), generator=gen, device=dev))
    for (cc, ww, xx) in ((c, w, x), (2017, *odd)):  # 2017 * 299 is odd
        for kind in prng.KINDS:
            got = enc_ops.encode_parity_prng(key, ww, xx, cc, kind)
            again = enc_ops.encode_parity_prng(key, ww, xx, cc, kind)
            want = enc_ref.encode_parity_prng(key, ww, xx, cc, kind)
            torch.cuda.synchronize()
            bound = 2e-4 * float(want.abs().max())
            err, ok = allclose_report(got, want, 2e-4, bound)
            phase(f"check encode_prng ({cc}, {xx.shape[0]}, {xx.shape[1]}) "
                  f"{kind}: max_abs_err {err:.3e} bound 2e-4*max|ref| = "
                  f"{bound:.3e}, allclose {ok}; bit-identical relaunch "
                  f"{torch.equal(got, again)}")
            check(ok, f"encode_prng {kind} disagrees with its plain version")
            check(torch.equal(got, again), "encode_prng not deterministic")
            if cc == c:
                errs[f"encode_prng_{kind}"] = err
    for kind in prng.KINDS:  # the float64 bound, G the plain generator
        g = prng.generator_values(key, c, ell, kind, device=dev)
        p64, bound = enc_ops.float64_reference_and_bound(g, w, x)
        del g
        shares = {
            label: float(((p.double() - p64).abs() / bound).max())
            for label, p in (
                ("kernel", enc_ops.encode_parity_prng(key, w, x, c, kind)),
                ("plain", enc_ref.encode_parity_prng(key, w, x, c, kind)))}
        del p64, bound
        phase(f"check encode_prng ({c}, {ell}, {d1}) {kind}: worst element "
              f"at {shares['kernel']:.4f} (kernel) and "
              f"{shares['plain']:.4f} (plain) of the float64 bound")
        check(shares["kernel"] <= 1.0 and shares["plain"] <= 1.0,
              f"encode_prng {kind} outside its float64 bound")
    return key, w, x


def check_lsq_kernel(dev, gen, errs: dict) -> tuple:
    """Phase 3's checks of the least-squares gradient (kernel 6) at the
    §IV parity block; returns (a, y, beta) for the timing phase."""
    from repro_torch.kernels.coded_grad import ops as cg_ops
    from repro_torch.kernels.coded_grad import ref as cg_ref
    from repro_torch.kernels.common import resolve_block
    from repro_torch.kernels.round_grad import ops as rg_ops

    m, d = 2016, 500
    a = torch.randn((m, d), generator=gen, device=dev)
    y = torch.randn((m,), generator=gen, device=dev)
    beta = torch.randn((d,), generator=gen, device=dev)
    got = cg_ops.lsq_gradient(a, y, beta)
    again = cg_ops.lsq_gradient(a, y, beta)
    plain = cg_ref.lsq_gradient(a, y, beta)
    # the flat kernel at the row tile lsq_gradient resolved (its family,
    # "coded_grad", is tuned apart from "round_grad")
    tile = resolve_block("coded_grad", (m, d), "auto", 0, dev)
    flat = rg_ops.masked_round_gradient(a, y, None, beta, block_m=tile)
    torch.cuda.synchronize()
    errs["lsq_gradient"] = held_to_float64(f"lsq_gradient ({m}, {d})", got,
                                           plain, a, y, None, beta)
    phase(f"  bit-identical relaunch {torch.equal(got, again)}; "
          f"torch.equal to the flat kernel at w = None and its row tile "
          f"{tile or rg_ops.rows_per_cta(m)} {torch.equal(got, flat)}")
    check(torch.equal(got, again), "lsq_gradient not deterministic")
    check(torch.equal(got, flat), "lsq_gradient differs from the flat kernel")
    return a, y, beta


def plain_composite(key, xs, ys, weights, c: int) -> tuple:
    """The fleet composite [X~ | y~] (c, d+1) of the plain in-kernel-
    generator encode, client by client in order, and S, the element-wise
    sum over clients of |G_i diag(w_i) [X_i | y_i]|: the magnitude of the
    summed terms, which scales the rounding of any reassociated sum."""
    from repro_torch.kernels.encode import prng
    from repro_torch.kernels.encode import ref as enc_ref

    keys = prng.split_keys(key, xs.shape[0])
    xa = torch.cat([xs, ys[..., None]], dim=-1)
    acc = torch.zeros((c, xa.shape[2]), device=xs.device)
    scale = torch.zeros_like(acc)
    for i in range(xs.shape[0]):
        p = enc_ref.encode_parity_prng(keys[i], weights[i], xa[i], c)
        acc, scale = acc + p, scale + p.abs()
    return acc, scale


def check_tiered_against_flat(label: str, tiered, flat, scale) -> None:
    """A T-tier composite against the flat one: within rtol 1e-5 plus an
    atol of 1e-6 * S.  The two sum the same client parities in another
    order, so they differ by float32 rounding that scales with S, the
    magnitude of the summed terms (24 terms in order: at most about
    1.4e-6 * S); at the §IV width (|entries| ~ 1e3) an element-wise atol
    of 1e-6 alone fails at cancelled entries.  Prints both."""
    err, elementwise = allclose_report(tiered, flat, 1e-5, 1e-6)
    worst = float(((tiered - flat).abs()
                   / (1e-5 * flat.abs() + 1e-6 * scale)).max())
    phase(f"{label}: tiered vs flat max_abs_err {err:.3e}, worst element at "
          f"{worst:.3f} of rtol 1e-5 + 1e-6 * S; element-wise rtol 1e-5 / "
          f"atol 1e-6 {elementwise}")
    check(worst <= 1.0, f"{label}: tiered encode outside its bound")


def check_against_reference(label, fused, ref) -> None:
    """A fused-path run against its reference-path run: NMSE within rtol
    1e-4, clocks identical."""
    rel = float(np.max(np.abs(ref.nmse - fused.nmse) / np.abs(ref.nmse)))
    same_clock = bool(np.array_equal(ref.times, fused.times))
    phase(f"{label}: fused vs reference max rel NMSE diff {rel:.3e} "
          f"(bound 1e-4); times identical {same_clock}")
    check(np.allclose(fused.nmse, ref.nmse, rtol=1e-4, atol=0.0),
          f"{label}: fused and reference traces disagree")
    check(same_clock, f"{label}: clocks differ")


def check_trace(rep) -> None:
    check(rep.nmse.shape == (601,)
          and bool(np.all(np.isfinite(rep.nmse))),
          f"{rep.label}: NMSE trace not finite or wrong shape")
    check(rep.nmse[600] < rep.nmse[300] < rep.nmse[0],
          f"{rep.label}: NMSE trace does not descend")


def fleet_width_phase(out, reset_counters, read_counters) -> dict:
    """Phase 8: the tiered in-kernel-generator encode of the quickstart's
    data at T = 3, the flat encode and T = 1."""
    from repro_torch.fleet import FleetTopology, encode_fleet_tiered
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.encode import prng

    data, state = out["data"], out["state"]
    xs, ys, weights, c = data.xs, data.ys, state.weights, state.c
    key = prng.prng_key(FLEET_KEY_SEED)
    reset_counters()
    t0 = time.perf_counter()
    x_t, y_t = encode_fleet_tiered(key, xs, ys, weights, c,
                                   FleetTopology.uniform(data.n, HIER_TIERS))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counters()
    check(counts == {**dict.fromkeys(counts, 0), "encode_prng": data.n},
          f"unexpected fleet-path launch counts {counts}")
    x_f, y_f = enc_ops.encode_fleet_prng(key, xs, ys, weights, c)
    x_1, y_1 = encode_fleet_tiered(key, xs, ys, weights, c,
                                   FleetTopology.uniform(data.n, 1))
    acc, scale = plain_composite(key, xs, ys, weights, c)
    torch.cuda.synchronize()
    flat = torch.cat([x_f, y_f[:, None]], dim=1)
    bound = 2e-4 * float(acc.abs().max())
    err, ok = allclose_report(flat, acc, 2e-4, bound)
    one_equal = torch.equal(x_1, x_f) and torch.equal(y_1, y_f)
    phase(f"fleet path (§IV width, {data.n} x {data.ell} x {data.d}, c={c}, "
          f"T={HIER_TIERS}): {seconds:.4f} s wall; launches {counts}")
    phase(f"fleet path: flat encode vs plain composite max_abs_err {err:.3e} "
          f"bound 2e-4*max|ref| = {bound:.3e}, allclose {ok}; T=1 torch.equal "
          f"to the flat encode {one_equal}")
    check(tuple(x_t.shape) == (c, data.d) and tuple(y_t.shape) == (c,)
          and bool(torch.isfinite(x_t).all() & torch.isfinite(y_t).all()),
          "tiered parity not finite or of the wrong shape")
    check(ok, "the flat in-kernel-generator encode disagrees with plain")
    check(one_equal, "T = 1 tiered encode differs from the flat one")
    check_tiered_against_flat(f"fleet path T={HIER_TIERS}",
                              torch.cat([x_t, y_t[:, None]], dim=1), flat,
                              scale)
    return {"launches": counts["encode_prng"], "seconds": seconds,
            "err": err}


def fleet_scale_phase(dev, reset_counters, read_counters) -> dict:
    """Phase 9: `solve_fleet`, the tiered encode and round scheduling at
    the scales of benchmarks/perf_fleet.py."""
    from repro_torch.fleet import (FleetTopology, encode_fleet_tiered,
                                   sample_tier_rounds, solve_fleet)
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.encode import prng
    from repro_torch.plan import PlanRequest
    from repro_torch.sim.network import mega_fleet

    fleet = mega_fleet(FLEET_N, d=FLEET_D, seed=0)
    sizes = np.random.default_rng(1).integers(POINTS_LO, POINTS_HI + 1,
                                              size=FLEET_N)
    req = PlanRequest(edge=fleet.edge, server=fleet.server,
                      data_sizes=sizes, c_up=FLEET_C_UP)
    reset_counters()
    t0 = time.perf_counter()
    plan = solve_fleet(req, eps_rel=FLEET_EPS_REL, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    check(set(read_counters().values()) == {0},
          "the fleet planner launched a hand-written kernel")
    phase(f"solve_fleet n={FLEET_N}: {plan_s:.4f} s wall; t*={plan.t_star!r} "
          f"c={plan.c} expected_agg={plan.expected_agg!r} (target {req.m}); "
          f"loads {np.bincount(plan.loads).tolist()} (count per load)")
    check(plan.loads.shape == (FLEET_N,) and bool(np.all(plan.loads >= 0))
          and bool(np.all(plan.loads <= sizes)), "plan exceeds device caps")
    check(plan.expected_agg >= req.m * (1.0 - 1e-6),
          "plan misses the return target")
    check(np.isfinite(plan.t_star) and 0 <= plan.c <= FLEET_C_UP,
          "fleet plan t* or c out of range")

    gen = torch.Generator(device=dev).manual_seed(3)
    xs = torch.randn((ENC_CLIENTS, ENC_ELL, FLEET_D), generator=gen,
                     device=dev)
    ys = torch.randn((ENC_CLIENTS, ENC_ELL), generator=gen, device=dev)
    w = torch.rand((ENC_CLIENTS, ENC_ELL), generator=gen, device=dev) + 0.5
    key = prng.prng_key(3)
    topo = FleetTopology.uniform(ENC_CLIENTS, ENC_TIERS)
    encodes, prng_launches = {}, 0
    for label, fn in (("tiered", lambda: encode_fleet_tiered(
            key, xs, ys, w, ENC_C, topo)),
            ("flat", lambda: enc_ops.encode_fleet_prng(key, xs, ys, w,
                                                       ENC_C))):
        reset_counters()
        t0 = time.perf_counter()
        encodes[label] = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counters()
        phase(f"fleet-scale {label} encode ({ENC_CLIENTS} x {ENC_ELL} x "
              f"{FLEET_D}, c={ENC_C}): {secs:.4f} s wall; launches {counts}")
        check(counts == {**dict.fromkeys(counts, 0),
                         "encode_prng": ENC_CLIENTS},
              f"unexpected fleet-scale encode launch counts {counts}")
        encodes[label + "_s"] = secs
        prng_launches += counts["encode_prng"]
    acc, scale = plain_composite(key, xs, ys, w, ENC_C)
    flat = torch.cat([encodes["flat"][0], encodes["flat"][1][:, None]], 1)
    bound = 2e-4 * float(acc.abs().max())
    err, ok = allclose_report(flat, acc, 2e-4, bound)
    phase(f"fleet-scale flat encode vs plain composite max_abs_err "
          f"{err:.3e} bound 2e-4*max|ref| = {bound:.3e}, allclose {ok}")
    check(ok, "the fleet-scale flat encode disagrees with plain")
    check_tiered_against_flat(
        f"fleet-scale T={ENC_TIERS}",
        torch.cat([encodes["tiered"][0], encodes["tiered"][1][:, None]], 1),
        flat, scale)

    def schedule(n: int) -> float:
        fl = mega_fleet(n, d=FLEET_D, seed=0)
        rng = np.random.default_rng(2)
        loads = rng.integers(POINTS_LO, POINTS_HI + 1, size=n)
        tp = FleetTopology.uniform(n, SAMPLE_TIERS) \
            .with_round_budget(SAMPLE_BUDGET)
        best = np.inf
        for _ in range(2):  # best of two: the check is a ratio of walls
            t0 = time.perf_counter()
            stats = sample_tier_rounds(tp, fl.edge, loads, SAMPLE_EPOCHS,
                                       rng)
            best = min(best, time.perf_counter() - t0)
        check(stats.total_participants < 4 * SAMPLE_BUDGET * SAMPLE_EPOCHS,
              f"round budget not honoured: {stats.total_participants}")
        check(bool(np.all(np.isfinite(stats.durations))),
              "round durations not finite")
        return best

    small_s, large_s = schedule(FLEET_N // 10), schedule(FLEET_N)
    growth = large_s / max(small_s, 1e-9)
    phase(f"sample_tier_rounds (budget {SAMPLE_BUDGET}, {SAMPLE_TIERS} "
          f"tiers, {SAMPLE_EPOCHS} epochs): n={FLEET_N // 10} {small_s:.6f} "
          f"s, n={FLEET_N} {large_s:.6f} s, wall ratio {growth:.3f} "
          f"(ceiling {GROWTH_CEIL})")
    check(growth <= GROWTH_CEIL, f"round scheduling grew {growth:.2f}x")
    return {"plan_s": plan_s, "tiered_s": encodes["tiered_s"],
            "flat_s": encodes["flat_s"], "small_s": small_s,
            "large_s": large_s, "growth": growth,
            "prng_launches": prng_launches}


def time_prng_fleet_shape(dev, gen, card: str) -> dict:
    """Kernel 3 at one launch of phase 9's fleet-scale encode: a client's
    (ENC_C, ENC_ELL, FLEET_D + 1) normal parity, labels as the last
    column, the calls rotating over ENC_CLIENTS clients' operands as the
    encode does (together 0.3 MB: the rotation is L2-warm, and copies of
    a client's 1 KB past twice the L2 would be ~10^5); a single client's
    operands beside it, its plain version, the library product on a
    materialized G (held to the kernel first) and the bound of
    `roofline.kernel_terms`."""
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.encode import prng
    from repro_torch.kernels.encode import ref as enc_ref

    c, ell, d1 = ENC_C, ENC_ELL, FLEET_D + 1
    key = prng.split_keys(prng.prng_key(3), ENC_CLIENTS)[0]
    clients = [(torch.rand((ell,), generator=gen, device=dev) + 0.5,
                torch.randn((ell, d1), generator=gen, device=dev))
               for _ in range(ENC_CLIENTS)]

    def kernel(w_, x_):
        return enc_ops.encode_parity_prng(key, w_, x_, c, "normal")

    def plain(w_, x_):
        return enc_ref.encode_parity_prng(key, w_, x_, c, "normal")

    g = prng.generator_values(key, c, ell, "normal", device=dev)
    w, x = clients[0]
    got = kernel(w, x)
    lib_err = float((g @ (w[:, None] * x) - got).abs().max())
    check(lib_err <= 2e-4 * max(1.0, float(got.abs().max())),
          f"the library product of kernel 3 at the fleet-scale shape "
          f"disagrees with the kernel: {lib_err:.3e}")
    terms = kernel_terms("encode_prng", (c, ell, d1))
    r = {"shape": [c, ell, d1], "ms": time_ms(kernel, clients),
         "ms_one_client": time_ms(kernel, clients[:1]),
         "plain_ms": time_ms(plain, clients[:8], calls=4),
         "library_ms": time_ms(lambda g_, w_, x_: g_ @ (w_[:, None] * x_),
                               [(g, *op) for op in clients]),
         "bound_ms": 1e3 * terms["bound_s"], "bound_by": terms["bound_by"]}
    phase(f"time encode_prng normal at the fleet-scale shape ({c}, {ell}, "
          f"{d1}) [{card}]: kernel {r['ms']!r} ms over {ENC_CLIENTS} "
          f"clients' operands (one client's {r['ms_one_client']!r} ms), "
          f"plain {r['plain_ms']!r} ms, library G @ (w X) on a "
          f"materialized G {r['library_ms']!r} ms (max |library - kernel| "
          f"{lib_err:.3e}), bound {r['bound_ms']!r} ms ({r['bound_by']})")
    return r


def legacy_phase(out, dev, reset_counters, read_counters) -> dict:
    """Phase 10: the legacy per-epoch loop over phase 4's CodedFL state."""
    from repro_torch import quickstart
    from repro_torch.api import CodedFL
    from repro_torch.core import aggregation, cfl

    state, data, plan = out["state"], out["data"], out["plan"]
    sched = CodedFL(key=1, fixed_c=plan.c, include_upload_delay=False,
                    redundancy_plan=plan).sample_epochs(
        state, out["fleet"], 600, np.random.default_rng(0))
    received = torch.as_tensor(sched.arrivals["received"], device=dev)
    parity_ok = torch.as_tensor(sched.arrivals["parity_ok"], device=dev)
    lr = torch.tensor(quickstart.LR, dtype=torch.float32, device=dev)

    def run(use_kernel: bool) -> np.ndarray:
        beta = torch.zeros(data.d, device=dev)
        trace = torch.empty(601, device=dev)
        trace[0] = aggregation.nmse(beta, data.beta_true)
        for e in range(600):
            g = cfl.epoch_gradient(state, data.xs, data.ys, beta,
                                   received[e], parity_ok[e],
                                   use_kernel=use_kernel)
            beta = aggregation.gd_update(beta, g, lr, data.m)
            trace[e + 1] = aggregation.nmse(beta, data.beta_true)
        return trace.cpu().numpy()  # the run's one sync

    reset_counters()
    t0 = time.perf_counter()
    fused = run(True)
    seconds = time.perf_counter() - t0
    counts = read_counters()
    t0 = time.perf_counter()
    plain = run(False)
    plain_s = time.perf_counter() - t0
    check(read_counters() == counts, "the plain legacy loop launched a kernel")
    rel = float(np.max(np.abs(fused - plain) / np.abs(plain)))
    phase(f"legacy path: 600 epochs {seconds:.4f} s wall (plain "
          f"{plain_s:.4f} s); final NMSE {fused[-1]:.3e}; launches {counts}; "
          f"kernel vs plain max rel NMSE diff {rel:.3e} (bound 1e-4)")
    check(counts == {**dict.fromkeys(counts, 0), "lsq_gradient": 600},
          f"unexpected legacy launch counts {counts}")
    check(bool(np.all(np.isfinite(fused))) and fused.shape == (601,),
          "legacy NMSE trace not finite or wrong shape")
    check(fused[600] < fused[300] < fused[0], "legacy trace does not descend")
    check(np.allclose(fused, plain, rtol=1e-4, atol=0.0),
          "legacy kernel and plain traces disagree")
    return {"launches": counts["lsq_gradient"], "seconds": seconds}


def timed_run(session, data, state=None, seed: int = 0):
    """One `Session.run` with a fresh generator; returns (report, host
    seconds ending in a device sync)."""
    t0 = time.perf_counter()
    rep = session.run(data, rng=np.random.default_rng(seed), state=state)
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t0


def gradcode_phase(out, dev, card: str, expect, reset_counters,
                   read_counters) -> dict:
    """Phase 14: GradientCodingFL through the registry on the §IV fleet and
    the quickstart's data, r = 2 and 3, flat and under the tiers."""
    from repro_torch.api import Session, make_strategy
    from repro_torch.core.gradient_coding import run_gradient_coding
    from repro_torch.fleet import FleetTopology, HierarchicalCFL, HierState

    fleet, data = out["fleet"], out["data"]
    lr, epochs = 0.0085, 600
    reports, seconds, launches = {}, {}, {}
    for r in GC_REPLICATION:
        strategy = make_strategy("gradcode", r=r)
        sess = Session(strategy, fleet, lr, epochs, device=dev)
        state = sess.plan(data)
        check(tuple(strategy.device_state(state, data)["x"].shape)
              == (data.m, data.d), "gradcode streams other than all m rows")
        reset_counters()
        rep, secs = timed_run(sess, data, state)
        counts = read_counters()
        phase(f"gradcode r={r} [{card}]: 600 epochs {secs:.4f} s wall; "
              f"{state.n_groups} groups, shard time {state.shard_time!r} s; "
              f"final NMSE {rep.final_nmse():.3e} at {rep.times[-1]:.1f} s "
              f"simulated; launches {counts}")
        check_trace(rep)
        check(counts == expect(round_grad=epochs),
              f"unexpected gradcode r={r} launch counts {counts}")
        before = read_counters()
        ref, _ = timed_run(Session(make_strategy(
            "gradcode", r=r, grad_path="reference"), fleet, lr, epochs,
            device=dev), data, state)
        check(read_counters() == before,
              "the reference path launched a kernel")
        check_against_reference(f"gradcode r={r}", rep, ref)
        reports[r], seconds[f"r={r}"] = rep, secs
        launches[f"r={r}"] = counts["round_grad"]

    r = GC_REPLICATION[0]
    base = make_strategy("gradcode", r=r)
    state = base.plan(fleet, data)
    for nt in (HIER_TIERS, 1):
        topo = FleetTopology.uniform(data.n, nt)
        hier = make_strategy("hierarchical", base=base, topology=topo)
        reset_counters()
        rep, secs = timed_run(Session(hier, fleet, lr, epochs, device=dev),
                              data, HierState(state, topo))
        counts = read_counters()
        phase(f"gradcode r={r} hierarchical T={nt} [{card}]: 600 epochs "
              f"{secs:.4f} s wall; final NMSE {rep.final_nmse():.3e}; "
              f"launches {counts}")
        check_trace(rep)
        check(counts == expect(tier_round_grad=epochs),
              f"unexpected gradcode hierarchical launch counts {counts}")
        if nt == HIER_TIERS:
            seconds[f"T={nt}"] = secs
            launches[f"T={nt}"] = counts["tier_round_grad"]
        else:
            equal = bool(np.array_equal(rep.nmse, reports[r].nmse))
            phase(f"gradcode T=1 NMSE trace bit-equal to the flat r={r} "
                  f"trace: {equal}")
            check(equal, "T = 1 gradcode trace differs from the flat one")
            check(np.array_equal(rep.times, reports[r].times),
                  "T = 1 gradcode clocks")

    reset_counters()
    shim = run_gradient_coding(fleet, data.xs, data.ys, data.beta_true, lr,
                               epochs, np.random.default_rng(0), r=r,
                               device=dev)
    counts = read_counters()
    equal = bool(np.array_equal(shim.nmse, reports[r].nmse)
                 and np.array_equal(shim.times, reports[r].times))
    phase(f"run_gradient_coding r={r}: trace bit-equal to the Session run "
          f"{equal}; launches {counts}")
    check(equal, "run_gradient_coding differs from the Session run")
    check(counts == expect(round_grad=epochs),
          f"unexpected run_gradient_coding launch counts {counts}")
    return {"seconds": seconds, "launches": launches}


def dp_scfl_phase(out, dev, card: str, expect, reset_counters,
                  read_counters) -> dict:
    """Phase 15: StochasticCodedFL calibrated to an (epsilon, delta)
    budget through the registry, calibration and planning on the card."""
    from repro_torch.api import Session, make_strategy
    from repro_torch.privacy import epsilon_spent

    fleet, data = out["fleet"], out["data"]
    lr, epochs = 0.0085, 600
    t0 = time.perf_counter()
    scfl = make_strategy("stochastic", key_seed=1, fixed_c=DP_FIXED_C,
                         epsilon_target=DP_EPSILON, delta=DP_DELTA,
                         rounds=epochs, sample_frac=DP_RHO,
                         include_upload_delay=False)
    calib_s = time.perf_counter() - t0
    sigma = scfl.noise_multiplier
    eps_at = epsilon_spent(sigma, DP_RHO, epochs, DP_DELTA, device=dev)
    phase(f"dp scfl [{card}]: calibrated noise multiplier {sigma!r} for "
          f"epsilon {DP_EPSILON} at delta {DP_DELTA}, {epochs} rounds, "
          f"rho {DP_RHO} in {calib_s:.4f} s; epsilon_spent(sigma) "
          f"{eps_at!r}; srv_weight {scfl.srv_weight!r}")
    check(eps_at <= DP_EPSILON, "the calibrated sigma overspends the budget")
    check(abs(eps_at - DP_EPSILON) <= 1e-3 * DP_EPSILON,
          "the calibrated sigma misses the budget by more than 1e-3")
    check(scfl.srv_weight == DP_RHO / (1.0 + sigma * sigma),
          "srv_weight != sample_frac / (1 + sigma^2)")
    sess = Session(scfl, fleet, lr, epochs, device=dev)
    reset_counters()
    t0 = time.perf_counter()
    state = sess.plan(data)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    rep, run_s = timed_run(sess, data, state)
    counts = read_counters()
    plan = state.plan
    phase(f"dp scfl [{card}]: plan+encode {plan_s:.4f} s, 600 epochs "
          f"{run_s:.4f} s wall; plan c={plan.c} t*={plan.t_star!r} "
          f"loads={plan.loads.tolist()}; final NMSE {rep.final_nmse():.3e} "
          f"(min {float(np.min(rep.nmse)):.3e}) at {rep.times[-1]:.1f} s "
          f"simulated; launches {counts}")
    check(plan.c == DP_FIXED_C, "dp scfl plan c")
    check(np.all(plan.loads <= data.ell) and np.all(plan.loads >= 0),
          "dp scfl loads outside their caps")
    check(rep.nmse.shape == (epochs + 1,)
          and bool(np.all(np.isfinite(rep.nmse))),
          "dp scfl NMSE trace not finite or wrong shape")
    check(counts == expect(coded_round_grad=epochs, encode=data.n),
          f"unexpected dp scfl launch counts {counts}")
    before = read_counters()
    ref, _ = timed_run(Session(
        dataclasses.replace(scfl, grad_path="reference"), fleet, lr, epochs,
        device=dev), data, state)
    check(read_counters() == before, "the reference path launched a kernel")
    check_against_reference("dp scfl", rep, ref)
    sched = rep.extras["epsilon_schedule"]
    budget = rep.privacy_budget()
    phase(f"dp scfl: epsilon_schedule shape {sched.shape}, first "
          f"{sched[0]!r}, last {sched[-1]!r}; privacy_budget() {budget}")
    check(sched.shape == (epochs,) and bool(np.all(np.diff(sched) >= 0.0)),
          "epsilon_schedule of the wrong shape or decreasing")
    check(sched[-1] == rep.extras["epsilon_spent"],
          "epsilon_schedule does not end at epsilon_spent")
    check(budget == (rep.extras["epsilon_spent"], DP_DELTA),
          "privacy_budget() != (epsilon_spent, delta)")
    check(rep.extras["epsilon_target"] == DP_EPSILON
          and rep.extras["accounting_rounds"] == epochs,
          "dp scfl extras")
    return {"seconds": {"calibrate": calib_s, "plan": plan_s, "run": run_s},
            "launches": counts, "sigma": sigma, "strategy": scfl,
            "state": state, "report": rep}


def lowlat_phase(out, dev, card: str, expect, reset_counters,
                 read_counters) -> dict:
    """Phase 16: LowLatencyCFL through the registry on the wireless §IV
    fleet (`benchmarks/fig_schemes.py`'s lowlat_session at delta = 0.28):
    the partial-return plan on the card, training, chunks = 1 against
    CodedFL, and the tiers."""
    from repro_torch.api import Session, make_strategy
    from repro_torch.fleet import FleetTopology, HierState
    from repro_torch.sim.network import wireless_fleet

    data = out["data"]
    fleet = wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0)
    lr, epochs = 0.0085, 600
    kw = {"key_seed": LL_KEY_SEED, "fixed_c": int(LL_DELTA * data.m),
          "include_upload_delay": False}
    ll = make_strategy("lowlatency", chunks=LL_CHUNKS, **kw)
    sess = Session(ll, fleet, lr, epochs, device=dev)
    reset_counters()
    t0 = time.perf_counter()
    state = sess.plan(data)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    rep, run_s = timed_run(sess, data, state)
    counts = read_counters()
    plan = state.plan
    phase(f"lowlat chunks={LL_CHUNKS} [{card}]: plan+encode {plan_s:.4f} s, "
          f"600 epochs {run_s:.4f} s wall; t*={plan.t_star!r} c={plan.c} "
          f"expected aggregate {plan.expected_agg!r} (target {data.m}); "
          f"loads={plan.loads.tolist()}; mean chunk probability "
          f"{rep.extras['mean_chunk_prob']!r}; final NMSE "
          f"{rep.final_nmse():.3e} at {rep.times[-1]:.1f} s simulated; "
          f"launches {counts}")
    check(np.all(plan.loads <= data.ell) and np.all(plan.loads >= 0),
          "lowlat loads outside their caps")
    check(plan.expected_agg >= data.m,
          "the partial-return plan misses its aggregate target")
    check(plan.c == kw["fixed_c"], "lowlat plan c")
    check_trace(rep)
    check(counts == expect(round_grad=epochs, encode=data.n),
          f"unexpected lowlat launch counts {counts}")
    before = read_counters()
    ref, _ = timed_run(Session(dataclasses.replace(ll, grad_path="reference"),
                               fleet, lr, epochs, device=dev), data, state)
    check(read_counters() == before, "the reference path launched a kernel")
    check_against_reference(f"lowlat chunks={LL_CHUNKS}", rep, ref)

    # chunks = 1 against CodedFL with the same key and c (the encode
    # through the kernel on both sides)
    one = make_strategy("lowlatency", chunks=1, **kw)
    cfl = make_strategy("cfl", use_kernel=True, **kw)
    st_1, st_c = one.plan(fleet, data), cfl.plan(fleet, data)
    r_1, _ = timed_run(Session(one, fleet, lr, epochs, device=dev), data,
                       st_1)
    r_c, _ = timed_run(Session(cfl, fleet, lr, epochs, device=dev), data,
                       st_c)
    same_parity = torch.equal(st_1.x_parity, st_c.x_parity) \
        and torch.equal(st_1.y_parity, st_c.y_parity)
    rel = float(np.max(np.abs(r_1.nmse - r_c.nmse) / np.abs(r_c.nmse)))
    bit_equal = bool(np.array_equal(r_1.nmse, r_c.nmse))
    phase(f"lowlat chunks=1 vs cfl: t* {st_1.plan.t_star!r} / "
          f"{st_c.plan.t_star!r}; parity torch.equal {same_parity}; max rel "
          f"NMSE diff {rel:.3e} (bound 1e-5), bit-equal {bit_equal}; "
          f"setup_time {r_1.setup_time!r} / {r_c.setup_time!r}")
    check(st_1.plan.t_star == st_c.plan.t_star, "chunks = 1 t* != CodedFL's")
    check(same_parity, "chunks = 1 parity differs from CodedFL's")
    check(np.allclose(r_1.nmse, r_c.nmse, rtol=1e-5, atol=1e-8),
          "chunks = 1 trace differs from CodedFL's past rtol 1e-5")
    check(r_1.setup_time == r_c.setup_time, "chunks = 1 setup_time")

    topo = FleetTopology.uniform(data.n, HIER_TIERS)
    hier = make_strategy("hierarchical", base=ll, topology=topo)
    reset_counters()
    r_h, hier_s = timed_run(Session(hier, fleet, lr, epochs, device=dev),
                            data, HierState(state, topo))
    hier_counts = read_counters()
    phase(f"lowlat hierarchical T={HIER_TIERS} [{card}]: 600 epochs "
          f"{hier_s:.4f} s wall; final NMSE {r_h.final_nmse():.3e}; "
          f"launches {hier_counts}")
    check_trace(r_h)
    check(hier_counts == expect(tier_round_grad=epochs),
          f"unexpected lowlat hierarchical launch counts {hier_counts}")
    return {"seconds": {"plan": plan_s, "run": run_s, "hier": hier_s},
            "launches": counts, "hier_launches": hier_counts}


def check_mec_plan(label: str, plan, fleet, ell: int, c: int) -> None:
    """A MEC plan: loads within their caps, c as asked, and the Eq.-17
    probabilities equal to `mec_total_cdf` at the plan."""
    from repro_torch.core.delay_model import mec_total_cdf

    same = bool(np.array_equal(
        plan.p_return[:-1],
        mec_total_cdf(fleet.edge, plan.loads, plan.t_star)))
    phase(f"{label}: MEC plan t*={plan.t_star!r} c={plan.c} "
          f"loads={plan.loads.tolist()}; p_return equal to mec_total_cdf "
          f"at the plan: {same}")
    check(np.all(plan.loads <= ell) and np.all(plan.loads >= 0),
          f"{label}: loads outside their caps")
    check(plan.c == c, f"{label}: plan c")
    check(same, f"{label}: p_return differs from mec_total_cdf")


def check_rff_on_card(label: str, strategy, data, dev) -> None:
    """The strategy's features on the card against the float64 oracle of
    the same weight draw, within the reference's 5e-6."""
    from repro_torch.data import rff_map_reference
    from repro_torch.schemes import rff_seed

    phi = strategy.features(data)
    ref = rff_map_reference(data.xs.cpu().numpy(), strategy.d_feat,
                            rff_seed(strategy.key), gamma=strategy.rff_gamma,
                            device=dev)
    err = float(np.max(np.abs(phi.cpu().numpy() - ref)))
    phase(f"{label}: RFF features {tuple(phi.shape)} on the card vs the "
          f"float64 oracle max_abs_err {err:.3e} (bound {RFF_ATOL})")
    check(err <= RFF_ATOL, f"{label}: RFF features outside {RFF_ATOL}")


def codedfedl_phase(out, dev, card: str, expect, reset_counters,
                    read_counters) -> dict:
    """Phase 17: CodedFedL — (a) the nonlinear quickstart and the uncoded
    baseline through `train_coded_head`, (b) the §IV fleet size at
    d_feat 512 flat and under the tiers, (c) d_feat=None against CFL."""
    from repro_torch import nonlinear_quickstart as nq
    from repro_torch.api import Session, TrainData, make_strategy
    from repro_torch.data import classification_dataset, one_vs_rest_targets
    from repro_torch.fed import (head_accuracy, reference_head,
                                 train_coded_head)
    from repro_torch.fleet import FleetTopology, HierState
    from repro_torch.sim.network import wireless_fleet

    seconds, launches = {}, {}

    def reference_of(strategy):
        return dataclasses.replace(strategy, use_kernel=False,
                                   grad_path="reference")

    # (a) the nonlinear quickstart, counted from its data to its report
    epochs = 300
    reset_counters()
    t0 = time.perf_counter()
    nl = nq.run(epochs=epochs, device=dev)
    torch.cuda.synchronize()
    seconds["quickstart"] = time.perf_counter() - t0
    counts = read_counters()
    strategy, data, state = nl["strategy"], nl["data"], nl["state"]
    rep = nl["report"]
    phase(f"cfedl quickstart [{card}]: {seconds['quickstart']:.4f} s wall "
          f"(" + ", ".join(f"{k} {v:.4f}" for k, v in nl["seconds"].items())
          + f"); final NMSE {rep.final_nmse():.4f} at {rep.times[-1]:.1f} s "
          f"simulated; held-out accuracy kernel {nl['accuracy']:.4f} vs "
          f"best-linear {nl['linear_accuracy']:.4f}; launches {counts}")
    check_mec_plan("cfedl quickstart", state.plan, nl["fleet"], nq.ELL,
                   nq.FIXED_C)
    check(rep.nmse.shape == (epochs + 1,)
          and bool(np.all(np.isfinite(rep.nmse)))
          and rep.nmse[-1] < rep.nmse[0],
          "cfedl quickstart: NMSE trace not finite or not descending")
    check(counts == expect(round_grad=epochs, encode=nq.N),
          f"unexpected cfedl quickstart launch counts {counts}")
    launches["quickstart"] = counts
    check(nl["accuracy"] > nl["linear_accuracy"],
          "the kernel head does not beat the best linear model")
    check_rff_on_card("cfedl quickstart", strategy, data, dev)
    check(torch.equal(strategy.features(data), state.features),
          "the state's features differ from the map")
    before = read_counters()
    ref, _ = timed_run(Session(reference_of(strategy), nl["fleet"], nq.LR,
                               epochs, device=dev), data, state)
    check(read_counters() == before, "the reference path launched a kernel")
    check_against_reference("cfedl quickstart", rep, ref)

    # the uncoded baseline on the same features, through the coded head
    # (its coded arm encodes through kernel 2, as the quickstart's does)
    reset_counters()
    t0 = time.perf_counter()
    heads = train_coded_head(
        nl["fleet"], None, data.xs, data.ys,
        torch.zeros(nq.D_RAW, device=dev), lr=nq.LR, epochs=epochs,
        key=nq.KEY_SEED, rng=np.random.default_rng(0),
        fixed_c=nq.FIXED_C, d_feat=nq.D_FEAT,
        rff_gamma=nq.TEACHER_GAMMA / nq.D_RAW)
    torch.cuda.synchronize()
    seconds["coded_head"] = time.perf_counter() - t0
    counts = read_counters()
    acc_u = head_accuracy(strategy, heads["uncoded"].beta, nl["xs_te"],
                          nl["y_te"])
    acc_h = head_accuracy(strategy, heads["cfedl"].beta, nl["xs_te"],
                          nl["y_te"])
    h_u, h_c = heads["uncoded"], heads["cfedl"]
    phase(f"cfedl coded head [{card}]: {seconds['coded_head']:.4f} s wall "
          f"(uncoded then coded, {epochs} epochs each); uncoded final NMSE "
          f"{h_u.final_nmse():.4f} at {h_u.times[-1]:.1f} s simulated, "
          f"held-out accuracy {acc_u:.4f}; coded {h_c.final_nmse():.4f} at "
          f"{h_c.times[-1]:.1f} s, accuracy {acc_h:.4f}; launches {counts}")
    check(counts == expect(round_grad=2 * epochs, encode=nq.N),
          f"unexpected coded head launch counts {counts}")
    for r in (h_u, h_c):
        check(bool(np.all(np.isfinite(r.nmse))) and r.nmse[-1] < r.nmse[0],
              f"coded head {r.label}: NMSE trace not finite or rising")
    launches["coded_head"] = counts

    # (b) the §IV fleet size at d_feat 512
    fleet = wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0,
                           d=CFEDL_D_FEAT)
    xs, labels = classification_dataset(
        torch.Generator(device=dev).manual_seed(nq.DATA_SEED), CFEDL_N,
        CFEDL_ELL + CFEDL_ELL_TEST, nq.D_RAW, n_classes=2, centers=32,
        gamma=nq.TEACHER_GAMMA)
    ys = one_vs_rest_targets(labels, 1)
    xs_tr, xs_te = (xs[:, :CFEDL_ELL].contiguous(),
                    xs[:, CFEDL_ELL:].contiguous())
    y_tr, y_te = (ys[:, :CFEDL_ELL].contiguous(),
                  ys[:, CFEDL_ELL:].contiguous())
    wide = make_strategy("codedfedl", key_seed=nq.KEY_SEED,
                         d_feat=CFEDL_D_FEAT,
                         rff_gamma=nq.TEACHER_GAMMA / nq.D_RAW,
                         fixed_c=CFEDL_FIXED_C, use_kernel=True)
    wdata = TrainData(xs=xs_tr, ys=y_tr,
                      beta_true=reference_head(wide, xs_tr, y_tr))
    check_rff_on_card("cfedl §IV size", wide, wdata, dev)
    sess = Session(wide, fleet, CFEDL_LR, CFEDL_EPOCHS, device=dev)
    reset_counters()
    t0 = time.perf_counter()
    wstate = sess.plan(wdata)
    torch.cuda.synchronize()
    seconds["plan"] = time.perf_counter() - t0
    wrep, seconds["run"] = timed_run(sess, wdata, wstate)
    counts = read_counters()
    acc = head_accuracy(wide, wrep.beta, xs_te, y_te)
    phase(f"cfedl §IV size [{card}]: {CFEDL_N} x ({CFEDL_ELL} + "
          f"{CFEDL_ELL_TEST}) x {nq.D_RAW} -> d_feat {CFEDL_D_FEAT}; "
          f"plan+encode {seconds['plan']:.4f} s, {CFEDL_EPOCHS} epochs "
          f"{seconds['run']:.4f} s wall; final NMSE {wrep.final_nmse():.4f} "
          f"at {wrep.times[-1]:.1f} s simulated; held-out accuracy "
          f"{acc:.4f}; launches {counts}")
    check_mec_plan("cfedl §IV size", wstate.plan, fleet, CFEDL_ELL,
                   CFEDL_FIXED_C)
    check(tuple(wstate.x_parity.shape) == (CFEDL_FIXED_C, CFEDL_D_FEAT)
          and tuple(wstate.features.shape)
          == (CFEDL_N, CFEDL_ELL, CFEDL_D_FEAT),
          "cfedl §IV size: encode shapes")
    check_trace(wrep)
    check(counts == expect(round_grad=CFEDL_EPOCHS, encode=CFEDL_N),
          f"unexpected cfedl §IV size launch counts {counts}")
    launches["wide"] = counts
    before = read_counters()
    wref, _ = timed_run(Session(reference_of(wide), fleet, CFEDL_LR,
                                CFEDL_EPOCHS, device=dev), wdata, wstate)
    check(read_counters() == before, "the reference path launched a kernel")
    check_against_reference("cfedl §IV size", wrep, wref)

    for nt in (HIER_TIERS, 1):
        topo = FleetTopology.uniform(CFEDL_N, nt)
        hier = make_strategy("hierarchical", base=wide, topology=topo)
        reset_counters()
        r_h, h_s = timed_run(Session(hier, fleet, CFEDL_LR, CFEDL_EPOCHS,
                                     device=dev), wdata,
                             HierState(wstate, topo))
        counts = read_counters()
        phase(f"cfedl hierarchical T={nt} [{card}]: {CFEDL_EPOCHS} epochs "
              f"{h_s:.4f} s wall; final NMSE {r_h.final_nmse():.4f}; "
              f"launches {counts}")
        check_trace(r_h)
        check(counts == expect(tier_round_grad=CFEDL_EPOCHS),
              f"unexpected cfedl hierarchical launch counts {counts}")
        if nt == HIER_TIERS:
            seconds[f"T={nt}"] = h_s
            launches["hier"] = counts
            before = read_counters()
            h_ref, _ = timed_run(Session(make_strategy(
                "hierarchical", base=reference_of(wide), topology=topo),
                fleet, CFEDL_LR, CFEDL_EPOCHS, device=dev), wdata,
                HierState(wstate, topo))
            check(read_counters() == before,
                  "the reference path launched a kernel")
            check_against_reference(f"cfedl hierarchical T={nt}", r_h,
                                    h_ref)
        else:
            equal = bool(np.array_equal(r_h.nmse, wrep.nmse)
                         and np.array_equal(r_h.times, wrep.times))
            phase(f"cfedl T=1 NMSE trace and clocks bit-equal to the flat "
                  f"run: {equal}")
            check(equal, "T = 1 cfedl trace differs from the flat one")

    # (c) d_feat=None against CFL, same key and c, on phase 4's data
    fleet4, data4 = out["fleet"], out["data"]
    kw = {"key_seed": 1, "fixed_c": out["plan"].c, "use_kernel": True,
          "include_upload_delay": False}
    pair = {}
    for name in ("cfl", "codedfedl"):
        s = make_strategy(name, **kw)
        reset_counters()
        st = s.plan(fleet4, data4)
        r, _ = timed_run(Session(s, fleet4, 0.0085, 600, device=dev), data4,
                         st)
        counts = read_counters()
        check(counts == expect(round_grad=600, encode=data4.n),
              f"unexpected {name} launch counts {counts}")
        pair[name] = (st, r, counts)
    (st_c, r_c, _), (st_f, r_f, counts) = pair["cfl"], pair["codedfedl"]
    launches["identity"] = counts
    same_parity = torch.equal(st_c.x_parity, st_f.x_parity) \
        and torch.equal(st_c.y_parity, st_f.y_parity)
    equal = bool(np.array_equal(r_f.nmse, r_c.nmse)
                 and np.array_equal(r_f.times, r_c.times))
    phase(f"cfedl d_feat=None vs cfl: t* {st_f.plan.t_star!r} / "
          f"{st_c.plan.t_star!r}; parity torch.equal {same_parity}; NMSE "
          f"trace and clocks bit-equal {equal}; setup_time "
          f"{r_f.setup_time!r} / {r_c.setup_time!r}; launches {counts} "
          f"each")
    check(st_f.plan.t_star == st_c.plan.t_star, "d_feat=None t* != CFL's")
    check(same_parity, "d_feat=None parity differs from CFL's")
    check(equal, "d_feat=None trace differs from CFL's")
    check(r_f.setup_time == r_c.setup_time, "d_feat=None setup_time")
    return {"seconds": seconds, "launches": launches}


def same_plan(got, want) -> bool:
    return (np.array_equal(got.loads, want.loads) and got.c == want.c
            and got.t_star == want.t_star
            and np.array_equal(got.p_return, want.p_return)
            and got.expected_agg == want.expected_agg)


def same_report(got, want) -> bool:
    """Trace, clocks, uplink bits and extras bit-equal."""
    return (np.array_equal(got.nmse, want.nmse)
            and np.array_equal(got.times, want.times)
            and np.array_equal(got.epoch_durations, want.epoch_durations)
            and got.uplink_bits_total == want.uplink_bits_total
            and set(got.extras) == set(want.extras)
            and all(np.array_equal(np.asarray(v), np.asarray(want.extras[k]))
                    for k, v in got.extras.items()))


def layout_of(state, m: int) -> tuple:
    """The fused layout the reference's rule gives a CFL plan: the
    support's row count padded to PACK_BLOCK (at least PACK_MIN), dense
    at PACK_DENSE_FRAC of m or more (`core.cfl.packed_row_indices`)."""
    from repro_torch.core.cfl import PACK_BLOCK, PACK_DENSE_FRAC, PACK_MIN
    k = int(np.sum(state.plan.loads))
    padded = max(PACK_MIN, PACK_BLOCK * -(-k // PACK_BLOCK)) if k \
        else PACK_MIN
    return ("dense", m) if padded >= PACK_DENSE_FRAC * m \
        else ("packed", padded)


def sweep_phase(out, dev, card: str, expect, reset_counters,
                read_counters) -> dict:
    """Phase 18a: benchmarks/perf_sweep.py's configuration through
    `plan_sweep` and `run_sweep`, then the 16 solo runs."""
    from repro_torch.api import Session, make_strategy, plan_sweep, run_sweep
    from repro_torch.plan import solve_redundancy_batched
    from repro_torch.sim.network import paper_fleet

    data = out["data"]
    epochs = SWEEP_EPOCHS
    sessions = [
        Session(make_strategy("cfl", key_seed=100 + i, fixed_c=SWEEP_C,
                              include_upload_delay=False, use_kernel=True,
                              label=f"cfl_nu={nu:.3f}"),
                paper_fleet(float(nu), float(nu), seed=0), SWEEP_LR, epochs,
                seed=i, device=dev)
        for i, nu in enumerate(np.linspace(0.0, 0.375, SWEEP_LANES))]
    reset_counters()
    t0 = time.perf_counter()
    states = plan_sweep(sessions, data)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan_counts = read_counters()
    check(plan_counts == expect(encode=SWEEP_LANES * data.n),
          f"unexpected plan_sweep launch counts {plan_counts}")
    for sess, state in zip(sessions, states):
        solo = solve_redundancy_batched(
            [sess.strategy.plan_request(sess.fleet, data)], device=dev)[0]
        check(same_plan(state.plan, solo),
              f"{sess.strategy.label}: batched plan differs from its own")
    layouts = [layout_of(state, data.m) for state in states]

    reset_counters()
    t0 = time.perf_counter()
    reports = run_sweep(sessions, data, states=states)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_counts = read_counters()
    buckets = len({k for sess in sessions for k in sess._engines})

    reset_counters()
    t0 = time.perf_counter()
    solos = [sess.run(data, rng=np.random.default_rng(sess.seed), state=st)
             for sess, st in zip(sessions, states)]
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    solo_counts = read_counters()
    equal = [same_report(rep, solo) for rep, solo in zip(reports, solos)]
    phase(f"sweep [{card}]: {SWEEP_LANES} CodedFL lanes (c={SWEEP_C}, nu "
          f"0..0.375, {epochs} epochs): plan_sweep {plan_s:.4f} s, "
          f"run_sweep {sweep_s:.4f} s, the {SWEEP_LANES} solo runs "
          f"{solo_s:.4f} s; t* {[round(st.plan.t_star, 4) for st in states]}")
    phase(f"sweep: {buckets} buckets (the reference's rule: "
          f"{len(set(layouts))}); kernel-1 shapes per lane "
          f"{[(n_rows, data.d) for _, n_rows in layouts]}; final NMSE "
          f"{[float(f'{r.final_nmse():.3e}') for r in reports]}")
    phase(f"sweep: lanes bit-equal to their solo runs {sum(equal)}/"
          f"{len(equal)}; launches plan_sweep {plan_counts}, run_sweep "
          f"{sweep_counts}, solo {solo_counts}")
    for rep in reports:
        check_trace_len(rep, epochs)
    check(all(equal), "a sweep lane differs from its solo run")
    check(buckets == len(set(layouts)),
          "bucket count differs from the reference's rule")
    check(sweep_counts == expect(round_grad=SWEEP_LANES * epochs),
          f"unexpected run_sweep launch counts {sweep_counts}")
    check(solo_counts == sweep_counts,
          f"unexpected solo launch counts {solo_counts}")
    return {"seconds": {"plan_sweep": plan_s, "run_sweep": sweep_s,
                        "solo runs": solo_s},
            "launches": {"round_grad": sweep_counts["round_grad"]
                         + solo_counts["round_grad"],
                         "encode": plan_counts["encode"]},
            "buckets": buckets}


def check_trace_len(rep, epochs: int) -> None:
    check(rep.nmse.shape == (epochs + 1,)
          and bool(np.all(np.isfinite(rep.nmse)))
          and rep.nmse[-1] < rep.nmse[0],
          f"{rep.label}: NMSE trace not finite, of the wrong shape or not "
          "descending")


def fedserve_phase(out, dev, card: str, expect, reset_counters,
                   read_counters) -> dict:
    """Phase 18b: benchmarks/perf_serve.py's configuration through
    `FedServeEngine.serve(..., states=plan_sweep(...))`, then the
    per-session loop of solo runs."""
    from repro_torch.api import Session, make_strategy, plan_sweep
    from repro_torch.serving import (ConvergenceCriterion, FedServeEngine,
                                     fed_engine, poisson_arrivals)
    from repro_torch.sim.network import paper_fleet

    data = out["data"]
    fleet = paper_fleet(0.2, 0.2, seed=0)
    epochs = SERVE_FL_EPOCHS
    c1, c2 = int(0.28 * data.m), int(0.5 * data.m)
    sessions = []
    for i in range(SERVE_FL_SESSIONS):
        if i % 4 in (0, 1):
            strat = make_strategy("cfl", key_seed=100 + i, fixed_c=c1,
                                  include_upload_delay=False,
                                  use_kernel=True, label=f"cfl_d28_{i}")
        elif i % 4 == 2:
            strat = make_strategy("cfl", key_seed=100 + i, fixed_c=c2,
                                  include_upload_delay=False,
                                  use_kernel=True, label=f"cfl_d50_{i}")
        else:
            strat = make_strategy("uncoded")
        sessions.append(Session(strat, fleet, SWEEP_LR, epochs, seed=i,
                                device=dev))
    arrivals = poisson_arrivals(SERVE_FL_SESSIONS, SERVE_FL_RATE,
                                np.random.default_rng(0))
    reset_counters()
    t0 = time.perf_counter()
    states = plan_sweep(sessions, data)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan_counts = read_counters()
    n_coded = sum(hasattr(st, "plan") for st in states)
    check(plan_counts == expect(encode=n_coded * data.n),
          f"unexpected serve plan_sweep launch counts {plan_counts}")

    reads = []
    real_fired = fed_engine._fired

    def counted(hits):  # the engine's one read-back per group-epoch
        reads.append(len(hits))
        return real_fired(hits)

    fed_engine._fired = counted
    try:
        engine = FedServeEngine(
            data, lane_width=SERVE_FL_WIDTH, chunk=SERVE_FL_CHUNK,
            criterion=ConvergenceCriterion(nmse_target=SERVE_FL_TARGET),
            device=dev)
        reset_counters()
        t0 = time.perf_counter()
        reports = engine.serve(sessions, arrivals=list(arrivals),
                               states=states)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve_counts = read_counters()
    finally:
        fed_engine._fired = real_fired
    exits = [rep.extras["serve_exit_epoch"] for rep in reports]

    reset_counters()
    t0 = time.perf_counter()
    solos = [sess.run(data, rng=np.random.default_rng(sess.seed), state=st)
             for sess, st in zip(sessions, states)]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_counts = read_counters()
    prefix = [bool(np.array_equal(rep.nmse, solo.nmse[:t + 1])
                   and np.array_equal(rep.times, solo.times[:t + 1]))
              for rep, solo, t in zip(reports, solos, exits)]
    served = int(sum(exits))
    phase(f"fedserve [{card}]: {SERVE_FL_SESSIONS} sessions (8 CFL c={c1}, "
          f"4 CFL c={c2}, 4 uncoded; {epochs} epochs; Poisson arrivals at "
          f"{SERVE_FL_RATE}), lane_width {SERVE_FL_WIDTH}, chunk "
          f"{SERVE_FL_CHUNK}, NMSE target {SERVE_FL_TARGET}: plan_sweep "
          f"{plan_s:.4f} s; serve {serve_s:.4f} s, {engine.n_groups} groups, "
          f"{engine.steps} engine steps; exit epochs {exits} (converged "
          f"{sum(r.extras['serve_converged'] for r in reports)})")
    phase(f"fedserve: {served} epochs served in {len(reads)} group-epochs "
          f"(one read-back each, {sum(reads)} lane predicates); "
          f"{SERVE_FL_SESSIONS / serve_s:.2f} sessions/s, "
          f"{served / serve_s:.0f} epochs/s; the per-session loop "
          f"{loop_s:.4f} s: {SERVE_FL_SESSIONS / loop_s:.2f} sessions/s, "
          f"{SERVE_FL_SESSIONS * epochs / loop_s:.0f} epochs/s")
    phase(f"fedserve: served traces prefix-equal to their solo runs "
          f"{sum(prefix)}/{len(prefix)}; launches plan_sweep {plan_counts}, "
          f"serve {serve_counts}, loop {loop_counts}")
    for solo in solos:
        check_trace_len(solo, epochs)
    check(all(prefix), "a served trace is not a prefix of its solo run")
    check(engine.n_groups == 3, f"{engine.n_groups} serve groups, not 3")
    check(serve_counts == expect(round_grad=served),
          f"unexpected serve launch counts {serve_counts}")
    check(loop_counts == expect(round_grad=SERVE_FL_SESSIONS * epochs),
          f"unexpected per-session loop launch counts {loop_counts}")
    return {"seconds": {"plan_sweep": plan_s, "serve": serve_s,
                        "loop": loop_s},
            "launches": {"round_grad": served + loop_counts["round_grad"],
                         "encode": plan_counts["encode"]},
            "read_backs": len(reads)}


def dp_serve_phase(dp, out, dev, card: str, expect, reset_counters,
                   read_counters) -> dict:
    """Phase 18c: phase 15's calibrated StochasticCodedFL in a session of
    800 epochs, served alone: the epsilon budget caps it at 600."""
    from repro_torch.api import Session
    from repro_torch.serving import FedServeEngine, fed_engine

    sess = Session(dp["strategy"], out["fleet"], 0.0085, DP_SERVE_EPOCHS,
                   device=dev)
    reads = []
    real_fired = fed_engine._fired

    def counted(hits):
        reads.append(len(hits))
        return real_fired(hits)

    fed_engine._fired = counted
    try:
        engine = FedServeEngine(out["data"], lane_width=1,
                                chunk=SERVE_FL_CHUNK, device=dev)
        reset_counters()
        t0 = time.perf_counter()
        [rep] = engine.serve([sess], states=[dp["state"]])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = read_counters()
    finally:
        fed_engine._fired = real_fired
    solo = dp["report"]
    t = rep.extras["serve_exit_epoch"]
    prefix = bool(np.array_equal(rep.nmse, solo.nmse[:t + 1])
                  and np.array_equal(rep.times, solo.times[:t + 1]))
    phase(f"dp serve [{card}]: a {DP_SERVE_EPOCHS}-epoch session served "
          f"alone: exit epoch {t}, converged "
          f"{rep.extras['serve_converged']}, {serve_s:.4f} s, "
          f"{len(reads)} read-backs; epsilon_spent "
          f"{rep.extras['epsilon_spent']!r} (phase 15: "
          f"{solo.extras['epsilon_spent']!r}); prefix-equal to phase 15's "
          f"run {prefix}; launches {counts}")
    check(t == 600 and not rep.extras["serve_converged"],
          "the served DP lane did not stop at its 600-round budget")
    check(prefix, "the served DP trace is not phase 15's run")
    check(rep.extras["epsilon_spent"] == solo.extras["epsilon_spent"]
          and np.array_equal(rep.extras["epsilon_schedule"],
                             solo.extras["epsilon_schedule"]),
          "the served DP lane's epsilon differs from phase 15's")
    check(counts == expect(coded_round_grad=600),
          f"unexpected dp serve launch counts {counts}")
    return {"seconds": serve_s, "launches": counts,
            "read_backs": len(reads)}


def ssd_operands(gen, dev, B, nc, Q, H, P, N, G) -> tuple:
    """Synthetic kernel-7 operands, the inputs of `tests/test_kernels.py`
    (da = -0.1 |N(0, 1)|), with B and C per group."""
    xc = torch.randn((B, nc, Q, H, P), generator=gen, device=dev)
    dtc = torch.nn.functional.softplus(
        torch.randn((B, nc, Q, H), generator=gen, device=dev))
    da = -0.1 * torch.randn((B, nc, Q, H), generator=gen, device=dev).abs()
    bc = torch.randn((B, nc, Q, G, N), generator=gen, device=dev)
    cc = torch.randn((B, nc, Q, G, N), generator=gen, device=dev)
    return xc, dtc, da, bc, cc


def per_head(ops) -> tuple:
    """Kernel-7 operands with B and C repeated per head (the reference's
    layout, which the plain version takes)."""
    xc, dtc, da, bc, cc = ops
    rep = xc.shape[3] // bc.shape[3]
    return (xc, dtc, da, bc.repeat_interleave(rep, 3),
            cc.repeat_interleave(rep, 3))


def bound_share(got, exact, bound) -> float:
    """The largest |got - exact| / bound over the elements (an element
    with a zero bound counts 0 if it is exact, else inf)."""
    err = (got.double() - exact).abs()
    share = torch.where(bound > 0, err / bound,
                        torch.where(err > 0, torch.inf, 0.0))
    return float(share.max())


def check_ssd_case(label: str, ops, float64: bool = False) -> float:
    """Kernel 7 against its plain version on `ops`: y and states within
    rtol 1e-4 / atol 1e-4 * max(1, max|ref|) (`tests/test_kernels.py`),
    a bit-identical relaunch, and with `float64` both held against the
    float64 value within the derived rounding bound
    (`kernels.ssd.ref.float64_reference_and_bound`).  Returns the max
    |kernel - plain| over y and states."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    got = ssd_ops.ssd_chunk(*ops)
    again = ssd_ops.ssd_chunk(*ops)
    plain = ssd_ref.ssd_chunk_reference(*per_head(ops))
    torch.cuda.synchronize()
    errs, oks = [], []
    for g, p in zip(got, plain):
        err, ok = allclose_report(g, p, 1e-4,
                                  1e-4 * max(1.0, float(p.abs().max())))
        errs.append(err)
        oks.append(ok)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    shape = list(ops[0].shape) + [ops[3].shape[3], ops[3].shape[4]]
    msg = (f"check ssd_chunk {label} (B, nc, Q, H, P, G, N) = {shape}: "
           f"max_abs_err y {errs[0]:.3e} (|ref| max "
           f"{float(plain[0].abs().max()):.3e}), states {errs[1]:.3e} "
           f"(|ref| max {float(plain[1].abs().max()):.3e}); within rtol "
           f"1e-4 / atol 1e-4*max(1,|ref|max) {oks[0] and oks[1]}; "
           f"bit-identical relaunch {same}")
    if float64:
        y64, s64, yb, sb = ssd_ref.float64_reference_and_bound(*ops)
        worst = {}
        for name, (y_, s_) in (("kernel", got), ("plain", plain)):
            worst[name] = max(bound_share(y_, y64, yb),
                              bound_share(s_, s64, sb))
        msg += (f"; against float64 the worst element at "
                f"{worst['kernel']:.3f} (kernel) and {worst['plain']:.3f} "
                f"(plain) of the derived rounding bound")
        check(worst["kernel"] <= 1.0 and worst["plain"] <= 1.0,
              f"ssd_chunk {label} outside its float64 bound")
    phase(msg)
    check(oks[0] and oks[1], f"ssd_chunk {label} disagrees with plain")
    check(same, f"ssd_chunk {label} not deterministic")
    return max(errs)


def check_ssd_kernel(dev, gen, errs: dict) -> tuple:
    """Phase 3's checks of kernel 7 at synthetic operands, zamba2's shape
    also against the float64 bound; returns the operands of mamba2's and
    of zamba2's serving shapes for the timing phase."""
    cases = {"serving shape": (*SSD_SHAPE[:5], SSD_SHAPE[5], 1),
             "serving shape, per-head B and C": (*SSD_SHAPE, 64),
             "zamba2 serving shape": (*SSD_HYBRID_SHAPE, 1),
             "reduced mamba2": (1, 3, 16, 16, 32, 16, 1),
             "odd Q": (1, 2, 97, 4, 64, 128, 2)}
    out = {}
    for label, (B, nc, Q, H, P, N, G) in cases.items():
        ops = ssd_operands(gen, dev, B, nc, Q, H, P, N, G)
        err = check_ssd_case(label, ops, float64=label.startswith("zamba2"))
        if label == "serving shape":
            errs["ssd_chunk"] = err
        if label == "zamba2 serving shape":
            errs["ssd_chunk_hybrid"] = err
        out[label] = ops
    return out["serving shape"], out["zamba2 serving shape"]


def draw_params(cfg, dev, seed: int, card: str, n_want: int):
    """The full-width parameter tree of `cfg`, drawn on the card from a
    seeded generator; prints its size and checks its parameter count.
    Returns (params, gen) with `gen` ready to draw the prompts."""
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def leaves(tree):
        return [t for v in tree.values()
                for t in (leaves(v) if isinstance(v, dict) else [v])]

    n_params = sum(t.numel() for t in leaves(params))
    phase(f"serve [{card}]: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}: {n_params} float32 parameters "
          f"on the card ({4 * n_params / 1e9:.2f} GB), drawn in "
          f"{init_s:.3f} s")
    check(n_params == n_want, f"{cfg.name} is not at full width")
    return params, gen


def run_engine(cfg, params, prompts, dev, card: str, kernels: dict,
               expect, reset_counters, read_counters,
               slots: int = SERVE_SLOTS, new: int = SERVE_NEW) -> dict:
    """`ServeEngine(n_slots=slots, max_seq=SERVE_MAX_SEQ)` over the
    prompts, `new` new tokens each, with the launch counters set to 0
    just before the run and read just after.  `kernels` maps a counter's
    name to (counter, launches per prefill, printed name): each of them
    exactly that often in every prefill, never in decode, and no other
    kernel.  Prints prefill ms per request, decode ms per engine step and
    tokens/s; returns the run's numbers, "launches" by counter name and
    "prefill_launches" by prompt length and counter name."""
    from repro_torch.serving import Request, ServeEngine

    reqs = [Request(uid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    eng = ServeEngine(cfg, params, n_slots=slots, max_seq=SERVE_MAX_SEQ,
                      device=dev)
    admit, step = eng.try_admit, eng.step
    prefill = {}      # uid -> (ms, {counter name: launches})
    steps = []        # (ms, {counter name: launches}, active slots)
    knames = ", ".join(k for _, _, k in kernels.values())

    def launched(n0):
        return {name: c.launches - n0[name]
                for name, (c, _, _) in kernels.items()}

    def timed_admit(req):
        torch.cuda.synchronize()
        n0 = {name: c.launches for name, (c, _, _) in kernels.items()}
        t0 = time.perf_counter()
        ok = admit(req)
        torch.cuda.synchronize()
        if ok:
            prefill[req.uid] = (1e3 * (time.perf_counter() - t0),
                                launched(n0))
        check(ok or not any(launched(n0).values()),
              f"a refused admission launched {knames}")
        return ok

    def timed_step():
        active = len(eng.active)
        torch.cuda.synchronize()
        n0 = {name: c.launches for name, (c, _, _) in kernels.items()}
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        steps.append((1e3 * (time.perf_counter() - t0), launched(n0),
                      active))
        return out

    eng.try_admit, eng.step = timed_admit, timed_step
    reset_counters()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counters()
    new_tokens = sum(len(r.out_tokens) for r in done)
    decode_s = sum(ms for ms, _, _ in steps) / 1e3
    step_ms = statistics.median(ms for ms, _, _ in steps)
    lengths = [len(p) for p in prompts]
    decode_launches = {name: sum(n[name] for _, n, _ in steps)
                       for name in kernels}
    phase(f"serve [{card}]: {cfg.name} ServeEngine(n_slots={slots}, "
          f"max_seq={SERVE_MAX_SEQ}) ran {len(done)} requests in "
          f"{run_s:.4f} s wall, {len(steps)} engine steps; "
          f"{new_tokens} new tokens, {new_tokens / run_s:.2f} tokens/s over "
          f"the run, {(new_tokens - len(done)) / decode_s:.2f} decoded "
          f"tokens/s over the steps; launches {counts}")
    phase(f"serve [{card}]: {cfg.name} prefill ms per request (prompt "
          f"tokens: ms, {knames} launches) " + ", ".join(
              f"{lengths[u]}: {ms:.3f}, "
              + "/".join(str(n[name]) for name in kernels)
              for u, (ms, n) in sorted(prefill.items())))
    by_slots = {k: [ms for ms, _, a in steps if a == k]
                for k in sorted({a for _, _, a in steps})}
    phase(f"serve [{card}]: {cfg.name} decode ms per engine step median "
          f"{step_ms:.3f}, by active slots " + ", ".join(
              f"{k}: {statistics.median(v):.3f} ({len(v)} steps)"
              for k, v in by_slots.items()) +
          f"; {knames} launches in decode {decode_launches}")
    check(sorted(r.uid for r in done) == list(range(len(prompts))),
          "the engine did not finish every request")
    check(all(len(r.out_tokens) == new for r in done),
          "a request finished with the wrong number of tokens")
    want = {name: per * len(prompts)
            for name, (_, per, _) in kernels.items()}
    check(counts == expect(**want),
          f"unexpected serve launch counts {counts}")
    for name, (_, per, kname) in kernels.items():
        check(sorted(n[name] for _, n in prefill.values()) ==
              [per] * len(prompts),
              f"a prefill did not launch {kname} {per} times")
    check(not any(decode_launches.values()), f"decode launched {knames}")
    return {"done": done, "launches": {name: counts[name]
                                       for name in kernels},
            "run_s": run_s, "tokens_per_s": new_tokens / run_s,
            "step_ms": step_ms,
            "prefill_ms": {lengths[u]: ms for u, (ms, _) in prefill.items()},
            "prefill_launches": {
                n: {name: sum(c[name] for u, (_, c) in prefill.items()
                              if lengths[u] == n) for name in kernels}
                for n in set(lengths)}}


def check_against_greedy(cfg, params, done, dev, card: str,
                         new: int = SERVE_NEW) -> None:
    """Each request's engine tokens against `greedy_generate` on its
    prompt alone."""
    from repro_torch.launch.serve import greedy_generate

    greedy_ms = []
    for r in sorted(done, key=lambda r: r.uid):
        out, t_pre, st = greedy_generate(
            cfg, params, torch.as_tensor(r.prompt, device=dev)[None],
            new, {}, device=dev)
        gen_toks = out[0, len(r.prompt):].tolist()
        greedy_ms.append((len(r.prompt), 1e3 * t_pre,
                          1e3 * statistics.median(st)))
        check(bool(((out >= 0) & (out < cfg.vocab)).all()),
              "a token outside the vocabulary")
        check(gen_toks == r.out_tokens,
              f"request {r.uid}: engine tokens differ from greedy_generate")
    phase(f"serve [{card}]: {cfg.name} engine tokens equal "
          f"greedy_generate's for all {len(done)} requests; greedy_generate "
          f"prefill ms / median decode ms per token (batch 1) " + ", ".join(
              f"{n}: {p:.3f} / {d:.3f}" for n, p, d in greedy_ms))


def check_kernel_prefill(cfg, params, toks, card: str, kname: str,
                         rtol: float, extra: dict | None = None) -> float:
    """The prefill of `toks` (with the stub inputs `extra`) with the
    kernel against the plain one: max |logit difference| within rtol *
    max(1, max|logit|), stated before the run, and the same greedy
    token.  Returns the difference."""
    from repro_torch.models import transformer as T

    batch = {"tokens": toks, **(extra or {})}
    t0 = time.perf_counter()
    lk, _ = T.prefill(cfg, params, batch)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lp, _ = T.prefill(cfg, params, batch, use_kernel=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    diff = float((lk - lp).abs().max())
    bound = rtol * max(1.0, float(lp.abs().max()))
    same_tok = int(lk[0, -1].argmax()) == int(lp[0, -1].argmax())
    phase(f"serve [{card}]: {cfg.name} {toks.shape[1]}-token prefill with "
          f"{kname} {1e3 * kernel_s:.3f} ms, plain {1e3 * plain_s:.3f} ms; "
          f"max |logit difference| {diff:.3e} (max|logit| "
          f"{float(lp.abs().max()):.3f}; bound stated in advance "
          f"{rtol} * max(1, max|logit|) = {bound:.3e}); greedy token "
          f"equal {same_tok}")
    check(bool(torch.isfinite(lk).all()) and tuple(lk.shape) ==
          (1, 1, cfg.vocab), "kernel prefill logits not finite or shape")
    check(diff <= bound, "kernel prefill outside its bound of plain")
    check(same_tok, "kernel and plain prefill choose different tokens")
    return diff


def serve_phase(dev, card: str, expect, reset_counters,
                read_counters) -> dict:
    """Phase 11: mamba2-1.3b at full width through `ServeEngine`, kernel 7
    on every prefill; kernel 7 at the model's own operands; the engine's
    tokens against `greedy_generate`; the kernel prefill against the
    plain one."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import transformer as T

    cfg = get_config(SERVE_ARCH)
    s = cfg.ssm
    check(cfg.n_layers == 48 and cfg.d_model == 2048 and cfg.vocab == 50280,
          "mamba2-1.3b is not at full width")
    phase(f"serve [{card}]: {cfg.name}: {s.n_heads(cfg.d_model)} heads of "
          f"{s.headdim}, d_state {s.d_state}, chunk {s.chunk}")
    params, gen = draw_params(cfg, dev, SERVE_SEED, card, SERVE_PARAMS)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                             device=dev).cpu().numpy()
               for n in SERVE_PROMPTS]

    # kernel 7 at the model's own operands: layer 0 of the longest prompt
    captured, real = [], ssd_ops.ssd_chunk

    def capture(*ops):
        captured.append(ops)
        return real(*ops)

    ssd_ops.ssd_chunk = capture
    try:
        T.prefill(cfg, params, {"tokens": torch.as_tensor(
            prompts[-1], device=dev)[None]})
    finally:
        ssd_ops.ssd_chunk = real
    model_ops = captured[0]  # layer 0's
    del captured
    cum = torch.cumsum(model_ops[2].double(), dim=2)
    phase(f"serve: layer 0's decay logs of the {SERVE_PROMPTS[-1]}-token "
          f"prompt reach |cum| {float(cum.abs().max()):.1f} within a chunk "
          f"(dt max {float(model_ops[1].max()):.3f})")
    model_err = check_ssd_case("at the model's own operands", model_ops,
                               float64=True)
    del model_ops, cum

    run = run_engine(cfg, params, prompts, dev, card,
                     {"ssd_chunk": (ssd_ops.SSD_COUNTER, cfg.n_layers,
                                    "kernel-7")},
                     expect, reset_counters, read_counters)
    check_against_greedy(cfg, params, run["done"], dev, card)
    diff = check_kernel_prefill(
        cfg, params, torch.as_tensor(prompts[-1], device=dev)[None], card,
        "kernel 7", LOGIT_RTOL)
    return {"launches": run["launches"]["ssd_chunk"], "model_err": model_err,
            "run_s": run["run_s"], "tokens_per_s": run["tokens_per_s"],
            "step_ms": run["step_ms"], "logit_diff": diff}


def dense_serve_phase(dev, card: str, expect, reset_counters,
                      read_counters) -> dict:
    """Phase 12: granite-8b at full width through `ServeEngine`, kernel 8
    on every prefill layer's attention core; the engine's tokens against
    `greedy_generate`; the kernel prefill against the plain one."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import ops as fa_ops

    cfg = get_config(DENSE_ARCH)
    check(cfg.n_layers == 36 and cfg.d_model == 4096 and cfg.n_heads == 32
          and cfg.n_kv_heads == 8 and cfg.d_ff == 14336 and
          cfg.vocab == 49152, "granite-8b is not at full width")
    phase(f"serve [{card}]: {cfg.name}: {cfg.n_heads} heads and "
          f"{cfg.n_kv_heads} key/value heads of {cfg.hd}, d_ff {cfg.d_ff}, "
          f"rope theta {cfg.rope_theta}")
    params, gen = draw_params(cfg, dev, SERVE_SEED, card, DENSE_PARAMS)
    # the floors the serve times stand against: a decode step reads every
    # weight once; a prefill of S tokens multiplies S rows through every
    # layer's projections and MLP, the head once, plus the causal
    # attention products
    S, d = SERVE_PROMPTS[-1], cfg.d_model
    layer_w = (2 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
               + 3 * d * cfg.d_ff)
    prefill_flops = (2 * S * cfg.n_layers * layer_w + 2 * d * cfg.vocab
                     + cfg.n_layers * 4 * cfg.n_heads * cfg.hd
                     * S * (S + 1) // 2)
    phase(f"serve [{card}]: {cfg.name} floors: reading the "
          f"{4 * DENSE_PARAMS / 1e9:.2f} GB of weights takes "
          f"{1e3 * 4 * DENSE_PARAMS / HBM_BYTES_PER_S:.3f} ms a decode step; "
          f"a {S}-token prefill is {prefill_flops / 1e12:.3f} TFLOP of "
          f"float32 products, {1e3 * prefill_flops / FP32_FLOPS_PER_S:.1f} "
          f"ms at 67 TFLOP/s")
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                             device=dev).cpu().numpy()
               for n in SERVE_PROMPTS]
    run = run_engine(cfg, params, prompts, dev, card,
                     {"causal_attention": (fa_ops.FLASH_COUNTER, cfg.n_layers,
                                           "kernel-8")},
                     expect, reset_counters, read_counters)
    check_against_greedy(cfg, params, run["done"], dev, card)
    toks = torch.as_tensor(prompts[-1], device=dev)[None]
    diff = check_kernel_prefill(cfg, params, toks, card, "kernel 8",
                                DENSE_LOGIT_RTOL)
    phase(f"serve [{card}]: {cfg.name} peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    optimized = dense_optimized_prefills(cfg, params, toks, card, expect,
                                         reset_counters, read_counters)
    return {"launches": run["launches"]["causal_attention"],
            "run_s": run["run_s"], "tokens_per_s": run["tokens_per_s"],
            "step_ms": run["step_ms"], "logit_diff": diff,
            "optimized": optimized}


def counted_prefill(cfg, params, batch, reset_counters, read_counters):
    """`transformer.prefill` with the launch counters set to 0 just
    before and read just after; returns (logits, counts, ms)."""
    from repro_torch.models import transformer as T

    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    logits, _ = T.prefill(cfg, params, batch)
    torch.cuda.synchronize()
    return logits, read_counters(), 1e3 * (time.perf_counter() - t0)


def dense_optimized_prefills(cfg, params, toks, card, expect,
                             reset_counters, read_counters) -> dict:
    """Phase 25 (b), granite-8b: the 2048-token prefill with
    `attn_impl="repeat"` at a float32 softmax, and under
    `optimize_config(cfg, "prefill")` (repeat and a bf16 softmax, which
    the prefill's causal self-attention does not read, as the
    reference's), each launching kernel 8 in every layer and
    `torch.equal` to the grouped kernel prefill; the full-sequence
    forward under `optimize_config(cfg, "train")`, whose bf16 softmax
    takes the plain expression (no launch), its last position within
    BF16_LOGIT_RTOL of the float32 prefill, greedy tokens printed.
    Returns the kernel-8 launches."""
    from repro_torch.launch.dryrun import optimize_config
    from repro_torch.models import transformer as T

    batch = {"tokens": toks}
    base, _ = T.prefill(cfg, params, batch)
    launches = 0
    for label, run_cfg in (
            ("attn_impl=repeat, float32 softmax",
             dataclasses.replace(cfg, attn_impl="repeat")),
            ("optimize_config(prefill): repeat, bf16 softmax",
             optimize_config(cfg, "prefill"))):
        logits, counts, ms = counted_prefill(run_cfg, params, batch,
                                             reset_counters, read_counters)
        equal = torch.equal(logits, base)
        phase(f"optimized [{card}]: {cfg.name} {toks.shape[1]}-token "
              f"prefill, {label}: {ms:.3f} ms, launches {counts}, logits "
              f"torch.equal to the grouped kernel prefill {equal}")
        check(counts == expect(causal_attention=cfg.n_layers),
              f"{label}: unexpected launch counts {counts}")
        check(equal, f"{label}: prefill logits differ from the grouped one")
        launches += counts["causal_attention"]
    opt = optimize_config(cfg, "train")
    check(opt.softmax_dtype == "bf16" and opt.attn_impl == "repeat",
          "optimize_config(train) sets no bf16 softmax")
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = T.forward_train(opt, params, batch, use_kernel=True)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counters()
    last = logits[:, -1:]
    diff = float((last - base).abs().max())
    bound = BF16_LOGIT_RTOL * max(1.0, float(base.abs().max()))
    tok, tok32 = int(last[0, -1].argmax()), int(base[0, -1].argmax())
    phase(f"optimized [{card}]: {cfg.name} {toks.shape[1]}-token forward "
          f"under optimize_config(train) (repeat, bf16 softmax, plain "
          f"expression): {ms:.3f} ms, launches {counts}; last position vs "
          f"the float32 kernel prefill max |logit difference| {diff:.3e} "
          f"(max|logit| {float(base.abs().max()):.3f}; bound stated in "
          f"advance {BF16_LOGIT_RTOL} * max(1, max|logit|) = {bound:.3e}); "
          f"greedy token {tok} (float32 prefill {tok32})")
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) ==
          (1, toks.shape[1], cfg.vocab), "bf16 forward logits")
    check(counts == expect(), f"the bf16 softmax launched {counts}")
    check(diff <= bound, "bf16-softmax forward outside its bound")
    del logits, last
    return {"launches": launches, "bf16_diff": diff, "bf16_ms": ms}


def free_card() -> None:
    """Return the memory of the tensors just dropped to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def meta_params(cfg) -> tuple:
    """(the full-width tree of `cfg` on the meta device, its parameter
    count): shapes only, nothing drawn."""
    from repro_torch import tree
    from repro_torch.models import transformer as T

    params = T.init_params(cfg, None, device="meta")
    return params, sum(t.numel() for t in tree.leaves(params))


def cut_depth(cfg, n_layers: int):
    """`cfg` at full width with its first `n_layers` layers, named so
    that every line printed of it states the cut."""
    return dataclasses.replace(
        cfg, n_layers=n_layers,
        name=f"{cfg.name} (cut to {n_layers} of {cfg.n_layers} layers)")


def draw_prompts(gen, dev, vocab: int, lengths) -> list:
    return [torch.randint(0, vocab, (n,), generator=gen,
                          device=dev).cpu().numpy() for n in lengths]


def hybrid_serve_phase(dev, card: str, expect, reset_counters,
                       read_counters) -> dict:
    """Phase 21: zamba2-1.2b at full width and depth through
    `ServeEngine`, kernel 7 in each Mamba2 layer and kernel 8 in each use
    of the shared block of every prefill; the engine's tokens against
    `greedy_generate`; the kernel prefill against the plain one."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    cfg = get_config(HYBRID_ARCH)
    s, ae = cfg.ssm, cfg.hybrid.attn_every
    check(cfg.n_layers == 38 and cfg.d_model == 2048 and ae == 6
          and s.d_state == 64 and cfg.n_heads == cfg.n_kv_heads == 32
          and cfg.vocab == 32000, "zamba2-1.2b is not at full width")
    uses = cfg.n_layers // ae
    phase(f"serve [{card}]: {cfg.name}: {cfg.n_layers} Mamba2 layers "
          f"({s.n_heads(cfg.d_model)} heads of {s.headdim}, d_state "
          f"{s.d_state}, chunk {s.chunk}) and one shared block "
          f"({cfg.n_heads} heads and {cfg.n_kv_heads} key/value heads of "
          f"{cfg.hd}, d_ff {cfg.d_ff}) after every {ae}th layer: {uses} uses")
    torch.cuda.reset_peak_memory_stats()
    params, gen = draw_params(cfg, dev, SERVE_SEED, card, HYBRID_PARAMS)
    prompts = draw_prompts(gen, dev, cfg.vocab, SERVE_PROMPTS)
    run = run_engine(
        cfg, params, prompts, dev, card,
        {"ssd_chunk": (ssd_ops.SSD_COUNTER, cfg.n_layers, "kernel-7"),
         "causal_attention": (fa_ops.FLASH_COUNTER, uses, "kernel-8")},
        expect, reset_counters, read_counters)
    check_against_greedy(cfg, params, run["done"], dev, card)
    toks = torch.as_tensor(prompts[-1], device=dev)[None]
    diff = check_kernel_prefill(cfg, params, toks, card, "kernels 7 and 8",
                                HYBRID_LOGIT_RTOL)
    optimized = hybrid_optimized_prefill(cfg, params, toks, uses, card,
                                         expect, reset_counters,
                                         read_counters)
    peak = torch.cuda.max_memory_allocated()
    phase(f"serve [{card}]: {cfg.name} prefill ms of the "
          f"{SERVE_PROMPTS[-1]}-token prompt in the engine "
          f"{run['prefill_ms'][SERVE_PROMPTS[-1]]:.3f}, decode step median "
          f"{run['step_ms']:.3f} ms, {run['tokens_per_s']:.2f} tokens/s over "
          f"the run; peak device memory {peak / 2**30:.3f} GiB")
    return {"launches": run["launches"], "run_s": run["run_s"],
            "tokens_per_s": run["tokens_per_s"], "step_ms": run["step_ms"],
            "prefill_ms": run["prefill_ms"], "logit_diff": diff,
            "peak_bytes": peak, "optimized": optimized}


def hybrid_optimized_prefill(cfg, params, toks, uses: int, card: str,
                             expect, reset_counters, read_counters) -> dict:
    """Phase 25 (b), zamba2-1.2b: the 2048-token prefill under
    `optimize_config(cfg, "prefill")` (`ssm.head_shard`, a mesh hint):
    kernels 7 and 8 as in phase 21 and logits `torch.equal` to its
    kernel prefill.  Returns the launches by counter."""
    from repro_torch.launch.dryrun import optimize_config
    from repro_torch.models import transformer as T

    batch = {"tokens": toks}
    base, _ = T.prefill(cfg, params, batch)
    opt = optimize_config(cfg, "prefill")
    check(opt.ssm.head_shard, "optimize_config(prefill) sets no head_shard")
    logits, counts, ms = counted_prefill(opt, params, batch, reset_counters,
                                         read_counters)
    equal = torch.equal(logits, base)
    phase(f"optimized [{card}]: {cfg.name} {toks.shape[1]}-token prefill "
          f"under optimize_config(prefill) (head_shard): {ms:.3f} ms, "
          f"launches {counts}, logits torch.equal to phase 21's {equal}")
    check(counts == expect(ssd_chunk=cfg.n_layers, causal_attention=uses),
          f"head_shard prefill: unexpected launch counts {counts}")
    check(equal, "head_shard prefill logits differ")
    return {k: counts[k] for k in ("ssd_chunk", "causal_attention")}


def dense_configs_phase(dev, card: str, expect, reset_counters,
                        read_counters) -> dict:
    """Phase 22: codeqwen1.5-7b and minitron-4b at full width and depth
    through `ServeEngine`, then mistral-large-123b at full width on the
    meta device and cut in depth on the card; each config's parameters
    freed before the next.  Returns each run's numbers and kernel 8's
    launches over the phase's counted runs (the engine's, the kernel
    prefills held against the plain ones, mistral's generation), in all
    and by (B, Hq, Hkv, S, D)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.launch.serve import greedy_generate

    out, by_shape = {}, {}

    def counted(cfg, seq, n):
        shape = (1, cfg.n_heads, cfg.n_kv_heads, seq, cfg.hd)
        by_shape[shape] = by_shape.get(shape, 0) + n

    for arch, n_want in DENSE_CONFIGS.items():
        cfg = get_config(arch)
        phase(f"serve [{card}]: {cfg.name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads and {cfg.n_kv_heads} "
              f"key/value heads of {cfg.hd}, q/k/v biases {cfg.attn_bias}, "
              f"d_ff {cfg.d_ff}, rope theta {cfg.rope_theta}")
        torch.cuda.reset_peak_memory_stats()
        params, gen = draw_params(cfg, dev, SERVE_SEED, card, n_want)
        prompts = draw_prompts(gen, dev, cfg.vocab, DENSE_PROMPTS)
        run = run_engine(
            cfg, params, prompts, dev, card,
            {"causal_attention": (fa_ops.FLASH_COUNTER, cfg.n_layers,
                                  "kernel-8")},
            expect, reset_counters, read_counters, slots=DENSE_SLOTS,
            new=DENSE_NEW)
        for seq, n in run["prefill_launches"].items():
            counted(cfg, seq, n["causal_attention"])
        check_against_greedy(cfg, params, run["done"], dev, card,
                             new=DENSE_NEW)
        reset_counters()
        diff = check_kernel_prefill(
            cfg, params, torch.as_tensor(prompts[-1], device=dev)[None],
            card, "kernel 8", DENSE_LOGIT_RTOL)
        counts = read_counters()
        check(counts == expect(causal_attention=cfg.n_layers),
              f"the {cfg.name} kernel prefill launched {counts}")
        counted(cfg, len(prompts[-1]), counts["causal_attention"])
        peak = torch.cuda.max_memory_allocated()
        phase(f"serve [{card}]: {cfg.name} peak device memory "
              f"{peak / 2**30:.3f} GiB")
        out[arch] = {"run_s": run["run_s"], "step_ms": run["step_ms"],
                     "tokens_per_s": run["tokens_per_s"],
                     "prefill_ms": run["prefill_ms"], "logit_diff": diff,
                     "peak_bytes": peak}
        del params, run
        free_card()

    cfg = get_config(MISTRAL_ARCH)
    meta, n = meta_params(cfg)
    check(n == MISTRAL_PARAMS and tuple(meta["blocks"]["attn"]["wq"].shape)
          == (88, 12288, 12288) and tuple(meta["lm_head"].shape) ==
          (12288, 32768), "mistral-large-123b's full-width tree differs")
    total = torch.cuda.get_device_properties(dev).total_memory
    cut = cut_depth(cfg, MISTRAL_LAYERS)
    phase(f"serve [{card}]: {cfg.name} at full width on the meta device: "
          f"{n} parameters ({4 * n / 2**30:.1f} GiB at float32, over the "
          f"card's {total / 2**30:.1f} GiB), the tree of JAX's eval_shape "
          f"(tests/test_torch_lm_serve.py); on the card {cut.name}, "
          f"{cfg.n_heads} heads and {cfg.n_kv_heads} key/value heads of "
          f"{cfg.hd}")
    del meta
    torch.cuda.reset_peak_memory_stats()
    params, gen = draw_params(cut, dev, SERVE_SEED, card, MISTRAL_CUT_PARAMS)
    toks = torch.randint(0, cut.vocab, (1, SERVE_PROMPTS[-1]), generator=gen,
                         device=dev)
    reset_counters()
    diff = check_kernel_prefill(cut, params, toks, card, "kernel 8",
                                DENSE_LOGIT_RTOL)
    counts = read_counters()
    check(counts == expect(causal_attention=MISTRAL_LAYERS),
          "the cut mistral prefill did not launch kernel 8 once a layer")
    counted(cut, toks.shape[1], counts["causal_attention"])
    reset_counters()
    gen_toks, t_pre, st = greedy_generate(cut, params, toks, DENSE_NEW, {},
                                          device=dev)
    counts = read_counters()
    check(counts == expect(causal_attention=MISTRAL_LAYERS),
          f"the cut mistral generation launched {counts}")
    counted(cut, toks.shape[1], counts["causal_attention"])
    new = gen_toks[0, toks.shape[1]:]
    check(bool(((new >= 0) & (new < cut.vocab)).all()),
          "a token outside the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    phase(f"serve [{card}]: {cut.name} greedy {DENSE_NEW} tokens after "
          f"the {toks.shape[1]}-token prompt: {new.tolist()}; prefill "
          f"{1e3 * t_pre:.3f} ms, decode median "
          f"{1e3 * statistics.median(st):.3f} ms a token; peak device "
          f"memory {peak / 2**30:.3f} GiB")
    out[MISTRAL_ARCH] = {"logit_diff": diff, "prefill_s": t_pre,
                         "step_ms": 1e3 * statistics.median(st),
                         "peak_bytes": peak}
    del params
    free_card()
    phase(f"serve [{card}]: kernel 8's launches in phase 22's counted runs "
          f"by (B, Hq, Hkv, S, D): {by_shape}")
    return {"configs": out, "launches": sum(by_shape.values()),
            "by_shape": by_shape}


def moe_serve_phase(dev, card: str, expect, reset_counters,
                    read_counters) -> dict:
    """Phase 23: phi3.5-moe at full width cut in depth through
    `ServeEngine`, kernel 8 in every layer of every prefill and the MoE
    FFN as the plain one-hot expression; each layer's dropped share of
    the longest prompt's prefill; llama4-maverick on the meta device."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    cfg = get_config(MOE_ARCH)
    m = cfg.moe
    meta, n = meta_params(cfg)
    check(n == MOE_PARAMS and tuple(meta["moe_blocks"]["moe"]["w_up"].shape)
          == (32, 16, 4096, 6400), "phi3.5-moe's full-width tree differs")
    del meta
    cut = cut_depth(cfg, MOE_LAYERS)
    total = torch.cuda.get_device_properties(dev).total_memory
    phase(f"serve [{card}]: {cfg.name}: {n} parameters at full width "
          f"({4 * n / 2**30:.1f} GiB at float32, over the card's "
          f"{total / 2**30:.1f} GiB); on the card {cut.name}: "
          f"{m.n_experts} experts top-{m.top_k} of d_ff {cfg.d_ff}, group "
          f"{m.group_size}, capacity factor {m.capacity_factor} (decode: "
          f"{float(m.n_experts)}, which drops nothing)")
    torch.cuda.reset_peak_memory_stats()
    params, gen = draw_params(cut, dev, SERVE_SEED, card, MOE_CUT_PARAMS)
    prompts = draw_prompts(gen, dev, cut.vocab, MOE_PROMPTS)
    run = run_engine(
        cut, params, prompts, dev, card,
        {"causal_attention": (fa_ops.FLASH_COUNTER, MOE_LAYERS, "kernel-8")},
        expect, reset_counters, read_counters, new=MOE_NEW)
    check_against_greedy(cut, params, run["done"], dev, card, new=MOE_NEW)
    toks = torch.as_tensor(prompts[-1], device=dev)[None]
    dropped, real = [], M.moe_ffn

    def capture(p, x, dims):
        y, aux = real(p, x, dims)
        dropped.append((float(aux["dropped_frac"]), dims.capacity(
            M.group_size(dims, x.shape[0] * x.shape[1]))))
        return y, aux

    M.moe_ffn = capture
    try:
        T.prefill(cut, params, {"tokens": toks})
    finally:
        M.moe_ffn = real
    phase(f"serve [{card}]: {cut.name} dropped share of (token, choice) "
          f"pairs by layer in the {toks.shape[1]}-token prefill (capacity "
          f"{dropped[0][1]}): {[d for d, _ in dropped]}")
    check(len(dropped) == MOE_LAYERS and all(0.0 <= d < 1.0 for d, _ in
                                             dropped),
          "a MoE layer's dropped share is out of range")
    diff = check_kernel_prefill(cut, params, toks, card, "kernel 8",
                                DENSE_LOGIT_RTOL)
    peak = torch.cuda.max_memory_allocated()
    phase(f"serve [{card}]: {cut.name} peak device memory "
          f"{peak / 2**30:.3f} GiB")
    del params
    free_card()

    mcfg = get_config(MAVERICK_ARCH)
    meta, n = meta_params(mcfg)
    check(n == MAVERICK_PARAMS, "llama4-maverick's full-width tree differs")
    one_each = sum(t.numel() // (t.shape[0] if k.startswith(
        ("blocks/", "moe_blocks/")) else 1)
        for k, t in tree.flatten_with_path(meta))
    check(one_each == MAVERICK_MIN_PARAMS,
          f"llama4-maverick: {one_each} parameters in one layer of each "
          "kind and the embeddings")
    phase(f"serve [{card}]: {mcfg.name} at full width on the meta device: "
          f"{n} parameters; one MoE layer ({mcfg.moe.n_experts} experts), "
          f"one dense layer and the embeddings alone hold {one_each} "
          f"({4 * one_each / 2**30:.1f} GiB at float32 of the card's "
          f"{total / 2**30:.1f} GiB): no depth of it is served on the card")
    return {"launches": run["launches"]["causal_attention"],
            "run_s": run["run_s"], "tokens_per_s": run["tokens_per_s"],
            "step_ms": run["step_ms"], "prefill_ms": run["prefill_ms"],
            "logit_diff": diff, "dropped": [d for d, _ in dropped],
            "peak_bytes": peak}


def modal_serve(cfg, n_want: int, prompt: int, new: int, dev, card: str,
                expect, reset_counters, read_counters) -> dict:
    """Phase 24's serve run of one vlm or audio config at full width and
    depth: the parameters drawn on the card with every gate from 0.5 +
    U(0, 1), one `prompt`-token prompt and its stub patches or frames
    (0.1 * N(0, 1), as `launch.serve` draws them); the kernel prefill
    against the plain one (kernel 8 once per causal decoder
    self-attention, counted from 0), the logits moved by other stubs,
    and `greedy_generate` of `new` tokens (the same launches: none in
    decode).  Frees the parameters; returns the run's numbers."""
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.launch.train import add_modality_stubs
    from repro_torch.models import transformer as T

    torch.cuda.reset_peak_memory_stats()
    params, gen = draw_params(cfg, dev, SERVE_SEED, card, n_want)
    gates = params["cross_blocks"]["gate"]
    gates.copy_(0.5 + torch.rand(gates.shape, generator=gen, device=dev))
    toks = torch.randint(0, cfg.vocab, (1, prompt), generator=gen,
                         device=dev)
    extra = add_modality_stubs({"tokens": toks}, cfg, gen)
    del extra["tokens"]
    (key, stub), = extra.items()
    n_self = T._n_attn(cfg)
    phase(f"serve [{card}]: {cfg.name}: {n_self} causal self-attention "
          f"layers in the decoder, {gates.shape[0]} cross blocks over "
          f"{key} {list(stub.shape)}, gates "
          f"{[round(g, 4) for g in gates.flatten().tolist()]}"
          + (f", {cfg.encdec.n_enc_layers} unmasked encoder layers"
             if cfg.encdec else ""))
    reset_counters()
    diff = check_kernel_prefill(cfg, params, toks, card, "kernel 8",
                                MODAL_LOGIT_RTOL, extra)
    counts = read_counters()
    check(counts == expect(causal_attention=n_self),
          f"{cfg.name}'s kernel prefill launched {counts}")
    base, _ = T.prefill(cfg, params, {"tokens": toks, **extra})
    other, _ = T.prefill(cfg, params, {"tokens": toks, key: -stub})
    moved = float((base - other).abs().max())
    check(moved > 0.0, f"{cfg.name}: the {key} do not reach the logits")
    reset_counters()
    out, t_pre, st = greedy_generate(cfg, params, toks, new, extra,
                                     device=dev)
    counts = read_counters()
    check(counts == expect(causal_attention=n_self),
          f"{cfg.name}'s generation launched {counts} (decode must launch "
          "nothing)")
    gen_toks = out[0, prompt:]
    check(tuple(out.shape) == (1, prompt + new) and bool(
        ((gen_toks >= 0) & (gen_toks < cfg.vocab)).all()),
        "a generated token outside the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    step_ms = 1e3 * statistics.median(st)
    phase(f"serve [{card}]: {cfg.name} {n_self} kernel-8 launches in the "
          f"{prompt}-token prefill, 0 in {new} decode steps; other {key} "
          f"move the logits by {moved:.3e}; greedy tokens "
          f"{gen_toks.tolist()}; prefill {1e3 * t_pre:.3f} ms, decode "
          f"median {step_ms:.3f} ms a token; peak device memory "
          f"{peak / 2**30:.3f} GiB")
    del params, out
    free_card()
    return {"launches": 2 * n_self, "logit_diff": diff, "moved": moved,
            "prefill_ms": 1e3 * t_pre, "step_ms": step_ms,
            "peak_bytes": peak}


def modal_phase(dev, card: str, expect, reset_counters,
                read_counters) -> dict:
    """Phase 24: the vlm and audio families served at full width and
    depth (`modal_serve`), then trained through `launch.train` on stub
    inputs drawn per step: whisper-tiny at full width and depth,
    llama-3.2-vision-11b at full width cut to one group.  Returns each
    run's numbers and kernel 8's launches over the phase."""
    from repro_torch.configs import get_config, register

    out = {}
    vlm, audio = get_config(VLM_ARCH), get_config(AUDIO_ARCH)
    n_groups = vlm.n_layers // vlm.vlm.cross_every
    check(vlm.n_layers == 40 and vlm.d_model == 4096 and n_groups == 8
          and vlm.vlm.n_patches == 1601 and vlm.vlm.d_vision == 4096
          and vlm.vocab == 128256, "llama-3.2-vision-11b is not at full "
          "width")
    check(audio.n_layers == audio.encdec.n_enc_layers == 4 and
          audio.d_model == 384 and audio.encdec.n_frames == 1500 and
          AUDIO_PROMPT + AUDIO_NEW == audio.encdec.max_decode_len,
          "whisper-tiny is not at full width")
    out[VLM_ARCH] = modal_serve(vlm, VLM_PARAMS, VLM_PROMPT, VLM_NEW, dev,
                                card, expect, reset_counters, read_counters)
    out[AUDIO_ARCH] = modal_serve(audio, AUDIO_PARAMS, AUDIO_PROMPT,
                                  AUDIO_NEW, dev, card, expect,
                                  reset_counters, read_counters)
    check(out[VLM_ARCH]["launches"] == 2 * 32 and
          out[AUDIO_ARCH]["launches"] == 2 * 4,
          "unexpected kernel-8 launches per prefill")

    cut = register(cut_depth(vlm, VLM_TRAIN_LAYERS))
    for cfg, seq in ((audio, audio.encdec.max_decode_len), (cut, 256)):
        res = run_training(["--arch", cfg.name, "--steps",
                            str(MODAL_TRAIN_STEPS), "--seq", str(seq),
                            "--log-every", "4"],
                           dev, card, expect, reset_counters, read_counters)
        losses = res["losses"]
        first, last = np.mean(losses[:3]), np.mean(losses[-3:])
        phase(f"train [{card}]: {cfg.name} mean loss of the first 3 steps "
              f"{first:.4f}, of the last 3 {last:.4f}")
        check(last < first, f"{cfg.name}'s loss did not go down")
        out[f"train {cfg.name}"] = {
            k: res[k] for k in ("wall_s", "step_s", "tokens_per_s",
                                "peak_bytes", "n_params")}
        out[f"train {cfg.name}"].update(first=first, last=last)
        del res
        free_card()
    return {"configs": out, "launches": sum(
        out[a]["launches"] for a in (VLM_ARCH, AUDIO_ARCH))}


def dryrun_phase(card: str) -> dict:
    """Phase 25 (a): `python -m repro_torch.launch.dryrun --all
    --both-meshes`, plain and `--optimized`, the two processes started
    together (each lays its 39 combinations out on a fake world of 256
    and one of 512 ranks, meta tensors only); 78 runs ok in each, the one
    skip, whisper-tiny's train_4k argument bytes on 16 x 16 equal to
    XLA's (430,750,252, `tests/test_torch_launch.py`); per-device
    argument GiB of every run and each process's wall time printed."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    atexit.register(shutil.rmtree, out_dir, True)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    procs = {}
    for label, extra in (("plain", []), ("optimized", ["--optimized"])):
        out = os.path.join(out_dir, f"{label}.json")
        log = open(os.path.join(out_dir, f"{label}.log"), "w")
        procs[label] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--both-meshes", "--out", out] + extra, cwd=root, env=env,
            stdout=log, stderr=subprocess.STDOUT), time.perf_counter(), out,
            log)
    results, walls = {}, {}
    for label, (proc, t0, out, log) in procs.items():
        rc = proc.wait(timeout=600)
        walls[label] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            with open(log.name) as f:
                print(f.read()[-2000:], file=sys.stderr)
        check(rc == 0, f"the {label} dry run exited {rc}")
        with open(out) as f:
            results[label] = json.load(f)
        runs = results[label]["runs"]
        check(len(runs) == 78 and all(r["ok"] for r in runs.values()),
              f"the {label} dry run did not lay out 78 runs")
        check(results[label]["skips"] == {
            "whisper-tiny|long_500k": "no sub-quadratic attention variant"},
            f"the {label} dry run's skips")
        phase(f"dry run [{card}] {label}: 78 runs ok, 1 skip "
              f"(whisper-tiny|long_500k), {walls[label]:.2f} s wall for the "
              f"process, {sum(r['seconds'] for r in runs.values()):.3f} s in "
              f"lower_one")
    whisper = results["plain"]["runs"]["whisper-tiny|train_4k|16x16"]
    check(whisper["memory"]["argument_size"] == 430_750_252,
          "whisper-tiny train_4k argument bytes differ from XLA's")
    plain, opt = (results[k]["runs"] for k in ("plain", "optimized"))
    combos = sorted({k.rsplit("|", 1)[0] for k in plain})
    for combo in combos:
        phase(f"dry run [{card}] {combo}: per-device argument GiB " + ", ".join(
            f"{mesh} {plain[f'{combo}|{mesh}']['memory']['argument_size'] / 2**30:.3f}"
            f" / optimized {opt[f'{combo}|{mesh}']['memory']['argument_size'] / 2**30:.3f}"
            for mesh in ("16x16", "2x16x16")))
    return {"walls": walls, "runs": {k: len(v["runs"])
                                     for k, v in results.items()}}


def distributed_phase(dev, card: str, expect, reset_counters,
                      read_counters) -> dict:
    """Phase 25 (c): `launch.train --distributed` (lm-100m, DIST_STEPS
    steps) with COORDINATOR_ADDRESS=127.0.0.1:<free port>,
    NUM_PROCESSES=1 and PROCESS_ID=0, over NCCL, against the same seed's
    run without it: losses equal, no kernel launched, the group gone
    after; then the bootstrap again with one NCCL all-reduce and
    `sync_hosts`."""
    import socket

    from repro_torch.launch import distributed as D
    from repro_torch.launch import train

    def free_port() -> int:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    argv = ["--steps", str(DIST_STEPS), "--log-every", str(DIST_STEPS)]
    plain = train.run(argv, device=dev)
    env = {"COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
           "NUM_PROCESSES": "1", "PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        reset_counters()
        t0 = time.perf_counter()
        run = train.run(argv + ["--distributed"], device=dev)
        wall = time.perf_counter() - t0
        counts = read_counters()
    finally:
        for k in env:
            os.environ.pop(k)
    same = run["losses"] == plain["losses"]
    differ = [i for i, (a, b) in enumerate(zip(run["losses"],
                                               plain["losses"])) if a != b]
    phase(f"distributed [{card}]: launch.train --distributed, "
          f"{DIST_STEPS} steps of {run['cfg'].name} in {wall:.2f} s, "
          f"launches {counts}; losses equal to the run without it {same} "
          f"(first loss {run['losses'][0]!r}, last {run['losses'][-1]!r}; "
          f"steps that differ {differ})")
    check(same, "the --distributed losses differ from the plain run's")
    check(counts == expect(), f"training launched {counts}")
    check(not torch.distributed.is_initialized(),
          "launch.train left its process group")
    check(D.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0) is False
          and torch.distributed.get_backend() == "nccl",
          "the bootstrap on the card is not NCCL")
    try:
        x = torch.full((), 3.0, device=dev)
        torch.distributed.all_reduce(x)
        D.sync_hosts()
        torch.cuda.synchronize()
        check(float(x) == 3.0 and D.is_coordinator(),
              "a one-rank NCCL all-reduce")
    finally:
        torch.distributed.destroy_process_group()
    phase(f"distributed [{card}]: NCCL world of 1: all-reduce ok")
    return {"wall_s": wall, "losses_equal": same}


def flash_operands(gen, dev, B, Hq, Hkv, S, D) -> tuple:
    """Synthetic kernel-8 operands: N(0, 1) q, k, v in the (B, H, S, D)
    layout of `tests/test_kernels.py`."""
    return tuple(torch.randn((B, h, S, D), generator=gen, device=dev)
                 for h in (Hq, Hkv, Hkv))


def check_flash_kernel(dev, gen, errs: dict) -> tuple:
    """Phase 3's checks of kernel 8: at each shape of FLASH_CASES the
    kernel and its plain version both within the float32 rounding bound
    of the float64 value (`kernels.flash_attn.ref.float64_reference_and_
    bound`, derived before the first run), within rtol 2e-4 / atol 2e-4
    of each other (`tests/test_kernels.py`), and a bit-identical
    relaunch; a shape the short-sequence instance takes also `torch.equal`
    to the D = 128 / D = 64 instance on the same rows (the operands
    extended past SHORT_MAX_S take it, and no row reads a later key).
    Returns the operands of granite's, zamba2's and whisper-tiny's serving
    shapes."""
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn import ref as fa_ref

    out, worst_err = {}, 0.0
    for label, shape in FLASH_CASES.items():
        ops = flash_operands(gen, dev, *shape)
        got = fa_ops.causal_attention(*ops)
        again = fa_ops.causal_attention(*ops)
        plain = fa_ref.causal_attention(*ops)
        o64, bound = fa_ref.float64_reference_and_bound(*ops)
        torch.cuda.synchronize()
        err, ok = allclose_report(got, plain, 2e-4, 2e-4)
        same = torch.equal(got, again)
        B, Hq, Hkv, S, D = shape
        inst = fa_ops.instance(D, s=S)
        if inst.startswith("short"):
            longer = [torch.cat([t, torch.randn(
                (B, t.shape[1], fa_ops.SHORT_MAX_S + 1, D), generator=gen,
                device=dev)], 2) for t in ops]
            long_eq = torch.equal(
                fa_ops.causal_attention(*longer)[:, :, :S], got)
            del longer
            phase(f"check causal_attention {label}: the {inst} instance "
                  f"torch.equal to the "
                  f"{fa_ops.instance(D, s=S + fa_ops.SHORT_MAX_S + 1)} "
                  f"instance on the same rows {long_eq}")
            check(long_eq, f"causal_attention {label}: the short instance "
                  "differs from the long one")
        share = {name: bound_share(o, o64, bound)
                 for name, o in (("kernel", got), ("plain", plain))}
        del o64, bound, plain
        phase(f"check causal_attention {label} (B, Hq, Hkv, S, D) = "
              f"{list(shape)}: max_abs_err vs plain {err:.3e} (|out| max "
              f"{float(got.abs().max()):.3e}); within rtol 2e-4 / atol 2e-4 "
              f"{ok}; against float64 the worst element at "
              f"{share['kernel']:.4f} (kernel) and {share['plain']:.4f} "
              f"(plain) of the derived rounding bound; bit-identical "
              f"relaunch {same}")
        check(share["kernel"] <= 1.0 and share["plain"] <= 1.0,
              f"causal_attention {label} outside its float64 bound")
        check(ok, f"causal_attention {label} disagrees with plain")
        check(same, f"causal_attention {label} not deterministic")
        worst_err = max(worst_err, err)
        if label in ("serving shape", "zamba2 serving shape",
                     "whisper-tiny serving shape"):
            out[label] = ops
    errs["causal_attention"] = worst_err
    return (out["serving shape"], out["zamba2 serving shape"],
            out["whisper-tiny serving shape"])


def sdpa_backend(q, k, v) -> str:
    """The backend `scaled_dot_product_attention(..., is_causal=True,
    enable_gqa=True)` takes on these operands: the first, in PyTorch's
    priority order, that accepts them alone."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    order = [SDPBackend(int(b)) for b in torch._C._get_sdp_priority_order()]
    for backend in order:
        try:
            with sdpa_kernel([backend]):
                torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
            return backend.name
        except RuntimeError:
            continue
    return "none"


def sdpa_gqa(q, k, v):
    """Kernel 8's function as one PyTorch call with grouped heads (timed
    beside the library yardstick; never used by the port)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)


def sdpa_expanded(q, k, v):
    """Kernel 8's function as PyTorch calls: the key/value heads repeated
    to the query heads, then `scaled_dot_product_attention` on equal head
    counts, which float32 admits to its fused backends (the library
    yardstick of the timing phase; never used by the port).  With one
    key/value head per query head nothing is repeated."""
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True)


def time_hybrid_shapes(ssd_ops_, flash_ops_, card: str) -> dict:
    """Phase 13 at zamba2-1.2b's 2048-token prefill: kernel 7 at
    SSD_HYBRID_SHAPE and kernel 8 at FLASH_HYBRID_SHAPE (phase 3's
    operands), cold and warm, their plain versions, the library calls of
    the serving shapes (held to the kernel first) and the bound of
    `roofline.kernel_terms`."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    out = {}
    B, nc, Q, H, P, N = SSD_HYBRID_SHAPE
    G = ssd_ops_[3].shape[3]
    got_y, got_s = ssd_ops.ssd_chunk(*ssd_ops_)
    hm, gm = head_major(ssd_ops_), group_major(ssd_ops_)
    lib_y, lib_s = ssd_library(*hm)
    lib_err = max(float((lib_y - got_y.movedim(3, 2).reshape(lib_y.shape))
                        .abs().max()),
                  float((lib_s - got_s.reshape(lib_s.shape)).abs().max()))
    lib_y, lib_s = ssd_library_grouped(*gm)
    lib_err = max(lib_err,
                  float((lib_y - got_y.reshape(B * nc, Q, G, H // G, P)
                         .movedim(1, 3)).abs().max()),
                  float((lib_s - got_s.reshape(lib_s.shape)).abs().max()))
    lib_bound = 1e-4 * max(1.0, float(got_y.abs().max()),
                           float(got_s.abs().max()))
    check(lib_err <= lib_bound, "a library expression of kernel 7 at "
          f"zamba2's shape disagrees with the kernel: {lib_err:.3e}")
    del lib_y, lib_s, got_y, got_s
    cold = cold_copies(ssd_ops_)
    terms = kernel_terms("ssd_chunk", (B, nc, Q, H, P, N, G))
    out["ssd_chunk"] = {
        "shape": [B, nc, Q, H, P, G, N],
        "ms": time_ms(ssd_ops.ssd_chunk, cold),
        "ms_l2_warm": time_ms(ssd_ops.ssd_chunk, [ssd_ops_]),
        "plain_ms": time_ms(ssd_ref.ssd_chunk_reference,
                            cold_copies(per_head(ssd_ops_)), calls=4),
        "library_ms": time_ms(ssd_library, cold_copies(hm), calls=4),
        "library_grouped_ms": time_ms(ssd_library_grouped, cold_copies(gm),
                                      calls=4),
        "bound_ms": 1e3 * terms["bound_s"], "bound_by": terms["bound_by"],
        "flops": int(terms["flops"]), "bytes": int(terms["bytes"])}
    del cold, hm, gm
    r = out["ssd_chunk"]
    phase(f"time ssd_chunk {list(SSD_HYBRID_SHAPE)} G={G} (zamba2) "
          f"[{card}]: kernel {r['ms']!r} ms (L2 warm {r['ms_l2_warm']!r} ms), "
          f"plain {r['plain_ms']!r} ms, library matmul + tril on head-major "
          f"views {r['library_ms']!r} ms, with C B^T once per group "
          f"{r['library_grouped_ms']!r} ms (max |library - kernel| "
          f"{lib_err:.3e}), bound {r['bound_ms']!r} ms ({r['bound_by']}, "
          f"flops {r['flops']}, bytes {r['bytes']})")

    out["causal_attention"] = time_flash(flash_ops_, FLASH_HYBRID_SHAPE,
                                         "zamba2", card)
    return out


def time_flash(flash_ops_, shape, label: str, card: str) -> dict:
    """Kernel 8 at `shape` (phase 3's operands of that shape), cold and
    warm, its plain version, the library call (held to the kernel
    first), the instance it takes and the bound of
    `roofline.kernel_terms`."""
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn import ref as fa_ref

    got = fa_ops.causal_attention(*flash_ops_)
    lib_err = float((sdpa_expanded(*flash_ops_) - got).abs().max())
    check(lib_err <= 2e-4, f"the library call of kernel 8 at {label}'s shape "
          f"disagrees with the kernel: {lib_err:.3e}")
    del got
    B, Hq, Hkv, S, D = shape
    rep = Hq // Hkv  # the backend of the expanded call that is timed
    backend = sdpa_backend(flash_ops_[0],
                           *(t.repeat_interleave(rep, 1)
                             for t in flash_ops_[1:]))
    cold = cold_copies(flash_ops_)
    terms = kernel_terms("causal_attention", shape)
    r = {"shape": list(shape), "instance": fa_ops.instance(D, s=S),
         "ms": time_ms(fa_ops.causal_attention, cold),
         "ms_l2_warm": time_ms(fa_ops.causal_attention, [flash_ops_]),
         "plain_ms": time_ms(fa_ref.causal_attention, cold, calls=4),
         "library_ms": time_ms(sdpa_expanded, cold, calls=4),
         "library": ("repeat_interleave + " if rep > 1 else "")
                    + f"scaled_dot_product_attention(is_causal) on {backend}",
         "bound_ms": 1e3 * terms["bound_s"], "bound_by": terms["bound_by"],
         "flops": int(terms["flops"]), "bytes": int(terms["bytes"])}
    del cold
    phase(f"time causal_attention {list(shape)} ({label}, the "
          f"{r['instance']} instance) [{card}]: kernel {r['ms']!r} ms (L2 "
          f"warm {r['ms_l2_warm']!r} ms), plain {r['plain_ms']!r} ms, "
          f"library {r['library']} {r['library_ms']!r} ms (max |library - "
          f"kernel| {lib_err:.3e}), bound {r['bound_ms']!r} ms "
          f"({r['bound_by']}, flops {r['flops']}, bytes {r['bytes']})")
    return r


def ssd_library(xh, dth, dah, bh, ch):
    """Kernel 7's function as `torch.matmul` on the (B*nc*H, Q, N) and
    (B*nc*H, Q, P) head-major views, the causal mask by `torch.tril`
    (the library yardstick of the timing phase; never used by the port)."""
    cum = torch.cumsum(dah, dim=-1, dtype=torch.float64).float()
    xw = xh * dth[..., None]
    lmat = torch.exp(cum[:, :, None] - cum[:, None, :])
    y = torch.matmul(torch.tril(torch.matmul(ch, bh.transpose(1, 2)) * lmat),
                     xw)
    dec = torch.exp(cum[:, -1:] - cum)
    states = torch.matmul((xw * dec[..., None]).transpose(1, 2), bh)
    return y, states


def ssd_library_grouped(xg, dtg, dag, bg, cg):
    """Kernel 7's function with C B^T once per group: `torch.matmul` on
    the (B*nc*G, Q, N) views, broadcast over the group's heads for the
    decay and `torch.tril`, then `torch.matmul` with dt x, and the state
    against B broadcast the same way (the second library yardstick of the
    timing phase; never used by the port)."""
    n, G, rep, Q, P = xg.shape
    cum = torch.cumsum(dag, dim=-1, dtype=torch.float64).float()
    xw = xg * dtg[..., None]
    scores = torch.matmul(cg, bg.transpose(1, 2)).view(n, G, 1, Q, Q)
    lmat = torch.exp(cum[..., :, None] - cum[..., None, :])
    y = torch.matmul(torch.tril(scores * lmat), xw)
    dec = torch.exp(cum[..., -1:] - cum)
    states = torch.matmul((xw * dec[..., None]).transpose(-1, -2),
                          bg.view(n, G, 1, Q, bg.shape[-1]))
    return y, states


def group_major(ops) -> tuple:
    """Kernel-7 operands as contiguous group-major views: x (B*nc, G, H/G,
    Q, P), dt and da (B*nc, G, H/G, Q), B and C (B*nc*G, Q, N)."""
    xc, dtc, da, bc, cc = ops
    B, nc, Q, H, P = xc.shape
    G, N = bc.shape[3], bc.shape[4]

    def heads(t):  # (B, nc, Q, H, ...) -> (B * nc, G, H / G, Q, ...)
        t = t.reshape(B * nc, Q, G, H // G, *t.shape[4:])
        return t.movedim(1, 3).contiguous()

    def groups(t):  # (B, nc, Q, G, N) -> (B * nc * G, Q, N)
        return t.movedim(3, 2).reshape(B * nc * G, Q, N).contiguous()

    return heads(xc), heads(dtc), heads(da), groups(bc), groups(cc)


def head_major(ops) -> tuple:
    """Kernel-7 operands as contiguous (B*nc*H, Q, ...) views."""
    xc, dtc, da, bc, cc = per_head(ops)
    B, nc, Q, H, P = xc.shape

    def hm(t):  # (B, nc, Q, H, ...) -> (B * nc * H, Q, ...)
        t = t.movedim(3, 2)
        return t.reshape(B * nc * H, Q, *t.shape[4:]).contiguous()

    return tuple(hm(t) for t in (xc, dtc, da, bc, cc))


def run_training(argv, dev, card: str, expect, reset_counters,
                 read_counters) -> dict:
    """`launch.train.run(argv)` on the card, counted from 0 just before;
    no kernel may launch (training takes the plain expressions).  Prints
    the host seconds a step (median after the first) and tokens/s."""
    from repro_torch.launch import train

    phase(f"train [{card}]: python -m repro_torch.launch.train "
          + " ".join(argv))
    gc.collect()
    torch.cuda.empty_cache()
    reset_counters()
    t0 = time.perf_counter()
    res = train.run(argv, device=dev)
    torch.cuda.synchronize()
    res["wall_s"] = time.perf_counter() - t0
    res["launches"] = read_counters()
    check(res["launches"] == expect(),
          f"training launched a kernel: {res['launches']}")
    losses = np.asarray(res["losses"])
    check(bool(np.all(np.isfinite(losses))), "a training loss is not finite")
    args = res["args"]
    res["step_s"] = statistics.median(res["step_seconds"][1:])
    res["tokens_per_s"] = args.batch * args.seq / res["step_s"]
    phase(f"train [{card}]: {res['cfg'].name}, {res['n_params']} "
          f"parameters, {len(losses)} steps of batch {args.batch} x "
          f"{args.seq} in {res['wall_s']:.3f} s wall (first step "
          f"{res['step_seconds'][0]:.3f} s); {res['step_s']!r} s a step, "
          f"{res['tokens_per_s']:.1f} tokens/s; peak "
          f"{res['peak_bytes'] / 2**30:.3f} GiB allocated; launches "
          f"{res['launches']}")
    return res


def check_resume(res, ckpt: str, dev, card: str, expect, reset_counters,
                 read_counters) -> float:
    """Phase 19a's resume: the step-200 checkpoint restored into a
    template on the card, steps 201-210 run again on the same batches;
    returns the largest relative loss difference."""
    from repro_torch import tree
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch import steps
    from repro_torch.optim import make_optimizer

    args, cfg = res["args"], res["cfg"]
    opt = make_optimizer(args.optimizer, args.lr)
    template = {"params": tree.tree_map(torch.empty_like, res["params"]),
                "opt": opt.init(res["params"])}
    step, state = restore_checkpoint(ckpt, template, step=TRAIN_RESUME_AT)
    check(step == TRAIN_RESUME_AT, f"restored step {step}")
    check(int(state["opt"].step) == TRAIN_RESUME_AT,
          "the restored optimizer step is not the checkpoint's")
    it = token_batches(args.seed, args.batch, args.seq, cfg.vocab,
                       device=dev)
    for _ in range(TRAIN_RESUME_AT):
        next(it)
    step_fn = steps.make_train_step(cfg, opt, compute_dtype=torch.float32,
                                    remat=False)
    params, opt_state = state["params"], state["opt"]
    reset_counters()
    again = []
    for _ in range(TRAIN_RESUME_STEPS):
        params, opt_state, m = step_fn(params, opt_state, next(it))
        again.append(float(m["loss"]))
    check(read_counters() == expect(), "the resumed steps launched a kernel")
    want = np.asarray(res["losses"][TRAIN_RESUME_AT:
                                    TRAIN_RESUME_AT + TRAIN_RESUME_STEPS])
    rel = float(np.max(np.abs(np.asarray(again) - want) / np.abs(want)))
    phase(f"train [{card}]: resumed from step {TRAIN_RESUME_AT}: steps "
          f"{TRAIN_RESUME_AT + 1}-{TRAIN_RESUME_AT + TRAIN_RESUME_STEPS} "
          f"losses {again[0]:.6f} .. {again[-1]:.6f}, max relative "
          f"difference from the uninterrupted run {rel:.3e} (rtol "
          f"{TRAIN_RESUME_RTOL})")
    check(rel <= TRAIN_RESUME_RTOL, "the resumed losses left the run's")
    return rel


def check_train_steps_against_cpu(arch: str, dev, card: str) -> dict:
    """Phase 19d: one float32 train step and one federated step of the
    reduced `arch` on the card and on the CPU from the same parameters
    and batch: the losses within rtol 1e-5, each gradient leaf within
    rtol 1e-4 / atol 1e-6 * max(1, max|CPU leaf|) (the gradients of the
    steps' own `value_and_grad`, and the parameters' change under SGD at
    lr 1).  Returns the largest share of the leaf bound and loss error."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import sgd

    cfg = get_config(arch).reduced()
    cpu = torch.device("cpu")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device=cpu)
    batch = next(token_batches(0, 4, 40, cfg.vocab, device=cpu))
    w = torch.tensor([0.0, 1.5, 1.0, 2.0])
    fed_grad = steps.make_fed_grad_fn(cfg)

    def run(device):
        p = tree.tree_map(lambda t: t.to(device), params)
        b = {k: v.to(device) for k, v in batch.items()}
        w_ = w.to(device)
        loss, _, grads = steps.value_and_grad(
            lambda q: T.loss_fn(cfg, q, b), p)
        floss, fgrads = fed_grad(p, b, w_)
        out = [(loss, grads), (floss, fgrads)]
        for make, extra in ((steps.make_train_step(
                cfg, sgd(1.0), compute_dtype=torch.float32, remat=False),
                ()), (steps.make_fed_train_step(cfg, sgd(1.0)), (w_,))):
            q = tree.tree_map(torch.clone, p)
            _, _, m = make(q, sgd(1.0).init(q), b, *extra)
            out.append((m["loss"], tree.tree_map(torch.sub, p, q)))
        return out

    want = run(cpu)
    got = run(dev)
    worst, loss_err = 0.0, 0.0
    for (g_loss, g_tree), (w_loss, w_tree) in zip(got, want):
        loss_err = max(loss_err, abs(float(g_loss) - float(w_loss))
                       / abs(float(w_loss)))
        for g, ref in zip(tree.leaves(g_tree), tree.leaves(w_tree)):
            ref64, g64 = ref.double(), g.cpu().double()
            bound = (1e-4 * ref64.abs()
                     + 1e-6 * max(1.0, float(ref64.abs().max())))
            worst = max(worst, float(((g64 - ref64).abs() / bound).max()))
    phase(f"train card vs CPU [{card}]: {cfg.name}: loss max relative "
          f"error {loss_err:.3e} (rtol 1e-5), gradient leaves at "
          f"{worst:.3f} of their bound (the train and federated steps' "
          f"gradients and SGD changes)")
    check(loss_err <= 1e-5, f"{cfg.name}: the card's loss left the CPU's")
    check(worst <= 1.0, f"{cfg.name}: a gradient leaf on the card left the "
          "CPU's bound")
    return {"bound_share": worst, "loss_err": loss_err}


def train_phase(dev, card: str, expect, reset_counters, read_counters) -> dict:
    """Phase 19: LM training and the federated LM trainer on the card."""
    import shutil
    from repro_torch.fed import FedConfig, fed_setup
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.sim.network import paper_fleet

    out = {}
    # (a) launch.train at its defaults, with checkpoints, and the resume
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        res = run_training(["--ckpt-dir", ckpt, "--ckpt-every",
                            str(TRAIN_CKPT_EVERY), "--log-every", "50"],
                           dev, card, expect, reset_counters, read_counters)
        losses = res["losses"]
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        phase(f"train [{card}]: lm-100m mean loss of the first 10 steps "
              f"{first:.4f}, of the last 10 {last:.4f}")
        check(res["cfg"].name == "lm-100m" and len(losses) == 300,
              "launch.train's defaults are not lm-100m for 300 steps")
        check(last < first, "lm-100m's loss did not go down")
        files = sorted(os.listdir(ckpt))
        check(files == [f"step_{s:08d}.msgpack" for s in (100, 200, 300)],
              f"checkpoints written: {files}")
        size = os.path.getsize(os.path.join(ckpt, files[1]))
        phase(f"train: checkpoints {files}, {size} bytes each")
        rel = check_resume(res, ckpt, dev, card, expect, reset_counters,
                           read_counters)
        out["lm"] = {k: res[k] for k in ("wall_s", "step_s", "tokens_per_s",
                                         "peak_bytes", "n_params")}
        out["lm"].update(first=first, last=last, resume_rel=rel,
                         ckpt_bytes=size)
        del res
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    # (b) mamba2-1.3b federated at full width
    res = run_training(["--arch", FED_ARCH, "--federated", "--n-clients",
                        str(FED_CLIENTS), "--steps", str(FED_ROUNDS),
                        "--batch", str(FED_CLIENTS), "--seq", str(FED_SEQ),
                        "--log-every", "5"],
                       dev, card, expect, reset_counters, read_counters)
    check(res["n_params"] == SERVE_PARAMS, "mamba2-1.3b is not at full width")
    want = fed_setup(paper_fleet(0.2, 0.2, seed=0, n=FED_CLIENTS,
                                 d=res["cfg"].d_model).edge,
                     FedConfig(FED_CLIENTS, 1, FED_CLIENTS))
    plan = res["fed"].plan
    check(plan.t_star == want.plan.t_star
          and np.array_equal(plan.loads, want.plan.loads)
          and np.array_equal(res["fed"].p_return, want.p_return),
          "launch.train's federated plan is not fed_setup's")
    losses = res["losses"]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    phase(f"train [{card}]: {FED_ARCH} federated t*={plan.t_star!r} s, "
          f"loads {plan.loads.tolist()} (fed_setup's on the host), "
          f"p_return {np.round(res['fed'].p_return, 4).tolist()}; mean "
          f"loss of the first 5 rounds {first:.4f}, of the last 5 "
          f"{last:.4f}")
    check(last < first, f"{FED_ARCH}'s federated loss did not go down")
    out["fed"] = {k: res[k] for k in ("wall_s", "step_s", "tokens_per_s",
                                      "peak_bytes", "n_params")}
    out["fed"].update(first=first, last=last)
    del res, plan

    # (c) the reference docstring's example
    res = run_training(["--arch", "granite-8b", "--reduced", "--federated",
                        "--log-every", "100"],
                       dev, card, expect, reset_counters, read_counters)
    losses = res["losses"]
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    phase(f"train [{card}]: granite-8b-reduced federated mean loss of the "
          f"first 10 steps {first:.4f}, of the last 10 {last:.4f}")
    check(last < first, "granite-8b-reduced's federated loss did not go down")
    out["granite"] = {k: res[k] for k in ("wall_s", "step_s",
                                          "tokens_per_s", "peak_bytes")}
    del res

    # (f) the hybrid and moe families, reduced, at launch.train's defaults
    for arch in (HYBRID_ARCH, MOE_ARCH):
        res = run_training(["--arch", arch, "--reduced", "--steps",
                            str(NEW_FAMILY_TRAIN_STEPS), "--log-every", "10"],
                           dev, card, expect, reset_counters, read_counters)
        losses = res["losses"]
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        phase(f"train [{card}]: {res['cfg'].name} mean loss of the first 5 "
              f"steps {first:.4f}, of the last 5 {last:.4f}; last step's "
              f"metrics {res['metrics']}")
        check(last < first, f"{res['cfg'].name}'s loss did not go down")
        if arch == MOE_ARCH:
            check(np.isfinite(res["metrics"].get("moe_aux_loss", np.nan)),
                  "the moe train step reports no finite moe_aux_loss")
        out[arch] = {k: res[k] for k in ("wall_s", "step_s", "tokens_per_s",
                                         "peak_bytes", "metrics")}
        out[arch].update(first=first, last=last)
        del res

    # (d) the card against the CPU, counted: no kernel
    reset_counters()
    out["vs_cpu"] = {arch: check_train_steps_against_cpu(arch, dev, card)
                     for arch in ("granite-8b", "mamba2-1.3b")}
    check(read_counters() == expect(), "a train step launched a kernel")

    # (e) kernels 7 and 8 refuse operands that require grad
    gen = torch.Generator(device=dev).manual_seed(19)
    q, k, v = (torch.randn((1, h, 64, 64), generator=gen, device=dev)
               for h in (4, 2, 2))
    ssd = ssd_operands(gen, dev, 1, 2, 16, 4, 8, 8, 1)
    reset_counters()
    for name, call in (
            ("causal_attention", lambda: fa_ops.causal_attention(
                q.requires_grad_(), k, v)),
            ("ssd_chunk", lambda: ssd_ops.ssd_chunk(
                ssd[0].requires_grad_(), *ssd[1:]))):
        try:
            call()
        except RuntimeError as err:
            check("no backward" in str(err), f"{name}: {err}")
        else:
            raise AssertionError(f"{name} launched on operands that "
                                 "require grad")
    check(read_counters() == expect(), "a refused call launched a kernel")
    phase("train: kernels 7 and 8 refuse operands that require grad on the "
          "card (no launch)")
    return out


def check_tiles(dev, card: str, expect, reset_counters,
                read_counters) -> None:
    """Phase 20b: every candidate tile of every family on the card against
    its kernel's plain version, by phase 3's bounds: kernels 1, 4 and 5
    at every "round_grad" tile and kernel 6 at every "coded_grad" tile
    within the float64 bound of `held_to_float64` (relaunches
    bit-identical, T = 1 `torch.equal` to flat, kernel 6 to flat w =
    None), kernel 2 within 2e-4 * max|ref| of its plain version and
    within the float64 bound of the encode; exact launch counts and
    per-tile launch records."""
    from repro_torch.kernels.coded_grad import ref as cg_ref
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.encode import ref as enc_ref
    from repro_torch.kernels.round_grad import ops as rg_ops
    from repro_torch.kernels.round_grad import ref as rg_ref
    from repro_torch.tune.families import FAMILIES

    gen = torch.Generator(device=dev).manual_seed(20)
    m, d = TUNE_SHAPES["round_grad"]
    x = torch.randn((m, d), generator=gen, device=dev)
    y = torch.randn((m,), generator=gen, device=dev)
    w = torch.rand((m,), generator=gen, device=dev)
    w[::7] = 0.0
    xp = torch.randn((DP_FIXED_C, d), generator=gen, device=dev)
    yp = torch.randn((DP_FIXED_C,), generator=gen, device=dev)
    wp = (torch.rand((DP_FIXED_C,), generator=gen, device=dev) < SCFL_RHO) \
        .float() / SCFL_RHO
    beta = torch.randn((d,), generator=gen, device=dev)
    tier_of = torch.randint(0, HIER_TIERS, (m,), generator=gen, device=dev)
    masks = (torch.arange(HIER_TIERS, device=dev)[:, None]
             == tier_of[None, :]).float()
    ones = torch.ones((1, m), device=dev)
    xc, yc = torch.cat([x, xp]), torch.cat([y, yp])
    refs = {"flat": float64_gradient_and_bound(x, y, w, beta),
            "coded": float64_gradient_and_bound(xc, yc, torch.cat([w, wp]),
                                                beta),
            "tier": float64_gradient_and_bound(x, y, w, beta, masks)}
    plain = {"flat": rg_ref.masked_round_gradient(x, y, w, beta),
             "coded": rg_ref.coded_round_gradient(x, y, w, xp, yp, wp, beta),
             "tier": rg_ref.tier_masked_round_gradient(x, y, w, masks, beta)}
    worst_plain = max(float64_share(plain[k], *refs[k]) for k in refs)
    tiles = FAMILIES["round_grad"].candidate_blocks((m, d), "cuda-sm90")
    for (tile,) in tiles:
        reset_counters()
        got = {"flat": rg_ops.masked_round_gradient(x, y, w, beta,
                                                    block_m=tile),
               "coded": rg_ops.coded_round_gradient(x, y, w, xp, yp, wp,
                                                    beta, block_m=tile),
               "tier": rg_ops.tier_masked_round_gradient(
                   x, y, w, masks, beta, block_m=tile)}
        again = rg_ops.masked_round_gradient(x, y, w, beta, block_m=tile)
        one = rg_ops.tier_masked_round_gradient(x, y, w, ones, beta,
                                                block_m=tile)
        torch.cuda.synchronize()
        check(read_counters() == expect(round_grad=2, coded_round_grad=1,
                                        tier_round_grad=2),
              f"round_grad tile {tile}: launch counts {read_counters()}")
        check(rg_ops.COUNTER.tiles == {(tile,): 2}
              and rg_ops.CODED_COUNTER.tiles == {(tile,): 1}
              and rg_ops.TIER_COUNTER.tiles == {(tile,): 2},
              f"round_grad tile {tile}: launches by tile "
              f"{rg_ops.COUNTER.tiles} {rg_ops.CODED_COUNTER.tiles} "
              f"{rg_ops.TIER_COUNTER.tiles}")
        shares = {k: float64_share(got[k], *refs[k]) for k in refs}
        phase(f"tile round_grad block_m={tile} ({m}, {d}) [{card}]: worst "
              f"element of the float64 bound flat {shares['flat']:.2e}, "
              f"coded (+ {DP_FIXED_C} parity rows) {shares['coded']:.2e}, "
              f"tier T={HIER_TIERS} {shares['tier']:.2e} (plain "
              f"{worst_plain:.2e}); relaunch bit-identical "
              f"{torch.equal(got['flat'], again)}; T=1 torch.equal to flat "
              f"{torch.equal(one[0], got['flat'])}")
        check(max(shares.values()) <= 1.0 and worst_plain <= 1.0,
              f"round_grad tile {tile} outside its float64 bound")
        check(torch.equal(got["flat"], again),
              f"round_grad tile {tile} not deterministic")
        check(torch.equal(one[0], got["flat"]),
              f"round_grad tile {tile}: T = 1 differs from flat")
    m, d = TUNE_SHAPES["coded_grad"]
    a = torch.randn((m, d), generator=gen, device=dev)
    ya = torch.randn((m,), generator=gen, device=dev)
    exact, bound = float64_gradient_and_bound(a, ya, None, beta[:d])
    plain_share = float64_share(cg_ref.lsq_gradient(a, ya, beta[:d]), exact,
                                bound)
    for (tile,) in FAMILIES["coded_grad"].candidate_blocks((m, d),
                                                           "cuda-sm90"):
        reset_counters()
        got = rg_ops.lsq_gradient(a, ya, beta[:d], block_m=tile)
        flat = rg_ops.masked_round_gradient(a, ya, None, beta[:d],
                                            block_m=tile)
        torch.cuda.synchronize()
        check(read_counters() == expect(lsq_gradient=1, round_grad=1)
              and rg_ops.LSQ_COUNTER.tiles == {(tile,): 1},
              f"coded_grad tile {tile}: launch counts {read_counters()}")
        share = float64_share(got, exact, bound)
        phase(f"tile coded_grad block_m={tile} ({m}, {d}) [{card}]: worst "
              f"element {share:.2e} of the float64 bound (plain "
              f"{plain_share:.2e}); torch.equal to flat at w = None "
              f"{torch.equal(got, flat)}")
        check(share <= 1.0 and plain_share <= 1.0,
              f"coded_grad tile {tile} outside its float64 bound")
        check(torch.equal(got, flat),
              f"coded_grad tile {tile} differs from the flat kernel")
    fam, shape = FAMILIES["encode"], TUNE_SHAPES["encode"]
    args = fam.make_args(shape, seed=20, device=dev)
    want = enc_ref.encode_parity(*args)
    p64, p_bound = enc_ops.float64_reference_and_bound(*args)
    plain_share = bound_share(want, p64, p_bound)
    first = None  # the first tile's result
    for tile in fam.candidate_blocks(shape, "cuda-sm90"):
        reset_counters()
        got = fam.bind(shape, tile)(*args)
        first = got if first is None else first
        torch.cuda.synchronize()
        check(read_counters() == expect(encode=1)
              and enc_ops.COUNTER.tiles == {tuple(tile): 1},
              f"encode tile {tile}: launch counts {read_counters()}")
        bound = 2e-4 * float(want.abs().max())
        err, ok = allclose_report(got, want, 2e-4, bound)
        share = bound_share(got, p64, p_bound)
        phase(f"tile encode {tile} {shape} [{card}]: max_abs_err "
              f"{err:.3e} vs plain (bound 2e-4*max|ref| = {bound:.3e}); "
              f"worst element {share:.4f} of the float64 bound 1.01 "
              f"(L + 20) u |G| |diag(w) X| (plain {plain_share:.4f}); "
              f"bit-equal to the first tile's {torch.equal(got, first)}")
        check(ok and share <= 1.0 and plain_share <= 1.0,
              f"encode tile {tile} disagrees with its plain version")


def tune_phase(dev, card: str, expect, reset_counters,
               read_counters) -> dict:
    """Phase 20: the tile autotuner on the card — (a) `tune.autotune` of
    each family at one CI shape into a temporary cache; (b) every
    candidate tile against its kernel's plain version (`check_tiles`);
    (c) cold misses `torch.equal` to the explicit default tile (the tile
    each kernel launched before it took tiles); (d) a cache hit launches
    the stored tile; (e) the keyed `encode_fleet` at §IV width against
    the plain streamed encode; (f) the host's time of a memoized
    `resolve_block("auto")`; exact launch counts throughout."""
    from repro_torch.core.encoding import (encode_fleet_streamed,
                                           generator_matrix)
    from repro_torch.kernels import common
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.encode import prng
    from repro_torch.kernels.encode import ref as enc_ref
    from repro_torch.kernels.round_grad import ops as rg_ops
    from repro_torch.tune import TileCache
    from repro_torch.tune import cache as tune_cache
    from repro_torch.tune.families import FAMILIES
    from repro_torch.tune.tuner import DEFAULT_SLACK, autotune

    t_phase = time.perf_counter()
    backend = common.backend(dev)
    check(backend == "cuda-sm90", f"the card's backend is {backend}")
    tuned = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    try:
        # (a) the tuner, into a cache of its own
        cache = TileCache(os.path.join(tmp, "tiles.json"))
        for name, shape in TUNE_SHAPES.items():
            t0 = time.perf_counter()
            res = autotune(name, shape, device=dev, cache=cache)
            secs = time.perf_counter() - t0
            ent = cache.lookup(name, shape, backend)
            check(ent is not None and tuple(ent["block"]) == res.block
                  and ent["device"] == card,
                  f"autotune {name} {shape} stored {ent}")
            phase(f"tune {name} {shape} [{card}]: {len(res.candidates)} "
                  f"candidates, {len(res.pruned)} pruned by the roofline "
                  f"(slack {DEFAULT_SLACK}), winner {res.block} at "
                  f"{res.us!r} us (its bound {res.bound_us!r} us), "
                  f"{secs:.2f} s; measured us: " + ", ".join(
                      f"{b} {us:.3f}" for b, us in res.measured))
            tuned[name] = {"shape": list(shape),
                           "n_candidates": len(res.candidates),
                           "n_pruned": len(res.pruned),
                           "winner": list(res.block), "winner_us": res.us,
                           "measured_us": [[list(b), us]
                                           for b, us in res.measured]}
        # (b) every candidate tile against the plain version
        check_tiles(dev, card, expect, reset_counters, read_counters)

        # (c) cold misses: the explicit default tile, bit for bit
        for name, shape in COLD_SHAPES.items():
            check(tune_cache.lookup_entry(name, shape, backend) is None,
                  f"{name} {shape} is not a cold miss")
        gen = torch.Generator(device=dev).manual_seed(21)
        m, d = COLD_SHAPES["round_grad"]
        x = torch.randn((m, d), generator=gen, device=dev)
        y = torch.randn((m,), generator=gen, device=dev)
        w = torch.rand((m,), generator=gen, device=dev)
        beta = torch.randn((d,), generator=gen, device=dev)
        xp = torch.randn((COLD_PARITY_ROWS, d), generator=gen, device=dev)
        yp = torch.randn((COLD_PARITY_ROWS,), generator=gen, device=dev)
        masks = (torch.rand((HIER_TIERS, m), generator=gen, device=dev)
                 < 0.5).float()
        rpc = rg_ops.rows_per_cta(m)
        check(rg_ops.rows_per_cta(COLD_PARITY_ROWS) == rpc,
              "the cold coded shape's blocks have different partitions")
        enc_args = FAMILIES["encode"].make_args(COLD_SHAPES["encode"], 21,
                                                dev)
        c_cold, ell_cold, d_cold = COLD_SHAPES["encode_prng"]
        prng_args = (prng.prng_key(22),
                     torch.rand((ell_cold,), generator=gen, device=dev),
                     torch.randn((ell_cold, d_cold), generator=gen,
                                 device=dev))
        calls = {  # {kernel: (call with block/block_m = tile or "auto")}
            "round_grad": lambda t: rg_ops.masked_round_gradient(
                x, y, w, beta, block_m=t),
            "coded_round_grad": lambda t: rg_ops.coded_round_gradient(
                x, y, w, xp, yp, 0.5, beta, block_m=t),
            "tier_round_grad": lambda t: rg_ops.tier_masked_round_gradient(
                x, y, w, masks, beta, block_m=t),
            "lsq_gradient": lambda t: rg_ops.lsq_gradient(x, y, beta,
                                                          block_m=t),
            "encode": lambda t: enc_ops.encode_parity(*enc_args, block=t),
            "encode_prng": lambda t: enc_ops.encode_parity_prng(
                *prng_args, c_cold, block=t)}
        defaults = {"round_grad": rpc, "coded_round_grad": rpc,
                    "tier_round_grad": rpc, "lsq_gradient": rpc,
                    "encode": enc_ops.DEFAULT_BLOCK,
                    "encode_prng": enc_ops.PRNG_BLOCK}
        cold_equal = {}
        for kernel, call in calls.items():
            reset_counters()
            cold, explicit = call("auto"), call(defaults[kernel])
            torch.cuda.synchronize()
            check(read_counters() == expect(**{kernel: 2}),
                  f"cold {kernel}: launch counts {read_counters()}")
            cold_equal[kernel] = torch.equal(cold, explicit)
        phase(f"cold misses at {COLD_SHAPES} (+ {COLD_PARITY_ROWS} parity "
              f"rows) torch.equal to the explicit default tile (rows a CTA "
              f"{rpc}, encode {enc_ops.DEFAULT_BLOCK}, encode_prng "
              f"{enc_ops.PRNG_BLOCK}): {cold_equal}")
        check(all(cold_equal.values()), "a cold miss differs from the "
              "explicit default tile")

        # (d) hits: a stored tile is what `block="auto"` launches
        user = TileCache(tune_cache.user_cache_path())
        for name, tile in HIT_TILES.items():
            user.store(name, COLD_SHAPES[name], backend, tile)
        hit = {"round_grad": HIT_TILES["round_grad"],
               "coded_round_grad": HIT_TILES["round_grad"],
               "tier_round_grad": HIT_TILES["round_grad"],
               "lsq_gradient": HIT_TILES["coded_grad"],
               "encode": HIT_TILES["encode"]}
        counters = {"round_grad": rg_ops.COUNTER,
                    "coded_round_grad": rg_ops.CODED_COUNTER,
                    "tier_round_grad": rg_ops.TIER_COUNTER,
                    "lsq_gradient": rg_ops.LSQ_COUNTER,
                    "encode": enc_ops.COUNTER}
        hit_ok = {}
        for kernel, tile in hit.items():
            call = calls[kernel]
            reset_counters()
            got = call("auto")
            record = dict(counters[kernel].tiles)
            explicit = call(tile if len(tile) > 1 else tile[0])
            torch.cuda.synchronize()
            check(read_counters() == expect(**{kernel: 2}),
                  f"hit {kernel}: launch counts {read_counters()}")
            hit_ok[kernel] = record == {tuple(tile): 1} \
                and torch.equal(got, explicit)
        os.remove(user.path)
        tune_cache.forget_resolved()
        phase(f"cache hits launch the stored tile {hit} (per-tile launch "
              f"record, and torch.equal to the explicit tile): {hit_ok}")
        check(all(hit_ok.values()), "a cache hit did not launch its tile")

        # (e) the keyed streamed encode at §IV width
        n, ell, d, c = KEYED_FLEET
        xs = torch.randn((n, ell, d), generator=gen, device=dev)
        ys = torch.randn((n, ell), generator=gen, device=dev)
        ws = torch.rand((n, ell), generator=gen, device=dev)
        seeds = [KEYED_SEED0 + i for i in range(n)]
        tile = common.resolve_block("encode", (c, ell, d), "auto",
                                    enc_ops.DEFAULT_BLOCK, dev)
        reset_counters()
        t0 = time.perf_counter()
        got_x, got_y = enc_ops.encode_fleet(seeds, xs, ys, ws, c)
        torch.cuda.synchronize()
        keyed_s = time.perf_counter() - t0
        check(read_counters() == expect(encode=n)
              and enc_ops.COUNTER.tiles == {tuple(tile): n},
              f"keyed encode_fleet: launches {read_counters()} by tile "
              f"{enc_ops.COUNTER.tiles}")

        def g_source(i):
            g_i = torch.Generator(device=dev).manual_seed(seeds[i])
            return generator_matrix(g_i, c, ell, dtype=xs.dtype)

        want_x, want_y = encode_fleet_streamed(
            g_source, xs, ys, ws, c, enc_ref.encode_parity)
        got = torch.cat([got_x, got_y[:, None]], dim=1)
        want = torch.cat([want_x, want_y[:, None]], dim=1)
        bound = 2e-4 * float(want.abs().max())
        err, ok = allclose_report(got, want, 2e-4, bound)
        phase(f"keyed encode_fleet ({n} x {ell} x {d}, c={c}) [{card}]: "
              f"{n} launches at tile {tuple(tile)}, {keyed_s:.4f} s wall; "
              f"vs the plain streamed encode max_abs_err {err:.3e}, bound "
              f"2e-4*max|ref| = {bound:.3e}, allclose {ok}")
        check(ok and bool(torch.isfinite(got).all()),
              "the keyed encode_fleet disagrees with the plain encode")

        # (f) what a launch pays on the host to resolve "auto"
        m, d = TUNE_SHAPES["round_grad"]
        check(common.resolve_block("round_grad", (m, d), "auto", 0, x.device)
              == tune_cache.RESOLVED[("round_grad", (m, d), x.device,
                                      os.environ[tune_cache.CACHE_ENV])],
              "resolve_block did not memoize its answer")
        t0 = time.perf_counter()
        for _ in range(RESOLVE_CALLS):
            common.resolve_block("round_grad", (m, d), "auto", 0, x.device)
        resolve_us = 1e6 * (time.perf_counter() - t0) / RESOLVE_CALLS
        phase(f"resolve_block('auto') memoized [{card}]: {resolve_us:.3f} "
              f"us a call on the host ({RESOLVE_CALLS} calls)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    phase(f"phase 20 [{card}]: {seconds:.2f} s wall")
    return {"tuned": tuned, "keyed_err": err, "seconds": seconds,
            "resolve_us": resolve_us}


def auto_tile(family: str, shape: tuple, dev) -> list:
    """The tile `block="auto"` launches a kernel of `family` with at
    `shape`, as its C entry point takes it ([0]: a round-gradient
    kernel's own partition)."""
    from repro_torch.kernels.common import resolve_block
    from repro_torch.kernels.encode import ops as enc_ops

    if family in ("round_grad", "coded_grad"):
        return [int(resolve_block(family, shape, "auto", 0, dev))]
    if family == "encode_prng":  # its one tile, read from no cache
        return list(enc_ops.PRNG_BLOCK)
    return list(resolve_block(family, shape, "auto", enc_ops.DEFAULT_BLOCK,
                              dev))


def check_wide_round_grads(dev, errs: dict) -> None:
    """Phase 3's checks of kernels 1, 4, 5 and 6 past the row-resident
    width (the cluster route; kernel 4 at D = 8192 the two-launch one, as
    the library's `rg_route` and the wrapper's `route` both say): at
    WIDE_ROWS x D for D in WIDE_DS each kernel and its plain
    version against the float64 bound (`held_to_float64`), a relaunch
    bit-identical, the tier kernel at T = 1 and the least-squares kernel
    `torch.equal` to the flat one.  Its own generator, so the other
    checks' operands are the parent's."""
    from repro_torch.kernels.round_grad import ops as rg_ops
    from repro_torch.kernels.round_grad import ref as rg_ref

    gen = torch.Generator(device=dev).manual_seed(29)
    m, c = WIDE_ROWS, WIDE_PARITY
    worst = 0.0
    lib = rg_ops._dispatch(dev)
    for d in WIDE_DS:
        routes = {coded: rg_ops.ROUTES[lib.rg_route(d, coded)]
                  for coded in (0, 1)}
        phase(f"  D = {d}: route {routes[0]} (kernels 1, 5, 6), "
              f"{routes[1]} (kernel 4)")
        check(routes == {0: rg_ops.route(d), 1: rg_ops.route(d, coded=True)}
              and routes[0] != "resident",
              f"D = {d}: the library's routes {routes} are not the "
              "wrapper's")
        x = torch.randn((m, d), generator=gen, device=dev)
        y = torch.randn((m,), generator=gen, device=dev)
        w = torch.rand((m,), generator=gen, device=dev)
        w[::7] = 0.0
        beta = torch.randn((d,), generator=gen, device=dev)
        xp = torch.randn((c, d), generator=gen, device=dev)
        yp = torch.randn((c,), generator=gen, device=dev)
        wp = torch.rand((c,), generator=gen, device=dev)
        tier_of = torch.randint(0, HIER_TIERS, (m,), generator=gen,
                                device=dev)
        masks = (torch.arange(HIER_TIERS, device=dev)[:, None]
                 == tier_of[None, :]).float()
        calls = {
            "round_grad": (lambda: rg_ops.masked_round_gradient(
                x, y, w, beta), lambda: rg_ref.masked_round_gradient(
                x, y, w, beta), (x, y, w, beta, None)),
            "coded_round_grad": (lambda: rg_ops.coded_round_gradient(
                x, y, w, xp, yp, wp, beta),
                lambda: rg_ref.coded_round_gradient(x, y, w, xp, yp, wp,
                                                    beta),
                (torch.cat([x, xp]), torch.cat([y, yp]),
                 torch.cat([w, wp]), beta, None)),
            "tier_round_grad": (lambda: rg_ops.tier_masked_round_gradient(
                x, y, w, masks, beta),
                lambda: rg_ref.tier_masked_round_gradient(x, y, w, masks,
                                                          beta),
                (x, y, w, beta, masks)),
            "lsq_gradient": (lambda: rg_ops.lsq_gradient(x, y, beta),
                             lambda: rg_ref.lsq_gradient(x, y, beta),
                             (x, y, None, beta, None))}
        for name, (kernel, plain, exact) in calls.items():
            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            xs, ys_, ws, bs, ms = exact
            worst = max(worst, held_to_float64(
                f"{name} ({m}, {d}) past the row-resident width", got, want,
                xs, ys_, ws, bs, masks=ms))
            check(torch.equal(got, again), f"{name} at D = {d} not "
                  "deterministic")
        one = rg_ops.tier_masked_round_gradient(
            x, y, w, torch.ones((1, m), device=dev), beta)
        flat = rg_ops.masked_round_gradient(x, y, w, beta)
        lsq = rg_ops.lsq_gradient(x, y, beta)
        flat1 = rg_ops.masked_round_gradient(x, y, None, beta)
        torch.cuda.synchronize()
        phase(f"  D = {d}: tier T=1 torch.equal to flat "
              f"{torch.equal(one[0], flat)}; lsq torch.equal to flat at "
              f"w = None {torch.equal(lsq, flat1)}")
        check(torch.equal(one[0], flat), f"T = 1 != flat at D = {d}")
        check(torch.equal(lsq, flat1), f"lsq != flat at D = {d}")
    errs["round_grad_wide"] = worst


def probe_phase(dev, card: str, expect, reset_counters,
                read_counters) -> dict:
    """Phase 26: `repro_torch.coded_head_probe.run` at full width and
    depth with the launch counters from 0: kernel 8 in the frozen
    backbone, kernel 2 on the 12 parity encodes, kernel 1 at D = 4096 in
    both heads.  Then, outside the counted run: client 0's features
    against the plain backbone's, kernel 1 on the probe's own rows
    against the float64 bound, and kernels 1 and 8 timed at the probe's
    shapes."""
    from repro_torch import coded_head_probe as probe
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn import ref as fa_ref
    from repro_torch.kernels.round_grad import ops as rg_ops
    from repro_torch.kernels.round_grad import ref as rg_ref

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    out = probe.run(device=dev, seed=PROBE_SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    cfg, reps = out["cfg"], out["reports"]
    n, ell, d = out["feats"].shape
    seq = out["tokens"].shape[-1]
    check(cfg.name == DENSE_ARCH and cfg.n_layers == 36 and d == 4096,
          "the probe's backbone is not granite-8b at full width and depth")
    phase(f"probe [{card}]: {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}) features of {n} x {ell} sequences of "
          f"{seq} tokens, {wall:.3f} s wall ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in out["seconds"].items())
          + f"); peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"launches {launches}")
    phase(f"probe [{card}]: uncoded head NMSE "
          f"{reps['uncoded'].final_nmse():.3e} in "
          f"{reps['uncoded'].times[-1]:.0f} s simulated; coded head NMSE "
          f"{reps['cfl'].final_nmse():.3e} in {reps['cfl'].times[-1]:.0f} s "
          f"simulated (c = {probe.FIXED_C}); coding gain to "
          f"NMSE {out['target']:.3e}: {out['gain']:.3f}x")
    check(launches == expect(**PROBE_LAUNCHES),
          f"unexpected probe launch counts {launches}")
    by_instance = {fa_ops.INSTANCES[code]: n
                   for (code,), n in fa_ops.FLASH_COUNTER.tiles.items()}
    want = {fa_ops.instance(cfg.hd, s=seq):
            PROBE_LAUNCHES["causal_attention"]}
    phase(f"probe [{card}]: kernel 8's launches by the instance its "
          f"library reports {by_instance}")
    check(by_instance == want and next(iter(want)).startswith("short"),
          f"the probe's kernel-8 launches did not all take the short "
          f"instance: {by_instance}")
    for rep in reps.values():
        check(rep.nmse.shape == (probe.EPOCHS + 1,)
              and bool(np.all(np.isfinite(rep.nmse)))
              and rep.final_nmse() < rep.nmse[0],
              f"probe {rep.label}: NMSE trace not finite or not falling")
    check(bool(torch.isfinite(out["feats"]).all()), "probe features")
    check(np.isfinite(out["gain"]), "the probe's coding gain is not finite")

    # client 0's kernel features against the plain backbone's
    params, toks = out["params"], out["tokens"]
    before = read_counters()
    plain = probe.probe_features(cfg, params, toks[:1], use_kernel=False)
    check(read_counters() == before, "the plain backbone launched a kernel")
    got = out["backbone_feats"][:1]
    diff = float((got - plain).abs().max())
    top = max(1.0, float(got.abs().max()))
    phase(f"probe [{card}]: client 0's kernel-8 features against the plain "
          f"backbone's: max |difference| {diff:.3e} (max|feature| "
          f"{float(got.abs().max()):.3f}; bound stated in advance "
          f"{PROBE_FEATURE_RTOL} * max(1, max|feature|) = "
          f"{PROBE_FEATURE_RTOL * top:.3e})")
    check(diff <= PROBE_FEATURE_RTOL * top,
          "the probe's kernel features disagree with the plain backbone's")
    del params, toks, plain, got
    out.pop("params")
    out.pop("tokens")
    free_card()

    # kernel 1 on the probe's rows (the uncoded head's round gradient at
    # its final beta) against float64, then timed there
    x = out["feats"].reshape(n * ell, d).contiguous()
    y = out["ys"].reshape(n * ell).contiguous()
    beta = torch.as_tensor(reps["uncoded"].beta, device=dev)
    got = rg_ops.masked_round_gradient(x, y, None, beta)
    want = rg_ref.masked_round_gradient(x, y, None, beta)
    torch.cuda.synchronize()
    err = held_to_float64(f"round_grad on the probe's rows ({n * ell}, {d})",
                          got, want, x, y, None, beta)
    cold = cold_copies((x, y, None, beta))
    coef = (x @ beta - y).contiguous()
    terms = kernel_terms("round_grad", (n * ell, d), weighted=False)
    rg = {"shape": [n * ell, d], "launches": launches["round_grad"],
          "max_abs_err": err,
          "ms": time_ms(rg_ops.masked_round_gradient, cold),
          "ms_l2_warm": time_ms(rg_ops.masked_round_gradient,
                                [(x, y, None, beta)]),
          "plain_ms": time_ms(rg_ref.masked_round_gradient, cold),
          "library_ms": time_ms(torch.matmul, cold_copies((coef, x))),
          "bound_ms": 1e3 * terms["bound_s"], "bound_by": terms["bound_by"],
          "bytes": int(terms["bytes"])}
    del cold
    phase(f"time round_grad at the probe's shape ({n * ell}, {d}) w=None "
          f"[{card}]: kernel {rg['ms']!r} ms (L2 warm {rg['ms_l2_warm']!r} "
          f"ms), plain {rg['plain_ms']!r} ms, library r @ X "
          f"{rg['library_ms']!r} ms, bound {rg['bound_ms']!r} ms "
          f"({rg['bound_by']}, bytes {rg['bytes']})")

    # kernel 8 at the backbone's shape: all 768 sequences of 32 tokens
    shape = (n * ell, cfg.n_heads, cfg.n_kv_heads, seq, cfg.hd)
    gen = torch.Generator(device=dev).manual_seed(26)
    ops = flash_operands(gen, dev, *shape)
    got = fa_ops.causal_attention(*ops)
    plain = fa_ref.causal_attention(*ops)
    o64, bound = fa_ref.float64_reference_and_bound(*ops)
    torch.cuda.synchronize()
    ferr, ok = allclose_report(got, plain, 2e-4, 2e-4)
    share = {name: bound_share(o, o64, bound)
             for name, o in (("kernel", got), ("plain", plain))}
    lib_err = float((sdpa_expanded(*ops) - got).abs().max())
    del o64, bound, plain, got
    phase(f"check causal_attention at the probe's shape {list(shape)}: "
          f"max_abs_err vs plain {ferr:.3e}, within rtol 2e-4 / atol 2e-4 "
          f"{ok}; against float64 {share['kernel']:.4f} (kernel) and "
          f"{share['plain']:.4f} (plain) of the derived bound; library "
          f"max |difference| {lib_err:.3e}")
    check(ok and share["kernel"] <= 1.0 and share["plain"] <= 1.0,
          "causal_attention at the probe's shape")
    check(lib_err <= 2e-4, "the library call of kernel 8 at the probe's "
          "shape disagrees with the kernel")
    rep = shape[1] // shape[2]
    backend = sdpa_backend(ops[0], ops[1].repeat_interleave(rep, 1),
                           ops[2].repeat_interleave(rep, 1))
    cold = cold_copies(ops)
    terms = kernel_terms("causal_attention", shape)
    fa = {"shape": list(shape), "launches": launches["causal_attention"],
          "instance": fa_ops.instance(shape[4], s=seq),
          "max_abs_err": ferr,
          "ms": time_ms(fa_ops.causal_attention, cold),
          "ms_l2_warm": time_ms(fa_ops.causal_attention, [ops]),
          "plain_ms": time_ms(fa_ref.causal_attention, cold, calls=4),
          "library_ms": time_ms(sdpa_expanded, cold, calls=4),
          "library": "repeat_interleave + scaled_dot_product_attention"
                     f"(is_causal) on {backend}",
          "bound_ms": 1e3 * terms["bound_s"], "bound_by": terms["bound_by"],
          "flops": int(terms["flops"]), "bytes": int(terms["bytes"])}
    del cold, ops
    phase(f"time causal_attention at the probe's shape {list(shape)} "
          f"(the {fa['instance']} instance) [{card}]: kernel {fa['ms']!r} ms (L2 warm {fa['ms_l2_warm']!r} "
          f"ms), plain {fa['plain_ms']!r} ms, library {fa['library']} "
          f"{fa['library_ms']!r} ms, bound {fa['bound_ms']!r} ms "
          f"({fa['bound_by']}, flops {fa['flops']}, bytes {fa['bytes']})")
    free_card()
    fa["launches_by_instance"] = {k[0]: n for k, n in by_instance.items()}
    return {"launches": launches, "wall_s": wall,
            "seconds": out["seconds"], "gain": out["gain"],
            "feature_diff": diff, "round_grad": rg, "causal_attention": fa}


def mesh_phase(out, dev, card: str, expect, reset_counters, read_counters,
               devices=None) -> dict:
    """Phase 27: the lane and shard meshes over every local card (k =
    `torch.cuda.device_count()` where `devices` is None): MESH_LANES
    CodedFL lanes of phase 18's sweep through `run_sweep` and through
    `FedServeEngine(lane_width=MESH_WIDTH)` over the k cards, and phase
    9's 100 000-client `solve_fleet` over them, each against the same
    call on this one card (lanes bit-equal, t*, c and loads equal)."""
    from repro_torch.api import Session, make_strategy, plan_sweep, run_sweep
    from repro_torch.fleet import solve_fleet
    from repro_torch.launch.mesh import (lane_mesh_size, local_devices,
                                         make_shard_mesh)
    from repro_torch.plan import PlanRequest
    from repro_torch.serving import FedServeEngine
    from repro_torch.sim.network import mega_fleet, paper_fleet

    devices = local_devices(dev) if devices is None else list(devices)
    k = len(devices)
    data = out["data"]
    sessions = [
        Session(make_strategy("cfl", key_seed=100 + i, fixed_c=SWEEP_C,
                              include_upload_delay=False, use_kernel=True,
                              label=f"cfl_nu={nu:.3f}"),
                paper_fleet(float(nu), float(nu), seed=0), SWEEP_LR,
                MESH_EPOCHS, seed=i, device=dev)
        for i, nu in enumerate(np.linspace(0.0, 0.375, MESH_LANES))]
    reset_counters()
    states = plan_sweep(sessions, data)
    plan_counts = read_counters()
    walls, results, counts = {}, {}, {}
    for label, devs in (("one card", [dev]), (f"{k} cards", devices)):
        reset_counters()
        t0 = time.perf_counter()
        sweep = run_sweep(sessions, data, states=states, devices=devs)
        for d_ in devs:
            torch.cuda.synchronize(d_)
        walls[f"sweep {label}"] = time.perf_counter() - t0
        counts[f"sweep {label}"] = read_counters()
        reset_counters()
        t0 = time.perf_counter()
        engine = FedServeEngine(data, lane_width=MESH_WIDTH, chunk=25,
                                device=dev, devices=devs)
        served = engine.serve(sessions, states=states)
        walls[f"serve {label}"] = time.perf_counter() - t0
        counts[f"serve {label}"] = read_counters()
        results[label] = (sweep, served)
    same = all(same_report(a, b)
               for kind in (0, 1)
               for a, b in zip(results["one card"][kind],
                               results[f"{k} cards"][kind]))
    phase(f"mesh [{card}]: {k} card(s) {[str(d_) for d_ in devices]}; "
          f"{MESH_LANES} CodedFL lanes, {MESH_EPOCHS} epochs: sweep lane "
          f"mesh {lane_mesh_size(MESH_LANES, devices)}, serve group mesh "
          f"{lane_mesh_size(MESH_WIDTH, devices)} ({MESH_WIDTH} slots); "
          f"lanes bit-equal to the one-card calls {same}; walls "
          + ", ".join(f"{key} {v:.4f} s" for key, v in walls.items())
          + f"; launches {counts}")
    check(same, "a lane over the mesh differs from the one-card call")
    check(plan_counts == expect(encode=MESH_LANES * data.n),
          f"unexpected mesh plan_sweep launch counts {plan_counts}")
    for key, c in counts.items():
        check(c == expect(round_grad=MESH_LANES * MESH_EPOCHS),
              f"unexpected {key} launch counts {c}")

    fleet = mega_fleet(FLEET_N, d=FLEET_D, seed=0)
    sizes = np.random.default_rng(1).integers(POINTS_LO, POINTS_HI + 1,
                                              size=FLEET_N)
    req = PlanRequest(edge=fleet.edge, server=fleet.server,
                      data_sizes=sizes, c_up=FLEET_C_UP)
    plans = {}
    for label, devs in (("one card", [dev]), (f"{k} cards", devices)):
        t0 = time.perf_counter()
        plans[label] = solve_fleet(req, eps_rel=FLEET_EPS_REL, device=dev,
                                   devices=devs)
        walls[f"solve_fleet {label}"] = time.perf_counter() - t0
    a, b = plans["one card"], plans[f"{k} cards"]
    equal = a.t_star == b.t_star and a.c == b.c and \
        bool(np.array_equal(a.loads, b.loads))
    phase(f"mesh [{card}]: solve_fleet n={FLEET_N} over the shard mesh of "
          f"{len(make_shard_mesh(devices))} card(s): t*, c and loads equal "
          f"to the one-card solve {equal}; "
          f"{walls['solve_fleet one card']:.4f} s one card, "
          f"{walls[f'solve_fleet {k} cards']:.4f} s over the mesh")
    check(equal, "solve_fleet over the shard mesh differs from one card")
    return {"cards": k, "walls": walls,
            "launches": {"encode": plan_counts["encode"], "round_grad": sum(
                c["round_grad"] for c in counts.values())}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch import quickstart
    from repro_torch.api import CodedFL, Session, coding_gain
    from repro_torch.core.redundancy import _fleet_with_server
    from repro_torch.core.returns import optimal_loads
    from repro_torch.device import resolve_device
    from repro_torch.fleet import FleetTopology, HierarchicalCFL, HierState
    from repro_torch.kernels import build
    from repro_torch.kernels.coded_grad import ops as cg_ops
    from repro_torch.kernels.coded_grad import ref as cg_ref
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.encode import prng
    from repro_torch.kernels.encode import ref as enc_ref
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn import ref as fa_ref
    from repro_torch.kernels.round_grad import ops as rg_ops
    from repro_torch.kernels.round_grad import ref as rg_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.schemes import StochasticCodedFL

    t_start = time.perf_counter()
    # no user tile cache on the machine steers the run: block="auto"
    # reads an empty one and the committed defaults
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tiles_")
    atexit.register(shutil.rmtree, tune_dir, True)
    os.environ["REPRO_TORCH_TUNE_CACHE_DIR"] = tune_dir
    dev = resolve_device("cuda")  # also pins float32 products to full fp32
    card = card_line()
    phase(card)
    phase(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build(build.SOURCES)
    phase(f"build: {time.perf_counter() - t0:.2f} s wall for "
          + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in built.items()))
    # the kernels that must not spill: {source: instance-name prefixes}
    no_spill = {"flash_attn": ("flash_attn_kernel", "short_attn_kernel"),
                "encode": ("encode_kernel", "encode_prng_kernel"),
                "round_grad": ("",), "ssd": ("ssd_chunk_kernel",)}
    for name, info in built.items():
        log = info["log"]
        if name in no_spill and not log:  # found built: no report
            log = ptxas_log_again(name)
        spills = {k: v for k, v in ptxas_report(name, log).items()
                  if name in no_spill and k.startswith(no_spill[name])}
        if name in no_spill:
            check(spills and not any(spills.values()),
                  f"{name}.cu kernels spill registers: {spills}")
    from repro_torch.tune import cache as tune_cache
    committed = [k for k in tune_cache._load_entries(
        tune_cache.defaults_path()) if "|cuda-sm90|" in k]
    phase(f"  tile cache: the user cache {tune_cache.user_cache_path()} "
          f"(empty), the committed defaults with {len(committed)} "
          f"cuda-sm90 entries")
    phase(f"  kernel 8 dynamic shared memory at D = {FLASH_SHAPE[4]}: "
          f"{fa_ops.smem_bytes(FLASH_SHAPE[4])} bytes a CTA, two CTAs an SM; "
          f"at D = 64 ({fa_ops.instance(64)} instance): "
          f"{fa_ops.smem_bytes(64)} bytes a CTA, three CTAs an SM")
    lib8 = fa_ops._dispatch(dev)
    for d, s in itertools.product((8, 40, 64, 70, 72, 128),
                                  (1, 15, 16, 32, 33, 63, 64, 65, 2048)):
        check(all(fa_ops.INSTANCES[lib8.flash_attn_instance(d, vec, s)]
                  == fa_ops.instance(d, aligned=bool(vec), s=s)
                  for vec in (0, 1)),
              f"kernel 8's library and wrapper disagree on the instance of "
              f"D = {d}, S = {s}")
    hmma = {}  # {kernel: HMMA count}, by its source and mangled name
    for kernel, name, function in (
            ("kernel 8", "flash_attn", ""),
            ("kernel 2", "encode", "13encode_kernel"),
            ("kernel 3", "encode", "18encode_prng_kernel"),
            ("kernel 7", "ssd", "")):
        hmma[kernel] = sass_count(build.library_path(name), "HMMA",
                                  function)
        phase(f"  {kernel} SASS ({name}.cu): {hmma[kernel]} HMMA "
              "instructions" if hmma[kernel] is not None else
              f"  {kernel} SASS: no cuobjdump beside nvcc, HMMA not "
              "counted")
        check(hmma[kernel] is None or hmma[kernel] > 0,
              f"{kernel} issues no HMMA instruction")

    # -- 3. kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    rg_cases = {"coded": (5632, 500, True), "uncoded": (7200, 500, False)}
    rg_inputs = {}
    for label, (m, d, weighted) in rg_cases.items():
        x = torch.randn((m, d), generator=gen, device=dev)
        y = torch.randn((m,), generator=gen, device=dev)
        w = torch.rand((m,), generator=gen, device=dev) if weighted else None
        if w is not None:
            w[::7] = 0.0  # zero-weight rows, as packing padding and misses
        beta = torch.randn((d,), generator=gen, device=dev)
        rg_inputs[label] = (x, y, w, beta)
        got = rg_ops.masked_round_gradient(x, y, w, beta)
        again = rg_ops.masked_round_gradient(x, y, w, beta)
        want = rg_ref.masked_round_gradient(x, y, w, beta)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=1e-3, atol=1e-6)
        worst = float(((got - want).abs()
                       / (1e-6 + 1e-3 * want.abs())).max())
        wdesc = "rand" if weighted else "None"
        phase(f"check round_grad {label} ({m}, {d}) w={wdesc}: max_abs_err "
              f"{err:.3e} (|ref| max {float(want.abs().max()):.3e}) "
              f"allclose(rtol 1e-3, atol 1e-6) {ok}, worst element at "
              f"{worst:.3f} of its bound; "
              f"bit-identical relaunch {torch.equal(got, again)}")
        check(ok, f"round_grad {label} disagrees with its plain version")
        check(torch.equal(got, again), f"round_grad {label} not deterministic")
        errs[f"round_grad_{label}"] = err
    c, ell, d1 = 2016, 300, 501
    g = torch.randn((c, ell), generator=gen, device=dev)
    w_enc = torch.rand((ell,), generator=gen, device=dev)
    x_enc = torch.randn((ell, d1), generator=gen, device=dev)
    got = enc_ops.encode_parity(g, w_enc, x_enc)
    again = enc_ops.encode_parity(g, w_enc, x_enc)
    want = enc_ref.encode_parity(g, w_enc, x_enc)
    p64, p_bound = enc_ops.float64_reference_and_bound(g, w_enc, x_enc)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    bound = 2e-4 * float(want.abs().max())
    ok = torch.allclose(got, want, rtol=2e-4, atol=bound)
    enc_share = {name: bound_share(p, p64, p_bound)
                 for name, p in (("kernel", got), ("plain", want))}
    del p64, p_bound
    phase(f"check encode ({c}, {ell}, {d1}): max_abs_err {err:.3e} "
          f"bound 2e-4*max|ref| = {bound:.3e}, allclose {ok}; against "
          f"float64 the worst element at {enc_share['kernel']:.4f} (kernel) "
          f"and {enc_share['plain']:.4f} (plain) of the stated bound 1.01 "
          f"(L + 20) u |G| |diag(w) X|; bit-identical relaunch "
          f"{torch.equal(got, again)}")
    check(ok, "encode disagrees with its plain version")
    check(enc_share["kernel"] <= 1.0 and enc_share["plain"] <= 1.0,
          "encode outside its float64 bound")
    check(torch.equal(got, again), "encode not deterministic")
    errs["encode"] = err

    # the coded kernel: 7200 systematic + 2016 parity rows (the SCFL main
    # path's dense layout), per-row and scalar parity weights, the parity
    # stream alone (systematic weights 0), and c = 0.  The per-row parity
    # weights are the Bernoulli mask over rho, of order 1 like the
    # systematic ones, so a dropped or misplaced parity row shows.
    m, c_par, d = 7200, 2016, 500
    x = torch.randn((m, d), generator=gen, device=dev)
    y = torch.randn((m,), generator=gen, device=dev)
    w = (torch.rand((m,), generator=gen, device=dev) < 0.85).float()
    xp = torch.randn((c_par, d), generator=gen, device=dev)
    yp = torch.randn((c_par,), generator=gen, device=dev)
    wp = (torch.rand((c_par,), generator=gen, device=dev) < SCFL_RHO) \
        .float() / SCFL_RHO
    beta = torch.randn((d,), generator=gen, device=dev)
    coded_inputs = (x, y, w, xp, yp, wp, beta)
    for label, w_sys, w_par in (
            ("rows", w, wp),
            ("scalar", w, torch.tensor(0.37, device=dev)),
            ("rows, parity alone", torch.zeros_like(w), wp)):
        before = (rg_ops.COUNTER.launches, rg_ops.CODED_COUNTER.launches)
        got = rg_ops.coded_round_gradient(x, y, w_sys, xp, yp, w_par, beta)
        again = rg_ops.coded_round_gradient(x, y, w_sys, xp, yp, w_par,
                                            beta)
        plain = rg_ref.coded_round_gradient(x, y, w_sys, xp, yp, w_par,
                                            beta)
        torch.cuda.synchronize()
        check((rg_ops.COUNTER.launches, rg_ops.CODED_COUNTER.launches)
              == (before[0], before[1] + 2), "coded kernel launch count")
        err = held_to_float64(
            f"coded_round_grad ({m} + {c_par}, {d}) w_par={label}", got,
            plain, torch.cat([x, xp]), torch.cat([y, yp]),
            torch.cat([w_sys, torch.broadcast_to(w_par, (c_par,))]), beta)
        phase(f"  bit-identical relaunch {torch.equal(got, again)}")
        check(torch.equal(got, again), "coded kernel not deterministic")
        errs.setdefault("coded_round_grad", err)
    empty = torch.zeros((0, d), device=dev)
    before = (rg_ops.COUNTER.launches, rg_ops.CODED_COUNTER.launches)
    got = rg_ops.coded_round_gradient(x, y, w, empty, empty[:, 0], 1.0,
                                      beta)
    flat = rg_ops.masked_round_gradient(x, y, w, beta)
    torch.cuda.synchronize()
    check((rg_ops.COUNTER.launches, rg_ops.CODED_COUNTER.launches)
          == (before[0] + 2, before[1]), "c = 0 must run the flat kernel")
    check(torch.equal(got, flat), "c = 0 differs from the flat kernel")
    phase("check coded_round_grad c = 0: ran the flat kernel, equal to it")

    # the tier kernel at the packed §IV layout, T = 3 and T = 8, and T = 1
    m = 5632
    x, y, w = x[:m].contiguous(), y[:m].contiguous(), w[:m].contiguous()
    tier_inputs = {}
    for nt in (HIER_TIERS, 8):
        tier_of = torch.randint(0, nt, (m,), generator=gen, device=dev)
        masks = (torch.arange(nt, device=dev)[:, None]
                 == tier_of[None, :]).float()
        tier_inputs[nt] = (x, y, w, masks, beta)
        before = rg_ops.TIER_COUNTER.launches
        got = rg_ops.tier_masked_round_gradient(x, y, w, masks, beta)
        again = rg_ops.tier_masked_round_gradient(x, y, w, masks, beta)
        plain = rg_ref.tier_masked_round_gradient(x, y, w, masks, beta)
        torch.cuda.synchronize()
        check(rg_ops.TIER_COUNTER.launches == before + 2,
              "tier kernel launch count")
        err = held_to_float64(f"tier_round_grad ({m}, {d}) T={nt}", got,
                              plain, x, y, w, beta, masks=masks)
        phase(f"  bit-identical relaunch {torch.equal(got, again)}")
        check(torch.equal(got, again), "tier kernel not deterministic")
        if nt == HIER_TIERS:
            errs["tier_round_grad"] = err
    for label, wt in (("w", w), ("w=None", None)):
        one = rg_ops.tier_masked_round_gradient(
            x, y, wt, torch.ones((1, m), device=dev), beta)
        flat = rg_ops.masked_round_gradient(x, y, wt, beta)
        torch.cuda.synchronize()
        phase(f"check tier_round_grad T=1 ({label}) torch.equal to the "
              f"flat kernel: {torch.equal(one[0], flat)}")
        check(torch.equal(one[0], flat), "T = 1 tier kernel != flat kernel")
    # the in-kernel-generator encode and the least-squares gradient
    prng_inputs = check_prng_kernel(dev, gen, errs)
    lsq_inputs = check_lsq_kernel(dev, gen, errs)
    # the SSD intra-chunk step (kernel 7) at synthetic operands
    ssd_inputs, ssd_hybrid_inputs = check_ssd_kernel(dev, gen, errs)
    # causal flash attention (kernel 8) at synthetic operands
    flash_inputs, flash_hybrid_inputs, flash_whisper_inputs = \
        check_flash_kernel(dev, gen, errs)
    # kernels 1, 4, 5 and 6 past the row-resident width
    check_wide_round_grads(dev, errs)

    counters = {"round_grad": rg_ops.COUNTER,
                "coded_round_grad": rg_ops.CODED_COUNTER,
                "tier_round_grad": rg_ops.TIER_COUNTER,
                "encode": enc_ops.COUNTER,
                "encode_prng": enc_ops.PRNG_COUNTER,
                "lsq_gradient": cg_ops.COUNTER,
                "ssd_chunk": ssd_ops.SSD_COUNTER,
                "causal_attention": fa_ops.FLASH_COUNTER}

    def reset_counters():
        for counter in counters.values():
            counter.reset()

    def read_counters() -> dict:
        return {k: counter.launches for k, counter in counters.items()}

    def expect(**launched) -> dict:
        return {**dict.fromkeys(counters, 0), **launched}

    # -- 4. the main path ------------------------------------------------
    reset_counters()
    t0 = time.perf_counter()
    out = quickstart.run(epochs=600, device=dev)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = read_counters()
    plan, res_u, res_c = out["plan"], out["uncoded"], out["coded"]
    gain = coding_gain(res_u, res_c, quickstart.TARGET)
    phase(f"main path: {main_s:.2f} s wall; plan c={plan.c} "
          f"t*={plan.t_star!r} loads={plan.loads.tolist()}")
    phase(f"main path: uncoded final NMSE {res_u.final_nmse():.3e} at "
          f"{res_u.times[-1]:.1f} s simulated; coded final NMSE "
          f"{res_c.final_nmse():.3e} at {res_c.times[-1]:.1f} s simulated; "
          f"coding gain to NMSE<={quickstart.TARGET}: {gain:.3f}x")
    phase(f"main path launches: {launches}")
    phase("main path phases (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in out["seconds"].items()))
    check(plan.c == 2016, "plan c != 2016")
    check(abs(plan.t_star - SEC4_T_STAR) <= 1e-3 * SEC4_T_STAR,
          "plan t* off by more than rtol 1e-3")
    check(plan.loads.tolist() == SEC4_LOADS, "plan loads differ")
    fleet = out["fleet"]
    host_loads, _ = optimal_loads(
        _fleet_with_server(fleet.edge, fleet.server),
        np.concatenate([np.full(24, 300), [2016]]), plan.t_star)
    check(host_loads[:-1].tolist() == plan.loads.tolist(),
          "device loads differ from the float64 host argmax at t*")
    for rep in (res_u, res_c):
        check(rep.nmse.shape == (601,) and bool(np.all(np.isfinite(rep.nmse))),
              f"{rep.label}: NMSE trace not finite or wrong shape")
    check(gain >= MIN_GAIN, f"coding gain {gain:.3f} below {MIN_GAIN}")
    check(launches == expect(round_grad=1200, encode=24),
          f"unexpected launch counts {launches}")

    # -- 5. the same coded run on the reference gradient path ------------
    strategy = CodedFL(key=1, fixed_c=plan.c, include_upload_delay=False,
                       redundancy_plan=plan, grad_path="reference")
    before = read_counters()
    res_r = Session(strategy, fleet, quickstart.LR, 600, device=dev).run(
        out["data"], rng=np.random.default_rng(0), state=out["state"])
    check(read_counters() == before, "the reference path launched a kernel")
    rel = float(np.max(np.abs(res_r.nmse - res_c.nmse) / np.abs(res_r.nmse)))
    phase(f"fused vs reference coded trace: max rel NMSE diff {rel:.3e} "
          f"(bound 1e-4); times identical "
          f"{bool(np.array_equal(res_r.times, res_c.times))}")
    check(np.allclose(res_c.nmse, res_r.nmse, rtol=1e-4, atol=0.0),
          "fused and reference coded traces disagree")
    check(np.array_equal(res_r.times, res_c.times), "clocks differ")

    # -- 6. the StochasticCodedFL path -----------------------------------
    data = out["data"]
    scfl = StochasticCodedFL(key=1, fixed_c=quickstart.FIXED_C,
                             noise_multiplier=SCFL_SIGMA,
                             sample_frac=SCFL_RHO,
                             include_upload_delay=False)
    reset_counters()
    t0 = time.perf_counter()
    scfl_sess = Session(scfl, fleet, quickstart.LR, 600, device=dev)
    scfl_state = scfl_sess.plan(data)
    torch.cuda.synchronize()
    scfl_plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_s = scfl_sess.run(data, rng=np.random.default_rng(0),
                          state=scfl_state)
    torch.cuda.synchronize()
    scfl_run_s = time.perf_counter() - t0
    scfl_launches = read_counters()
    splan = scfl_state.plan
    phase(f"scfl: plan+encode {scfl_plan_s:.4f} s, 600 epochs "
          f"{scfl_run_s:.4f} s wall; plan c={splan.c} t*={splan.t_star!r} "
          f"srv_weight={scfl_state.srv_weight!r} "
          f"loads={splan.loads.tolist()}")
    phase(f"scfl: final NMSE {res_s.final_nmse():.3e} at "
          f"{res_s.times[-1]:.1f} s simulated; NMSE rises in "
          f"{int(np.sum(np.diff(res_s.nmse) > 0))} of 600 epochs")
    phase(f"scfl launches: {scfl_launches}")
    check(splan.c == 2016, "scfl plan c != 2016")
    check(scfl_state.srv_weight == SCFL_SRV_WEIGHT, "scfl srv_weight")
    host_loads, _ = optimal_loads(
        _fleet_with_server(fleet.edge, fleet.server),
        np.concatenate([np.full(24, 300), [2016]]), splan.t_star)
    check(host_loads[:-1].tolist() == splan.loads.tolist(),
          "scfl loads differ from the float64 host argmax at t*")
    check(splan.loads.tolist() == SEC4_SCFL_LOADS, "scfl plan loads differ")
    check("sys_x" not in scfl.device_state(scfl_state, data),
          "the §IV SCFL plan should take the dense fused layout")
    check_trace(res_s)
    check(scfl_launches == expect(coded_round_grad=600, encode=24),
          f"unexpected scfl launch counts {scfl_launches}")
    before = read_counters()
    res_sr = Session(dataclasses.replace(scfl, grad_path="reference"),
                     fleet, quickstart.LR, 600, device=dev).run(
        data, rng=np.random.default_rng(0), state=scfl_state)
    check(read_counters() == before, "the reference path launched a kernel")
    check_against_reference("scfl", res_s, res_sr)

    # -- 7. the HierarchicalCFL path -------------------------------------
    # phase 4's coded strategy (fused), over its plan and encoded state
    coded = CodedFL(key=1, fixed_c=plan.c, include_upload_delay=False,
                    use_kernel=True, redundancy_plan=plan)
    reports = {}
    for nt in (HIER_TIERS, 1):
        topo = FleetTopology.uniform(24, nt)
        hier = HierarchicalCFL(coded, topo)
        reset_counters()
        t0 = time.perf_counter()
        reports[nt] = Session(hier, fleet, quickstart.LR, 600,
                              device=dev).run(
            data, rng=np.random.default_rng(0),
            state=HierState(out["state"], topo))
        torch.cuda.synchronize()
        hier_s = time.perf_counter() - t0
        counts = read_counters()
        phase(f"hierarchical T={nt}: 600 epochs {hier_s:.4f} s wall; final "
              f"NMSE {reports[nt].final_nmse():.3e}; launches {counts}")
        check_trace(reports[nt])
        check(counts == expect(tier_round_grad=600),
              f"unexpected hierarchical launch counts {counts}")
        if nt == HIER_TIERS:
            hier_launches, hier_run_s = counts, hier_s
            before = read_counters()
            res_hr = Session(
                HierarchicalCFL(dataclasses.replace(
                    coded, use_kernel=False, grad_path="reference"),
                    topo), fleet, quickstart.LR, 600, device=dev).run(
                data, rng=np.random.default_rng(0),
                state=HierState(out["state"], topo))
            check(read_counters() == before,
                  "the reference path launched a kernel")
            check_against_reference(f"hierarchical T={nt}", reports[nt],
                                    res_hr)
    single_equal = bool(np.array_equal(reports[1].nmse, res_c.nmse))
    phase(f"hierarchical T=1 NMSE trace bit-equal to the flat coded trace "
          f"of phase 4: {single_equal}")
    check(single_equal, "T = 1 hierarchical trace differs from the flat one")
    check(np.array_equal(reports[1].times, res_c.times), "T = 1 clocks")

    # -- 8. the fleet path at the §IV width ------------------------------
    fleet_width = fleet_width_phase(out, reset_counters, read_counters)

    # -- 9. the fleet path at fleet scale --------------------------------
    fleet_scale = fleet_scale_phase(dev, reset_counters, read_counters)

    # -- 10. the legacy path ----------------------------------------------
    legacy = legacy_phase(out, dev, reset_counters, read_counters)

    # -- 11. serving mamba2-1.3b at full width ----------------------------
    serve = serve_phase(dev, card, expect, reset_counters, read_counters)
    # its 5.8 GB of parameters went with the phase's frame
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"after phase 11: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          f"allocated on the card")

    # -- 12. serving granite-8b at full width -----------------------------
    torch.cuda.reset_peak_memory_stats()
    dense = dense_serve_phase(dev, card, expect, reset_counters,
                              read_counters)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13. timing ------------------------------------------------------
    records = []
    for label in ("coded", "uncoded"):
        x, y, w, beta = rg_inputs[label]
        m, d = x.shape
        cold = cold_copies((x, y, w, beta))
        coef = ((x @ beta - y) * (1.0 if w is None else w)).contiguous()
        ms = time_ms(rg_ops.masked_round_gradient, cold)
        warm = time_ms(rg_ops.masked_round_gradient, [(x, y, w, beta)])
        plain = time_ms(rg_ref.masked_round_gradient, cold)
        lib = time_ms(torch.matmul, cold_copies((coef, x)))
        del cold
        terms = kernel_terms("round_grad", (m, d), weighted=w is not None)
        n_bytes, bound_ms = int(terms["bytes"]), 1e3 * terms["bound_s"]
        phase(f"time round_grad {label} ({m}, {d}): kernel {ms!r} ms "
              f"(L2 warm {warm!r} ms), plain {plain!r} ms, library "
              f"(r*w) @ X {lib!r} ms, bound {bound_ms!r} ms "
              f"(bytes {n_bytes})")
        records.append((label, m, d, ms, warm, plain, lib, bound_ms))
    cold = cold_copies((g, w_enc, x_enc))
    enc_ms = time_ms(enc_ops.encode_parity, cold)
    enc_warm = time_ms(enc_ops.encode_parity, [(g, w_enc, x_enc)])
    enc_plain = time_ms(enc_ref.encode_parity, cold)
    wx = (w_enc[:, None] * x_enc).contiguous()
    enc_lib = time_ms(torch.matmul, cold_copies((g, wx)))
    del cold
    # 3xTF32: three TF32 tensor-core products per float32 product
    terms = kernel_terms("encode", (c, ell, d1))
    enc_flops, enc_bytes = int(terms["flops"]), int(terms["bytes"])
    enc_bound_by, enc_bound = terms["bound_by"], 1e3 * terms["bound_s"]
    enc_bound_fp32 = 1e3 * terms["t_fp32"]
    enc_shape = [c, ell, d1]
    phase(f"time encode ({c}, {ell}, {d1}) [{card}]: kernel {enc_ms!r} ms "
          f"(L2 warm {enc_warm!r} ms), plain {enc_plain!r} ms, library "
          f"G @ (w X) {enc_lib!r} ms, bound {enc_bound!r} ms "
          f"({enc_bound_by}, 3xTF32 at 495 TFLOP/s: flops {enc_flops}, "
          f"bytes {enc_bytes}; on the float32 FMA pipes {enc_bound_fp32!r} "
          f"ms)")

    # the coded kernel at the SCFL path's shapes: 7200 + 2016 rows of 500
    x, y, w, xp, yp, wp, beta = coded_inputs
    m, c_par, d = x.shape[0], xp.shape[0], x.shape[1]
    cold = cold_copies(coded_inputs)
    coded_ms = time_ms(rg_ops.coded_round_gradient, cold)
    coded_warm = time_ms(rg_ops.coded_round_gradient, [coded_inputs])
    coded_plain = time_ms(rg_ref.coded_round_gradient, cold)
    del cold
    coef_s = ((x @ beta - y) * w).contiguous()
    coef_p = ((xp @ beta - yp) * wp).contiguous()
    coded_lib = time_ms(lambda cs, xs_, cp, xp_: cs @ xs_ + cp @ xp_,
                        cold_copies((coef_s, x, coef_p, xp)))
    terms = kernel_terms("coded_round_grad", (m, c_par, d))
    coded_bytes, coded_bound = int(terms["bytes"]), 1e3 * terms["bound_s"]
    coded_bound_by = terms["bound_by"]
    phase(f"time coded_round_grad ({m} + {c_par}, {d}): kernel "
          f"{coded_ms!r} ms (L2 warm {coded_warm!r} ms), plain "
          f"{coded_plain!r} ms, library coef_s @ X + coef_p @ X_par "
          f"{coded_lib!r} ms, bound {coded_bound!r} ms "
          f"(bytes {coded_bytes})")

    # the tier kernel at the hierarchical path's shapes: (5632, 500), T = 3
    x, y, w, masks, beta = tier_inputs[HIER_TIERS]
    m, d, nt = x.shape[0], x.shape[1], masks.shape[0]
    cold = cold_copies(tier_inputs[HIER_TIERS])
    tier_ms = time_ms(rg_ops.tier_masked_round_gradient, cold)
    tier_warm = time_ms(rg_ops.tier_masked_round_gradient,
                        [tier_inputs[HIER_TIERS]])
    tier_plain = time_ms(rg_ref.tier_masked_round_gradient, cold)
    del cold
    coef_masks = (((x @ beta - y) * w)[None, :] * masks).contiguous()
    tier_lib = time_ms(torch.matmul, cold_copies((coef_masks, x)))
    terms = kernel_terms("tier_round_grad", (m, d, nt))
    tier_bytes, tier_bound = int(terms["bytes"]), 1e3 * terms["bound_s"]
    tier_bound_by = terms["bound_by"]
    tier_shape = [m, d, nt]
    phase(f"time tier_round_grad ({m}, {d}) T={nt}: kernel {tier_ms!r} ms "
          f"(L2 warm {tier_warm!r} ms), plain {tier_plain!r} ms, library "
          f"(coef * masks) @ X {tier_lib!r} ms, bound {tier_bound!r} ms "
          f"(bytes {tier_bytes})")

    # the in-kernel-generator encode at (2016, 300, 501), both kinds
    key, w_p, x_p = prng_inputs
    c, (ell, d1) = 2016, x_p.shape
    prng_shape = [c, ell, d1]
    prng_rec = {}
    for kind in ("normal", "bernoulli"):
        def prng_kernel(w_, x_, kind=kind):
            return enc_ops.encode_parity_prng(key, w_, x_, c, kind)

        def prng_plain(w_, x_, kind=kind):
            return enc_ref.encode_parity_prng(key, w_, x_, c, kind)

        cold = cold_copies((w_p, x_p))
        p_ms = time_ms(prng_kernel, cold)
        p_warm = time_ms(prng_kernel, [(w_p, x_p)])
        # the plain generator is ~220 launches a call: 4 calls a run
        p_plain = time_ms(prng_plain, cold, calls=4)
        del cold
        g_mat = prng.generator_values(key, c, ell, kind, device=dev)
        p_lib = time_ms(lambda g_, w_, x_: g_ @ (w_[:, None] * x_),
                        cold_copies((g_mat, w_p, x_p)))
        del g_mat
        # one hash per generator entry: the least work (the kernel's CTAs
        # span 512 columns, so at d1 <= 512 it hashes each entry once);
        # 3xTF32: three TF32 tensor-core products per float32 product
        terms = kernel_terms("encode_prng", (c, ell, d1))
        p_flops, p_bytes = int(terms["flops"]), int(terms["bytes"])
        p_hash_ops = HASH_INT_OPS * c * ell
        bound_by = terms["bound_by"]
        p_bound_fp32 = 1e3 * max(terms["t_fp32"], terms["pipes"]["int32"])
        prng_rec[kind] = {"ms": p_ms, "warm": p_warm, "plain": p_plain,
                          "lib": p_lib, "bound": 1e3 * terms["bound_s"],
                          "bound_by": bound_by}
        phase(f"time encode_prng {kind} ({c}, {ell}, {d1}) [{card}]: "
              f"kernel {p_ms!r} ms (L2 warm {p_warm!r} ms), plain "
              f"{p_plain!r} ms, library G @ (w X) on a materialized G (no "
              f"generation) {p_lib!r} ms, bound {prng_rec[kind]['bound']!r} "
              f"ms ({bound_by}, the larger of 3xTF32 at 495 TFLOP/s and "
              f"the hashes at the INT32 rate: flops {p_flops}, hash "
              f"integer ops {p_hash_ops}, bytes {p_bytes}; on the float32 "
              f"FMA pipes {p_bound_fp32!r} ms)")

    # the least-squares gradient at the §IV parity block (2016, 500)
    a, y, beta = lsq_inputs
    lsq_m, lsq_d = a.shape
    cold = cold_copies(lsq_inputs)
    lsq_ms = time_ms(cg_ops.lsq_gradient, cold)
    lsq_warm = time_ms(cg_ops.lsq_gradient, [lsq_inputs])
    lsq_plain = time_ms(cg_ref.lsq_gradient, cold)
    lsq_lib = time_ms(lambda a_, y_, b_: (a_ @ b_ - y_) @ a_, cold)
    del cold
    terms = kernel_terms("coded_grad", (lsq_m, lsq_d))
    lsq_bytes, lsq_bound = int(terms["bytes"]), 1e3 * terms["bound_s"]
    lsq_bound_by = terms["bound_by"]
    phase(f"time lsq_gradient ({lsq_m}, {lsq_d}): kernel {lsq_ms!r} ms "
          f"(L2 warm {lsq_warm!r} ms), plain {lsq_plain!r} ms, library "
          f"(A @ beta - y) @ A {lsq_lib!r} ms, bound {lsq_bound!r} ms "
          f"(bytes {lsq_bytes})")
    # kernel 7 at the serving shape (a 2048-token prefill, one group)
    B, nc, Q, H, P, N = SSD_SHAPE
    G = ssd_inputs[3].shape[3]
    cold = cold_copies(ssd_inputs)
    ssd_ms = time_ms(ssd_ops.ssd_chunk, cold)
    ssd_warm = time_ms(ssd_ops.ssd_chunk, [ssd_inputs])
    del cold
    # the plain version and the library expression allocate ~1 GB of
    # intermediates a call and take ~14 ms of host time: 4 calls a run
    cold = cold_copies(per_head(ssd_inputs))
    ssd_plain = time_ms(ssd_ref.ssd_chunk_reference, cold, calls=4)
    del cold
    hm = head_major(ssd_inputs)
    lib_y, lib_s = ssd_library(*hm)
    got_y, got_s = ssd_ops.ssd_chunk(*ssd_inputs)
    lib_err = max(float((lib_y - got_y.movedim(3, 2).reshape(lib_y.shape))
                        .abs().max()),
                  float((lib_s - got_s.reshape(lib_s.shape)).abs().max()))
    del lib_y, lib_s
    gm = group_major(ssd_inputs)
    lib_y, lib_s = ssd_library_grouped(*gm)
    lib_err = max(lib_err,
                  float((lib_y - got_y.reshape(B * nc, Q, G, H // G, P)
                         .movedim(1, 3)).abs().max()),
                  float((lib_s - got_s.reshape(lib_s.shape)).abs().max()))
    lib_bound = 1e-4 * max(1.0, float(got_y.abs().max()),
                           float(got_s.abs().max()))
    check(lib_err <= lib_bound, "a library expression of kernel 7 "
          f"disagrees with the kernel: {lib_err:.3e} > {lib_bound:.3e}")
    del lib_y, lib_s, got_y, got_s
    ssd_lib = time_ms(ssd_library, cold_copies(hm), calls=4)
    del hm
    ssd_lib_grouped = time_ms(ssd_library_grouped, cold_copies(gm), calls=4)
    del gm
    # the least work: C B^T once per (chunk, group) over its causal half,
    # then per head the causal half of the product with dt x and the
    # state; beside it the count with the scores once per head (the work
    # of the head-major library expression)
    tri = Q * (Q + 1) // 2
    ssd_flops_per_head = B * nc * H * (tri * 2 * (N + P) + 2 * Q * P * N)
    # 3xTF32: three TF32 tensor-core products per float32 product
    terms = kernel_terms("ssd_chunk", (B, nc, Q, H, P, N, G))
    ssd_flops, ssd_bytes = int(terms["flops"]), int(terms["bytes"])
    ssd_bound_by, ssd_bound = terms["bound_by"], 1e3 * terms["bound_s"]
    ssd_bound_fp32 = 1e3 * terms["t_fp32"]
    ssd_bound_per_head = 1e3 * ssd_flops_per_head / FP32_FLOPS_PER_S
    phase(f"time ssd_chunk {list(SSD_SHAPE)} G={G} [{card}]: kernel "
          f"{ssd_ms!r} ms (L2 warm {ssd_warm!r} ms), plain {ssd_plain!r} "
          f"ms, library matmul + tril on head-major views {ssd_lib!r} ms, "
          f"with C B^T once per group {ssd_lib_grouped!r} ms (max "
          f"|library - kernel| {lib_err:.3e}), bound {ssd_bound!r} ms "
          f"({ssd_bound_by}, 3xTF32 at 495 TFLOP/s: flops {ssd_flops} with "
          f"the scores once per group, bytes {ssd_bytes}; on the float32 "
          f"FMA pipes {ssd_bound_fp32!r} ms; the scores once per head "
          f"{ssd_flops_per_head} flops, {ssd_bound_per_head!r} ms on the "
          f"FMA pipes)")
    # kernel 8 at the serving shape (a 2048-token granite-8b prefill)
    B, Hq, Hkv, S, D = FLASH_SHAPE
    cold = cold_copies(flash_inputs)
    flash_ms = time_ms(fa_ops.causal_attention, cold)
    flash_warm = time_ms(fa_ops.causal_attention, [flash_inputs])
    # the plain version materializes (B, Hq, S, S) float32 scores, 537 MB,
    # and several like it a call: 4 calls a run
    flash_plain = time_ms(fa_ref.causal_attention, cold, calls=4)
    # the library yardstick: key/value heads expanded to Hq, then SDPA,
    # the expansion timed with it; the grouped call beside it
    rep = Hq // Hkv
    q0, k0, v0 = flash_inputs
    backend = sdpa_backend(q0, k0.repeat_interleave(rep, 1),
                           v0.repeat_interleave(rep, 1))
    gqa_backend = sdpa_backend(*flash_inputs)
    got = fa_ops.causal_attention(*flash_inputs)
    lib_err = 0.0
    for lib_fn in (sdpa_expanded, sdpa_gqa):
        lib_err = max(lib_err, float((lib_fn(*flash_inputs) - got)
                                     .abs().max()))
    check(lib_err <= 2e-4, "the library call of kernel 8 disagrees with the "
          f"kernel: {lib_err:.3e}")
    del got
    flash_lib = time_ms(sdpa_expanded, cold, calls=4)
    flash_lib_gqa = time_ms(sdpa_gqa, cold, calls=4)
    del cold
    # 3xTF32: three TF32 tensor-core products per float32 product
    terms = kernel_terms("causal_attention", FLASH_SHAPE)
    flash_flops, flash_bytes = int(terms["flops"]), int(terms["bytes"])
    flash_bound_by, flash_bound = terms["bound_by"], 1e3 * terms["bound_s"]
    flash_bound_fp32 = 1e3 * terms["t_fp32"]
    phase(f"time causal_attention {list(FLASH_SHAPE)} [{card}]: kernel "
          f"{flash_ms!r} ms (L2 warm {flash_warm!r} ms), plain "
          f"{flash_plain!r} ms, library repeat_interleave + "
          f"scaled_dot_product_attention(is_causal) {flash_lib!r} ms on "
          f"{backend} (with enable_gqa instead, {flash_lib_gqa!r} ms on "
          f"{gqa_backend}; max |library - kernel| {lib_err:.3e}), bound "
          f"{flash_bound!r} ms ({flash_bound_by}, 3xTF32 at 495 TFLOP/s: "
          f"flops {flash_flops}, bytes {flash_bytes}; on the float32 FMA "
          f"pipes {flash_bound_fp32!r} ms)")
    hybrid_times = time_hybrid_shapes(ssd_hybrid_inputs, flash_hybrid_inputs,
                                      card)
    whisper_time = time_flash(flash_whisper_inputs,
                              FLASH_CASES["whisper-tiny serving shape"],
                              "whisper-tiny", card)
    del ssd_hybrid_inputs, flash_hybrid_inputs, flash_whisper_inputs
    # kernel 8 at the other driven prefill shapes, kernel 3 at the
    # fleet-scale encode's
    dense_times = {}
    for label, shape in FLASH_DENSE_TIMED.items():
        ops = flash_operands(gen, dev, *shape)
        dense_times[label] = time_flash(ops, shape, label, card)
        del ops
    prng_fleet = time_prng_fleet_shape(dev, gen, card)
    prng_fleet["launches"] = fleet_scale["prng_launches"]
    phase(f"serve [{card}]: granite-8b engine {dense['tokens_per_s']:.2f} "
          f"tokens/s, decode step median {dense['step_ms']:.3f} ms; "
          f"mamba2-1.3b engine {serve['tokens_per_s']:.2f} tokens/s, "
          f"decode step median {serve['step_ms']:.3f} ms")
    phase(f"new paths' host seconds: scfl plan+encode {scfl_plan_s:.4f}, "
          f"scfl 600 epochs {scfl_run_s:.4f}, hierarchical T={HIER_TIERS} "
          f"600 epochs {hier_run_s:.4f}")
    phase(f"fleet paths' host seconds: tiered encode at §IV width "
          f"{fleet_width['seconds']:.4f}, solve_fleet n={FLEET_N} "
          f"{fleet_scale['plan_s']:.4f}, fleet-scale tiered encode "
          f"{fleet_scale['tiered_s']:.4f} (flat {fleet_scale['flat_s']:.4f}), "
          f"round scheduling n={FLEET_N // 10} {fleet_scale['small_s']:.6f} / "
          f"n={FLEET_N} {fleet_scale['large_s']:.6f} (ratio "
          f"{fleet_scale['growth']:.3f}), legacy 600 epochs "
          f"{legacy['seconds']:.4f}")

    # -- 14. gradient coding ----------------------------------------------
    gradcode = gradcode_phase(out, dev, card, expect, reset_counters,
                              read_counters)

    # -- 15. StochasticCodedFL calibrated to a DP budget ------------------
    dp = dp_scfl_phase(out, dev, card, expect, reset_counters,
                       read_counters)

    # -- 16. low latency ---------------------------------------------------
    lowlat = lowlat_phase(out, dev, card, expect, reset_counters,
                          read_counters)
    phase(f"phases 14-16 host seconds [{card}]: " + ", ".join(
        [f"gradcode {k} {v:.4f}" for k, v in gradcode["seconds"].items()]
        + [f"dp scfl {k} {v:.4f}" for k, v in dp["seconds"].items()]
        + [f"lowlat {k} {v:.4f}" for k, v in lowlat["seconds"].items()]))

    # -- 17. CodedFedL -----------------------------------------------------
    cfedl = codedfedl_phase(out, dev, card, expect, reset_counters,
                            read_counters)
    phase(f"phase 17 host seconds [{card}]: " + ", ".join(
        f"cfedl {k} {v:.4f}" for k, v in cfedl["seconds"].items()))
    cfedl_counts = cfedl["launches"].values()

    # -- 18. the sweep and serving engines ---------------------------------
    sweep = sweep_phase(out, dev, card, expect, reset_counters,
                        read_counters)
    fedserve = fedserve_phase(out, dev, card, expect, reset_counters,
                              read_counters)
    dp_serve = dp_serve_phase(dp, out, dev, card, expect, reset_counters,
                              read_counters)
    phase(f"phase 18 host seconds [{card}]: " + ", ".join(
        [f"sweep {k} {v:.4f}" for k, v in sweep["seconds"].items()]
        + [f"fedserve {k} {v:.4f}" for k, v in fedserve["seconds"].items()]
        + [f"dp serve {dp_serve['seconds']:.4f}"]))

    # -- 19. training and the federated LM trainer --------------------------
    training = train_phase(dev, card, expect, reset_counters, read_counters)
    phase(f"phase 19 [{card}]: lm-100m {training['lm']['step_s']!r} s a "
          f"step, {training['lm']['tokens_per_s']:.1f} tokens/s, peak "
          f"{training['lm']['peak_bytes'] / 2**30:.3f} GiB; {FED_ARCH} "
          f"federated {training['fed']['step_s']!r} s a round, "
          f"{training['fed']['tokens_per_s']:.1f} tokens/s, peak "
          f"{training['fed']['peak_bytes'] / 2**30:.3f} GiB; granite-8b-"
          f"reduced federated {training['granite']['step_s']!r} s a step, "
          f"{training['granite']['tokens_per_s']:.1f} tokens/s")

    # -- 20. the tile autotuner -------------------------------------------
    tuning = tune_phase(dev, card, expect, reset_counters, read_counters)

    # -- 21. serving zamba2-1.2b (the hybrid family) at full width ---------
    free_card()
    hybrid = hybrid_serve_phase(dev, card, expect, reset_counters,
                                read_counters)
    free_card()

    # -- 22. the other dense configs ---------------------------------------
    dense_cfgs = dense_configs_phase(dev, card, expect, reset_counters,
                                     read_counters)
    for label, shape in FLASH_DENSE_TIMED.items():
        check(shape in dense_cfgs["by_shape"],
              f"phase 22 launched kernel 8 at no {label} shape {shape}")
        dense_times[label]["launches"] = dense_cfgs["by_shape"][shape]

    # -- 23. the moe family ------------------------------------------------
    moe = moe_serve_phase(dev, card, expect, reset_counters, read_counters)
    phase(f"phases 21-23 [{card}]: zamba2-1.2b engine "
          f"{hybrid['tokens_per_s']:.2f} tokens/s, decode step median "
          f"{hybrid['step_ms']:.3f} ms; " + "; ".join(
              f"{k} engine {v['tokens_per_s']:.2f} tokens/s, decode step "
              f"median {v['step_ms']:.3f} ms"
              for k, v in dense_cfgs["configs"].items()
              if "tokens_per_s" in v)
          + f"; {MOE_ARCH} cut to {MOE_LAYERS} layers engine "
          f"{moe['tokens_per_s']:.2f} tokens/s, decode step median "
          f"{moe['step_ms']:.3f} ms")

    # -- 24. the vlm and audio families -------------------------------------
    modal = modal_phase(dev, card, expect, reset_counters, read_counters)
    phase(f"phase 24 [{card}]: " + "; ".join(
        f"{a} prefill {modal['configs'][a]['prefill_ms']:.3f} ms, decode "
        f"step median {modal['configs'][a]['step_ms']:.3f} ms, peak "
        f"{modal['configs'][a]['peak_bytes'] / 2**30:.3f} GiB"
        for a in (VLM_ARCH, AUDIO_ARCH)) + "; " + "; ".join(
        f"{k} {v['step_s']!r} s a step, peak "
        f"{v['peak_bytes'] / 2**30:.3f} GiB"
        for k, v in modal["configs"].items() if k.startswith("train ")))

    # -- 25. the launch layer ----------------------------------------------
    free_card()
    launch_dist = distributed_phase(dev, card, expect, reset_counters,
                                    read_counters)
    dry = dryrun_phase(card)
    phase(f"phase 25 [{card}]: dry run " + ", ".join(
        f"{k} {v:.2f} s" for k, v in dry["walls"].items())
        + f"; granite-8b repeat prefills {dense['optimized']['launches']} "
        f"kernel-8 launches, bf16-softmax forward "
        f"{dense['optimized']['bf16_ms']:.3f} ms at "
        f"{dense['optimized']['bf16_diff']:.3e} from float32; zamba2-1.2b "
        f"head_shard prefill {hybrid['optimized']}; --distributed "
        f"{launch_dist['wall_s']:.2f} s")

    # -- 26. the coded-head probe at full width ----------------------------
    free_card()
    probe = probe_phase(dev, card, expect, reset_counters, read_counters)
    phase(f"phase 26 [{card}]: the probe {probe['wall_s']:.3f} s wall, "
          f"coding gain {probe['gain']:.3f}x, launches {probe['launches']}")

    # -- 27. the lane and shard meshes over every local card --------------
    mesh = mesh_phase(out, dev, card, expect, reset_counters, read_counters)
    phase(f"phase 27 [{card}]: {mesh['cards']} card(s); " + ", ".join(
        f"{k} {v:.4f} s" for k, v in mesh["walls"].items()))

    # launches on the driven paths: phase 4 and the new paths' runs
    # (kernel 1), phases 4, 15, 16 (kernel 2), 6 and 15 (kernel 4), 7, 14
    # and 16 at T = 3 (kernel 5), every counted run of phase 17, and
    # phase 18's sweep, solo, served and per-session-loop runs (kernel 1),
    # plan_sweep encodes (kernel 2) and served DP lane (kernel 4); the
    # serve phases 11 and 21 (kernel 7), 12 and 21-24 (kernel 8), and
    # phase 25's optimized prefills (kernels 7 and 8); phase 26's probe
    # (kernels 1, 2 and 8) and phase 27's mesh runs (kernels 1 and 2)
    driven = {
        "round_grad": launches["round_grad"] + sum(
            gradcode["launches"][f"r={r}"] for r in GC_REPLICATION)
        + lowlat["launches"]["round_grad"]
        + sum(c["round_grad"] for c in cfedl_counts)
        + sweep["launches"]["round_grad"]
        + fedserve["launches"]["round_grad"]
        + probe["launches"]["round_grad"] + mesh["launches"]["round_grad"],
        "encode": launches["encode"] + dp["launches"]["encode"]
        + lowlat["launches"]["encode"]
        + sum(c["encode"] for c in cfedl_counts)
        + sweep["launches"]["encode"] + fedserve["launches"]["encode"]
        + probe["launches"]["encode"] + mesh["launches"]["encode"],
        "coded_round_grad": scfl_launches["coded_round_grad"]
        + dp["launches"]["coded_round_grad"]
        + dp_serve["launches"]["coded_round_grad"],
        "tier_round_grad": hier_launches["tier_round_grad"]
        + gradcode["launches"][f"T={HIER_TIERS}"]
        + lowlat["hier_launches"]["tier_round_grad"]
        + sum(c["tier_round_grad"] for c in cfedl_counts),
        "ssd_chunk": serve["launches"] + hybrid["launches"]["ssd_chunk"]
        + hybrid["optimized"]["ssd_chunk"],
        "causal_attention": dense["launches"]
        + hybrid["launches"]["causal_attention"] + dense_cfgs["launches"]
        + moe["launches"] + modal["launches"]
        + dense["optimized"]["launches"]
        + hybrid["optimized"]["causal_attention"]
        + probe["launches"]["causal_attention"]}
    phase(f"launches on the driven paths: {driven}")

    label, m, d, ms, warm, plain, lib, bound_ms = records[0]
    kernels = [
        {"name": "masked_round_gradient", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/round_grad.cu",
         "replaces": "src/repro/kernels/round_grad/round_grad.py:81",
         "launches": driven["round_grad"],
         "max_abs_err": errs["round_grad_coded"], "ms": ms,
         "plain_ms": plain, "bound_ms": bound_ms,
         "bound_by": kernel_terms("round_grad", (m, d))["bound_by"],
         "library_ms": lib, "ms_l2_warm": warm, "shape": [m, d],
         "max_abs_err_wide": errs["round_grad_wide"],
         "probe_shape": probe["round_grad"]},
        {"name": "encode_parity", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/encode.cu",
         "replaces": "src/repro/kernels/encode/encode.py:61",
         "launches": driven["encode"], "max_abs_err": errs["encode"],
         "ms": enc_ms, "plain_ms": enc_plain, "bound_ms": enc_bound,
         "bound_by": enc_bound_by, "library_ms": enc_lib,
         "bound_route": "3xTF32: three TF32 products per float32 product "
                        "at 495 TFLOP/s",
         "hmma": hmma["kernel 2"], "ms_l2_warm": enc_warm,
         "shape": enc_shape},
        {"name": "coded_round_gradient", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/round_grad.cu",
         "replaces": "src/repro/kernels/round_grad/round_grad.py:134",
         "launches": driven["coded_round_grad"],
         "max_abs_err": errs["coded_round_grad"], "ms": coded_ms,
         "plain_ms": coded_plain, "bound_ms": coded_bound,
         "bound_by": coded_bound_by, "library_ms": coded_lib,
         "ms_l2_warm": coded_warm,
         "shape": [coded_inputs[0].shape[0], coded_inputs[3].shape[0],
                   coded_inputs[0].shape[1]]},
        {"name": "tier_masked_round_gradient", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/round_grad.cu",
         "replaces": "src/repro/kernels/round_grad/round_grad.py:190",
         "launches": driven["tier_round_grad"],
         "max_abs_err": errs["tier_round_grad"], "ms": tier_ms,
         "plain_ms": tier_plain, "bound_ms": tier_bound,
         "bound_by": tier_bound_by, "library_ms": tier_lib,
         "ms_l2_warm": tier_warm, "shape": tier_shape},
        {"name": "encode_parity_prng", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/encode.cu",
         "replaces": "src/repro/kernels/encode/encode.py:210",
         "launches": fleet_width["launches"],
         "max_abs_err": max(errs["encode_prng_normal"],
                            errs["encode_prng_bernoulli"]),
         "ms": prng_rec["normal"]["ms"],
         "plain_ms": prng_rec["normal"]["plain"],
         "bound_ms": prng_rec["normal"]["bound"],
         "bound_by": prng_rec["normal"]["bound_by"],
         "library_ms": prng_rec["normal"]["lib"],
         "bound_route": "the larger of 3xTF32 (three TF32 products per "
                        "float32 product at 495 TFLOP/s) and one threefry "
                        "hash per generator entry at the INT32 rate",
         "hmma": hmma["kernel 3"],
         "ms_l2_warm": prng_rec["normal"]["warm"],
         "bernoulli": {k: prng_rec["bernoulli"][k] for k in
                       ("ms", "warm", "plain", "lib", "bound")},
         "shape": prng_shape, "fleet_shape": prng_fleet},
        {"name": "lsq_gradient", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/round_grad.cu",
         "replaces": "src/repro/kernels/coded_grad/coded_grad.py:53",
         "launches": legacy["launches"],
         "max_abs_err": errs["lsq_gradient"], "ms": lsq_ms,
         "plain_ms": lsq_plain, "bound_ms": lsq_bound,
         "bound_by": lsq_bound_by,
         "library_ms": lsq_lib, "ms_l2_warm": lsq_warm,
         "shape": [lsq_m, lsq_d]},
        {"name": "ssd_chunk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd.cu",
         "replaces": "src/repro/kernels/ssd/ssd.py:57",
         "launches": driven["ssd_chunk"],
         "max_abs_err": max(errs["ssd_chunk"], serve["model_err"]),
         "ms": ssd_ms, "plain_ms": ssd_plain, "bound_ms": ssd_bound,
         "bound_by": ssd_bound_by, "library_ms": ssd_lib,
         "bound_route": "3xTF32: three TF32 products per float32 product "
                        "at 495 TFLOP/s, the scores once per group",
         "hmma": hmma["kernel 7"],
         "library": "torch.matmul + torch.tril on head-major views",
         "library_grouped_ms": ssd_lib_grouped,
         "library_grouped": "torch.matmul with C B^T once per group, "
                            "broadcast over its heads",
         "ms_l2_warm": ssd_warm, "shape": [*SSD_SHAPE[:5], G, N],
         "hybrid_shape": {**hybrid_times["ssd_chunk"],
                          "max_abs_err": errs["ssd_chunk_hybrid"]}},
        {"name": "causal_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn/flash_attn.py:75",
         "launches": driven["causal_attention"],
         "max_abs_err": errs["causal_attention"], "ms": flash_ms,
         "plain_ms": flash_plain, "bound_ms": flash_bound,
         "bound_by": flash_bound_by, "library_ms": flash_lib,
         "bound_route": "3xTF32: three TF32 products per float32 product "
                        "at 495 TFLOP/s",
         "hmma": hmma["kernel 8"],
         "library": "repeat_interleave + scaled_dot_product_attention "
                    f"on {backend}",
         "library_gqa_ms": flash_lib_gqa,
         "library_gqa": f"scaled_dot_product_attention(enable_gqa) on "
                        f"{gqa_backend}",
         "ms_l2_warm": flash_warm, "shape": list(FLASH_SHAPE),
         "hybrid_shape": hybrid_times["causal_attention"],
         "whisper_shape": whisper_time,
         "probe_shape": probe["causal_attention"],
         "dense_shapes": dense_times},
    ]
    # kernels 1-6: the tile block="auto" launched at the record's shape,
    # and phase 20's measured tuning of the kernel's family (kernel 3 has
    # none): {kernel: (family, the family's (m, d) or (c, ell, d))}
    tiled = {
        "masked_round_gradient": ("round_grad", (m, d)),
        "coded_round_gradient": ("round_grad",
                                 (coded_inputs[0].shape[0], d)),
        "tier_masked_round_gradient": ("round_grad", tuple(tier_shape[:2])),
        "lsq_gradient": ("coded_grad", (lsq_m, lsq_d)),
        "encode_parity": ("encode", tuple(enc_shape)),
        "encode_parity_prng": ("encode_prng", tuple(prng_shape))}
    for rec in kernels:
        if rec["name"] in tiled:
            family, shape = tiled[rec["name"]]
            rec["tile"] = auto_tile(family, shape, dev)
            if family in tuning["tuned"]:
                rec["tuned"] = tuning["tuned"][family]
    phase(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
