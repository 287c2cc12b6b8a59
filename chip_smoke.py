#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # one card; exits non-zero without one
    python3 chip_smoke.py --profile  # also print a torch.profiler breakdown

Phases (any failure exits non-zero; none catches its own):

  1. device: the card's name and power limit (nvidia-smi).
  2. build: every `csrc/*.cu` of `repro_torch` with nvcc for sm_90a, one
     nvcc each, in parallel; `cuobjdump -sass` must show HGMMA (tensor-core
     wgmma) in `grouped_matmul_wgmma_kernel`, in the
     `grouped_matmul_dw_wgmma_kernel` the train step takes (tiles of
     128 x 256; its registers and spills printed) and in the
     `flash_attention_wgmma_kernel` instance the prefill takes (head_dim
     64), and a 128-bit global load (LDG.E.128 or LDGSTS.128) in the
     `flash_decode_kernel` instance that the decode step's shapes take;
     those two instances' registers and spills (ptxas -v) are printed;
     HGMMA, registers and spills of the `flash_attention_wgmma_kernel`
     instances that phase 14's jamba (head_dim 128) and gemma2 (head_dim
     256) prefills and phase 15's qwen2-vl (head_dim 128, G 8) and
     seamless decoder (head_dim 64, G 1) prefills take, and registers and
     spills of the `flash_decode_kernel` instances of their decode steps;
     and
     `HMMA ... TF32` in every `spconv_fod_tc_kernel` instance (column tile,
     fused or not) that the MinkUNet path takes, with its registers and
     spills, and in every `fused_mlp_tc_kernel` instance that a
     PointNet++(s) group takes (`fused_mlp.plan_mlp` at PN_SEG_GROUPS);
     registers and spills of every fused_mlp instance are printed.
  3. kernels: one full-width MinkUNet forward (plain torch flow "fod") on a
     50k-point city scene in the 65536 bucket records the inputs of all 41
     sparse convs.  Every site must plan the tensor-core kernel
     (`spconv.plan_for`; printed as the CTAs that ran a pipeline stage, of
     the CTAs launched, and the most rounds of a cluster, both counted by
     the kernel itself in one extra call with `stats=`).  The
     kernels (tensor-core, and the earlier FMA kernel) are held against
     their plain PyTorch versions on those inputs (atol = rtol = 1e-4:
     float32 sums in another order; the error is printed as a fraction of
     max|plain|) and timed as device time a call (CUDA graph) beside the
     plain version and a GEMM-only yardstick (an einsum over pre-gathered
     rows; not used by the port), both with CUDA events, and two bounds:
     the larger of (bytes / memory rate) and either FLOPs / float32
     non-tensor peak or 3 x FLOPs / dense TF32 peak (the tensor-core
     route's), counting only this run's non-empty inverse entries (2 * nnz
     * Cin * Cout FLOPs) and the feature rows they reference.  Per stride
     level: ms, share, the FMA kernel's ms and the row use at 64-row and
     16-row skips.  Negative control: the fused kernel on `inv` with the
     offsets of the plan's last cluster rank set to -1 must fail the site
     check at every site where those offsets hold an input (the offsets
     k = n_split - 1 (mod n_split), which the cluster's last rank takes
     when it spreads a tile over the whole cluster).
  4. main path: `PointCloudEngine(flow="cuda_fused").segment` serves five
     requests (scene A, scene B, A, B, A: two misses, then mapping-cache
     hits), then one `flow="cuda"` request runs the baseline kernel.  The
     launch counts are zeroed just before and read just after; the fused
     kernel must launch 41 times per request and the baseline 41 times,
     all on the tensor-core variant.  Labels are checked against
     the "fod" logits on valid rows: a mismatch is allowed only where the
     top-2 logit gap is below the tolerance.
  4b. batched serving: a `ServeScheduler(engine, max_batch=4,
     pipeline_depth=2)` over phase 4's full-width MinkUNet (flow
     "cuda_fused") serves a stream of 12 `city_scene` scenes of mixed
     size, interleaved (65536 bucket: scenes A, B, 45000 and 35000 points;
     32768: 18000, 24000, 30000; 16384: 9000, 15000; then A, B, A again),
     flush() and drain(), then the same ordered stream once more (every
     micro-batch composition repeats: AssemblyCache hits).  Every result
     must be ok, with labels equal to `engine.segment` of the same scene
     on every row (the scheduler runs each scene through the same code).
     `segment_batch` on (4, 50000) stacked scenes must equal four
     `segment` calls, and `levels_for(batched=True)` must then find their
     four pyramids in the mapping cache.  Launch counts are zeroed just before and read just
     after: 41 tensor-core `spconv_fod_fused` launches per real scene the
     engine's micro-batches ran, none of the FMA variant or of
     `spconv_fod`.  stats() keys must equal `SCHEDULER_STATS_KEYS`, the
     mapping cache must show the stream's 9 misses and 3 hits, the
     assembly cache 4 misses then 4 hits, `compile_stats()` at most the 3
     buckets; one more pass through a scheduler with
     `FaultPlan(fail_dispatches={1})` (no bisect) must retry once and
     still give equal labels.  Every distinct scene also runs one plain
     "fod" forward, outside the counted window: the served labels must
     equal its argmax on valid rows except where its top-2 gap is below
     TOL (phase 4's rule).  Apart from that injected failure no
     dispatch may fail and no request may end rejected, shed, timed out
     or exec_failed.  The producer polls after each submit.  Prints
     scenes/s of each pass (host clock from the first submit to the last
     result) and p50/p95 request latency (from stats(), and exact from the
     results).  With `--profile`, a cold pass over a fresh engine and a
     replay pass run under torch.profiler (device busy share, host ops).
  4c. router: `ServeRouter(PointCloudEngine.factory(module, 4,
     flow="cuda_fused"), 2, max_batch=4, pipeline_depth=2)` serves the same
     12-scene stream (two engines on the one card, each worker thread
     dispatching through its own scheduler).  Every result must be ok with
     labels equal to `segment` on every row; each worker's routed count
     must equal what `router.preview` gave for the stream; launch counts,
     zeroed just before and read just after: 41 tensor-core
     `spconv_fod_fused` launches per scene, none on FMA; stats() keys equal
     `ROUTER_STATS_KEYS` / `ROUTER_FAULT_KEYS`, no typed error.  Then a
     router over the same, now warm, engines with a tight `LivenessPolicy`
     and `FaultPlan(kill_workers={w: 2})`, w the worker the stream loads
     most: failovers 1, replayed >= 1, the worker dead, labels still equal,
     no typed error.  Scenes/s of both passes printed (not gated).
  4d. partition: on an engine with tracing on, `segment(*scene A,
     partition=PartitionPolicy(force=True))` must come in 3 chunks and
     `city_scene(21, 150000, extent=2452)` (above the 65536 top bucket:
     a plain `segment` must raise "exceeds the bucket ladder") in 5 through
     `partition="auto"`; each with no chunk above 65536 points, no chunk
     error, 41 tensor-core launches per chunk (counts zeroed just before,
     read just after) and -1 on masked rows, and its labels on valid rows
     equal to one monolithic forward of the same module except where that
     forward's top-2 gap is below TOL (the oversized scene whole through
     an engine whose ladder reaches 262144); the differing rows are
     counted.  A repeat must hit the mapping cache in every chunk and give
     equal labels.  The plan's host ms, the chunks' wall ms (both from the
     partition's trace), halo fractions and the monolithic forward's ms
     are printed.
  4e. v1 mapping engine: `segment` of scene A on a `PointCloudEngine(
     engine="v1", flow="cuda_fused")`: 41 tensor-core launches (counts
     zeroed just before, read just after), labels equal to phase 4's v2
     labels on valid rows except where the plain forward's top-2 gap is
     below TOL; the mapping ms of v1 and v2 (the median of five misses,
     each after a fresh mapping cache, minus the median of five hits, the
     engines taking turns; every sample printed).  An out-of-budget
     stream (scene A moved by +65536 in x, a multiple of every level's
     stride, and scene A at batch index 20000): a v2 `ServeScheduler`
     must refuse both (rejected: `validate_scene` raises AdmissionError)
     with no launch, a v1 one must serve both with 41 launches each and
     labels held to the v2 labels by the same rule.  A D = 2 cloud (scene A projected on (x, y)) through
     `PointAccSession` (engine inferred: v1) at flow "cuda": k = 3
     stride 1 and 2 and the transposed conv, within TOL of flow "fod".
  5. point kernels: one plain full-width PointNet++(s) forward (13
     classes, B = 16 clouds of N = 4096 points from `dense_xyz_batch`, the
     last cloud masked to 3000 valid points) and one plain full-width
     PointNet forward (40 classes, B = 8 x 1024) record the input of every
     fused-MLP group.  The point models' weights are the reference's init
     from `torch.Generator().manual_seed(seed)` scaled to He's gain, with
     biases uniform in +-0.1 (`smoke_weights`), so activations and logits
     stay O(1).  Each group's launch plan (`fused_mlp.plan_for`: variant
     tc / tc_stream / few_rows / fma, rows a tile, grid, W split, shared
     memory) is printed; the kernel it names and the FMA kernel
     (`fused_mlp_kernel(kind="fma")`, the earlier design) are held against
     the plain version on each group: max|kernel - plain| <= 1e-5 *
     max|plain| (float32 sums in another order), with the rms and max of
     the plain output printed.  Both are timed beside the plain version, a
     layer-by-layer cuBLAS yardstick (`torch.addmm` + `relu_`, TF32 off;
     not used by the port), each as the device time of one call (20
     calls captured in a CUDA graph, replayed between CUDA events), and
     given two bounds: the larger of (x read + output written + weights
     and biases once) / memory rate and either 2 * rows * sum(Cin * Cout) /
     float32 peak or 3 times that over the dense TF32 peak (the
     tensor-core route's).
  6. point path: PointNet++(s) at full width on that batch, initialised
     on the card; one warm-up and three timed forwards (host clock around
     synchronised calls).  The launch count is zeroed just before and read
     just after: the kernel must launch once per planned group (6) each
     forward, none of them on the FMA variant.  Logits are held against the plain forward with the same
     relative rule, and labels on valid points must be equal except where
     the plain top-2 gap is below 1e-5 * max|plain logit|.  Negative
     controls: the same check must reject the forward with any one group
     written as zeros, and with the head's output off by a relative 1e-4.
  7. the other five models (PointNet, PointNet++(c) at n1 = 512, n2 = 128,
     PointNet++(ps), DGCNN at k = 20, F-PointNet++), width 1, B = 8 x 1024:
     one forward each through the kernel (launches = planned groups, none
     on the FMA variant) and one plain, checked the same way (F-PointNet++'s
     centre and box too).  DGCNN takes kNN on features, so a forward through
     the kernel takes the plain run's kNN graph (every `pointops.knn` call
     recorded in the plain run and replayed), and each neighbour set that
     its own kNN would choose otherwise must be a near tie (k-th and
     (k+1)-th distances within KNN_TIE); the forward with its own graph is
     printed, not checked.
  8. LM kernels: full-width granite-moe-1b-a400m (the repo's config:
     24 layers, d_model 1024, 16 / 8 heads of 64, 32 experts top-8, vocab
     49155) with random weights from torch.Generator("cuda").manual_seed(0)
     in the reference's init.  First, one decode step of an attention
     layer at those widths with a 128-token window over a 1024-slot plain
     cache (the masked path; no kernel) at float32 on the card must agree
     with the same call on the CPU within 1e-5 x max|plain|.  One plain bf16 prefill of 8 x 512 prompt
     tokens (`np.random.default_rng(0)`) and 8 plain decode steps record
     the operands of layer 0's and layer 23's flash_attention, their three
     grouped_matmul calls (w_in, w_gate, w_out) and two flash_decode calls.
     Each kernel is held against its plain version on them at float32
     (max|kernel - plain| <= 1e-5 * max|plain|: sums in another order) and
     at bf16 (<= 8e-3 * max|plain|: one bf16 rounding of the output
     scale).  flash_attention and grouped_matmul take their float32-FMA
     kernels at float32 and their tensor-core (wgmma) kernels at bf16, and
     each check must move that variant's launch count; the FMA kernels are
     held at bf16 too, and two negative controls must fail the bf16 check:
     the tensor-core grouped_matmul without its last 64-deep K stage, the
     tensor-core flash_attention on K/V without their last 128 keys.  Each
     kernel is timed at bf16 as device time a call (CUDA graph; the calls
     take turns over enough copies of the operands that each reads them
     from device memory, not from L2) beside its plain version and one
     library call (SDPA with is_causal and
     enable_gqa; `torch.bmm` over the (E, capacity, Cin) view; SDPA over
     the cache's valid prefix), with its bound: the larger of the bytes
     read and written once at 3.35 TB/s and the operations the masks
     leave at 989 TFLOP/s (bf16); the earlier FMA kernels of
     flash_attention and grouped_matmul are timed the same way.
     flash_attention is also checked with a window and a softcap and at
     head_dim 128 and 256, each on the variant `variant` names (printed,
     and its launch count must move); flash_decode, at
     the decode step's widths with operands from a seed, at unequal
     lengths (0, 1, 63, 64, 65, 511, 1024 and one past S) and at every
     split count 1..8, each printed with its launch plan (n_split, CTAs,
     cluster or not).
  9. LM main path: `ServeEngine(build(cfg), params, ServeConfig(max_len=
     1024))` (bf16 weights and cache), `generate(prompts, 32)` once to
     warm up and three timed runs; prefill ms, decode ms a step and
     tokens/s on the host clock around synchronised calls.  Launch counts
     are zeroed just before and read just after: 24 flash_attention and 72
     grouped_matmul launches a prefill, all on the tensor-core kernels, 24
     flash_decode a decode step.
  10. LM correctness: the plain path (all three kernels swapped for their
     plain versions here) is teacher-forced on the kernel path's tokens,
     and prefill and every decode step's logits compared: at bf16 (the
     main path) within LM_BF16_PATH_TOL * max|plain|, at float32 (an
     engine with compute and cache in float32) within 1e-4 * max|plain|;
     a greedy token may differ only where the plain top-2 gap is below the
     same bound; the float32 run's prefill must launch the FMA
     flash_attention 24 times and the FMA grouped_matmul 72 times.  Three
     negative controls at float32 must be rejected:
     flash_attention skipping its last kv tile, grouped_matmul writing
     expert 0's tiles as zeros, flash_decode reading lengths - 1.
  12. train step: full-width granite-moe-1b-a400m, float32 weights from
     torch.Generator("cuda").manual_seed(0), `make_train_step` with
     TrainConfig(compute_dtype=bf16, remat=True) and AdamW (lr 1e-3, a
     1-step warmup), three steps on one `token_batch(0, 0)` of 4 x 512:
     each step's ms, training tokens/s (B * S / step wall) and peak memory
     printed; the loss finite and the third step's below the first.
     Launch counts, zeroed before each step and read after it: 48
     flash_attention (24 forward + 24 recomputed by remat; its backward
     recomputes through the plain version), 216 grouped_matmul (144
     forward, 72 dX), 72 grouped_matmul_dw (72 `grouped_matmul_dw_wgmma`,
     0 `grouped_matmul_dw_fma`), all on the tensor-core variants.  The
     MoE dispatch gathers differentiate through the dispatch's inverse
     tables (`ops.dispatch_gather`), so the step runs no IndexBackward0
     for them.  grouped_matmul_dw held against its plain version on the
     first step's three calls of layer 23, each variant on its own type:
     f32 through the FMA kernel (1e-5 x max|plain|), bf16 through the
     tensor-core kernel (8e-3), and the FMA kernel on the bf16 operands
     (8e-3); each check must move that variant's count; both kernels timed
     at bf16 beside the plain version and torch.bmm, with the bound.
     Parity: one step's gradients at float32 with 2 layers at full width,
     kernels against the plain versions with the kernel run's MoE routing
     imposed: loss within 1e-4 relative, every gradient leaf within 1e-4 x
     max|plain leaf|; the same at bf16 within 5e-2; dW through the FMA
     kernel at f32 and the tensor-core kernel at bf16 (counts checked).  At
     each type a grouped_matmul_dw that writes expert 0's gradient as
     zeros (through that type's kernel) must be rejected.
  13. trainer: `repro_torch.launch.train` (the launcher a user runs) at
     the full width and depth of granite-moe-1b-a400m with `--compute-dtype
     bfloat16 --batch 4 --seq 512 --lr 1e-3 --log-every 1
     --lr-total-steps 6`.  U: `main([... --steps 6])` in-process; each
     step's `step_s` (the launcher's StepTimer, stopped once the step's
     metrics are read), training tokens/s, peak memory, the model FLOPs of
     a step (`launch/flops.cell_flops`, remat) and their share of the
     dense bf16 peak are printed; launch counts, zeroed before step 2 and
     read after it, must be phase 12's (48 flash_attention, 216
     grouped_matmul of them 72 dX, 72 grouped_matmul_dw; all wgmma).  A:
     the same command as a subprocess with `--ckpt-dir` under build/ (the
     free disk, printed, must hold two checkpoints), sent SIGTERM once it
     has printed its step 1 line: it must print `[preempt] saving final
     checkpoint`, exit 0 and leave a committed step k >= 2 in the
     directory and its `opt/` (the save's wall, from the `[preempt]` line
     to the `opt` COMMIT stamp, and its bytes printed).  B: `main` resumed
     from it in-process: `[resume] step k`, losses at steps k..5 within
     2e-3 relative of U's (restore wall printed).  One `--accum 2` step on
     U's first batch: loss within 1e-2 relative of U's step 0, grad norm
     within 5e-2 of the norm of the mean of the two half-batches' gradients
     (`make_grad_fn` through the kernels; the MoE load-balance loss is a
     product of batch means, so U's step-0 grad norm is printed beside it,
     not checked).  The checkpoints are removed.  Then qwen1.5-4b,
     qwen1.5-32b, granite-34b and mixtral-8x7b at full width with 2
     layers: one bf16 `train_logits` of 2 x 512 tokens through the kernels
     against the plain path (mixtral: the plain run's routing imposed)
     within 5e-2 x max|plain|, launches by the variant `variant` names
     (granite-34b's 48 query heads a kv head take the FMA attention).
  14. recurrent, hybrid and gemma2 LMs, after the earlier phases' objects
     are freed and the allocator's cache emptied; random weights from
     torch.Generator("cuda").manual_seed(0), drawn in bf16 through
     `lm_init` (each leaf cast as it is drawn); the peak memory of each
     init and each run printed.
     14a. jamba-v0.1-52b at full width, one body (8 of its 32 layers: 7
     mamba, 1 attention, MoE with 16 experts top-2 on the 4 odd
     sub-layers; about 13.3 B parameters).  `ServeEngine(ServeConfig(
     max_len=1024))` generates 16 tokens from 2 x 512 prompts (4
     128-token scan chunks carry the mamba state), RECURRENT_RUNS times
     (the first a warm-up): prefill and decode-step ms (medians) beside the
     decode step's weight-read yardstick (all bf16 weights over the memory
     rate: the decode MoE is "dense"); launches a generate: flash_attention
     1 (wgmma, head_dim 128, G 4), grouped_matmul 12 (wgmma), flash_decode
     1 a decode step.  The plain path teacher-forced on the generated
     tokens (its MoE routing recorded) against the kernel path with that
     routing imposed: every logit within LM_BF16_PATH_TOL x max|plain|.
     Then one bf16 forward and backward of `train_logits` on 1 x 512 (no
     optimiser) through the plain path and through the kernels (the plain
     routing imposed): the loss and the gradient norm of each leaf, and of
     each expert of an expert leaf, within GRAD_NORM_TOL relative;
     grouped_matmul_dx and grouped_matmul_dw launch 12 times each, all
     wgmma.  The backward's first two dX and dW calls, kept from the
     kernel run, are held alone against their plain versions
     (LM_BF16_TOL), and a dW that writes expert 0's gradient as zeros must
     fail the norms check.
     14b. xlstm-125m: a mamba sub-layer at jamba's full width and an mLSTM
     and an sLSTM block at xlstm's, float32 on 1 x 256 (prefill mode), on
     the card against the same call on the CPU: output and every state
     leaf within 1e-4 x max|CPU| (no kernel on this path: this shows a
     fault only the card makes).  Then xlstm-125m at full width and depth
     (12 layers) generates 32 tokens from 4 x 512 prompts (prefill and
     decode-step ms printed; the sLSTM is a Python loop of S steps, host
     bound), and `launch.train.main(--arch xlstm-125m --compute-dtype
     bfloat16 --batch 4 --seq 512 --steps 3)` runs: losses finite, step
     ms, training tokens/s and peak memory printed.
     14c. gemma2-2b at full width and depth (26 layers, head_dim 256, vocab
     256000, tied head, softcaps 50 / 30, 13 local layers with a 4096
     window), its trainer first (below), on an empty allocator: generate
     32 tokens from 4 x 512 prompts, checked against the
     plain path as in 14a (no MoE); launches: flash_attention 26 a prefill
     (all wgmma, head_dim 256, G 2, softcap 50; 13 of the recorded calls
     windowed at 4096), flash_decode 26 a decode step.  One prefill of 1 x
     4608 tokens (the window binds) through the kernels against the plain
     path: all logits within the same tolerance.  `launch.train.main(--arch
     gemma2-2b --compute-dtype bfloat16 --batch 2 --seq 512 --steps 3)`
     (the tied head and the final softcap through the chunked CE): losses
     finite, step ms and peak printed.
     Kernel calls recorded in the plain runs are held alone against their
     plain versions (LM_BF16_TOL) and timed a call beside them and the
     library call at the same shapes, with the bound, as in phase 8:
     jamba's flash_attention, flash_decode and two prefill grouped_matmul
     calls (w_in and w_out of its first MoE sub-layer; torch.bmm beside
     them), gemma2's global-layer flash_attention at 4 x 512, its
     flash_decode, and its local layer 0's flash_attention in the 1 x
     4608 prefill, where the window binds (SDPA has no softcap and no
     window).  The phase's wall is printed.
  15. qwen2-vl and the encoder-decoder, random bf16 weights from a CUDA
     generator, each path run MM_RUNS times (the first a warm-up; prefill
     and decode-step ms on the host clock, medians) and then the plain
     path teacher-forced on the kernel path's tokens: every prefill and
     decode logit within MM_TOL x max|plain|.
     15a. qwen2-vl-72b at full width (d_model 8192, 64 / 8 heads of 128,
     d_ff 29568, vocab 152064) and 8 of its 80 layers (all 80 do not fit
     on one card): B 2, 256 patch embeddings (a 16 x 16 grid at t = 0,
     (h, w) ids from the grid) before 768 text tokens whose three ids
     continue from the grid's largest + 1, then 16 decode steps with
     (B, 1, 3) positions.  Launches: flash_attention 8 a prefill, all
     wgmma (head_dim 128, G 8); flash_decode 8 a step.
     15b. seamless-m4t-medium at full width and depth (12 encoder + 12
     decoder layers, d_model 1024, 16 heads of 64, vocab 256206): B 4,
     1024 seeded frame embeddings, 256 decoder tokens (1024 /
     AUDIO_DEC_FRACTION), then 32 decode steps over the cross cache.
     Launches: flash_attention 12 a prefill, all wgmma (head_dim 64, G 1);
     flash_decode 12 a step.  One more prefill splits out the plain
     encoder and cross-attention time (CUDA events around each call); one
     bf16 forward and backward of the train step (remat, chunked CE) on
     the same batch: loss and every gradient finite, 24 wgmma
     flash_attention launches, peak memory printed.
     Each path's first flash_attention call and its last step's first
     flash_decode call, recorded in the plain run, are held alone against
     their plain versions and timed beside SDPA with the bound, as in
     phase 14.  The phase's wall is printed.
  16. sharding: NCCL at world 1 (`file://` rendezvous under build/),
     a 1 x 1 ("data", "model") and a 1 x 1 x 1 ("pod", "data", "model")
     mesh on the card.  16a: one train step of full-width granite
     (float32 weights, bf16 compute, remat, AdamW, 4 x 512) with
     `ShardingConfig(mesh, fsdp=True, seq_parallel=True)` and one without,
     from the same seeded weights and batch, one after the other (the
     first's parameters wait on the host); each takes a second step for a
     steady time.  Gates: loss within 1e-4 relative, each updated leaf
     within 5e-2 of its max, launches of each equal to phase 12's (48
     flash_attention, 216 grouped_matmul of them 72 dX, 72 dW, all
     wgmma).  16b: `ServeEngine.generate` 8 x 512 + 32 with `sc` and
     without: launches equal (24 flash_attention and 72 grouped_matmul a
     prefill, 24 flash_decode a step), greedy tokens compared, both
     engines teacher-forced on the unsharded tokens within 5e-2.  16c:
     `moe_apply_ep` at ep = 1 on granite's layer (4 x 512 tokens) against
     `moe_apply_sorted` within 1e-4 (f32) / 5e-2 (bf16), no kernel
     launched by EP (plain matmuls).  16d: a one-stage `pipelined_forward`
     against the plain loop, forward and gradient within 1e-5.  16e:
     `compressed_psum` at pod = 1: payload, scales and mean equal to a
     CPU run of the same input (a difference is counted and named).  16f:
     `elastic.resume_or_init` on the 1 x 1 mesh from a checkpoint saved
     without a mesh (reduced granite): params bit-equal, start step 7.
     16g: `make_scene_mesh()` is None on one card; a scheduler's
     `n_devices` is 1 and `max_batch` unrounded.
  17. a {"v1": ..., "train": {..., "trainer": ...}, "recurrent": ...,
     "multimodal": ..., "sharding": ...} line,
     a {"kernels": [...]} line (seven kernels; flash_attention,
     grouped_matmul and grouped_matmul_dw carry phase 13's counts as
     `trainer_launches`, and the four LM kernels phase 14's counts by path
     as `recurrent_launches`; flash_attention and flash_decode phase 15's
     as `multimodal_launches`; flash_attention, flash_decode and
     grouped_matmul carry phases 14 and 15's timed instances as
     `instances`), the nvidia-smi line, and last
     the {"ok": true, "device": {...}} line.

`--profile` adds torch.profiler tables of one segment hit and one miss
(each with its wall, device time, busy share and spconv kernel time), of one
PointNet++(s) forward (split into FPS, ball query, kNN, gathers and
fused-MLP groups, with the forward's device time and that of the
fused_mlp kernels, every variant), of one LM prefill and of four LM decode steps
(device busy share, and the time of each LM kernel), and of one more train
step (busy share, time by kernel name, and the device time of the
IndexBackward0, _DispatchGatherBackward and EmbeddingBackward nodes).
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4                 # atol = rtol: float32 summation-order differences
SCENE_A = (11, 50000)      # city_scene(seed, n_points): 65536 bucket
SCENE_B = (12, 40000)
SERVE_STREAM = (  # phase 4b, in submission order: buckets 65536 / 32768 / 16384
    SCENE_A, (15, 18000), (18, 9000), SCENE_B, (16, 24000), (13, 45000),
    (19, 15000), (17, 30000), (14, 35000), SCENE_A, SCENE_B, SCENE_A)
SERVE_BATCH = (SCENE_A, (20, 50000), (21, 50000), (22, 50000))  # segment_batch
SERVE_MAX_BATCH = 4
ROUTER_WORKERS = 2         # phase 4c: workers of the ServeRouter, one card
ROUTER_KILL_STEP = 2       # the killed worker dies on its third request
OVERSIZED = (21, 150000, 2452)  # city_scene(seed, n_points, extent), phase 4d:
                           # above the 65536 top bucket, a quarter of the
                           # default density (the default-density scene's halo
                           # outgrows the ladder: plan_partition refuses it)
MONO_TOP = 262144          # ladder top of the engine that runs it whole
FORCED_CHUNKS, AUTO_CHUNKS = 3, 5  # chunks of scene A forced, of OVERSIZED
N_STAGES = 4
REPS = 10
MAP_SAMPLES = 5            # phase 4e: misses and hits timed per mapping engine
NAMED = {  # the shapes the kernel phase must cover, by site
    "stem": "stem, Cin=4",
    "enc3.b0.conv1": "level-4 encoder, Cin=Cout=256",
    "dec3.b0.conv1": "level-0 decoder conv1, 128->96",
    "dec3.b0.conv2": "level-0 decoder conv2, 96->96 + residual",
}
PN_BATCH = (0, 0, 16, 4096)   # dense_xyz_batch(seed, step, B, N): PointNet++(s)
PN_LAST_VALID = 3000          # valid points of the last cloud
OTHER_BATCH = (1, 0, 8, 1024)  # the other five models
OTHER_LAST_VALID = 700
MLP_REPS = 20              # calls captured in one CUDA graph (point kernels)
GRAPH_REPLAYS = 5
REL_TOL = 1e-5  # point path: max|got - want| <= REL_TOL * max|want|
KNN_TIE = 1e-4  # a kNN set may differ from the plain run's only where the k-th
                # and (k+1)-th distances lie within KNN_TIE of each other (relative)
PN_SEG_GROUPS = (  # PointNet++(s) at PN_BATCH: (name, widths, rows) of its groups
    ("sa1", (3, 32, 32, 64), 131072), ("sa2", (67, 64, 64, 128), 32768),
    ("fp2.g0", (192, 128), 4096), ("fp2.g1", (128, 64), 4096),
    ("fp1", (64, 64, 64), 65536), ("head", (64, 64, 13), 65536))
PEAKS = {  # (bytes/s, float32 non-tensor FLOP/s), NVIDIA data sheets
    "sxm": (3.35e12, 67e12),
    "pcie": (2.0e12, 51e12),
}
BF16_PEAKS = {"sxm": 989e12, "pcie": 756e12}  # dense bf16 tensor FLOP/s
TF32_PEAKS = {"sxm": 494.7e12, "pcie": 378e12}  # dense TF32 tensor FLOP/s
LM_ARCH = "granite-moe-1b-a400m"
LM_BATCH, LM_PROMPT, LM_NEW, LM_MAX_LEN = 8, 512, 32, 1024
LM_PLAIN_STEPS = 8           # decode steps of the kernel phase's plain run
LM_CONTROL_STEPS = 4         # decode steps of each negative control
LM_F32_TOL = 1e-4            # teacher-forced logits: err <= tol * max|plain|
LM_BF16_TOL = 8e-3           # kernel phase at bf16: one rounding of the scale
FA_CONTROL_KEYS = 128        # keys the flash_attention negative control drops
LM_KERNEL_F32_TOL = 1e-5     # kernel phase at f32
LM_BF16_PATH_TOL = 5e-2      # teacher-forced logits at bf16
LM_NEAR_TIE = {"f32": 1e-4, "bf16": 2.0 ** -5}  # routing flips: gap / p_k
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 3   # phase 12
TRAIN_LR = 1e-3
TRAINER_STEPS = 6            # phase 13: steps of each launcher run, and the
                             # fixed --lr-total-steps
TRAINER_STEADY = 2           # the step whose launches are counted
TRAINER_RESUME_TOL = 2e-3    # resumed losses vs uninterrupted (relative)
TRAINER_ACCUM_TOL = {"loss": 1e-2, "grad_norm": 5e-2}  # --accum 2 (relative)
TRAINER_TIMEOUT_S = 420      # the preempted subprocess's deadline
CONFIG_ARCHS = ("qwen1.5-4b", "qwen1.5-32b", "granite-34b", "mixtral-8x7b")
CONFIG_LAYERS, CONFIG_BATCH, CONFIG_SEQ = 2, 2, 512   # their forwards
RECURRENT_ARCHS = ("jamba-v0.1-52b", "xlstm-125m", "gemma2-2b")  # phase 14
RECURRENT_RUNS = 3           # generate calls of each path, the first a warm-up
JAMBA_LAYERS = 8             # 14a: one body of jamba's 32 layers
JAMBA_BATCH, JAMBA_PROMPT, JAMBA_NEW, JAMBA_MAX_LEN = 2, 512, 16, 1024
JAMBA_TRAIN = (1, 512)       # one forward and backward of train_logits
GRAD_NORM_TOL = 1e-2         # per-leaf (per-expert) gradient norms, relative
EXPERT_LEAVES = ("w_in", "w_gate", "w_out")  # MoE leaves with an expert axis
BLOCK_SHAPE = (1, 256)       # 14b: each recurrent block, f32, card vs CPU
BLOCK_TOL = 1e-4             # max|card - cpu| <= tol * max|cpu|
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_NEW = 4, 512, 32
GEMMA_BATCH, GEMMA_PROMPT, GEMMA_NEW = 4, 512, 32
GEMMA_LONG = 4608            # 14c: a prefill past gemma2's 4096 window
RECURRENT_TRAIN = {"xlstm-125m": (4, 512), "gemma2-2b": (2, 512)}
RECURRENT_TRAIN_STEPS = 3
MM_ARCHS = ("qwen2-vl-72b", "seamless-m4t-medium")   # phase 15
MM_RUNS = 3                  # runs of each path, the first a warm-up
MM_TOL = LM_BF16_PATH_TOL    # bf16 logits, kernel path against plain path
MM_EMBED_STD = 0.02          # the stub frontends' embeddings: the token
                             # table's scale
QWEN_LAYERS = 8              # 15a: 8 of qwen2-vl's 80 layers
SHARD_EP_CAPACITY = 8.0       # 16c: no assignment dropped by either path
SHARD_EP_TOKENS = (4, 512)    # 16c: the MoE input (B, S) at granite's width
SHARD_PIPE = (4, 8, 512, 1024)  # 16d: bodies, then x (B, S, D)
SHARD_TRAIN_TOL = 5e-2        # 16a: each updated leaf, of its max (bf16)
SHARD_LOSS_TOL = 1e-4         # 16a: the loss, relative
QWEN_BATCH, QWEN_GRID, QWEN_TEXT, QWEN_NEW = 2, 16, 768, 16
SEAMLESS_BATCH, SEAMLESS_ENC, SEAMLESS_NEW = 4, 1024, 32   # 15b


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sass_lines(lib, kernel: str, op: str) -> list[str]:
    """The SASS instructions naming `op` in the function of `lib` whose
    mangled name holds `kernel` (`cuobjdump -sass`)."""
    from repro_torch.kernels import build
    text = subprocess.run([build.tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    for part in text.split("Function : ")[1:]:
        if kernel in part.split(maxsplit=1)[0]:
            return [line.strip() for line in part.splitlines() if op in line]
    raise AssertionError(f"no function {kernel} in the SASS of {lib}")


def ptxas_kernels(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from nvcc's `-Xptxas -v` output."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], (0, 0)
        elif "spill stores" in line and name:
            words = line.replace(",", "").split()
            spill = (int(words[words.index("spill") - 2]),
                     int(words[len(words) - 4]))
        elif "Used" in line and "registers" in line and name:
            words = line.replace(",", "").split()
            out[name] = (int(words[words.index("registers") - 1]), *spill)
    return out


def fd_kernel_name(plan, kv_bf16: bool) -> str:
    """The mangled-name fragment of the flash_decode_kernel instance that a
    launch plan takes."""
    kv = "13__nv_bfloat16" if kv_bf16 else "f"
    return (f"flash_decode_kernelI{kv}Li{plan.vec}ELi{plan.nv}ELi"
            f"{plan.gt}E")


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device ms of one `fn()` call: `reps` calls captured in one CUDA graph,
    the graph replayed GRAPH_REPLAYS times between two CUDA events, so
    the wrapper's host work (operand checks, ctypes, allocation) is not
    in the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()      # warm-up outside the graph (cuBLAS handles, attributes)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * GRAPH_REPLAYS)


def rotating(fns):
    """One zero-argument call that runs fns[0], fns[1], ... in turn."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def cold_copies(args, nbytes: int, l2_bytes: int) -> list:
    """`args` and clones of its tensors, enough that the calls in between
    two uses of one copy move at least twice the L2 cache: timed in
    turn, each call reads its operands from device memory."""
    import torch
    n = min(MLP_REPS, 1 + -(-2 * l2_bytes // nbytes))
    return [args] + [tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args) for _ in range(n - 1)]


def smoke_weights(model, gen):
    """The smoke's point models: the reference's init scaled to He's gain
    (uniform +-sqrt(6 / fan_in)) with biases uniform in +-0.1 from `gen`,
    so that activations and logits stay O(1) through every layer and the
    relative checks below see real values, not a decayed signal."""
    import torch
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".w"):
                p.mul_(6.0 ** 0.5)
            else:
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * 0.1)
    return model


def rel_close(got, want) -> tuple[bool, float, float]:
    """The point path's rule: shapes equal, `got` finite, max|want| > 0
    and max|got - want| <= REL_TOL * max|want|.  Returns (ok, max abs
    error, max|want|)."""
    import torch
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return False, float("inf"), float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.abs().max())
    return scale > 0 and err <= REL_TOL * scale, err, scale


def rms(t) -> float:
    return float(t.float().square().mean().sqrt())


def planned_launches(tree) -> int:
    """Fused-MLP launches of one forward: one per group of the port's plan,
    over every MLP chain ({"fc0": ..., "fc1": ...}) of a model tree."""
    from repro_torch.core.fusion import plan_fusion
    if all(k.startswith("fc") for k in tree):
        ws = [tree[f"fc{i}"]["w"] for i in range(len(tree))]
        return len(plan_fusion([ws[0].shape[0]] + [w.shape[1] for w in ws]))
    return sum(planned_launches(v) for v in tree.values())


@contextlib.contextmanager
def mlp_groups_through(fn):
    """Run every group of `fused_mlp_chain` through `fn(x, ws, bs,
    final_act=...)` instead of the kernel: the plain path, for checks."""
    from repro_torch.kernels.fused_mlp import ops
    saved = ops.fused_mlp
    ops.fused_mlp = fn
    try:
        yield
    finally:
        ops.fused_mlp = saved


@contextlib.contextmanager
def knn_through(fn):
    """Run every `pointops.knn` call (ball query's too) through `fn`."""
    from repro_torch.core import pointops
    saved = pointops.knn
    pointops.knn = fn
    try:
        yield
    finally:
        pointops.knn = saved


def recording_knn(store):
    """kNN that appends each call's (idx, sqdist) to `store`."""
    from repro_torch.core import pointops
    orig = pointops.knn

    def fn(query, qmask, ref, rmask, k, chunk=1024):
        out = orig(query, qmask, ref, rmask, k, chunk=chunk)
        store.append(out)
        return out
    return fn


def imposed_knn(store, roots):
    """kNN that returns the recorded calls of `store` in order (the plain
    run's graph), after taking its own on its inputs: for each call it
    appends to `roots` (queries, queries whose neighbour set differs from
    the recorded one, of those the ones whose own k-th and (k+1)-th
    distances are not within KNN_TIE of each other)."""
    import torch
    from repro_torch.core import pointops
    orig = pointops.knn
    calls = iter(store)

    def fn(query, qmask, ref, rmask, k, chunk=1024):
        idx_rec, dist_rec = next(calls)
        k1 = min(k + 1, ref.shape[1])
        idx, dist = orig(query, qmask, ref, rmask, k1, chunk=chunk)
        differ = (idx[..., :k].sort(dim=-1).values
                  != idx_rec.sort(dim=-1).values).any(dim=-1)
        tie = (dist[..., k] - dist[..., k - 1] <= KNN_TIE * dist[..., k]) \
            if k1 > k else torch.zeros_like(differ)
        roots.append((differ.numel(), int(differ.sum()),
                      int((differ & ~tie).sum())))
        return idx_rec, dist_rec
    return fn


def plain_groups(record=None):
    """The plain fused-MLP version as a group function; appends each
    group's operands to `record` when given."""
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref

    def fn(x, ws, bs, *, final_act=True):
        if record is not None:
            record.append((x.contiguous(), list(ws), list(bs), final_act))
        return fused_mlp_ref(x, ws, bs, final_act)
    return fn


def cublas_chain(x, ws, bs, final_act):
    """Layer by layer through cuBLAS: the yardstick beside the kernel."""
    import torch
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = torch.addmm(b, h, w)
        if i < len(ws) - 1 or final_act:
            h.relu_()
    return h


def labels_agree(got, want, valid) -> tuple[bool, str]:
    """The point path's output check against the plain forward `want`:
    logits within `rel_close`, and argmax labels equal on `valid` rows
    except where `want`'s top-2 gap is below REL_TOL * max|want|."""
    ok, err, scale = rel_close(got, want)
    n_valid = int(valid.sum())
    if got.shape != want.shape:
        return False, f"logits {tuple(got.shape)} != {tuple(want.shape)}"
    top2 = want.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    diff = (got.argmax(-1) != want.argmax(-1)) & valid
    close = diff & (gap < REL_TOL * scale)
    ok = ok and not int((diff & ~close).sum())
    return ok, (f"logits max abs err {err:.2e}, max|plain| {scale:.3g}, "
                f"rms plain {rms(want):.3g}; labels: {int(diff.sum())} of "
                f"{n_valid} valid differ, {int(close.sum())} of them within "
                f"a top-2 gap < {REL_TOL:g} * max|plain|")


def check_labels(label, got, want, valid):
    ok, msg = labels_agree(got, want, valid)
    print(f"{label} vs plain: {msg}")
    if not ok:
        raise AssertionError(f"{label}: output differs from the plain path "
                             "beyond the tolerance")


def check_vs_fod(label, preds, logits, valid, quiet=False, against="fod"):
    """MinkUNet labels against the `logits` of another forward (by default
    the plain "fod" one): class ids in range on every row, and equal to
    its argmax on `valid` rows except where its top-2 gap is below TOL.
    Returns (rows that differ, of them near ties)."""
    n_classes = logits.shape[1]
    if preds.shape != logits.shape[:1] or int(preds.min()) < 0 \
            or int(preds.max()) >= n_classes:
        raise AssertionError(f"{label}: bad predictions {preds.shape}")
    top2 = logits.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    diff = (preds != logits.argmax(-1)) & valid
    close = diff & (gap < TOL)
    if not quiet:
        print(f"labels {label} vs {against}: {int(diff.sum())} of "
              f"{int(valid.sum())} valid rows differ, {int(close.sum())} of "
              f"them within a top-2 gap < {TOL:g}")
    if int((diff & ~close).sum()):
        raise AssertionError(f"{label}: labels differ from {against} beyond "
                             "the tolerance")
    return int(diff.sum()), int(close.sum())


def logits_of(probe, scene, flow="fod"):
    """Logits of the full forward (flow `flow`, by default the plain "fod")
    of one raw scene through the engine `probe`'s ladder and mapping
    cache, on the scene's rows."""
    import torch
    from repro_torch.core import mapping as M
    from repro_torch.models import minkunet as MU
    from repro_torch.serve.buckets import pad_scene
    coords, mask, feats = scene
    cap = probe.ladder.bucket_for(coords.shape[0])
    c, m, f = pad_scene(coords, mask, feats, cap)
    levels, _ = probe._levels_padded(c, m, cap)
    dev = probe.device
    pc = M.PointCloud(torch.from_numpy(c).to(dev), torch.from_numpy(m).to(dev),
                      1)
    logits = MU.minkunet_apply(probe.module, pc,
                               torch.from_numpy(f).to(dev).float(),
                               flow=flow, levels=levels)
    return logits[:coords.shape[0]]


def site_names(tree) -> list[str]:
    """Conv sites in `minkunet_forward` order."""
    names = ["stem"]
    for side, (stages, first) in (("enc", (tree["enc"], "down")),
                                  ("dec", (tree["dec"], "up"))):
        for i, st in enumerate(stages):
            names.append(f"{side}{i}.{first}")
            for b in range(len(st["blocks"])):
                names += [f"{side}{i}.b{b}.conv1", f"{side}{i}.b{b}.conv2"]
    return names


def record_sites(module, scene):
    """One plain ("fod") full-width MinkUNet forward of `scene` (coords,
    mask, feats) in its bucket, recording each conv's kernel operands:
    ([{"features", "inv", "weights", "epi"}, ...] in forward order, the
    logits of the scene's rows)."""
    import torch
    from repro_torch.api import PointAccSession
    from repro_torch.kernels.spconv import ops
    from repro_torch.models import minkunet as MU
    from repro_torch.serve.buckets import pad_scene
    from repro_torch.serve.engine import PointCloudEngine
    sites = []

    class Recording(PointAccSession):
        def _apply_conv(self, x, maps, out_pc, weights, epilogue, new_stride):
            epi = epilogue._replace(
                mask=epilogue.mask.float().contiguous(),
                residual=None if epilogue.residual is None
                else epilogue.residual.contiguous())
            sites.append({"features": x.feats.contiguous(),
                          "inv": ops.invert_maps(maps, out_pc.capacity),
                          "weights": weights.contiguous(), "epi": epi})
            return super()._apply_conv(x, maps, out_pc, weights, epilogue,
                                       new_stride)

    probe = PointCloudEngine(module, N_STAGES, flow="fod")
    coords, mask, feats = scene
    levels, _ = probe.levels_for(coords, mask)
    session = Recording(flow="fod")
    bucket = probe.ladder.bucket_for(coords.shape[0])
    c, m, f = pad_scene(coords, mask, feats, bucket)
    dev = probe.device
    x = session.tensor(torch.from_numpy(c).to(dev), torch.from_numpy(m).to(dev),
                       torch.from_numpy(f).to(dev),
                       context=MU._context_from_levels(levels))
    logits = MU.minkunet_forward(session, probe.module.tree(), x)
    return sites, logits[:coords.shape[0]]


def conv_couts(tree) -> set[int]:
    """Cout of every sparse-conv weight (K, Cin, Cout) in a model tree."""
    if isinstance(tree, dict):
        return set().union(*(conv_couts(v) for v in tree.values()))
    if isinstance(tree, (list, tuple)):
        return set().union(*(conv_couts(v) for v in tree))
    return {int(tree.shape[2])} if getattr(tree, "dim", lambda: 0)() == 3 \
        else set()


def level_of(site: str) -> int:
    """Stride level (0 = full resolution) of a conv site's output."""
    if site == "stem":
        return 0
    i = int(site[3])
    return i + 1 if site.startswith("enc") else N_STAGES - 1 - i


def serve_pass(sch, scenes: dict, stream, label: str, got: list) -> dict:
    """One pass of `stream` through `sch` (a ServeScheduler or a
    ServeRouter): a producer that polls after each submit, then flush()
    and drain().  Every result must be ok; (label, scene, labels) go to
    `got`.  Returns the pass's wall ms, scenes/s and exact p50/p95."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids, out = [], []
    for key in stream:         # a producer that takes what is ready as it goes
        rids.append(sch.submit(scenes[key][0], scenes[key][2],
                               scenes[key][1]))
        out += sch.poll()
    sch.flush()
    out += sch.drain()
    wall = time.perf_counter() - t0
    by_rid = {r.rid: r for r in out}
    if sorted(by_rid) != sorted(rids):
        raise AssertionError(f"{label}: results for {sorted(by_rid)}, "
                             f"submitted {sorted(rids)}")
    lat = []
    for rid, key in zip(rids, stream):
        r = by_rid[rid]
        if not r.ok:
            raise AssertionError(f"{label}: scene {key} failed: {r.error}")
        got.append((label, key, r.preds))
        lat.append(r.latency_s * 1e3)
    print(f"{label}: {len(rids)} scenes in {wall * 1e3:.2f} ms = "
          f"{len(rids) / wall:.2f} scenes/s; request latency exact p50 "
          f"{np.percentile(lat, 50):.2f} ms, p95 "
          f"{np.percentile(lat, 95):.2f} ms; completion order "
          f"{[r.rid for r in out]}")
    return {"wall_ms": wall * 1e3, "scenes_per_s": len(rids) / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95))}


def v1_phase(module, n_stages: int, scene, v2_preds, fod_logits) -> dict:
    """Phase 4e: the v1 mapping engine at full width.  `segment` of `scene`
    on an engine="v1" engine (flow "cuda_fused"): 41 tensor-core launches,
    labels vs `v2_preds` (phase 4's v2 labels) and vs `fod_logits` by the
    near-tie rule; mapping ms of v1 and v2 (miss minus hit); an
    out-of-budget stream refused by a v2 scheduler and served by a v1 one;
    a D = 2 cloud through the session at flow "cuda" vs "fod".  Returns
    its numbers and the counted run's launches."""
    import warnings

    import numpy as np
    import torch
    from repro_torch.api import MappingCache, PointAccSession
    from repro_torch.core import packed as PK
    from repro_torch.kernels.spconv import spconv as K
    from repro_torch.serve import faults as FLT
    from repro_torch.serve.engine import PointCloudEngine
    from repro_torch.serve.scheduler import ServeScheduler

    n_sites = len(site_names(module.tree()))
    coords, mask, feats = scene
    dev = fod_logits.device
    valid = torch.from_numpy(mask).to(dev)
    warnings.filterwarnings("ignore", message="transposed conv on maps "
                            "without an inverse table")

    def timed_segment(eng, sc=scene):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, hit = eng.segment(*sc)
        torch.cuda.synchronize()
        return preds, hit, (time.perf_counter() - t0) * 1e3

    v1 = PointCloudEngine(module, n_stages, flow="cuda_fused", engine="v1")
    K.reset_launch_counts()
    preds, hit, v1_miss = timed_segment(v1)
    launches = dict(K.LAUNCHES)
    print(f"v1 segment of scene {SCENE_A}: hit={hit}, launches {launches}")
    if launches["spconv_fod_fused"] != n_sites or \
            launches["spconv_fod_fused_tc"] != n_sites or \
            launches["spconv_fod"]:
        raise AssertionError(f"v1 segment launches {launches}, expected "
                             f"{n_sites} fused, all on the tensor cores")
    levels, _ = v1.levels_for(coords, mask)
    if any("cloud" in lv for lv in levels) or levels[0]["subm"].inv \
            is not None:
        raise AssertionError("the v1 engine's pyramid carries v2 state")
    top2 = fod_logits.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) < TOL

    def vs_v2(label, got):
        """Labels equal to phase 4's v2 labels on valid rows, except where
        the plain forward's top-2 gap is below TOL."""
        diff = (got.to(v2_preds.dtype) != v2_preds) & valid
        print(f"labels {label} vs v2 segment: {int(diff.sum())} of "
              f"{int(valid.sum())} valid rows differ, "
              f"{int((diff & near).sum())} of them within a top-2 gap < "
              f"{TOL:g}")
        if int((diff & ~near).sum()):
            raise AssertionError(f"{label}: labels differ from v2's beyond "
                                 "the tolerance")
        return int(diff.sum())

    vs_v2("v1 segment", preds)
    check_vs_fod("v1 segment", preds, fod_logits, valid)
    # mapping ms: the median of MAP_SAMPLES misses (mapping + forward; a
    # fresh mapping cache before each) minus the median of as many hits,
    # the two engines taking turns; every sample is printed
    v2 = PointCloudEngine(module, n_stages, flow="cuda_fused")
    samples = {"v1": ([], []), "v2": ([], [])}
    for _ in range(MAP_SAMPLES):
        for label, eng in (("v1", v1), ("v2", v2)):
            eng.session.maps_cache = MappingCache(
                eng.session.maps_cache.max_entries)
            for ms, want_hit in zip(samples[label], (False, True)):
                _, hit, t = timed_segment(eng)
                if hit != want_hit:
                    raise AssertionError(f"{label} segment: hit={hit}, "
                                         f"expected {want_hit}")
                ms.append(t)
    times = {}
    for label, (miss, hits) in samples.items():
        times[label] = {
            "miss_ms": statistics.median(miss),
            "hit_ms": statistics.median(hits),
            "mapping_ms": statistics.median(miss) - statistics.median(hits),
            "miss_samples_ms": miss, "hit_samples_ms": hits}
        print(f"{label} segment at the 65536 bucket, ms: misses "
              f"{[round(t, 2) for t in miss]}, hits "
              f"{[round(t, 2) for t in hits]}")
    print(f"v1 first segment (the counted miss above): {v1_miss:.2f} ms")
    print(f"v1 vs v2 mapping (median of {MAP_SAMPLES} misses - median of "
          f"{MAP_SAMPLES} hits): " + "; ".join(
              f"{k}: miss {v['miss_ms']:.2f}, hit {v['hit_ms']:.2f}, mapping "
              f"{v['mapping_ms']:.2f}" for k, v in times.items()))

    # out of the packed-key budget: scene A moved by +65536 in x (a multiple
    # of every level's stride, so each level quantises as the original) and
    # scene A at batch index 20000
    far = coords.copy()
    far[mask, 1] += 65536
    high = coords.copy()
    high[mask, 0] = 20000
    stream = [("x + 65536", far), ("batch 20000", high)]
    if not (int(far[mask, 1].max()) > PK.COORD_MAX
            and int(high[mask, 0].max()) > PK.BATCH_MAX):
        raise AssertionError("the out-of-budget scenes are in the budget")
    served = {}
    for label, eng in (("v2", v2), ("v1", v1)):
        sched = ServeScheduler(eng, max_batch=2)
        K.reset_launch_counts()
        rids = [sched.submit(c, feats, mask) for _, c in stream]
        sched.flush()
        out = sched.take(rids)
        counts = dict(K.LAUNCHES)
        for (what, c), rid in zip(stream, rids):
            r = out[rid]
            if label == "v2":
                try:
                    FLT.validate_scene(c, feats, mask, eng.ladder)
                except FLT.AdmissionError as e:
                    typed = e
                else:
                    raise AssertionError(f"validate_scene admits {what}")
                if r.ok or r.error.code != FLT.REJECTED or \
                        "packed-key budget" not in r.error.message:
                    raise AssertionError(f"v2 scheduler, {what}: {r}")
                print(f"v2 scheduler refuses scene A {what}: {r.error.code} "
                      f"({type(typed).__name__}: {typed})")
                continue
            if not r.ok:
                raise AssertionError(f"v1 scheduler, {what}: {r.error}")
            got = torch.as_tensor(np.asarray(r.preds)).to(dev)
            served[what] = vs_v2(f"v1 scheduler, scene A {what}", got)
        want = 0 if label == "v2" else n_sites * len(stream)
        if counts["spconv_fod_fused"] != want or \
                counts["spconv_fod_fused_tc"] != want:
            raise AssertionError(f"{label} scheduler launches {counts}, "
                                 f"expected {want}")
        print(f"{label} scheduler over the out-of-budget stream: launches "
              f"{counts}")

    # a D = 2 cloud (scene A's valid rows projected on (x, y)) through the
    # session: subm, strided and transposed convs, kernel flow vs plain
    xy = np.unique(coords[mask][:, :3], axis=0).astype(np.int32)
    gen = torch.Generator().manual_seed(7)
    cin, mid = 16, 32
    f2 = torch.randn((xy.shape[0], cin), generator=gen)
    ws = [torch.randn(shape, generator=gen) / np.sqrt(shape[0] * shape[1])
          for shape in ((9, cin, mid), (9, mid, mid), (9, mid, cin))]
    outs = {}
    for flow in ("cuda", "fod"):
        session = PointAccSession(flow=flow)
        x = session.tensor(torch.from_numpy(xy).to(dev),
                           torch.ones(xy.shape[0], dtype=torch.bool,
                                      device=dev), f2.to(dev))
        if x.context.engine != "v1":
            raise AssertionError("a D = 2 cloud did not take the v1 engine")
        K.reset_launch_counts()
        h1 = session.conv(x, ws[0].to(dev))
        h2 = session.conv(h1, ws[1].to(dev), stride=2)
        y = session.conv_transposed(h2, ws[2].to(dev), stride=2)
        torch.cuda.synchronize()
        outs[flow] = (h1.feats, h2.feats, y.feats, dict(K.LAUNCHES))
    d2 = []
    for i, what in enumerate(("k=3 stride 1", "k=3 stride 2",
                              "transposed k=3 stride 2")):
        got, want = outs["cuda"][i], outs["fod"][i]
        err = float((got - want).abs().max())
        d2.append(err)
        print(f"D = 2 cloud ({xy.shape[0]} points) {what}: flow cuda vs fod "
              f"max abs err {err:.2e}, max|plain| "
              f"{float(want.abs().max()):.3g}")
        if not torch.allclose(got, want, atol=TOL, rtol=TOL):
            raise AssertionError(f"D = 2 {what}: flow cuda differs from fod")
    l2 = outs["cuda"][3]
    if l2["spconv_fod"] != 3 or l2["spconv_fod_tc"] != 3:
        raise AssertionError(f"D = 2 session launches {l2}, expected 3 on "
                             "the tensor cores")
    if any(outs["fod"][3].values()):
        raise AssertionError("the plain flow launched a kernel")
    return {"launches": launches, "times": times, "served": served,
            "d2_points": int(xy.shape[0]), "d2_err": max(d2)}


def serving_phase(module, n_stages: int, scenes: dict, segment_engine,
                  stream=SERVE_STREAM, batch=SERVE_BATCH,
                  with_profile: bool = False) -> dict:
    """Phase 4b: a stream of scenes through a `ServeScheduler` over a
    fresh engine (flow "cuda_fused"), checked against
    `segment_engine.segment` (exactly) and against the plain "fod"
    forward of every distinct scene (phase 4's near-tie rule); returns
    its numbers and launch counts.  `with_profile` adds a cold pass over
    a fresh engine and one more replay pass, both under torch.profiler."""
    import numpy as np
    import torch
    from repro_torch.kernels.spconv import spconv as K
    from repro_torch.obs import metrics as MX
    from repro_torch.serve.engine import PointCloudEngine
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.scheduler import ServeScheduler

    n_sites = len(site_names(module.tree()))
    engine = PointCloudEngine(module, n_stages, flow="cuda_fused",
                              max_batch=SERVE_MAX_BATCH)
    sched = ServeScheduler(engine, max_batch=SERVE_MAX_BATCH,
                           pipeline_depth=2)
    plain = PointCloudEngine(module, n_stages, flow="fod")
    got = []                   # (label, scene, labels): checked after counting
    want = {}                  # scene -> (segment labels, plain fod logits)

    def check_labels_equal():
        near = differ = 0
        for label, key, preds in got:
            if key not in want:
                coords, mask, feats = scenes[key]
                want[key] = (segment_engine.segment(
                    coords, mask, feats)[0].cpu().numpy(),
                    logits_of(plain, scenes[key]).cpu())
            seg, logits = want[key]
            d, c = check_vs_fod(f"{label} scene {key}",
                                torch.from_numpy(preds).long(), logits,
                                torch.from_numpy(scenes[key][1]), quiet=True)
            differ, near = differ + d, near + c
            if not np.array_equal(preds, seg):
                diff = int((preds != seg).sum())
                raise AssertionError(f"{label}: scene {key}: {diff} labels "
                                     "differ from segment")
        print(f"labels: {len(got)} served scenes equal to segment of the "
              f"same scene on every row; against the plain fod forward of "
              f"each of {len(want)} distinct scenes {differ} valid rows "
              f"differ, {near} of them within a top-2 gap < {TOL:g}")
        got.clear()

    def run(sch, label):
        return serve_pass(sch, scenes, stream, label, got)

    def clean(st, label, failed_dispatches=0):
        ft = st["faults"]
        bad = {k: ft[k] for k in ("rejected", "shed", "timeout",
                                  "exec_failed") if ft[k]}
        if bad or ft["failed_dispatches"] != failed_dispatches:
            raise AssertionError(f"{label}: faults {ft}")

    K.reset_launch_counts()
    cold = run(sched, "serve stream (cold)")
    st_cold = sched.stats()
    print(f"cold pass: host assembly (mapping misses included) "
          f"{st_cold['assembly_time_per_batch_s'] * 1e3:.3f} ms a batch")
    warm = run(sched, "serve stream (replay)")
    st = sched.stats()
    coords = np.stack([scenes[k][0] for k in batch])
    mask = np.stack([scenes[k][1] for k in batch])
    feats = np.stack([scenes[k][2] for k in batch])
    preds, _ = engine.segment_batch(coords, mask, feats)
    launches = dict(K.LAUNCHES)
    got.extend(("segment_batch", key, preds[b].numpy())
               for b, key in enumerate(batch))
    check_labels_equal()
    levels, hit = engine.levels_for(coords, mask, batched=True)
    if not hit or len(levels) != len(batch):
        raise AssertionError(f"levels_for(batched=True): {len(levels)} "
                             f"pyramids, hit={hit}")
    print(f"levels_for(batched=True): {len(levels)} cached pyramids")
    batch_st = engine.scheduler().stats()
    ran = sum(b["scenes"] for b in st["buckets"].values()) + \
        sum(b["scenes"] for b in batch_st["buckets"].values())
    print(f"serve launches over {ran} scheduled scenes: {launches}")
    if launches["spconv_fod_fused"] != n_sites * ran or \
            launches["spconv_fod_fused_tc"] != n_sites * ran or \
            launches["spconv_fod_fused_fma"] or launches["spconv_fod"]:
        raise AssertionError(f"serve launches {launches}: expected "
                             f"{n_sites} x {ran} fused, all on the tensor "
                             "cores")

    if set(st) != MX.SCHEDULER_STATS_KEYS or \
            set(st["faults"]) != MX.SCHEDULER_FAULT_KEYS or \
            any(set(b) != MX.SCHEDULER_BUCKET_KEYS
                for b in st["buckets"].values()):
        raise AssertionError(f"stats() keys {sorted(st)}")
    n_unique = len(set(stream))
    mc, ac = st_cold["mapping_cache"], st["assembly_cache"]
    n_batches = sum(b["batches"] for b in st_cold["buckets"].values())
    if (mc["misses"], mc["hits"]) != (n_unique, len(stream) - n_unique) \
            or st["mapping_cache"] != mc:
        raise AssertionError(f"mapping cache {mc} then "
                             f"{st['mapping_cache']}")
    if (ac["misses"], ac["hits"]) != (n_batches, n_batches) or \
            st_cold["assembly_cache"]["hits"]:
        raise AssertionError(f"assembly cache {ac}")
    comp = engine.compile_stats()
    n_buckets = len(st["buckets"])
    if max(comp.values()) > n_buckets:
        raise AssertionError(f"compile_stats {comp} over {n_buckets} buckets")
    clean(st, "serve stream")
    clean(batch_st, "segment_batch")
    print(f"serve stats: buckets {st['buckets']}; mapping cache {mc}; "
          f"assembly cache {ac}; compile_stats {comp}; padding overhead "
          f"{st['padding_overhead']:.4f}; assembly "
          f"{st['assembly_time_per_batch_s'] * 1e3:.3f} ms a batch; latency "
          f"quantiles (stats(), both passes) "
          f"{ {k: round(v * 1e3, 2) for k, v in st['latency_quantiles_s'].items()} } ms")

    faulty = ServeScheduler(engine, max_batch=SERVE_MAX_BATCH,
                            pipeline_depth=2, retry_bisect=False,
                            fault_plan=FaultPlan(fail_dispatches={1}))
    run(faulty, "serve stream (one injected dispatch failure)")
    check_labels_equal()
    fst = faulty.stats()
    clean(fst, "injected fault", failed_dispatches=1)
    if fst["faults"]["retries"] != 1:
        raise AssertionError(f"injected fault: faults {fst['faults']}")
    print(f"injected fault: retried once, faults {fst['faults']}")
    if with_profile:
        from torch.profiler import ProfilerActivity, profile

        def span_ms(es):
            return sum(e.time_range.end - e.time_range.start
                       for e in es) / 1e3
        fresh = PointCloudEngine(module, n_stages, flow="cuda_fused",
                                 max_batch=SERVE_MAX_BATCH)
        for label, sch in (
                ("cold, fresh engine", ServeScheduler(
                    fresh, max_batch=SERVE_MAX_BATCH, pipeline_depth=2)),
                ("replay", sched)):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                res = run(sch, f"serve stream ({label}, profiled)")
            got.clear()
            wall = res["wall_ms"]
            print(prof.key_averages().table(sort_by="cuda_time_total",
                                            row_limit=12))
            print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                            row_limit=15))
            evs = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
            conv = [e for e in evs if "spconv_fod_tc_kernel" in e.name]
            pst = sch.stats()
            print(f"serve {label} under the profiler: wall {wall:.2f} ms, "
                  f"device events {span_ms(evs):.3f} ms over {len(evs)} "
                  f"(busy {span_ms(evs) / wall:.3f}), spconv_fod_tc_kernel "
                  f"{span_ms(conv):.3f} ms over {len(conv)} launches; host "
                  f"assembly {pst['assembly_time_per_batch_s'] * 1e3:.3f} ms "
                  f"a batch over the scheduler's passes")
    q = st["latency_quantiles_s"]
    return {"cold": cold, "warm": warm, "launches": launches,
            "scenes": ran, "p50_ms": q["p50"] * 1e3,
            "p95_ms": q["p95"] * 1e3}


def router_phase(module, n_stages: int, scenes: dict, segment_engine,
                 stream=SERVE_STREAM) -> dict:
    """Phase 4c: `stream` through a ServeRouter of ROUTER_WORKERS workers
    (engines from `PointCloudEngine.factory`, flow "cuda_fused", one card),
    then once more through a router over the same, now warm, engines in
    which one worker is killed; labels held to `segment_engine.segment`.
    Returns its numbers and launch counts."""
    import numpy as np
    from repro_torch.kernels.spconv import spconv as K
    from repro_torch.obs import metrics as MX
    from repro_torch.serve.engine import PointCloudEngine
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.router import LivenessPolicy, ServeRouter

    n_sites = len(site_names(module.tree()))
    got, want = [], {}

    def check_labels_equal(label):
        for _, key, preds in got:
            if key not in want:
                coords, mask, feats = scenes[key]
                want[key] = segment_engine.segment(
                    coords, mask, feats)[0].cpu().numpy()
            if not np.array_equal(preds, want[key]):
                diff = int((preds != want[key]).sum())
                raise AssertionError(f"{label}: scene {key}: {diff} labels "
                                     "differ from segment")
        print(f"{label}: {len(got)} routed scenes equal to segment of the "
              "same scene on every row")
        got.clear()

    def clean(st, label, failovers=0):
        ft = st["faults"]
        bad = {k: ft[k] for k in ("rejected", "shed", "timeout",
                                  "exec_failed") if ft[k]}
        if bad or ft["failovers"] != failovers:
            raise AssertionError(f"{label}: faults {ft}")

    build = PointCloudEngine.factory(module, n_stages, flow="cuda_fused")
    engines = []               # the workers' engines, kept for the kill pass

    def factory():
        engines.append(build())
        return engines[-1]

    router = ServeRouter(factory, ROUTER_WORKERS, max_batch=SERVE_MAX_BATCH,
                         pipeline_depth=2)
    previews = [router.preview(scenes[k][0], scenes[k][1]) for k in stream]
    K.reset_launch_counts()
    cold = serve_pass(router, scenes, stream, "router stream (cold)", got)
    launches = dict(K.LAUNCHES)
    st = router.stats()
    router.close()
    check_labels_equal("router stream")
    routed = {name: w["routed"] for name, w in st["workers"].items()}
    print(f"router: previews {previews}; routed {routed}")
    if routed != {name: previews.count(name) for name in routed}:
        raise AssertionError(f"routed {routed} != previews {previews}")
    ran = sum(b["scenes"] for w in st["workers"].values()
              for b in w["scheduler"]["buckets"].values())
    print(f"router launches over {ran} scheduled scenes: {launches}")
    if ran != len(stream) or \
            launches["spconv_fod_fused"] != n_sites * ran or \
            launches["spconv_fod_fused_tc"] != n_sites * ran or \
            launches["spconv_fod_fused_fma"] or launches["spconv_fod"]:
        raise AssertionError(f"router launches {launches}: expected "
                             f"{n_sites} x {len(stream)} fused, all on the "
                             "tensor cores")
    if set(st) != MX.ROUTER_STATS_KEYS or \
            set(st["faults"]) != MX.ROUTER_FAULT_KEYS:
        raise AssertionError(f"router stats() keys {sorted(st)}, faults "
                             f"{sorted(st['faults'])}")
    clean(st, "router stream")

    # the same engines, warm, under a tight liveness policy: the worker
    # that the stream loads most dies on its third request
    victim = max(routed, key=routed.get)
    if routed[victim] <= ROUTER_KILL_STEP:
        raise AssertionError(f"no worker takes {ROUTER_KILL_STEP + 1} "
                             f"scenes: {routed}")
    ordinal = st["workers"][victim]["ordinal"]
    plan = FaultPlan(kill_workers={ordinal: ROUTER_KILL_STEP})
    warm = iter(engines)
    faulty = ServeRouter(lambda: next(warm), ROUTER_WORKERS,
                         max_batch=SERVE_MAX_BATCH, pipeline_depth=2,
                         fault_plan=plan)
    faulty.liveness = LivenessPolicy(beat_s=0.05, miss_beats=100)
    killed = serve_pass(faulty, scenes, stream,
                        f"router stream (worker {victim} killed)", got)
    fst = faulty.stats()
    faulty.close()
    check_labels_equal("router stream, one worker killed")
    clean(fst, "worker kill", failovers=1)
    if fst["faults"]["replayed"] < 1 or \
            plan.stats()["workers_killed"] != 1 or \
            fst["workers"][victim]["state"] != "dead":
        raise AssertionError(f"worker kill: faults {fst['faults']}, plan "
                             f"{plan.stats()}")
    print(f"worker kill: {victim} dead ({fst['workers'][victim]['reason']}),"
          f" faults {fst['faults']}")
    return {"cold": cold, "killed": killed, "launches": launches,
            "scenes": ran, "replayed": fst["faults"]["replayed"],
            "recovery_s": fst["faults"]["recovery_s"]}


def partition_phase(module, n_stages: int, scene, oversized,
                    mono_ladder=None, n_forced=FORCED_CHUNKS,
                    n_auto=AUTO_CHUNKS) -> dict:
    """Phase 4d: `segment(partition=)` on `scene` forced into chunks, and
    on `oversized` (above the ladder) through "auto", on an engine with
    flow "cuda_fused" and tracing on; each held to one monolithic forward
    (an engine whose ladder is `mono_ladder` runs `oversized` whole) by the
    near-tie rule.  Returns its numbers and launch counts."""
    import numpy as np
    import torch
    from repro_torch.kernels.spconv import spconv as K
    from repro_torch.obs import Observability
    from repro_torch.partition import PartitionPolicy
    from repro_torch.serve.buckets import geometric_ladder
    from repro_torch.serve.engine import PointCloudEngine

    n_sites = len(site_names(module.tree()))
    engine = PointCloudEngine(module, n_stages, flow="cuda_fused",
                              obs=Observability.enabled())
    top = engine.ladder.capacities[-1]
    out = {"launches": {}, "chunks": 0}

    def partitioned(label, sc, policy, n_chunks):
        coords, mask, feats = sc
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        preds, hit = engine.segment(coords, mask, feats, partition=policy)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        st = engine.last_partition_stats
        trace = [t for t in engine.obs.tracer.finished()
                 if t.tid.startswith("partition:")][-1]
        (fan,), (stitch,) = trace.find("chunk_fanout"), trace.find("stitch")
        plan_ms = (trace.spans[trace.root_id].t_start - t0) * 1e3
        chunks_ms = (stitch.t_start - fan.t_start) * 1e3
        print(f"{label}: {st['n_chunks']} chunks of {st['chunk_points']} "
              f"points (budget {st['budget']}, halo fraction "
              f"{st['halo_fraction']:.4f}), hit={hit}; plan on the host "
              f"{plan_ms:.2f} ms, chunks served {chunks_ms:.2f} ms; "
              f"launches {launches}")
        preds = preds.cpu()
        if st["n_chunks"] != n_chunks or st["chunk_errors"] or \
                st["max_chunk_points"] > top or \
                preds.shape != (coords.shape[0],) or \
                bool((preds[torch.from_numpy(~mask)] != -1).any()):
            raise AssertionError(f"{label}: stats {st}")
        if launches["spconv_fod_fused"] != n_sites * n_chunks or \
                launches["spconv_fod_fused_tc"] != n_sites * n_chunks or \
                launches["spconv_fod_fused_fma"] or launches["spconv_fod"]:
            raise AssertionError(f"{label}: launches {launches}, expected "
                                 f"{n_sites} x {n_chunks} fused, all on the "
                                 "tensor cores")
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        out["chunks"] += n_chunks
        return preds, hit, st, plan_ms, chunks_ms

    def held_to_whole(label, preds, probe, sc):
        coords, mask, _ = sc
        probe.levels_for(coords, mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = logits_of(probe, sc, flow=probe.flow)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        whole, _ = probe.segment(coords, mask, sc[2])
        if not torch.equal(whole.cpu().long(), logits.argmax(-1).cpu()):
            raise AssertionError(f"{label}: segment != argmax of its forward")
        valid = torch.from_numpy(mask)
        logits = logits.cpu()
        # masked rows are -1 (checked in `partitioned`); the rule reads the
        # valid ones
        preds = torch.where(valid, preds.long(), logits.argmax(-1))
        d, near = check_vs_fod(label, preds, logits, valid,
                               against="the monolithic forward")
        return ms, d, near

    forced = partitioned(f"scene {SCENE_A} forced into chunks", scene,
                         PartitionPolicy(force=True), n_forced)
    d_a = held_to_whole("partitioned scene A", forced[0], engine, scene)

    coords, mask, feats = oversized
    try:
        engine.segment(coords, mask, feats)
    except ValueError as e:
        if "exceeds the bucket ladder" not in str(e):
            raise
        print(f"oversized scene ({coords.shape[0]} rows) without partition: "
              f"{e}")
    else:
        raise AssertionError("an oversized scene was served whole")
    auto = partitioned("oversized scene, partition='auto'", oversized,
                       "auto", n_auto)
    if auto[1] is not False:
        raise AssertionError(f"oversized scene, first pass: hit={auto[1]}")
    mono = PointCloudEngine(module, n_stages, flow="cuda_fused",
                            ladder=mono_ladder or geometric_ladder(128,
                                                                   MONO_TOP))
    K.reset_launch_counts()
    mono_ms, d_o, near_o = held_to_whole("partitioned oversized scene",
                                         auto[0], mono, oversized)
    print(f"monolithic forward of the oversized scene at the "
          f"{mono.ladder.bucket_for(coords.shape[0])} bucket: {mono_ms:.2f} ms"
          f" (mapping cached), launches {dict(K.LAUNCHES)}")
    again = partitioned("oversized scene again", oversized, "auto", n_auto)
    if again[1] is not True or not torch.equal(again[0], auto[0]):
        raise AssertionError(f"oversized scene repeat: hit={again[1]}, "
                             "labels equal: "
                             f"{torch.equal(again[0], auto[0])}")
    out.update({
        "forced": {"n_chunks": forced[2]["n_chunks"],
                   "halo_fraction": forced[2]["halo_fraction"],
                   "plan_ms": forced[3], "chunks_ms": forced[4],
                   "mono_ms": d_a[0], "differ": d_a[1], "near": d_a[2]},
        "oversized": {"n_chunks": auto[2]["n_chunks"],
                      "chunk_points": auto[2]["chunk_points"],
                      "halo_fraction": auto[2]["halo_fraction"],
                      "plan_ms": auto[3], "chunks_ms": auto[4],
                      "hit_plan_ms": again[3], "hit_chunks_ms": again[4],
                      "mono_ms": mono_ms, "differ": d_o, "near": near_o}})
    return out


def point_phases(dev, mem_rate: float, flop_rate: float, tf32_rate: float,
                 with_profile: bool):
    """Phases 5-7 (see the module docstring).  Returns the main-path
    fused-MLP launch counts and the kernel phase's PointNet++(s) totals."""
    import torch
    from repro_torch.data.synthetic import dense_xyz_batch
    from repro_torch.kernels.fused_mlp import fused_mlp as FK
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    from repro_torch.models import pointnets as PN

    def cloud_batch(spec, last_valid):
        xyz, pmask, _ = dense_xyz_batch(*spec)
        pmask[-1, last_valid:] = False
        return (torch.from_numpy(xyz).to(dev), torch.from_numpy(pmask).to(dev))

    def model(init, seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        return smoke_weights(getattr(PN, init)(gen, device=dev, **kw), gen)

    # 5. point kernels, on the input of every fused-MLP group of one plain
    # PointNet++(s) forward and one plain PointNet forward
    xyz, pmask = cloud_batch(PN_BATCH, PN_LAST_VALID)
    seg = model("pointnetpp_seg_init", 0, n_classes=13)
    seg_groups, pn_groups = [], []
    with mlp_groups_through(plain_groups(seg_groups)):
        seg_plain = seg(xyz, pmask)
    per_forward = planned_launches(seg.tree())
    if not len(seg_groups) == per_forward == 6:
        raise AssertionError(f"PointNet++(s): {len(seg_groups)} groups "
                             f"recorded, {per_forward} planned; expected 6")
    oxyz, omask = cloud_batch(OTHER_BATCH, OTHER_LAST_VALID)
    pointnet = model("pointnet_init", 1, n_classes=40)
    with mlp_groups_through(plain_groups(pn_groups)):
        pointnet(oxyz, omask)

    print(f"fused_mlp kernel phase: every group of one PointNet++(s) "
          f"forward {PN_BATCH[2]}x{PN_BATCH[3]} and one PointNet forward "
          f"{OTHER_BATCH[2]}x{OTHER_BATCH[3]}; rule max|kernel - plain| <= "
          f"{REL_TOL:g} * max|plain| (the kernel and the FMA kernel); ms = "
          f"device time a call ({MLP_REPS} calls in one CUDA graph, "
          f"{GRAPH_REPLAYS} replays, CUDA events); kernel = the variant "
          f"plan_mlp names (csrc/fused_mlp_tc.cu), fma = csrc/fused_mlp.cu "
          f"forced; bounds: bytes at "
          f"{mem_rate / 1e12:g} TB/s against FLOPs at {flop_rate / 1e12:g} "
          f"TFLOP/s (f32) or 3 x FLOPs at {tf32_rate / 1e12:g} TFLOP/s "
          f"(tf32x3)")
    print(f"{'group':12s} {'rows':>7s} {'widths':24s} {'variant':9s} "
          f"{'R':>3s} {'grid':>9s} {'smem':>6s} {'rms':>8s} "
          f"{'max':>8s} {'err':>9s} {'err_fma':>9s} {'kernel':>8s} "
          f"{'fma':>8s} {'plain':>8s} {'cublas':>8s} "
          f"{'b_f32':>8s} {'b_tf32':>8s} {'by':>5s}")
    mlp = {"ms": 0.0, "fma": 0.0, "plain": 0.0, "cublas": 0.0, "bound": 0.0,
           "bound_f32": 0.0, "bytes": 0.0, "ops": 0.0, "tc_ops": 0.0,
           "err": 0.0}
    seg_names = [g[0] for g in PN_SEG_GROUPS]
    got_groups = [(n, tuple([gx.shape[1]] + [w.shape[1] for w in ws]),
                   gx.shape[0]) for n, (gx, ws, _, _) in zip(seg_names,
                                                             seg_groups)]
    if got_groups != list(PN_SEG_GROUPS):
        raise AssertionError(f"PointNet++(s) groups {got_groups}, expected "
                             f"{PN_SEG_GROUPS}")
    pn_names = [f"pointnet.{i}" for i in range(len(pn_groups))]
    per_group = {}
    for gname, (gx, ws, bs, fa) in zip(seg_names + pn_names,
                                       seg_groups + pn_groups):
        plan = FK.plan_for(gx, ws, bs)
        got = FK.fused_mlp_cuda(gx, ws, bs, fa)
        want = fused_mlp_ref(gx, ws, bs, fa)
        ok, err, scale = rel_close(got, want)
        ok_fma, err_fma, _ = rel_close(
            FK.fused_mlp_kernel(gx, ws, bs, fa, kind="fma"), want)
        if not (ok and ok_fma):
            raise AssertionError(
                f"fused_mlp kernel disagrees with its plain version at "
                f"{gname}: max abs err {err} ({plan.variant}), {err_fma} "
                f"(fma) against max|plain| {scale}")
        rows = gx.shape[0]
        widths = [gx.shape[1]] + [w.shape[1] for w in ws]
        nbytes = 4 * (rows * (widths[0] + widths[-1])
                      + sum(w.numel() + b.numel() for w, b in zip(ws, bs)))
        flops = 2.0 * rows * sum(a * b for a, b in zip(widths, widths[1:]))
        b_bytes = nbytes / mem_rate * 1e3
        b_ops, b_tc = flops / flop_rate * 1e3, 3 * flops / tf32_rate * 1e3
        t = {"ms": graph_ms(lambda: FK.fused_mlp_cuda(gx, ws, bs, fa),
                            MLP_REPS),
             "fma": graph_ms(lambda: FK.fused_mlp_kernel(gx, ws, bs, fa,
                                                         kind="fma"),
                             MLP_REPS),
             "plain": graph_ms(lambda: fused_mlp_ref(gx, ws, bs, fa),
                               MLP_REPS),
             "cublas": graph_ms(lambda: cublas_chain(gx, ws, bs, fa),
                                MLP_REPS)}
        bound, bound_f32 = max(b_bytes, b_tc), max(b_bytes, b_ops)
        per_group[gname] = {
            "variant": plan.variant, "rows": rows, "widths": widths,
            "plan": plan._asdict(), "err": err,
            "bound_tf32x3": bound, "bound_f32": bound_f32, **t}
        if gname in seg_names:
            for key in ("ms", "fma", "plain", "cublas"):
                mlp[key] += t[key]
            mlp["bound"] += bound
            mlp["bound_f32"] += bound_f32
            mlp["bytes"] += b_bytes
            mlp["ops"] += b_ops
            mlp["tc_ops"] += b_tc
        mlp["err"] = max(mlp["err"], err)
        print(f"{gname:12s} {rows:7d} {str(widths):24s} {plan.variant:9s} "
              f"{plan.rows:3d} {str(plan.grid):>9s} {plan.smem:6d} "
              f"{rms(want):8.3g} {scale:8.3g} {err:9.2e} {err_fma:9.2e} "
              f"{t['ms']:8.4f} {t['fma']:8.4f} {t['plain']:8.4f} "
              f"{t['cublas']:8.4f} {bound_f32:8.4f} {bound:8.4f} "
              f"{'ops' if b_tc >= b_bytes else 'bytes':>5s}")
    mlp["groups"] = per_group
    print(f"PointNet++(s) forward, 6 groups: kernel {mlp['ms']:.4f} ms, FMA "
          f"kernel {mlp['fma']:.4f} ms, plain {mlp['plain']:.4f} ms, cuBLAS "
          f"layer by layer {mlp['cublas']:.4f} ms; bound (tf32x3) "
          f"{mlp['bound']:.4f} ms (bytes {mlp['bytes']:.4f}, 3 x ops "
          f"{mlp['tc_ops']:.4f}), bound (f32) {mlp['bound_f32']:.4f} ms (ops "
          f"{mlp['ops']:.4f})")

    # 6. point path: PointNet++(s) through the kernel
    FK.reset_launch_counts()
    seg_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg_logits = seg(xyz, pmask)
        torch.cuda.synchronize()
        seg_ms.append((time.perf_counter() - t0) * 1e3)
    point_launches = dict(FK.LAUNCHES)
    tensor_core = sum(point_launches[f"fused_mlp_{v}"] for v in FK.VARIANTS
                      if v != "fma")
    if point_launches["fused_mlp"] != 4 * per_forward or \
            tensor_core != 4 * per_forward:
        raise AssertionError(f"fused_mlp launches {point_launches}, expected "
                             f"{per_forward} per forward, none fma")
    n_pts = PN_BATCH[2] * PN_BATCH[3]
    seg_median = statistics.median(seg_ms[1:])
    print(f"PointNet++(s) forward {PN_BATCH[2]}x{PN_BATCH[3]}: warm-up "
          f"{seg_ms[0]:.2f} ms, timed {[round(v, 2) for v in seg_ms[1:]]} "
          f"ms, median {seg_median:.2f} ms, {n_pts / seg_median * 1e3:.0f} "
          f"points/s; fused_mlp launches {point_launches['fused_mlp']} "
          f"({per_forward} per forward; by variant "
          f"{ {v: point_launches[f'fused_mlp_{v}'] for v in FK.VARIANTS} })")
    if seg_logits.shape != (PN_BATCH[2], PN_BATCH[3], 13):
        raise AssertionError(f"PointNet++(s) logits {seg_logits.shape}")
    check_labels("PointNet++(s)", seg_logits, seg_plain, pmask)

    # negative controls: the same check must reject a forward in which one
    # group is wrong (each group in turn written as zeros; the head off by
    # a relative 1e-4)
    def broken(bad_group, corrupt):
        calls = []

        def fn(x, ws, bs, *, final_act=True):
            out = fused_mlp_ref(x, ws, bs, final_act)
            calls.append(len(calls))
            return corrupt(out) if calls[-1] == bad_group else out
        return fn
    controls = [(f"{g} written as zeros", i, torch.zeros_like)
                for i, g in enumerate(seg_names)]
    controls.append(("head times (1 + 1e-4)", 5, lambda o: o * (1 + 1e-4)))
    for what, gi, corrupt in controls:
        with mlp_groups_through(broken(gi, corrupt)):
            bad = seg(xyz, pmask)
        ok, msg = labels_agree(bad, seg_plain, pmask)
        print(f"negative control, {what}: {msg} -> "
              f"{'ACCEPTED' if ok else 'rejected'}")
        if ok:
            raise AssertionError(f"the PointNet++(s) check accepts a forward "
                                 f"with {what}")

    # 7. the other five models, through the kernel and plain
    others = [
        ("PointNet", pointnet, {}),
        ("PointNet++(c)", model("pointnetpp_cls_init", 2, n_classes=40), {}),
        ("PointNet++(ps)", model("pointnetpp_seg_init", 3, n_classes=50), {}),
        ("DGCNN", model("dgcnn_init", 4, n_classes=16), {"k": 20}),
        ("F-PointNet++", model("fpointnetpp_init", 5), {}),
    ]
    # DGCNN takes kNN on features, where a difference of 1e-6 can swap two
    # neighbours at a near tie and change the graph: each forward through
    # the kernel takes the plain run's kNN graph (`imposed_knn`), and every
    # neighbour set its own kNN would choose otherwise must be a near tie
    # (on xyz, as in the other models, the sets are equal)
    cloud_rows = torch.ones(OTHER_BATCH[2], dtype=torch.bool, device=dev)
    for label, net, kw in others:
        store, roots = [], []
        with mlp_groups_through(plain_groups()), \
                knn_through(recording_knn(store)):
            plain = net(oxyz, omask, **kw)
        before = dict(FK.LAUNCHES)
        with knn_through(imposed_knn(store, roots)):
            out = net(oxyz, omask, **kw)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in FK.LAUNCHES.items()
                 if v != before[k]}
        n_launch = moved.get("fused_mlp", 0)
        print(f"{label}: {n_launch} fused_mlp launches ({moved}); kNN calls "
              f"(queries, sets that differ from the plain run's, of them not "
              f"near ties): {roots}")
        if n_launch != planned_launches(net.tree()) or "fused_mlp_fma" in moved:
            raise AssertionError(f"{label}: launches {moved}, planned "
                                 f"{planned_launches(net.tree())}, none fma")
        if any(r[2] for r in roots):
            raise AssertionError(f"{label}: a kNN set differs from the plain "
                                 f"run's away from a near tie: {roots}")
        free = net(oxyz, omask, **kw)
        free = free["seg"] if isinstance(free, dict) else free
        ok_free, msg = labels_agree(free, plain["seg"] if isinstance(
            plain, dict) else plain, omask if free.dim() == 3 else cloud_rows)
        print(f"{label} with its own kNN graph (not checked): {msg}")
        if label == "F-PointNet++":
            for key in ("center", "box"):
                ok, err, scale = rel_close(out[key], plain[key])
                print(f"{label} {key}: max abs err {err:.2e}, max|plain| "
                      f"{scale:.3g}")
                if not ok:
                    raise AssertionError(f"{label} {key} differs from plain")
            out, plain = out["seg"], plain["seg"]
        check_labels(label, out, plain,
                     omask if out.dim() == 3 else cloud_rows)

    if with_profile:
        from torch.profiler import ProfilerActivity, profile, record_function
        from repro_torch.core import pointops
        from repro_torch.kernels.fused_mlp import ops as fops
        labelled = [(pointops, "farthest_point_sampling", "fps"),
                    (pointops, "ball_query", "ball_query"),
                    (pointops, "knn", "knn"),
                    (pointops, "gather_points", "gather_points"),
                    (fops, "fused_mlp", "fused_mlp_group")]
        saved = [getattr(mod, fn) for mod, fn, _ in labelled]

        def labelled_fn(fn, label):
            def run(*a, **k):
                with record_function(label):
                    return fn(*a, **k)
            return run
        for (mod, fn, label), orig in zip(labelled, saved):
            setattr(mod, fn, labelled_fn(orig, label))
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                seg(xyz, pmask)
                torch.cuda.synchronize()
        finally:
            for (mod, fn, _), orig in zip(labelled, saved):
                setattr(mod, fn, orig)
        rows = prof.key_averages()
        print(rows.table(sort_by="cuda_time_total", row_limit=25))

        def busy_us(evt):
            return evt.time_range.end - evt.time_range.start
        names = {lab for _, _, lab in labelled}
        split = []
        for evt in rows:
            if evt.key in names and evt.cpu_time_total > 0:
                split.append(f"{evt.key}: {evt.count} calls, host "
                             f"{evt.cpu_time_total / 1e3:.2f} ms, device "
                             f"{evt.device_time_total / 1e3:.3f} ms")
        # device events without the GPU-side spans of the labels above,
        # which cover idle time between their kernels
        device_events = [e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and e.name not in names
                         and not getattr(e, "is_user_annotation", False)]
        kernel_events = [e for e in device_events
                         if "fused_mlp_" in e.name and "_kernel" in e.name]
        print("PointNet++(s) forward split under the profiler (device = "
              "kernels the profiler ties to the calls; ball_query includes "
              "its knn; the ctypes launches are not tied to "
              "fused_mlp_group): " + "; ".join(split))
        print(f"PointNet++(s) profiled forward: device time of all device "
              f"events (kernels, copies, fills) "
              f"{sum(busy_us(e) for e in device_events) / 1e3:.3f} ms over "
              f"{len(device_events)}; fused_mlp kernels (every variant) "
              f"{sum(busy_us(e) for e in kernel_events) / 1e3:.3f} ms over "
              f"{len(kernel_events)} launches")
    return point_launches, mlp


@contextlib.contextmanager
def lm_kernels_through(fa=None, gmm=None, fd=None):
    """Run the LM path's flash_attention / grouped_matmul / flash_decode
    calls through the given functions (same signatures as the `ops`
    entry points) instead of the kernels: the plain path, recording or
    broken stand-ins, for checks."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    slots = [(fa_ops, "flash_attention", fa), (gmm_ops, "grouped_matmul", gmm),
             (fd_ops, "flash_decode", fd)]
    saved = [getattr(mod, name) for mod, name, _ in slots]
    for mod, name, fn in slots:
        if fn is not None:
            setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), orig in zip(slots, saved):
            setattr(mod, name, orig)


def plain_lm(record=None, keep_calls=None):
    """The three LM kernels' plain versions as ops-shaped functions.  With
    `record`, each call appends to record[name] its operands when its call
    index is in keep_calls[name], else None."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

    def keep(name, args):
        if record is not None:
            calls = record.setdefault(name, [])
            calls.append(args if len(calls) in keep_calls[name] else None)

    def fa(q, k, v, causal=True, window=None, softcap=None, scale=None):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        keep("flash_attention", (q, k, v, kw))
        return attention_ref(q, k, v, **kw)

    def gmm(x, tile_eid, weights, row_tile=128):
        keep("grouped_matmul", (x.contiguous(), tile_eid, weights, row_tile))
        return grouped_matmul_ref(x, tile_eid, weights, row_tile)

    def fd(q, k, v, lengths, *, softcap=None, scale=None):
        lengths = lengths.to(torch.int32)
        keep("flash_decode", (q.contiguous(), k, v, lengths,
                              dict(softcap=softcap, scale=scale)))
        return flash_decode_ref(q, k, v, lengths, softcap=softcap, scale=scale)
    return {"fa": fa, "gmm": gmm, "fd": fd}


def teacher_forced(engine, prompts, tokens, steps=None):
    """The engine's prefill on `prompts`, then decode steps fed `tokens`
    (B, N) (the first `steps` of them): the logits of the prefill
    (B, S, V) and of each step (B, V), in float32."""
    import torch
    from repro_torch.distributed import sharding as SH
    b, s = prompts.shape
    dev = engine.device
    sc = getattr(engine, "sc", None)
    kw = {} if sc is None else {"shard": SH.make_shard_fn(sc),
                                "mesh": sc.mesh}
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64, device=dev),
             "positions": torch.arange(s, device=dev).expand(b, s)}
    with torch.no_grad():
        logits, pre, _ = engine.model.prefill(engine.params, batch, **kw)
        out = [SH.full(logits).float()]
        states = engine.place_states(pre, b)
        del pre, logits
        n = tokens.shape[1] if steps is None else steps
        for t in range(n):
            pos = s + t
            db = {"tokens": torch.as_tensor(tokens[:, t:t + 1], dtype=torch.int64,
                                            device=dev),
                  "positions": torch.full((b, 1), pos, dtype=torch.int64,
                                          device=dev),
                  "cache_pos": torch.full((b,), pos, dtype=torch.int64,
                                          device=dev)}
            logits, states, _ = engine.model.decode(engine.params, db, states,
                                                    **kw)
            out.append(SH.full(logits[:, -1]).float())
    return out


def lm_compare(got, want, tol):
    """The LM path's rule, step by step (prefill, then each decode step):
    max|got - want| <= tol * max|want|, and greedy tokens equal except
    where want's top-2 gap is below tol * max|want|.  Returns (ok, tokens
    that differ, of them tolerated, relative error per step)."""
    ok, n_diff, n_close, rels = True, 0, 0, []
    for g, w in zip(got, want):
        if g.shape != w.shape or not bool(g.isfinite().all()):
            return False, -1, 0, rels
        scale = float(w.abs().max())
        rel = float((g - w).abs().max()) / scale
        rels.append(rel)
        top2 = w.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        diff = g.argmax(-1) != w.argmax(-1)
        close = diff & (gap < tol * scale)
        n_diff += int(diff.sum())
        n_close += int(close.sum())
        ok = ok and rel <= tol and not int((diff & ~close).sum())
    return ok, n_diff, n_close, rels


@contextlib.contextmanager
def routes_through(fn):
    """Run the MoE router (`models.moe.route`) through `fn`."""
    from repro_torch.models import moe
    saved = moe.route
    moe.route = fn
    try:
        yield
    finally:
        moe.route = saved


def _router_probs(p, x2d):
    import torch
    from repro_torch import nn
    return torch.softmax(nn.dense(p["router"], x2d).float(), dim=-1)


def recording_route(store):
    """`route` that appends, per call, its expert choices and the top-(k+1)
    router probabilities, sorted."""
    from repro_torch.models import moe
    route = moe.route

    def fn(p, cfg, x2d):
        out = route(p, cfg, x2d)
        top = _router_probs(p, x2d).sort(dim=-1, descending=True).values
        store.append((out[1], top[:, :cfg.topk + 1]))
        return out
    return fn


def imposed_route(routes):
    """`route` that takes its expert choices, call by call, from a recorded
    run, with gates from this run's router probabilities at those
    experts."""
    from repro_torch.models import moe
    route = moe.route
    calls = iter(routes)

    def fn(p, cfg, x2d):
        _, _, aux = route(p, cfg, x2d)
        idx = next(calls)[0]
        g = _router_probs(p, x2d).gather(1, idx)
        return (g / g.sum(dim=-1, keepdim=True)).to(x2d.dtype), idx, aux
    return fn


def routing_flips(got, want, batch: int, n_layers: int):
    """Compare two recorded runs' routing (prefill calls, then decode steps,
    n_layers calls each).  A (token, layer) pair whose expert set differs
    perturbs every later layer of its sequence at its position and after;
    in the prefill it perturbs every later layer of every token, since the
    sorted dispatch drops assignments past an expert's capacity over the
    whole batch.  Only differences outside every earlier one's reach are
    root causes.  Returns (pairs that differ, the roots as (layer,
    position, relative top-k gap (p_k - p_{k+1}) / p_k of `want`'s router)
    sorted widest gap first)."""
    seq = want[0][0].shape[0] // batch
    flips = []                           # (sequence, layer, pos, gap)
    for c, ((gi, _), (wi, wtop)) in enumerate(zip(got, want)):
        diff = (gi.sort(-1).values != wi.sort(-1).values).any(-1)
        if not bool(diff.any()):
            continue
        k = wi.shape[1]
        gap = ((wtop[:, k - 1] - wtop[:, k]) / wtop[:, k - 1]).tolist()
        layer, step = c % n_layers, c // n_layers
        for t in diff.nonzero().flatten().tolist():
            b, pos = divmod(t, seq) if step == 0 else (t, seq + step - 1)
            flips.append((b, layer, pos, gap[t]))
    first_prefill = min((f[1] for f in flips if f[2] < seq), default=n_layers)
    roots = [(layer, pos, gap) for b, layer, pos, gap in flips
             if layer <= first_prefill
             and not any(b0 == b and l0 < layer and p0 <= pos
                         for b0, l0, p0, _ in flips)]
    return len(flips), sorted(roots, key=lambda r: -r[2])


def capacity_drops(routes, n_experts: int, n_layers: int,
                   capacity_factor: float = 1.5, row_tile: int = 128) -> int:
    """Assignments the sorted dispatch drops at capacity over a recorded
    run's prefill calls (the capacity rule of `sorted_moe_ffn`)."""
    import torch
    drops = 0
    for idx, _ in routes[:n_layers]:
        t, k = idx.shape
        cap = -(-(int(t * k * capacity_factor / n_experts) + 1) // row_tile) \
            * row_tile
        counts = torch.bincount(idx.flatten(), minlength=n_experts)
        drops += int((counts - cap).clamp(min=0).sum())
    return drops


def windowed_decode_check(dev, cfg):
    """One decode step of an attention layer at the config's widths, f32,
    with a window shorter than its plain cache (the valid slots are no
    prefix: the masked path, as in the reference): on the card within
    REL_TOL * max|plain| of the same call on the CPU."""
    import numpy as np
    import torch
    from repro_torch.models import layers as TL
    s_cache, window = 1024, 128
    rng = np.random.default_rng(5)
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (h * hd, d)}
    ws = {n: rng.normal(size=sh) / np.sqrt(sh[0]) for n, sh in shapes.items()}
    x = rng.normal(size=(2, 1, d))
    kv = rng.normal(size=(2, 2, s_cache, hkv, hd))
    pos = np.array([window // 2, s_cache - 100])

    def run(device):
        def t(a, dtype=torch.float32):
            return torch.tensor(a, dtype=dtype, device=device)
        out, _ = TL.attention_apply(
            {n: {"w": t(w)} for n, w in ws.items()}, cfg, t(x),
            t(pos[:, None], torch.int64), layer_window=window, mode="decode",
            cache=TL.KVCache(t(kv[0]), t(kv[1])),
            cache_pos=t(pos, torch.int64))
        return out.cpu()
    got, want = run(dev), run("cpu")
    ok, err, scale = rel_close(got, want)
    print(f"windowed decode (window {window} < {s_cache}-slot cache, f32, "
          f"masked path) on the card vs the CPU: max abs err {err:.2e}, "
          f"max|plain| {scale:.3g}, tol {REL_TOL:g} x max|plain|")
    if not ok:
        raise AssertionError("windowed decode differs from the CPU call")


def lm_calls(kind, args, dtype=None):
    """(kernel, plain, library) zero-argument calls on a recorded LM kernel
    call's operands `args`, cast to dtype when given; flash_attention and
    grouped_matmul add their earlier float32-FMA kernel."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as FAK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.flash_decode import flash_decode as FDK
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GMK
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    cast = (lambda t: t.to(dtype)) if dtype is not None else (lambda t: t)
    if kind == "flash_attention":
        q, k, v, kw = args
        q, k, v = cast(q), cast(k), cast(v)
        return (lambda: FAK.flash_attention_cuda(q, k, v, **kw),
                lambda: attention_ref(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=kw["scale"],
                    enable_gqa=True),
                lambda: FAK.flash_attention_fma(q, k, v, **kw))
    if kind == "grouped_matmul":
        x, eid, w, rt = args
        x, w = cast(x), cast(w)
        e = w.shape[0]
        xe = x.view(e, x.shape[0] // e, x.shape[1])
        return (lambda: GMK.grouped_matmul_cuda(x, eid, w, rt),
                lambda: grouped_matmul_ref(x, eid, w, rt),
                lambda: torch.bmm(xe, w),
                lambda: GMK.grouped_matmul_fma(x, eid, w, rt))
    q, k, v, lengths, kw = args
    q, k, v = cast(q), cast(k), cast(v)
    n = int(lengths.max())
    if int(lengths.min()) != n:
        raise AssertionError("the library yardstick takes one length")
    q4 = q[:, :, None, :]
    kl, vl = k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
    return (lambda: FDK.flash_decode_cuda(q, k, v, lengths, **kw),
            lambda: flash_decode_ref(q, k, v, lengths, **kw),
            lambda: F.scaled_dot_product_attention(
                q4, kl, vl, scale=kw["scale"], enable_gqa=True))


def lm_work(kind, args):
    """(bytes, FLOPs) the call needs: each input read once, each output
    written once; attention pairs the masks leave."""
    if kind == "flash_attention":
        q, k, v, kw = args
        bsz, hq, sq, d = q.shape
        skv = k.shape[2]
        win = kw.get("window") or skv
        pairs = sum(min(i + 1, skv, win) for i in range(sq)) \
            if kw["causal"] else sq * skv
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        return nbytes, 4.0 * bsz * hq * pairs * d
    if kind == "grouped_matmul":
        x, eid, w, rt = args
        nbytes = x.element_size() * (x.numel() + w.numel()
                                     + x.shape[0] * w.shape[2]) \
            + eid.numel() * 4
        return nbytes, 2.0 * x.shape[0] * w.shape[1] * w.shape[2]
    q, k, v, lengths, kw = args
    bsz, hq, hd = q.shape
    n = int(lengths.sum())
    nbytes = q.element_size() * 2 * q.numel() + lengths.numel() * 4 \
        + k.element_size() * 2 * n * k.shape[2] * hd
    return nbytes, 4.0 * n * hq * hd


def lm_phases(dev, mem_rate: float, bf16_rate: float, with_profile: bool):
    """Phases 8-10 (see the module docstring).  Returns the kernels-line
    entries of the three LM kernels."""
    import numpy as np
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.kernels.flash_attention import flash_attention as FAK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.flash_decode import flash_decode as FDK
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GMK
    from repro_torch.models import registry
    from repro_torch.serve.lm import ServeConfig, ServeEngine

    t_lm = time.perf_counter()
    # the card's L2 (50 MiB on an H100 where torch does not report it)
    l2_bytes = getattr(torch.cuda.get_device_properties(dev),
                       "L2_cache_size", 50 * 2**20)
    cfg = get_config(LM_ARCH)
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    engine = ServeEngine(model, params, ServeConfig(max_len=LM_MAX_LEN),
                         device=dev)
    print(f"LM: {LM_ARCH} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"{cfg.n_experts} experts top-{cfg.topk}, vocab {cfg.vocab_size}), "
          f"{n_params / 1e9:.3f} B parameters from torch.Generator(cuda)"
          f".manual_seed(0); prompts {LM_BATCH} x {LM_PROMPT}")
    windowed_decode_check(dev, cfg)

    # 8. kernel phase: record the kernels' operands in one plain bf16
    # prefill and LM_PLAIN_STEPS plain decode steps
    rec: dict = {}
    b, s = prompts.shape
    last = cfg.n_layers - 1
    step = (LM_PLAIN_STEPS - 1) * cfg.n_layers
    keep_calls = {"flash_attention": {0, last},
                  "grouped_matmul": {0, 1, 2, 3 * last, 3 * last + 1,
                                     3 * last + 2},
                  "flash_decode": {step, step + last}}
    with lm_kernels_through(**plain_lm(rec, keep_calls)):
        # decode inputs: the prompts' first tokens (only the operands count)
        teacher_forced(engine, prompts, prompts[:, :LM_PLAIN_STEPS])
    n_fa, n_gmm = len(rec["flash_attention"]), len(rec["grouped_matmul"])
    n_fd = len(rec["flash_decode"])
    if (n_fa, n_gmm, n_fd) != (cfg.n_layers, 3 * cfg.n_layers,
                               cfg.n_layers * LM_PLAIN_STEPS):
        raise AssertionError(f"plain run recorded {n_fa} attention, {n_gmm} "
                             f"grouped-matmul, {n_fd} decode calls")
    sites = ([("flash_attention", f"layer {i}", rec["flash_attention"][i])
              for i in (0, last)]
             + [("grouped_matmul", f"layer {i} {w}",
                 rec["grouped_matmul"][3 * i + j])
                for i in (0, last) for j, w in enumerate(("w_in", "w_gate",
                                                          "w_out"))]
             + [("flash_decode", f"step {LM_PLAIN_STEPS - 1} layer {i}",
                 rec["flash_decode"][(LM_PLAIN_STEPS - 1) * cfg.n_layers + i])
                for i in (0, last)])
    del rec

    def kernel_check(got, want, tol):
        """(passes, max abs error, max|plain|): the per-kernel rule."""
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        ok = (got.shape == want.shape and got.dtype == want.dtype
              and bool(got.isfinite().all()) and err <= tol * scale)
        return ok, err, scale

    def gmm_skip_last_k_stage(x, eid, w, rt):
        """The tensor-core kernel without its last K stage: run on every
        input channel but those of the last WGMMA_K_STEP-deep stage."""
        k = (x.shape[1] - 1) // GMK.WGMMA_K_STEP * GMK.WGMMA_K_STEP
        return GMK.grouped_matmul_wgmma(x[:, :k].contiguous(), eid,
                                        w[:, :k].contiguous(), rt)

    def fa_without_last_keys(q, k, v, kw):
        """The tensor-core kernel on K/V without their last
        FA_CONTROL_KEYS keys."""
        n = k.shape[2] - FA_CONTROL_KEYS
        return FAK.flash_attention_wgmma(q, k[:, :, :n].contiguous(),
                                         v[:, :, :n].contiguous(), **kw)

    controls = {
        "grouped_matmul": (gmm_skip_last_k_stage, f"tensor-core kernel "
                           f"skipping its last {GMK.WGMMA_K_STEP}-deep K "
                           f"stage"),
        "flash_attention": (fa_without_last_keys, f"tensor-core kernel on "
                            f"K/V without their last {FA_CONTROL_KEYS} "
                            f"keys")}

    print(f"LM kernel phase: operands recorded from one plain bf16 prefill "
          f"({b} x {s}) and {LM_PLAIN_STEPS} plain decode steps; rule "
          f"max|kernel - plain| <= {LM_KERNEL_F32_TOL:g} * max|plain| at f32, "
          f"{LM_BF16_TOL:g} * max|plain| at bf16; ms = device time a call "
          f"(bf16; {MLP_REPS} calls in one CUDA graph, {GRAPH_REPLAYS} "
          f"replays), the calls taking turns over copies of the operands "
          f"that move at least twice the {l2_bytes / 2**20:.0f} MiB L2 "
          f"between two uses of one copy; 'warm L2' = the kernel on one "
          f"copy, its operands left in L2); bound at {mem_rate / 1e12:.2f} TB/s and "
          f"{bf16_rate / 1e12:.0f} TFLOP/s bf16")
    print(f"{'kernel':16s} {'site':22s} {'shape':26s} {'max':>8s} "
          f"{'rel f32':>9s} {'rel bf16':>9s} {'kernel':>8s} {'warm L2':>8s} "
          f"{'plain':>8s} {'library':>8s} {'bound':>8s} {'by':>5s} "
          f"{'earlier':>8s}")
    stats = {k: {"n": 0, "ms": 0.0, "plain": 0.0, "lib": 0.0, "earlier": 0.0,
                 "bound": 0.0, "bytes": 0.0, "ops": 0.0, "err": 0.0}
             for k in ("flash_attention", "grouped_matmul", "flash_decode")}
    notes = []
    for kind, site, args in sites:
        rels = {}
        for label, dtype in (("f32", torch.float32), ("bf16", None)):
            fns = lm_calls(kind, args, dtype)
            before = {**GMK.LAUNCHES, **FAK.LAUNCHES}
            got, want = fns[0](), fns[1]()
            torch.cuda.synchronize()
            tol = LM_KERNEL_F32_TOL if label == "f32" else LM_BF16_TOL
            ok, err, scale = kernel_check(got, want, tol)
            rels[label] = err / scale
            if not ok:
                raise AssertionError(
                    f"{kind} disagrees with its plain version at {site} "
                    f"({label}): max abs err {err} against max|plain| "
                    f"{scale}")
            if label == "bf16":
                stats[kind]["err"] = max(stats[kind]["err"], err)
            if kind == "flash_decode":
                continue
            # the check reached the kernel the selection rule names: the
            # float32-FMA kernel at f32 (no TF32), the tensor cores at bf16
            ran = f"{kind}_{'fma' if label == 'f32' else 'wgmma'}"
            if {**GMK.LAUNCHES, **FAK.LAUNCHES}[ran] != before[ran] + 1:
                raise AssertionError(f"{kind} at {label} did not launch "
                                     f"{ran}")
            if label == "f32":
                continue
            control, what = controls[kind]
            ok_e, err_e, _ = kernel_check(fns[3](), want, tol)
            ok_c, err_c, _ = kernel_check(control(*args), want, tol)
            torch.cuda.synchronize()
            notes.append(
                f"{kind} {site}: earlier FMA kernel at bf16 "
                f"{err_e / scale:.2e}; negative control ({what}) "
                f"{err_c / scale:.2e} -> {'ACCEPTED' if ok_c else 'rejected'}")
            if not ok_e:
                raise AssertionError(f"the FMA {kind} disagrees with its "
                                     f"plain version at {site} (bf16)")
            if ok_c:
                raise AssertionError(f"the bf16 kernel check accepts the "
                                     f"{what}")
        nbytes, flops = lm_work(kind, args)
        copies = cold_copies(args, nbytes, l2_bytes)
        fns = [lm_calls(kind, a) for a in copies]
        t = [graph_ms(rotating([f[i] for f in fns]), MLP_REPS)
             for i in range(len(fns[0]))]
        warm = graph_ms(fns[0][0], MLP_REPS)
        del fns, copies
        b_bytes, b_ops = nbytes / mem_rate * 1e3, flops / bf16_rate * 1e3
        st = stats[kind]
        st["n"] += 1
        for key, val in zip(("ms", "plain", "lib", "earlier"), t):
            st[key] += val
        st["bound"] += max(b_bytes, b_ops)
        st["bytes"] += b_bytes
        st["ops"] += b_ops
        shape = "x".join(str(n) for n in args[0].shape)
        if kind == "grouped_matmul":
            shape += f" @ {args[2].shape[1]}->{args[2].shape[2]}"
        print(f"{kind:16s} {site:22s} {shape:26s} {scale:8.3g} "
              f"{rels['f32']:9.2e} {rels['bf16']:9.2e} {t[0]:8.4f} "
              f"{warm:8.4f} {t[1]:8.4f} {t[2]:8.4f} "
              f"{max(b_bytes, b_ops):8.4f} "
              f"{'ops' if b_ops >= b_bytes else 'bytes':>5s} "
              + (f"{t[3]:8.4f}" if len(t) > 3 else f"{'-':>8s}"))
    for line in notes:
        print(line)
    fd_args = next(a for kind, _, a in sites if kind == "flash_decode")
    fd_plan = FDK.plan_launch(*fd_args[:3], torch.cuda.get_device_properties(
        dev).multi_processor_count)
    print(f"flash_decode launch plan at the decode step's shapes: n_split "
          f"{fd_plan.n_split}, {fd_plan.ctas} CTAs ({fd_plan.grid[0]} x "
          f"{fd_plan.n_split}), cluster {fd_plan.cluster}, {fd_plan.vec}-byte "
          f"loads, {fd_plan.gs} lanes a row, {fd_plan.gt} heads a CTA, "
          f"{fd_plan.smem} bytes of shared memory")
    # its time at each power-of-two split and its fixed cost (every length
    # 0: launch, the lengths read, barriers and merges), at layer 0's
    # operands, cold as above
    q, k, v, lengths, kw = fd_args
    copies = cold_copies((q, k, v, lengths), lm_work("flash_decode", fd_args)[0],
                         l2_bytes)
    split_ms = {n: graph_ms(rotating([
        lambda a=a, n=n: FDK.flash_decode_cuda(*a, **kw, n_split=n)
        for a in copies]), MLP_REPS) for n in (1, 2, 4, 8)}
    zero = torch.zeros_like(lengths)
    fixed_ms = graph_ms(rotating([
        lambda a=a: FDK.flash_decode_cuda(*a[:3], zero, **kw)
        for a in copies]), MLP_REPS)
    del copies, q, k, v, lengths
    print(f"flash_decode: device ms a call (cold) at n_split "
          + ", ".join(f"{n}: {t:.4f}" for n, t in split_ms.items())
          + f"; with every length 0: {fixed_ms:.4f}")

    # flash attention at the shapes other configs need: window, softcap,
    # head_dim 128 and 256
    rng = np.random.default_rng(1)
    for hd, g, n, kw in ((128, 2, 384, dict(window=100, softcap=30.0)),
                         (256, 4, 200, dict(window=None, softcap=None)),
                         (64, 2, 300, dict(window=64, softcap=50.0))):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(dev, dtype) for shape in
                ((2, 2 * g, n, hd), (2, 2, n, hd), (2, 2, n, hd)))
            ran = FAK.variant(dtype, hd, g, [t.data_ptr() % 16
                                            for t in (q, k, v)])
            before = FAK.LAUNCHES[f"flash_attention_{ran}"]
            got = FAK.flash_attention_cuda(q, k, v, **kw)
            want = attention_ref(q, k, v, **kw)
            scale = float(want.float().abs().max())
            err = float((got.float() - want.float()).abs().max())
            tol = LM_KERNEL_F32_TOL if dtype == torch.float32 else LM_BF16_TOL
            print(f"flash_attention hd {hd}, G {g}, S {n}, {kw}, {dtype}: "
                  f"{ran} kernel, max abs err {err:.2e}, max|plain| "
                  f"{scale:.3g}")
            if FAK.LAUNCHES[f"flash_attention_{ran}"] != before + 1:
                raise AssertionError(f"flash_attention at hd {hd} {dtype} "
                                     f"did not launch its {ran} kernel")
            if not err <= tol * scale:
                raise AssertionError(f"flash_attention disagrees at hd {hd} "
                                     f"{kw} {dtype}")

    # flash decode at the decode step's widths, operands from a seed:
    # unequal lengths (around the 64-slot split unit, full, one past S),
    # then every split count
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    hd = cfg.resolved_head_dim
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(dev) for shape in ((LM_BATCH, cfg.n_heads, hd),
                                      (LM_BATCH, LM_MAX_LEN, cfg.n_kv_heads,
                                       hd), (LM_BATCH, LM_MAX_LEN,
                                             cfg.n_kv_heads, hd)))
    unequal = [0, 1, 63, 64, 65, 511, LM_MAX_LEN, LM_MAX_LEN + 37]
    near = [LM_PROMPT + 1 + i for i in range(LM_BATCH)]
    cases = ([("unequal lengths", unequal, None)]
             + [(f"n_split {n}", near, n)
                for n in range(1, FDK.MAX_SPLIT + 1)])
    for label, lens, n_split in cases:
        lengths = torch.tensor([lens[i % len(lens)] for i in range(LM_BATCH)],
                               dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            qc, kc, vc = q.to(dtype), k.to(dtype), v.to(dtype)
            plan = FDK.plan_launch(qc, kc, vc, n_sm, n_split)
            got = FDK.flash_decode_cuda(qc, kc, vc, lengths, scale=hd ** -0.5,
                                        n_split=n_split)
            want = flash_decode_ref(qc, kc, vc, lengths, scale=hd ** -0.5)
            torch.cuda.synchronize()
            tol = LM_KERNEL_F32_TOL if dtype == torch.float32 else LM_BF16_TOL
            ok, err, scale = kernel_check(got, want, tol)
            print(f"flash_decode {label}, lengths {lengths.tolist()}, "
                  f"{dtype}: n_split {plan.n_split}, {plan.ctas} CTAs, "
                  f"cluster {plan.cluster}, {plan.vec}-byte loads; max abs "
                  f"err {err:.2e}, max|plain| {scale:.3g}")
            if not ok:
                raise AssertionError(f"flash_decode disagrees with its plain "
                                     f"version ({label}, {dtype})")
    del q, k, v

    # 9. main path: generate through ServeEngine, timed
    for mod in (FAK, GMK, FDK):
        mod.reset_launch_counts()
    gen, pre_ms, dec_ms, runs_ms = timed_generate(engine, prompts, LM_NEW, 4)
    launches = {**FAK.LAUNCHES, **GMK.LAUNCHES, **FDK.LAUNCHES}
    n_dec = 4 * LM_NEW
    want_launch = {"flash_attention": 4 * cfg.n_layers,
                   "flash_attention_wgmma": 4 * cfg.n_layers,
                   "flash_attention_fma": 0,
                   "grouped_matmul": 4 * 3 * cfg.n_layers,
                   "grouped_matmul_wgmma": 4 * 3 * cfg.n_layers,
                   "grouped_matmul_fma": 0, "grouped_matmul_dx": 0,
                   "grouped_matmul_dw": 0, "grouped_matmul_dw_wgmma": 0,
                   "grouped_matmul_dw_fma": 0,
                   "flash_decode": n_dec * cfg.n_layers}
    print(f"LM main-path launches over 4 generate calls (4 prefills, {n_dec} "
          f"decode steps): {launches}")
    if launches != want_launch:
        raise AssertionError(f"LM launches {launches}, expected {want_launch}")
    if gen.shape != (b, LM_NEW) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"bad generated tokens {gen.shape}")
    gen_ms = runs_ms[1:]
    med_gen = statistics.median(gen_ms)
    print(f"LM generate {b} x {s} prompt + {LM_NEW} new tokens: warm-up "
          f"{runs_ms[0]:.1f} ms, timed {[round(v, 1) for v in gen_ms]} ms; "
          f"prefill {[round(v, 2) for v in pre_ms]} ms (median "
          f"{statistics.median(pre_ms):.2f}); decode step median "
          f"{statistics.median(dec_ms):.3f} ms (min {min(dec_ms):.3f}, max "
          f"{max(dec_ms):.3f}); {b * LM_NEW / med_gen * 1e3:.1f} generated "
          f"tokens/s end to end, {b / statistics.median(dec_ms) * 1e3:.1f} "
          f"tokens/s a decode step, {b * s / statistics.median(pre_ms) * 1e3:.0f}"
          f" prompt tokens/s in prefill")

    if with_profile:
        from torch.profiler import ProfilerActivity, profile
        names = ("flash_attention_wgmma_kernel", "flash_attention_fma_kernel",
                 "grouped_matmul_wgmma_kernel", "grouped_matmul_kernel",
                 "flash_decode_kernel")
        dev_b = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                           device=dev),
                 "positions": torch.arange(s, device=dev).expand(b, s)}

        def decode_batch(tok, pos):
            return {"tokens": tok[:, None].to(torch.int64),
                    "positions": torch.full((b, 1), pos, device=dev),
                    "cache_pos": torch.full((b,), pos, device=dev)}

        def profiled(label, fn, n_steps):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            print(prof.key_averages().table(sort_by="cuda_time_total",
                                            row_limit=12))
            events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)]
            busy = sum(e.time_range.end - e.time_range.start
                       for e in events) / 1e3
            per = {k: sum(e.time_range.end - e.time_range.start
                          for e in events if k in e.name) / 1e3
                   for k in names}
            print(f"LM profiled {label}: wall {wall / n_steps:.2f} ms a step, "
                  f"device events {busy / n_steps:.3f} ms a step over "
                  f"{len(events)} (busy share {busy / wall:.3f}); "
                  + ", ".join(f"{k} {v / n_steps:.3f} ms" for k, v in
                              per.items() if v))
            return out

        with torch.no_grad():
            tok, pre = profiled(f"prefill ({b} x {s})",
                                lambda: engine.prefill_step(engine.params,
                                                            dev_b), 1)
            states = engine.place_states(pre, b)
            del pre

            def four_steps():
                nonlocal tok, states
                for j in range(4):
                    tok, states = engine.decode_step(
                        engine.params, states, decode_batch(tok, s + j))
            profiled("decode steps (4)", four_steps, 4)
            del states

    # 10. correctness: teacher-force the plain path on the kernel path's
    # tokens, at bf16 (the main path) and f32, with negative controls
    def check(engine, tokens, label, tol):
        """Plain and kernel paths teacher-forced on `tokens`; the kernel
        path's routing may differ from the plain path's only at near ties,
        and with the plain path's routing imposed its logits must pass
        `lm_compare` at `tol`.  Returns the plain logits and routing."""
        plain_routes, kernel_routes = [], []
        with lm_kernels_through(**plain_lm()), \
                routes_through(recording_route(plain_routes)):
            want = teacher_forced(engine, prompts, tokens)
        with routes_through(recording_route(kernel_routes)):
            got = teacher_forced(engine, prompts, tokens)
        steps = [got[0][:, -1]] + got[1:-1]
        if not all(np.array_equal(g.argmax(-1).cpu().numpy(), tokens[:, t])
                   for t, g in enumerate(steps)):
            raise AssertionError(f"LM {label}: teacher-forced kernel logits "
                                 "do not give the generated tokens")
        _, n_diff, _, rels = lm_compare(got, want, tol)
        flips, roots = routing_flips(kernel_routes, plain_routes,
                                     prompts.shape[0], cfg.n_layers)
        flip_gap = roots[0][2] if roots else 0.0
        drops = capacity_drops(plain_routes, cfg.n_experts, cfg.n_layers)
        print(f"LM {label}, kernel path as generated, against the plain path "
              f"teacher-forced on its tokens: logit rms {rms(want[0]):.3f}, "
              f"max|plain| {float(want[0].abs().max()):.3g}; relative error "
              f"prefill {rels[0]:.2e}, decode steps max {max(rels[1:]):.2e}; "
              f"greedy tokens differing {n_diff}; expert choices differing "
              f"at {flips} (token, layer) pairs, {len(roots)} of them roots "
              f"(outside the reach of an earlier one; the prefill drops "
              f"{drops} assignments at capacity), the widest root at a "
              f"top-k gap of {flip_gap:.2e} of p_k (near tie: < "
              f"{LM_NEAR_TIE[label]:.3g}); roots (layer, position, gap): "
              f"{[(l, p, float(f'{g:.3g}')) for l, p, g in roots[:6]]}")
        if flip_gap >= LM_NEAR_TIE[label]:
            raise AssertionError(f"LM {label}: the kernel path first routes "
                                 "a token differently without a near tie")
        del got
        with routes_through(imposed_route(plain_routes)):
            got = teacher_forced(engine, prompts, tokens)
        ok, n_diff, n_close, rels = lm_compare(got, want, tol)
        print(f"LM {label}, kernel path with the plain path's routing: "
              f"relative error prefill {rels[0]:.2e}, decode steps max "
              f"{max(rels[1:]):.2e}; greedy tokens differing {n_diff} of "
              f"{sum(g.shape[0] * (g.shape[1] if g.dim() == 3 else 1) for g in got)}"
              f", {n_close} tolerated (top-2 gap < {tol:g} * max|plain|)")
        if not ok:
            raise AssertionError(f"LM {label}: kernel path differs from the "
                                 f"plain path beyond {tol:g} * max|plain|")
        return want, plain_routes

    check(engine, gen, "bf16", LM_BF16_PATH_TOL)
    del engine
    engine32 = ServeEngine(model, params, ServeConfig(
        max_len=LM_MAX_LEN, compute_dtype=torch.float32,
        cache_dtype=torch.float32), device=dev)
    GMK.reset_launch_counts()
    FAK.reset_launch_counts()
    gen32 = engine32.generate(prompts, max_new_tokens=LM_NEW)
    l32 = {**FAK.LAUNCHES, **GMK.LAUNCHES}
    print(f"LM f32 generate: tokens equal to the bf16 run's "
          f"{float((gen32 == gen).mean()):.3f}; prefill launches {l32}")
    n = cfg.n_layers
    if l32 != {"flash_attention": n, "flash_attention_wgmma": 0,
               "flash_attention_fma": n, "grouped_matmul": 3 * n,
               "grouped_matmul_wgmma": 0, "grouped_matmul_fma": 3 * n,
               "grouped_matmul_dx": 0, "grouped_matmul_dw": 0,
               "grouped_matmul_dw_wgmma": 0, "grouped_matmul_dw_fma": 0}:
        raise AssertionError(f"f32 prefill launches {l32}, expected {n} "
                             f"flash_attention and {3 * n} grouped_matmul, "
                             f"all on the FMA kernels")
    want, plain_routes = check(engine32, gen32, "f32", LM_F32_TOL)

    real_gmm = GMK.grouped_matmul_cuda
    real_fd = FDK.flash_decode_cuda

    def fa_skip_last_tile(q, k, v, causal=True, window=None, softcap=None,
                          scale=None):
        """Plain attention without the last kv tile (64 keys) that each
        CTA's block of 64 / G query positions reads."""
        g = q.shape[1] // k.shape[1]
        bq = FAK.FMA_ROWS_PER_CTA // g
        n = q.shape[2]
        qpos = torch.arange(n, device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        last_tile = ((qpos // bq) * bq + bq - 1).clamp(max=n - 1) // 64
        keep = (kpos <= qpos) & (kpos // 64 != last_tile)
        qg = q.reshape(q.shape[0], k.shape[1], g, n, -1).float() * scale
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
        sc = torch.where(keep, sc, -1e30)
        p = torch.softmax(sc, -1) * keep.any(-1)[:, None].to(sc.dtype)
        out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
        return out.reshape(q.shape).to(q.dtype)

    def gmm_zero_expert(x, tile_eid, weights, row_tile=128):
        out = real_gmm(x, tile_eid, weights, row_tile)
        out.view(-1, row_tile, out.shape[1])[tile_eid == 0] = 0
        return out

    def fd_short(q, k, v, lengths, *, softcap=None, scale=None):
        return real_fd(q, k, v, lengths.to(torch.int32) - 1, softcap=softcap,
                       scale=scale)

    controls = [("flash_attention skipping its last kv tile",
                 dict(fa=fa_skip_last_tile)),
                ("grouped_matmul writing expert 0's tiles as zeros",
                 dict(gmm=gmm_zero_expert)),
                ("flash_decode reading lengths - 1", dict(fd=fd_short))]
    want_c = want[:LM_CONTROL_STEPS + 1]
    for what, stand_in in controls:
        with lm_kernels_through(**stand_in), \
                routes_through(imposed_route(plain_routes)):
            bad = teacher_forced(engine32, prompts, gen32, LM_CONTROL_STEPS)
        ok_c, nd, _, rels_c = lm_compare(bad, want_c, LM_F32_TOL)
        print(f"LM negative control (f32, plain routing), {what}: relative "
              f"error prefill {rels_c[0]:.2e}, decode max "
              f"{max(rels_c[1:]):.2e}, tokens differing {nd} -> "
              f"{'ACCEPTED' if ok_c else 'rejected'}")
        if ok_c:
            raise AssertionError(f"the LM check accepts a run with {what}")
    del want, want_c, engine32
    print(f"LM part: {time.perf_counter() - t_lm:.1f} s wall")

    src = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
    sources = {name: src.format(name).replace(".cu", "_wgmma.cu")
               for name in ("grouped_matmul", "flash_attention")}
    replaces = {
        "grouped_matmul":
            "src/repro/kernels/grouped_matmul/grouped_matmul.py:48",
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:96",
        "flash_decode": "src/repro/kernels/flash_decode/flash_decode.py:79"}
    per = {"grouped_matmul": "one call at the prefill's shape, mean over "
                             "layers 0 and 23 (w_in, w_gate, w_out); 72 a "
                             "prefill",
           "flash_attention": "one call at the prefill's shape, mean over "
                              "layers 0 and 23; 24 a prefill",
           "flash_decode": "one call at a decode step's shape, mean over "
                           "layers 0 and 23; 24 a step"}
    entries = []
    for name in ("grouped_matmul", "flash_attention", "flash_decode"):
        st = stats[name]
        n = st["n"]
        entries.append({
            "name": name, "route": "cuda",
            "source": sources.get(name, src.format(name)),
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": st["err"], "ms": st["ms"] / n,
            "plain_ms": st["plain"] / n, "bound_ms": st["bound"] / n,
            "bound_by": "operations" if st["ops"] >= st["bytes"] else "bytes",
            "library_ms": st["lib"] / n,
            "library": {"grouped_matmul": "torch.bmm over the (E, capacity, "
                                          "Cin) view",
                        "flash_attention": "scaled_dot_product_attention("
                                           "is_causal, enable_gqa)",
                        "flash_decode": "scaled_dot_product_attention over "
                                        "k[:, :L] (enable_gqa)"}[name],
            "timing": "device ms a call: 20 calls in one CUDA graph (bf16)",
            "per": per[name]})
    entries[0].update({
        "variant": "wgmma", "launches_by_variant": {
            k: launches[f"grouped_matmul_{k}"] for k in ("wgmma", "fma")},
        "earlier_ms": stats["grouped_matmul"]["earlier"]
        / stats["grouped_matmul"]["n"],
        "earlier_source": src.format("grouped_matmul"),
        "earlier": "float32-FMA kernel (still taken for float32 and odd "
                   "widths)"})
    entries[1].update({
        "variant": "wgmma", "launches_by_variant": {
            k: launches[f"flash_attention_{k}"] for k in ("wgmma", "fma")},
        "earlier_ms": stats["flash_attention"]["earlier"]
        / stats["flash_attention"]["n"],
        "earlier_source": src.format("flash_attention"),
        "earlier": "float32-FMA kernel (still taken for float32 and other "
                   "head_dims, groups or alignments)"})
    entries[2].update({
        "n_split": fd_plan.n_split, "ctas": fd_plan.ctas,
        "cluster": fd_plan.cluster, "load_bytes": fd_plan.vec,
        "split_ms": {str(n): t for n, t in split_ms.items()},
        "fixed_ms": fixed_ms,
        "earlier": "one CTA per (batch, kv head), scalar loads (first port; "
                   "no longer in the source, so not timed here)"})
    return entries


def dw_check(label: str, call, dtype, kind: str, fn, tol: float):
    """A recorded weight-gradient call (x, dy, tile_eid, n_experts,
    row_tile), cast to `dtype`, through `fn` against grouped_matmul_dw_ref:
    max|got - plain| <= tol x max|plain|, and one launch of the `kind`
    kernel and none of another.  Returns (max abs err, max|plain|)."""
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GMK
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_dw_ref
    x, dy, eid, e, rt = call
    xc, dyc = x.to(dtype), dy.to(dtype)
    keys = ("grouped_matmul_dw", "grouped_matmul_dw_wgmma",
            "grouped_matmul_dw_fma")
    before = {k: GMK.LAUNCHES[k] for k in keys}
    got = fn(xc, dyc, eid, e, rt)
    want = grouped_matmul_dw_ref(xc, dyc, eid, e, rt)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    moved = {k: GMK.LAUNCHES[k] - before[k] for k in keys}
    print(f"{label} ({x.shape[0]} x {x.shape[1]} -> {dy.shape[1]}, {e} "
          f"experts), {dtype} through {kind}: max abs err {err:.2e}, "
          f"max|plain| {scale:.3g} ({err / scale:.2e}, tol {tol:g})")
    if moved != {"grouped_matmul_dw": 1,
                 "grouped_matmul_dw_wgmma": int(kind == "wgmma"),
                 "grouped_matmul_dw_fma": int(kind == "fma")} or \
            got.dtype != dtype or not err <= tol * scale:
        raise AssertionError(f"{label}: grouped_matmul_dw ({kind}) disagrees "
                             f"with its plain version ({dtype}), or ran "
                             f"another kernel: launches {moved}")
    return err, scale


def train_phase(dev, mem_rate: float, bf16_rate: float,
                with_profile: bool = False) -> dict:
    """Phase 12: the LM train step (see the module docstring).  Returns the
    kernels-line entry of grouped_matmul_dw and the step's numbers.
    `with_profile` adds one more step under torch.profiler."""
    import numpy as np
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels.flash_attention import flash_attention as FAK
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GMK
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_dw_ref
    from repro_torch.models import registry
    from repro_torch.models.params import flatten_tree
    from repro_torch.nn import count_params
    from repro_torch.train import optim as OPT
    from repro_torch.train import step as STEP

    t_train = time.perf_counter()
    l2_bytes = getattr(torch.cuda.get_device_properties(dev),
                       "L2_cache_size", 50 * 2**20)
    cfg = get_config(LM_ARCH)
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    batch = token_batch(0, 0, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    tc = STEP.TrainConfig(compute_dtype=torch.bfloat16, remat=True)
    opt = OPT.AdamWConfig(lr=TRAIN_LR, warmup_steps=1)
    step = STEP.make_train_step(model, tc, opt)
    state = OPT.init(params)
    n = cfg.n_layers
    # remat runs each body's forward twice (once more in the backward);
    # flash_attention's backward recomputes through the plain version
    want_launch = {"flash_attention": 2 * n, "flash_attention_wgmma": 2 * n,
                   "flash_attention_fma": 0,
                   "grouped_matmul": 2 * 3 * n + 3 * n,
                   "grouped_matmul_wgmma": 2 * 3 * n + 3 * n,
                   "grouped_matmul_fma": 0, "grouped_matmul_dx": 3 * n,
                   "grouped_matmul_dw": 3 * n,
                   "grouped_matmul_dw_wgmma": 3 * n, "grouped_matmul_dw_fma": 0}
    print(f"train: {LM_ARCH} full width ({n} layers, d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.topk}, vocab {cfg.vocab_size}), "
          f"{count_params(params) / 1e9:.3f} B float32 parameters "
          f"from torch.Generator(cuda).manual_seed(0); TrainConfig(bf16, "
          f"remat=True), AdamW lr {TRAIN_LR:g} with a 1-step warmup; one "
          f"token_batch(0, 0) of {TRAIN_BATCH} x {TRAIN_SEQ} every step; "
          f"expected launches a step {want_launch}")
    # the first step's weight-gradient calls (layer 23's: its backward
    # runs first), kept for the kernel check below
    real_dw = gmm_ops.grouped_matmul_dw_cuda
    dw_calls = []

    def keep_dw(x, dy, tile_eid, n_experts, row_tile=128):
        if len(dw_calls) < 3:
            dw_calls.append((x.detach(), dy.detach(), tile_eid, n_experts,
                             row_tile))
        return real_dw(x, dy, tile_eid, n_experts, row_tile)

    rows, launches_total = [], dict.fromkeys(want_launch, 0)
    p = params
    for i in range(TRAIN_STEPS):
        FAK.reset_launch_counts()
        GMK.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        if i == 0:
            gmm_ops.grouped_matmul_dw_cuda = keep_dw
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, state, met = step(p, state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            gmm_ops.grouped_matmul_dw_cuda = real_dw
        if i == 0:
            del params
        counts = {k: {**FAK.LAUNCHES, **GMK.LAUNCHES}[k] for k in want_launch}
        met = {k: float(v) for k, v in met.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        rows.append({"ms": ms, "loss": met["loss"], "aux": met["aux"],
                     "grad_norm": met["grad_norm"], "lr": met["lr"],
                     "peak_gib": peak,
                     "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3})
        print(f"train step {i + 1}: {ms:.1f} ms, "
              f"{rows[-1]['tokens_per_s']:.0f} training tokens/s, peak "
              f"memory {peak:.2f} GiB; loss {met['loss']:.5f}, aux "
              f"{met['aux']:.4f}, grad_norm {met['grad_norm']:.4f}, lr "
              f"{met['lr']:.3g}, n_tokens {met['n_tokens']:.0f}; launches "
              f"{counts}")
        if counts != want_launch:
            raise AssertionError(f"train step {i + 1}: launches {counts}, "
                                 f"expected {want_launch}")
        if not all(np.isfinite(v) for v in met.values()):
            raise AssertionError(f"train step {i + 1}: metrics {met}")
        for k, v in counts.items():
            launches_total[k] += v
    if not rows[-1]["loss"] < rows[0]["loss"]:
        raise AssertionError(f"the loss did not fall: {[r['loss'] for r in rows]}")
    if with_profile:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            p, state, _ = step(p, state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        averages = prof.key_averages()
        print(averages.table(sort_by="cuda_time_total", row_limit=25))

        def dev_ms(ev):
            us = getattr(ev, "device_time_total", None)
            return (ev.cuda_time_total if us is None else us) / 1e3
        # the MoE gathers' backward (_DispatchGatherBackward) and any
        # IndexBackward0 left (the embedding lookup's, once a step)
        nodes = {ev.key: (dev_ms(ev), ev.count) for ev in averages
                 if any(k in ev.key for k in ("IndexBackward0",
                                              "DispatchGather",
                                              "EmbeddingBackward"))}
        print("train step autograd nodes (device ms, calls): "
              + (", ".join(f"{k} {v[0]:.3f} ms x {v[1]}" for k, v in
                           sorted(nodes.items())) or "none"))
        if not any("DispatchGather" in k for k in nodes):
            raise AssertionError("the profiled step ran no "
                                 "_DispatchGatherBackward")
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        busy = sum(e.time_range.end - e.time_range.start
                   for e in events) / 1e3
        per = {k: sum(e.time_range.end - e.time_range.start
                      for e in events if k in e.name) / 1e3
               for k in ("flash_attention_wgmma_kernel",
                         "grouped_matmul_wgmma_kernel",
                         "grouped_matmul_dw_wgmma_kernel",
                         "grouped_matmul_dw_kernel", "gemm", "elementwise",
                         "reduce", "index", "scatter", "gather", "sort")}
        print(f"train step under the profiler: wall {wall:.1f} ms, device "
              f"events {busy:.3f} ms over {len(events)} (busy share "
              f"{busy / wall:.3f}); by kernel name: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in per.items()))
    del p, state

    # grouped_matmul_dw against its plain version at the step's shapes, each
    # variant on its own type: float32 through the FMA kernel, bf16 through
    # the tensor-core kernel, and the FMA kernel on the bf16 operands too
    # (the earlier design); timed at bf16 beside the plain version and
    # torch.bmm over the (E, Cin, capacity) x (E, capacity, Cout) view, with
    # its bound
    dw = dict.fromkeys(("n", "ms", "fma", "plain", "lib", "bound", "bytes",
                        "ops", "err", "rel", "err_f32", "rel_f32"), 0.0)
    for j, (x, dy, eid, e, rt) in enumerate(dw_calls):
        cap = x.shape[0] // e
        if not torch.equal(eid.long(), torch.arange(e, device=dev)
                           .repeat_interleave(cap // rt)):
            raise AssertionError("the step's tile_eid is not sorted by "
                                 "expert in equal segments")
        for dtype, kind, fn, tol in (
                (torch.float32, "fma", GMK.grouped_matmul_dw_cuda,
                 LM_KERNEL_F32_TOL),
                (torch.bfloat16, "wgmma", GMK.grouped_matmul_dw_cuda,
                 LM_BF16_TOL),
                (torch.bfloat16, "fma", GMK.grouped_matmul_dw_fma,
                 LM_BF16_TOL)):
            err, scale = dw_check(f"grouped_matmul_dw call {j}",
                                  dw_calls[j], dtype, kind, fn, tol)
            if dtype == torch.float32:
                dw["err_f32"] = max(dw["err_f32"], err)
                dw["rel_f32"] = max(dw["rel_f32"], err / scale)
            elif kind == "wgmma":
                dw["err"] = max(dw["err"], err)
                dw["rel"] = max(dw["rel"], err / scale)
        nbytes = x.element_size() * (x.numel() + dy.numel()
                                     + e * x.shape[1] * dy.shape[1]) \
            + eid.numel() * 4
        flops = 2.0 * x.shape[0] * x.shape[1] * dy.shape[1]
        copies = cold_copies((x, dy, eid), nbytes, l2_bytes)
        kernel = graph_ms(rotating([
            lambda a=a: GMK.grouped_matmul_dw_cuda(a[0], a[1], a[2], e, rt)
            for a in copies]), MLP_REPS)
        fma = graph_ms(rotating([
            lambda a=a: GMK.grouped_matmul_dw_fma(a[0], a[1], a[2], e, rt)
            for a in copies]), MLP_REPS)
        lib = graph_ms(rotating([
            lambda a=a: torch.bmm(
                a[0].view(e, cap, -1).transpose(1, 2),
                a[1].view(e, cap, -1)) for a in copies]), MLP_REPS)
        plain = cuda_ms(lambda: grouped_matmul_dw_ref(x, dy, eid, e, rt),
                        REPS)
        del copies
        b_bytes, b_ops = nbytes / mem_rate * 1e3, flops / bf16_rate * 1e3
        print(f"grouped_matmul_dw call {j} (bf16): wgmma kernel {kernel:.4f} "
              f"ms (128 x 256 tiles), FMA kernel {fma:.4f} ms, "
              f"plain {plain:.4f} ms, torch.bmm {lib:.4f} ms, bound "
              f"{max(b_bytes, b_ops):.4f} ms ({'ops' if b_ops >= b_bytes else 'bytes'};"
              f" bytes {b_bytes:.4f}, ops {b_ops:.4f})")
        for key, val in (("ms", kernel), ("fma", fma), ("plain", plain),
                         ("lib", lib), ("bound", max(b_bytes, b_ops)),
                         ("bytes", b_bytes), ("ops", b_ops)):
            dw[key] += val
        dw["n"] += 1
    del dw_calls

    # parity: one step's gradients at 2 layers of full width, kernels
    # against the plain versions with the kernel run's routing imposed
    cfg2 = cfg.replace(n_layers=2)
    model2 = registry.build(cfg2)
    params2 = model2.init(torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    batch2 = {k: torch.as_tensor(v, device=dev) for k, v in
              token_batch(1, 0, TRAIN_BATCH, TRAIN_SEQ,
                          cfg.vocab_size).items()}
    parity = {}

    def grads(grad_fn, routes, record, **through):
        router = recording_route(routes) if record else imposed_route(routes)
        with lm_kernels_through(**through), routes_through(router):
            g, m = grad_fn(params2, batch2)
        torch.cuda.synchronize()
        return dict(flatten_tree(g)), float(m["loss"])

    def compare(got, want, tol):
        """(passes, worst leaf error / max|plain leaf|, that leaf)."""
        worst, name = 0.0, ""
        for k, w in want.items():
            scale = float(w.abs().max())
            rel = float((got[k] - w).abs().max()) / max(scale, 1e-30)
            if not bool(got[k].isfinite().all()):
                rel = float("inf")
            if rel > worst:
                worst, name = rel, k
        return worst <= tol, worst, name

    m2 = 2 * cfg2.n_layers
    for label, dtype, tol in (("f32", torch.float32, LM_F32_TOL),
                              ("bf16", torch.bfloat16, LM_BF16_PATH_TOL)):
        variant = "fma" if label == "f32" else "wgmma"
        grad_fn = STEP.make_grad_fn(
            model2, STEP.TrainConfig(compute_dtype=dtype, remat=True))
        routes = []
        FAK.reset_launch_counts()
        GMK.reset_launch_counts()
        g_k, loss_k = grads(grad_fn, routes, True)
        counts = {**FAK.LAUNCHES, **GMK.LAUNCHES}
        if counts[f"flash_attention_{variant}"] != m2 or \
                counts[f"grouped_matmul_{variant}"] != 3 * m2 + 3 * \
                cfg2.n_layers or counts["grouped_matmul_dw"] != \
                3 * cfg2.n_layers or counts[f"grouped_matmul_dw_{variant}"] \
                != 3 * cfg2.n_layers:
            raise AssertionError(f"parity {label}: launches {counts}")
        g_p, loss_p = grads(grad_fn, routes, False, **plain_lm())
        ok, worst, leaf = compare(g_k, g_p, tol)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        parity[label] = {"loss_rel": loss_rel, "grad_rel": worst,
                         "leaf": leaf, "dw_launches": {
                             v: counts[f"grouped_matmul_dw_{v}"]
                             for v in ("wgmma", "fma")}}
        print(f"train parity {label} (2 layers at full width, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}, the kernel run's routing "
              f"imposed on the plain run): loss {loss_k:.6f} vs plain "
              f"{loss_p:.6f} (relative {loss_rel:.2e}, tol {tol:g}); worst "
              f"gradient leaf {leaf}: max|kernel - plain| = {worst:.2e} x "
              f"max|plain leaf| (tol {tol:g}); launches {counts}")
        if not ok or not loss_rel <= tol:
            raise AssertionError(f"train parity {label} fails")
        # negative control at this type, through this type's dW kernel
        def dw_zero_expert0(x, dy, tile_eid, n_experts, row_tile=128):
            out = real_dw(x, dy, tile_eid, n_experts, row_tile)
            out[0] = 0
            return out
        GMK.reset_launch_counts()
        gmm_ops.grouped_matmul_dw_cuda = dw_zero_expert0
        try:
            g_bad, _ = grads(grad_fn, routes, False)
        finally:
            gmm_ops.grouped_matmul_dw_cuda = real_dw
        ran = GMK.LAUNCHES[f"grouped_matmul_dw_{variant}"]
        ok_c, worst_c, leaf_c = compare(g_bad, g_p, tol)
        parity[label]["control_rel"] = worst_c
        print(f"train negative control ({label}): grouped_matmul_dw "
              f"({variant}, {ran} launches) writing expert 0's gradient as "
              f"zeros: worst leaf {leaf_c} at {worst_c:.2e} (tol {tol:g}) -> "
              f"{'ACCEPTED' if ok_c else 'rejected'}")
        if ran != 3 * cfg2.n_layers:
            raise AssertionError(f"the {label} negative control ran {ran} "
                                 f"grouped_matmul_dw_{variant} launches")
        if ok_c:
            raise AssertionError(f"the {label} train parity check accepts a "
                                 f"dW without expert 0")
        del g_k, g_p, g_bad
    print(f"train part: {time.perf_counter() - t_train:.1f} s wall")
    n_dw = dw["n"]
    src = "src/repro_torch/kernels/grouped_matmul/csrc/"
    entry = {
        "name": "grouped_matmul_dw", "route": "cuda",
        "source": src + "grouped_matmul_dw_wgmma.cu",
        "sources": {"wgmma": src + "grouped_matmul_dw_wgmma.cu",
                    "fma": src + "grouped_matmul_dw.cu"},
        "replaces": "src/repro/kernels/grouped_matmul/grouped_matmul.py:48 "
                    "(its weight gradient: no TPU kernel, the reference "
                    "trains through grouped_matmul_ref)",
        "launches": launches_total["grouped_matmul_dw"],
        "launches_by_variant": {v: launches_total[f"grouped_matmul_dw_{v}"]
                                for v in ("wgmma", "fma")},
        "parity_launches_by_variant": {k: v["dw_launches"]
                                       for k, v in parity.items()},
        "max_abs_err": dw["err"], "max_rel_err": dw["rel"],
        "max_rel_err_f32_fma": dw["rel_f32"],
        "ms": dw["ms"] / n_dw, "kernel_ms": dw["ms"] / n_dw,
        "tile": "128 x 256",
        "earlier_ms": dw["fma"] / n_dw,
        "earlier": "float32-FMA kernel (csrc/grouped_matmul_dw.cu) on the "
                   "same bf16 operands",
        "plain_ms": dw["plain"] / n_dw,
        "bound_ms": dw["bound"] / n_dw,
        "bound_by": "operations" if dw["ops"] >= dw["bytes"] else "bytes",
        "library_ms": dw["lib"] / n_dw,
        "library": "torch.bmm over the (E, Cin, capacity) x (E, capacity, "
                   "Cout) view",
        "timing": "device ms a call (bf16): 20 calls in one CUDA graph, "
                  "operands cold",
        "per": f"one call at the train step's shapes, mean over layer "
               f"{n - 1}'s three; {3 * n} a step",
        "train_launches": launches_total}
    return {"entry": entry, "steps": rows, "parity": parity}


class _Tee:
    """A text stream that writes through to `out` and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def step_lines(text: str) -> dict:
    """{step: loss} from the launcher's `step N loss X ...` lines."""
    out = {}
    for line in text.splitlines():
        if line.startswith("step "):
            parts = line.split()
            out[int(parts[1])] = float(parts[3])
    return out


def run_preempted(cmd, env, deadline_s: float):
    """Start the launcher `cmd`, send it SIGTERM once it has printed its
    `step 1` line, and read it to its end.  Returns (exit code, its lines,
    time.time() when its `[preempt]` line was read).  The process is killed
    if it outlives `deadline_s`."""
    import queue
    import signal
    import threading
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=str(ROOT))
    lines_q: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines_q.put(line)
        lines_q.put(None)
    threading.Thread(target=pump, daemon=True).start()
    lines, t_preempt, sent = [], None, False
    end = time.monotonic() + deadline_s
    try:
        while True:
            line = lines_q.get(timeout=max(0.1, end - time.monotonic()))
            if line is None:
                break
            lines.append(line)
            print(f"  [A] {line.rstrip()}", flush=True)
            if not sent and line.startswith("step ") and \
                    line.split()[1] == "1":
                proc.send_signal(signal.SIGTERM)
                sent = True
            if line.startswith("[preempt]"):
                t_preempt = time.time()
        rc = proc.wait(timeout=max(1.0, end - time.monotonic()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if not sent:
        raise AssertionError("the preempted run never printed its step 1 "
                             "line")
    return rc, lines, t_preempt


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def trainer_phase(dev, bf16_rate: float) -> dict:
    """Phase 13: the launcher `repro_torch.launch.train` at the full width
    of granite-moe-1b-a400m (see the module docstring).  Returns its
    numbers for the JSON line."""
    import os
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.configs import get as get_config
    from repro_torch.kernels.flash_attention import flash_attention as FAK
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GMK
    from repro_torch.launch import train as TRAIN
    from repro_torch.launch.flops import cell_flops
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models import registry
    from repro_torch.nn import count_params

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    n = cfg.n_layers
    args = ["--arch", LM_ARCH, "--compute-dtype", "bfloat16", "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", f"{TRAIN_LR:g}",
            "--log-every", "1", "--lr-total-steps", str(TRAINER_STEPS),
            "--steps", str(TRAINER_STEPS)]
    want_launch = {"flash_attention": 2 * n, "flash_attention_wgmma": 2 * n,
                   "flash_attention_fma": 0,
                   "grouped_matmul": 2 * 3 * n + 3 * n,
                   "grouped_matmul_wgmma": 2 * 3 * n + 3 * n,
                   "grouped_matmul_fma": 0, "grouped_matmul_dx": 3 * n,
                   "grouped_matmul_dw": 3 * n,
                   "grouped_matmul_dw_wgmma": 3 * n, "grouped_matmul_dw_fma": 0}
    flops = cell_flops(cfg, ShapeSpec("trainer", "train", TRAIN_SEQ,
                                      TRAIN_BATCH), remat=True)["total"]
    print(f"trainer: python -m repro_torch.launch.train {' '.join(args)} "
          f"(full width, float32 weights from torch.Generator(cuda)"
          f".manual_seed(0)); model FLOPs a step {flops / 1e12:.4f} T "
          f"(launch/flops.cell_flops, remat)")

    def collect(rows, launches=None):
        def on_step(step, met, stats):
            if launches is not None:
                if step == TRAINER_STEADY:
                    launches.update({k: {**FAK.LAUNCHES, **GMK.LAUNCHES}[k]
                                     for k in want_launch})
                FAK.reset_launch_counts()
                GMK.reset_launch_counts()
            rows[step] = {**met, "step_s": stats["step_s"],
                          "straggler": stats["straggler"]}
        return on_step

    def launcher(argv, on_step):
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            losses = TRAIN.main(argv, on_step=on_step)
        return losses, tee.text()

    root = ROOT / "build" / f"trainer_ckpt_{os.getpid()}"
    shutil.rmtree(root, ignore_errors=True)
    try:
        # U: uninterrupted, in-process
        u_rows, launches = {}, {}
        FAK.reset_launch_counts()
        GMK.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        u_losses, _ = launcher(args, collect(u_rows, launches))
        u_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        if sorted(u_rows) != list(range(TRAINER_STEPS)) or \
                not all(np.isfinite(r["loss"]) for r in u_rows.values()):
            raise AssertionError(f"run U: steps {sorted(u_rows)}")
        steady = [u_rows[s]["step_s"] for s in range(1, TRAINER_STEPS)]
        step_s = statistics.median(steady)
        tokens_s = TRAIN_BATCH * TRAIN_SEQ / step_s
        share = flops / step_s / bf16_rate
        print(smi_line())
        for s, r in sorted(u_rows.items()):
            print(f"trainer U step {s}: step_s {r['step_s'] * 1e3:.1f} ms "
                  f"(StepTimer{', straggler' if r['straggler'] else ''}), "
                  f"{TRAIN_BATCH * TRAIN_SEQ / r['step_s']:.0f} training "
                  f"tokens/s; loss {r['loss']:.5f}, grad_norm "
                  f"{r['grad_norm']:.4f}, lr {r['lr']:.3g}")
        print(f"trainer U: median steady step {step_s * 1e3:.1f} ms, "
              f"{tokens_s:.0f} training tokens/s, peak memory {peak:.2f} GiB,"
              f" {flops / step_s / 1e12:.2f} model TFLOP/s = {share:.2%} of "
              f"the dense bf16 peak ({bf16_rate / 1e12:g} TFLOP/s); "
              f"{u_wall:.1f} s for {TRAINER_STEPS} steps")
        print(f"trainer launches of step {TRAINER_STEADY} (zeroed before it, "
              f"read after): {launches}")
        if launches != want_launch:
            raise AssertionError(f"trainer step {TRAINER_STEADY}: launches "
                                 f"{launches}, expected {want_launch}")

        # A: preempted, a subprocess, with a checkpoint directory
        model = registry.build(cfg)
        probe = model.init(torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        n_params = count_params(probe)
        del probe
        torch.cuda.empty_cache()        # the subprocess needs the memory
        ckpt_bytes = 3 * 4 * n_params   # float32 params, m and v
        root.mkdir(parents=True)
        free = shutil.disk_usage(root).free
        print(f"trainer checkpoint: about {ckpt_bytes / 1e9:.2f} GB a step "
              f"({n_params} float32 parameters, m and v); free disk under "
              f"{root.parent}: {free / 1e9:.2f} GB")
        if free < 2 * ckpt_bytes:
            raise AssertionError(
                f"not enough disk for phase 13's checkpoints: "
                f"{free / 1e9:.2f} GB free under {root.parent}, "
                f"{2 * ckpt_bytes / 1e9:.2f} GB needed (twice one checkpoint)")
        ckpt = root / "A"
        env = dict(os.environ, PYTHONUNBUFFERED="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                                               if os.environ.get("PYTHONPATH")
                                               else [])))
        t0 = time.perf_counter()
        rc, lines, t_preempt = run_preempted(
            [sys.executable, "-m", "repro_torch.launch.train", *args,
             "--ckpt-dir", str(ckpt)], env, TRAINER_TIMEOUT_S)
        a_wall = time.perf_counter() - t0
        k = store.latest_step(str(ckpt))
        k_opt = store.latest_step(str(ckpt / "opt"))
        text = "".join(lines)
        if rc != 0 or "[preempt] saving final checkpoint" not in text or \
                k is None or k < 2 or k_opt != k or t_preempt is None:
            raise AssertionError(f"run A: exit {rc}, committed steps {k} / "
                                 f"{k_opt}")
        a_losses = step_lines(text)
        commit = float((ckpt / "opt" / f"step_{k:08d}" / "COMMIT")
                       .read_text())
        save_s = commit - t_preempt
        save_bytes = dir_bytes(ckpt / f"step_{k:08d}") + \
            dir_bytes(ckpt / "opt" / f"step_{k:08d}")
        print(f"trainer A: SIGTERM after step 1; exit {rc}; committed step "
              f"{k} (params and opt) in {save_s:.2f} s wall ({save_bytes} "
              f"bytes, {save_bytes / save_s / 1e9:.2f} GB/s); run wall "
              f"{a_wall:.1f} s")
        for s, loss in a_losses.items():
            if abs(loss - u_losses[s]) > TRAINER_RESUME_TOL * abs(u_losses[s]):
                raise AssertionError(f"run A step {s}: loss {loss} vs U's "
                                     f"{u_losses[s]}")

        # B: resumed, in-process
        real_restore, restores = store.restore, []

        def timed_restore(*a, **kw):
            t = time.perf_counter()
            out = real_restore(*a, **kw)
            torch.cuda.synchronize()
            restores.append(time.perf_counter() - t)
            return out
        b_rows = {}
        store.restore = timed_restore
        try:
            b_losses, b_text = launcher(args + ["--ckpt-dir", str(ckpt)],
                                        collect(b_rows))
        finally:
            store.restore = real_restore
        if f"[resume] step {k}" not in b_text or \
                sorted(b_rows) != list(range(k, TRAINER_STEPS)):
            raise AssertionError(f"run B: resumed steps {sorted(b_rows)}")
        diffs = {s: abs(b_rows[s]["loss"] - u_losses[s]) / abs(u_losses[s])
                 for s in b_rows}
        worst = max(diffs.values())
        print(f"trainer B: [resume] step {k}; restore {sum(restores):.2f} s "
              f"wall ({' + '.join(f'{t:.2f}' for t in restores)} s: params, "
              f"opt; {save_bytes} bytes); losses "
              f"{[round(b_rows[s]['loss'], 5) for s in sorted(b_rows)]} vs U "
              f"{[round(u_losses[s], 5) for s in sorted(b_rows)]}: largest "
              f"relative difference {worst:.2e} (tol {TRAINER_RESUME_TOL:g})")
        if not worst <= TRAINER_RESUME_TOL:
            raise AssertionError("the resumed run's losses leave U's")
        shutil.rmtree(root)

        # one step with --accum 2 on U's first batch.  Its gradient is the
        # mean of the two half-batches' gradients; their load-balance loss
        # is not the whole batch's (it is a product of two batch means), so
        # its grad norm is held to that mean's, and only printed beside U's
        c_rows = {}
        launcher(args[:-2] + ["--steps", "1", "--accum", "2"],
                 collect(c_rows))
        mean_norm = half_batch_grad_norm(model, dev)
        accum = {"loss": abs(c_rows[0]["loss"] - u_rows[0]["loss"])
                 / abs(u_rows[0]["loss"]),
                 "grad_norm": abs(c_rows[0]["grad_norm"] - mean_norm)
                 / mean_norm,
                 "grad_norm_vs_u": abs(c_rows[0]["grad_norm"]
                                       - u_rows[0]["grad_norm"])
                 / u_rows[0]["grad_norm"]}
        print(f"trainer --accum 2: loss {c_rows[0]['loss']:.5f} vs U step 0 "
              f"{u_rows[0]['loss']:.5f} (relative {accum['loss']:.2e}, tol "
              f"{TRAINER_ACCUM_TOL['loss']:g}); grad_norm "
              f"{c_rows[0]['grad_norm']:.4f} vs {mean_norm:.4f}, the norm "
              f"of the mean of the two half-batches' gradients (make_grad_fn"
              f"; relative {accum['grad_norm']:.2e}, tol "
              f"{TRAINER_ACCUM_TOL['grad_norm']:g}); U step 0's grad_norm "
              f"{u_rows[0]['grad_norm']:.4f} (relative "
              f"{accum['grad_norm_vs_u']:.2e}, not checked: the load-balance"
              f" loss differs between one batch and two halves)")
        if not all(accum[key] <= tol for key, tol in
                   TRAINER_ACCUM_TOL.items()):
            raise AssertionError("the accumulated step leaves its reference")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    configs = config_forwards(dev)
    wall = time.perf_counter() - t_phase
    print(f"phase 13 (trainer and configs): {wall:.1f} s wall")
    return {"steps": [{"step": s, **r} for s, r in sorted(u_rows.items())],
            "step_s": step_s, "tokens_per_s": tokens_s, "peak_gib": peak,
            "model_flops_per_step": flops, "bf16_peak_share": share,
            "launches_steady_step": launches,
            "preempt": {"exit": rc, "step": k, "save_s": save_s,
                        "save_bytes": save_bytes, "run_s": a_wall},
            "resume": {"step": k, "restore_s": restores,
                       "max_rel_loss_diff": worst,
                       "losses": {s: b_rows[s]["loss"] for s in b_rows}},
            "accum2": {"loss": c_rows[0]["loss"],
                       "grad_norm": c_rows[0]["grad_norm"], "rel": accum},
            "configs": configs, "wall_s": wall}


def half_batch_grad_norm(model, dev) -> float:
    """The global norm of the mean of the gradients of token_batch(0, 0)'s
    two halves at the launcher's seed-0 init and TrainConfig (bf16, remat,
    chunked CE): what one `--accum 2` step must give."""
    import torch
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.params import tree_map
    from repro_torch.train import optim as OPT
    from repro_torch.train import step as STEP
    cfg = model.cfg
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    grad_fn = STEP.make_grad_fn(model, STEP.TrainConfig(
        compute_dtype=torch.bfloat16, remat=True,
        use_chunked_ce=cfg.vocab_size >= 8192))
    batch = token_batch(0, 0, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    half = TRAIN_BATCH // 2
    total = None
    for i in range(2):
        g, _ = grad_fn(params, {k: torch.as_tensor(
            v[i * half:(i + 1) * half], device=dev) for k, v in batch.items()})
        g = tree_map(lambda x: x.float() / 2, g)
        total = g if total is None else tree_map(torch.add, total, g)
        del g
    norm = float(OPT.global_norm(total))
    del params, total
    torch.cuda.empty_cache()
    return norm


def config_forwards(dev) -> dict:
    """Phase 13's second part: one bf16 `train_logits` of each of
    CONFIG_ARCHS at full width, CONFIG_LAYERS layers, through the kernels
    and through the plain path (mixtral: the plain run's routing imposed on
    the kernel run); errors within LM_BF16_PATH_TOL x max|plain|, and the
    launches by variant that `variant` predicts."""
    import torch
    from repro_torch import nn
    from repro_torch.configs import get as get_config
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels.flash_attention import flash_attention as FAK
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GMK
    from repro_torch.models import registry
    from repro_torch.nn import count_params

    out = {}
    for name in CONFIG_ARCHS:
        cfg = get_config(name).replace(n_layers=CONFIG_LAYERS)
        model = registry.build(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        n_params = count_params(params)
        cparams = nn.cast_floating(params.tree(), torch.bfloat16)
        del params
        batch = {k: torch.as_tensor(v, device=dev) for k, v in token_batch(
            0, 0, CONFIG_BATCH, CONFIG_SEQ, cfg.vocab_size).items()
            if k != "labels"}
        hd, g = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
        fa_v = FAK.variant(torch.bfloat16, hd, g, (0, 0, 0))
        n_moe = CONFIG_LAYERS if cfg.n_experts else 0
        gmm_v = GMK.variant(torch.bfloat16, cfg.d_model, cfg.d_ff, 128)
        want = {"flash_attention": CONFIG_LAYERS,
                f"flash_attention_{fa_v}": CONFIG_LAYERS,
                "grouped_matmul": 3 * n_moe,
                f"grouped_matmul_{gmm_v}": 3 * n_moe}
        want = {k: v for k, v in want.items() if v}
        routes = []
        with torch.no_grad():
            with lm_kernels_through(**plain_lm()), \
                    routes_through(recording_route(routes)):
                plain, _ = model.train_logits(cparams, batch)
            torch.cuda.synchronize()
            FAK.reset_launch_counts()
            GMK.reset_launch_counts()
            impose = routes_through(imposed_route(routes)) if n_moe else \
                contextlib.nullcontext()
            t0 = time.perf_counter()
            with impose:
                got, _ = model.train_logits(cparams, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in {**FAK.LAUNCHES, **GMK.LAUNCHES}.items()
                  if v}
        ok, err, scale = False, float("inf"), float(plain.float().abs().max())
        if got.shape == plain.shape and bool(got.isfinite().all()):
            err = float((got.float() - plain.float()).abs().max())
            ok = err <= LM_BF16_PATH_TOL * scale
        rel = err / scale
        print(f"config {name}: full width ({cfg.d_model} d_model, "
              f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {hd}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_size}"
              + (f", {cfg.n_experts} experts top-{cfg.topk}" if n_moe else "")
              + (f", window {cfg.sliding_window}" if cfg.sliding_window
                 else "") + f") at {CONFIG_LAYERS} layers "
              f"({n_params / 1e9:.3f} B parameters), bf16 train_logits of "
              f"{CONFIG_BATCH} x {CONFIG_SEQ}: max|kernel - plain| = "
              f"{rel:.2e} x max|plain| (tol {LM_BF16_PATH_TOL:g}); kernel "
              f"forward {ms:.1f} ms (first call); launches {counts}")
        if not ok or counts != want:
            raise AssertionError(f"config {name}: error {rel:.2e}, launches "
                                 f"{counts}, expected {want}")
        out[name] = {"rel_err": rel, "launches": counts, "ms": ms,
                     "params": n_params}
        del cparams, plain, got, routes
        torch.cuda.empty_cache()
    return out


def timed_generate(engine, prompts, n_new: int, runs: int):
    """`engine.generate(prompts, n_new)` `runs` times, the first a warm-up,
    with the prefill and each decode step timed on the host clock around
    synchronised calls.  Returns (tokens, prefill ms and decode-step ms of
    the runs after the warm-up, whole-call ms of each run); every run must
    give the same tokens and take n_new decode steps."""
    import numpy as np
    import torch
    step_ms = {"prefill": [], "decode": []}

    def timed(fn, key):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            step_ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    steps = (engine.prefill_step, engine.decode_step)
    engine.prefill_step = timed(steps[0], "prefill")
    engine.decode_step = timed(steps[1], "decode")
    outs = []
    try:
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = engine.generate(prompts, max_new_tokens=n_new)
            outs.append(((time.perf_counter() - t0) * 1e3, toks))
    finally:
        engine.prefill_step, engine.decode_step = steps
    toks = outs[0][1]
    if any(not np.array_equal(t, toks) for _, t in outs[1:]):
        raise AssertionError("generate gave different tokens across runs")
    if len(step_ms["decode"]) != runs * n_new:
        raise AssertionError(f"{len(step_ms['decode'])} decode steps in "
                             f"{runs} generate calls of {n_new} tokens")
    return (toks, step_ms["prefill"][1:], step_ms["decode"][n_new:],
            [ms for ms, _ in outs])


def lm_launches() -> dict:
    """The LM kernels' launch counts, those of no launch left out."""
    from repro_torch.kernels.flash_attention import flash_attention as FAK
    from repro_torch.kernels.flash_decode import flash_decode as FDK
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GMK
    return {k: v for k, v in {**FAK.LAUNCHES, **GMK.LAUNCHES,
                              **FDK.LAUNCHES}.items() if v}


def reset_lm_launches() -> None:
    from repro_torch.kernels.flash_attention import flash_attention as FAK
    from repro_torch.kernels.flash_decode import flash_decode as FDK
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GMK
    for mod in (FAK, GMK, FDK):
        mod.reset_launch_counts()


def path_check(label: str, engine, prompts, tokens, record=None,
               keep_calls=None) -> list:
    """The plain path teacher-forced on the kernel path's tokens (recording
    its MoE routing, and the kernels' operands at `keep_calls`), then the
    kernel path with that routing imposed: `lm_compare` at
    LM_BF16_PATH_TOL.  Returns the relative error of each step."""
    routes = []
    with lm_kernels_through(**plain_lm(record, keep_calls)), \
            routes_through(recording_route(routes)):
        want = teacher_forced(engine, prompts, tokens)
    impose = routes_through(imposed_route(routes)) if routes else \
        contextlib.nullcontext()
    with impose:
        got = teacher_forced(engine, prompts, tokens)
    ok, n_diff, n_close, rels = lm_compare(got, want, LM_BF16_PATH_TOL)
    print(f"{label}: kernel path against the plain path teacher-forced on "
          f"the generated tokens{' (plain routing imposed)' if routes else ''}"
          f": logit rms {rms(want[0]):.3f}, relative error prefill "
          f"{rels[0]:.2e}, decode steps max {max(rels[1:]):.2e} (tol "
          f"{LM_BF16_PATH_TOL:g}); greedy tokens differing {n_diff}, "
          f"{n_close} of them at a near tie")
    if not ok:
        raise AssertionError(f"{label}: kernel path differs from the plain "
                             f"path beyond {LM_BF16_PATH_TOL:g} x max|plain|")
    return rels


def kernel_instance(label: str, kind: str, args, mem_rate: float,
                    bf16_rate: float, l2_bytes: int) -> dict:
    """One recorded bf16 call of a phase-14 path: the kernel held against
    its plain version (LM_BF16_TOL x max|plain|) and timed beside it and
    the library call at the same shapes (SDPA, or torch.bmm for
    grouped_matmul), with its bound (phase 8's timing rule)."""
    import torch
    fns = lm_calls(kind, args)
    got, want = fns[0](), fns[1]()
    torch.cuda.synchronize()
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    if got.shape != want.shape or not bool(got.isfinite().all()) \
            or err > LM_BF16_TOL * scale:
        raise AssertionError(f"{label}: {kind} disagrees with its plain "
                             f"version: max abs err {err}, max|plain| "
                             f"{scale}")
    del got, want
    nbytes, flops = lm_work(kind, args)
    copies = cold_copies(args, nbytes, l2_bytes)
    calls = [lm_calls(kind, a) for a in copies]
    ms, plain, lib = (graph_ms(rotating([c[i] for c in calls]), MLP_REPS)
                      for i in range(3))
    del calls, copies
    b_bytes, b_ops = nbytes / mem_rate * 1e3, flops / bf16_rate * 1e3
    shape = "x".join(str(n) for n in args[0].shape)
    kw = args[-1] if isinstance(args[-1], dict) else {}
    if kind == "grouped_matmul":
        what = (f"x {shape} -> {args[2].shape[2]}, {args[2].shape[0]} "
                f"experts", f"torch.bmm {lib:.4f}")
    else:
        unlike = [k for k in ("softcap", "window") if kw.get(k)]
        what = (f"{shape} (softcap {kw.get('softcap')}, window "
                f"{kw.get('window')})", f"SDPA {lib:.4f}" + (
                    f" (no {', no '.join(unlike)})" if unlike else ""))
    print(f"  {label} {kind} {what[0]}: {ms:.4f} ms a call, plain "
          f"{plain:.4f}, {what[1]}, bound {max(b_bytes, b_ops):.4f} "
          f"({'ops' if b_ops >= b_bytes else 'bytes'}); max abs err "
          f"{err:.2e} = {err / scale:.2e} x max|plain|")
    return {"shape": shape, "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "max_abs_err": err, "softcap": kw.get("softcap")}


def leaf_grad_norms(loss_fn, params, batch):
    """One forward and backward of `loss_fn(params, batch)` with each
    parameter leaf's gradient norm taken as it lands, then the gradient
    dropped, so no whole gradient tree is held.  An expert weight leaf
    (bodies, experts, ...) gives one norm an expert, `name[e]`.  Returns
    ({name: norm}, metrics)."""
    import torch
    from repro_torch.models.params import flatten_tree, tree_map
    tree = tree_map(lambda p: p.detach().requires_grad_(), params.tree())
    sums: dict = {}

    def land(key, expert):
        def hook(p):
            sq = p.grad.float().square()
            sq = sq.sum((0, *range(2, sq.dim()))) if expert else sq.sum()
            sums[key] = sums[key] + sq if key in sums else sq
            p.grad = None
        return hook
    for name, p in flatten_tree(tree):
        expert = name.rsplit(".", 1)[-1] in EXPERT_LEAVES and p.dim() == 4
        p.register_post_accumulate_grad_hook(land(name, expert))
    total, metrics = loss_fn(tree, batch)
    total.backward()
    del tree
    norms = {}
    for k, v in sums.items():
        if v.dim():
            norms.update((f"{k}[{e}]", n) for e, n in
                         enumerate(v.sqrt().tolist()))
        else:
            norms[k] = float(v) ** 0.5
    return norms, {k: float(v.detach()) for k, v in metrics.items()}


def norms_rel(got: dict, want: dict) -> dict:
    """Relative difference of each norm; a norm that is 0 in `want` must be
    0 in `got` too."""
    return {k: abs(got[k] - w) / w if w else (0.0 if got[k] == 0 else
                                              float("inf"))
            for k, w in want.items()}


def jamba_phase(dev, mem_rate: float, bf16_rate: float,
                l2_bytes: int) -> dict:
    """Phase 14a (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GMK
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    from repro_torch.models import lm as LM
    from repro_torch.models import registry
    from repro_torch.nn import count_params
    from repro_torch.serve.lm import ServeConfig, ServeEngine
    from repro_torch.train import step as STEP
    from torch.utils.checkpoint import checkpoint

    cfg = get_config(RECURRENT_ARCHS[0]).replace(n_layers=JAMBA_LAYERS)
    specs = LM.body_layout(cfg)
    n_bodies = cfg.n_layers // cfg.block_pattern
    n_attn = n_bodies * sum(s.kind == "attn" for s in specs)
    n_moe = n_bodies * sum(s.ffn == "moe" for s in specs)
    model = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16, device=dev)
    n_params = count_params(params)
    weight_bytes = 2 * n_params
    print(f"14a jamba: {cfg.name} at full width, one body of "
          f"{cfg.n_layers} layers ({[s.kind + '/' + str(s.ffn) for s in specs]}"
          f"; d_model {cfg.d_model}, d_inner {cfg.ssm_expand * cfg.d_model}, "
          f"d_state {cfg.d_state}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, {cfg.n_experts} experts top-{cfg.topk}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}): {n_params / 1e9:.3f} B "
          f"parameters in bf16 ({weight_bytes / 2**30:.2f} GiB) from "
          f"torch.Generator(cuda).manual_seed(0); init peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (JAMBA_BATCH, JAMBA_PROMPT))
    engine = ServeEngine(model, params, ServeConfig(max_len=JAMBA_MAX_LEN),
                         device=dev)
    reset_lm_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    toks, pre_ms, dec_ms, gen_ms = timed_generate(engine, prompts, JAMBA_NEW,
                                                  RECURRENT_RUNS)
    pre_ms, dec_ms = statistics.median(pre_ms), statistics.median(dec_ms)
    launches = lm_launches()
    want = {"flash_attention": n_attn, "flash_attention_wgmma": n_attn,
            "grouped_matmul": 3 * n_moe, "grouped_matmul_wgmma": 3 * n_moe,
            "flash_decode": n_attn * JAMBA_NEW}
    want = {k: v * RECURRENT_RUNS for k, v in want.items() if v}
    yardstick = weight_bytes / mem_rate * 1e3
    print(f"14a jamba generate {JAMBA_BATCH} x {JAMBA_PROMPT} + {JAMBA_NEW} "
          f"(ServeConfig(max_len={JAMBA_MAX_LEN}), bf16): runs "
          f"{[round(v, 1) for v in gen_ms]} ms; prefill {pre_ms:.2f} ms "
          f"(median), decode "
          f"step {dec_ms:.3f} ms (median) against the weight-read yardstick "
          f"{yardstick:.3f} ms (all {weight_bytes / 1e9:.2f} GB of bf16 "
          f"weights at {mem_rate / 1e12:.2f} TB/s: the decode MoE is dense); "
          f"peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
          f"launches over {RECURRENT_RUNS} generate calls {launches}")
    if launches != want:
        raise AssertionError(f"jamba launches {launches}, expected {want}")
    rec: dict = {}
    # the prefill's first MoE sub-layer: its w_in (call 0) and w_out (2)
    keep = {"flash_attention": {0}, "grouped_matmul": {0, 2},
            "flash_decode": {n_attn * (JAMBA_NEW - 1)}}
    rels = path_check("14a jamba bf16", engine, prompts, toks, rec, keep)
    instances = {
        "flash_attention": kernel_instance(
            "jamba prefill", "flash_attention", rec["flash_attention"][0],
            mem_rate, bf16_rate, l2_bytes),
        "grouped_matmul": [kernel_instance(
            f"jamba prefill MoE call {i}", "grouped_matmul",
            rec["grouped_matmul"][i], mem_rate, bf16_rate, l2_bytes)
            for i in sorted(keep["grouped_matmul"])],
        "flash_decode": kernel_instance(
            f"jamba decode step {JAMBA_NEW}", "flash_decode",
            rec["flash_decode"][n_attn * (JAMBA_NEW - 1)], mem_rate,
            bf16_rate, l2_bytes)}
    del rec, engine

    # one bf16 forward and backward of train_logits through the kernels and
    # through the plain path, the plain path's routing imposed
    tb = {k: torch.as_tensor(v, device=dev) for k, v in token_batch(
        0, 0, *JAMBA_TRAIN, cfg.vocab_size).items()}
    loss_fn = STEP.make_loss_fn(model, STEP.TrainConfig(
        compute_dtype=torch.bfloat16, remat=False, use_chunked_ce=False))
    # the plain grouped matmul gathers each tile's expert weights in
    # float32 (3.76 GB a call at this width); under checkpoint its backward
    # recomputes them instead of keeping all 12
    plain = plain_lm()
    gmm = plain["gmm"]
    plain["gmm"] = lambda *a, **kw: checkpoint(gmm, *a, use_reentrant=False,
                                               **kw)
    routes = []
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with lm_kernels_through(**plain), \
            routes_through(recording_route(routes)):
        plain_norms, met_p = leaf_grad_norms(loss_fn, params, tb)
    plain_s = time.perf_counter() - t0
    plain_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # the kernel run keeps the backward's first two dX and dW calls (the
    # last MoE sub-layer's w_out and w_gate) for the checks below
    real = {"dx": gmm_ops.grouped_matmul_dx_cuda,
            "dw": gmm_ops.grouped_matmul_dw_cuda}
    grad_calls = {"dx": [], "dw": []}

    def keeping(kind):
        def call(*a):
            if len(grad_calls[kind]) < 2:
                grad_calls[kind].append(tuple(
                    t.detach() if torch.is_tensor(t) else t for t in a))
            return real[kind](*a)
        return call
    reset_lm_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    gmm_ops.grouped_matmul_dx_cuda = keeping("dx")
    gmm_ops.grouped_matmul_dw_cuda = keeping("dw")
    t0 = time.perf_counter()
    try:
        with routes_through(imposed_route(routes)):
            norms, met_k = leaf_grad_norms(loss_fn, params, tb)
    finally:
        gmm_ops.grouped_matmul_dx_cuda = real["dx"]
        gmm_ops.grouped_matmul_dw_cuda = real["dw"]
    kernel_s = time.perf_counter() - t0
    train_launches = lm_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rel = norms_rel(norms, plain_norms)
    worst = max(rel, key=rel.get)
    loss_rel = abs(met_k["loss"] - met_p["loss"]) / abs(met_p["loss"])
    n_exp = sum("[" in k for k in rel)
    print(f"14a jamba train_logits {JAMBA_TRAIN[0]} x {JAMBA_TRAIN[1]} "
          f"forward + backward (bf16, no optimiser): kernels {kernel_s:.2f} s"
          f", plain {plain_s:.2f} s (first calls); peak {peak:.2f} GiB "
          f"(plain run {plain_peak:.2f}); loss {met_k['loss']:.5f} vs plain "
          f"{met_p['loss']:.5f} (relative {loss_rel:.2e}); gradient norms of "
          f"{len(rel)} leaves ({n_exp} of them one expert of an expert leaf; "
          f"each gradient normed as it lands, then dropped): worst {worst} "
          f"{norms[worst]:.4g} vs {plain_norms[worst]:.4g} (relative "
          f"{rel[worst]:.2e}, tol {GRAD_NORM_TOL:g}); worst of each "
          f"sub-layer " + ", ".join(
              f"{g} {max(v for k, v in rel.items() if k.startswith(g + '.')):.1e}"
              for g in sorted({".".join(k.split(".")[:2]) for k in rel
                               if k.startswith("layers.")}))
          + f"; launches {train_launches}")
    if rel[worst] > GRAD_NORM_TOL or loss_rel > GRAD_NORM_TOL:
        raise AssertionError(f"jamba gradient norms differ from the plain "
                             f"path's beyond {GRAD_NORM_TOL:g}: worst {worst}"
                             f" {rel[worst]:.2e}, loss {loss_rel:.2e}")
    if train_launches.get("grouped_matmul_dw") != 3 * n_moe or \
            train_launches.get("grouped_matmul_dw_wgmma") != 3 * n_moe or \
            train_launches.get("grouped_matmul_dx") != 3 * n_moe:
        raise AssertionError(f"jamba backward launches {train_launches}: "
                             f"expected {3 * n_moe} grouped_matmul_dx and "
                             f"grouped_matmul_dw, all wgmma")

    # the backward's kernels alone at jamba's shapes, against their plain
    # versions: dX through the forward kernel on the transposed weights
    if [len(v) for v in grad_calls.values()] != [2, 2]:
        raise AssertionError(f"the jamba backward ran "
                             f"{[len(v) for v in grad_calls.values()]} dX "
                             f"and dW calls through the kept entry points")
    grad_errs = {"dx": [], "dw": []}
    for j, (dy, eid, w, rt) in enumerate(grad_calls["dx"]):
        before = lm_launches()
        got = GMK.grouped_matmul_dx_cuda(dy, eid, w, rt)
        want = grouped_matmul_ref(dy, eid, w.transpose(1, 2), rt)
        torch.cuda.synchronize()
        moved = {k: v - before.get(k, 0) for k, v in lm_launches().items()
                 if v != before.get(k, 0)}
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        print(f"jamba backward dX call {j} ({dy.shape[0]} x {dy.shape[1]} -> "
              f"{w.shape[1]}, {w.shape[0]} experts), bf16: max abs err "
              f"{err:.2e}, max|plain| {scale:.3g} ({err / scale:.2e}, tol "
              f"{LM_BF16_TOL:g}); launches {moved}")
        if moved != {"grouped_matmul": 1, "grouped_matmul_wgmma": 1,
                     "grouped_matmul_dx": 1} or not err <= LM_BF16_TOL * scale:
            raise AssertionError(f"jamba dX call {j} disagrees with its plain "
                                 f"version, or ran another kernel")
        grad_errs["dx"].append(err / scale)
        del got, want
    for j, call in enumerate(grad_calls["dw"]):
        err, scale = dw_check(f"jamba backward dW call {j}", call,
                              torch.bfloat16, "wgmma",
                              GMK.grouped_matmul_dw_cuda, LM_BF16_TOL)
        grad_errs["dw"].append(err / scale)
    del grad_calls

    # negative control at jamba's shapes: dW writing expert 0's gradient as
    # zeros must fail the norms check
    def dw_zero_expert0(x, dy, tile_eid, n_experts, row_tile=128):
        out = real["dw"](x, dy, tile_eid, n_experts, row_tile)
        out[0] = 0
        return out
    reset_lm_launches()
    gmm_ops.grouped_matmul_dw_cuda = dw_zero_expert0
    try:
        with routes_through(imposed_route(routes)):
            bad, _ = leaf_grad_norms(loss_fn, params, tb)
    finally:
        gmm_ops.grouped_matmul_dw_cuda = real["dw"]
    ran = lm_launches().get("grouped_matmul_dw_wgmma")
    rel_c = norms_rel(bad, plain_norms)
    worst_c = max(rel_c, key=rel_c.get)
    ok_c = rel_c[worst_c] <= GRAD_NORM_TOL
    print(f"14a jamba negative control: grouped_matmul_dw (wgmma, {ran} "
          f"launches) writing expert 0's gradient as zeros: worst leaf "
          f"{worst_c} at {rel_c[worst_c]:.2e} (tol {GRAD_NORM_TOL:g}) -> "
          f"{'ACCEPTED' if ok_c else 'rejected'}")
    if ran != 3 * n_moe or ok_c:
        raise AssertionError("the jamba gradient check accepts a dW without "
                             "expert 0")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": n_params, "prefill_ms": pre_ms, "decode_ms": dec_ms,
            "weight_read_ms": yardstick, "rel_err": max(rels),
            "launches": launches, "train_launches": train_launches,
            "grad_norm_rel": rel[worst], "grad_kernel_rel": grad_errs,
            "control_rel": rel_c[worst_c], "train_peak_gib": peak,
            "plain_train_peak_gib": plain_peak, "instances": instances}


def block_checks(dev) -> dict:
    """Phase 14b's first part: one block of each recurrent kind at float32
    on 1 x 256, on the card against the same call on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.models import mamba as MB
    from repro_torch.models import xlstm as XL
    from repro_torch.models.params import flatten_tree, tree_map
    jcfg, xcfg = (get_config(a) for a in RECURRENT_ARCHS[:2])
    cases = (("mamba (jamba width)", jcfg, MB.mamba_init, MB.mamba_apply),
             ("mLSTM (xlstm width)", xcfg, XL.mlstm_block_init,
              XL.mlstm_block_apply),
             ("sLSTM (xlstm width)", xcfg, XL.slstm_block_init,
              XL.slstm_block_apply))
    out = {}
    for label, cfg, init, apply in cases:
        p = init(torch.Generator().manual_seed(0), cfg)
        x = torch.from_numpy(np.random.default_rng(4).normal(
            size=(*BLOCK_SHAPE, cfg.d_model)).astype(np.float32))
        with torch.no_grad():
            want, wst = apply(p, cfg, x, mode="prefill")
            t0 = time.perf_counter()
            got, gst = apply(tree_map(lambda t: t.to(dev), p), cfg, x.to(dev),
                             mode="prefill")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        rels = {}
        for name, w, g in [("out", want, got)] + [
                (f"state.{n}", a, b) for (n, a), (_, b) in zip(
                    flatten_tree(wst._asdict()), flatten_tree(gst._asdict()))]:
            scale = float(w.abs().max())
            ok = g.shape == w.shape and bool(g.isfinite().all())
            rels[name] = float((g.cpu() - w).abs().max()) / max(scale, 1e-30)
            if not ok or rels[name] > BLOCK_TOL:
                raise AssertionError(f"{label} on the card differs from the "
                                     f"CPU at {name}: {rels[name]:.2e} x "
                                     f"max|cpu|")
        print(f"14b block {label}, f32 {BLOCK_SHAPE[0]} x {BLOCK_SHAPE[1]}: "
              f"card against CPU " + ", ".join(
                  f"{k} {v:.2e}" for k, v in rels.items())
              + f" x max|cpu| (tol {BLOCK_TOL:g}); card call {ms:.1f} ms "
              "(first)")
        out[label] = max(rels.values())
    return out


def trainer_run(label: str, arch: str, batch: int, seq: int, dev) -> dict:
    """`repro_torch.launch.train.main` for RECURRENT_TRAIN_STEPS bf16 steps
    in-process: losses finite; step_s (its StepTimer), training tokens/s
    and peak memory printed."""
    import numpy as np
    import torch
    from repro_torch.launch import train as TRAIN
    args = ["--arch", arch, "--compute-dtype", "bfloat16", "--batch",
            str(batch), "--seq", str(seq), "--steps",
            str(RECURRENT_TRAIN_STEPS), "--log-every", "1"]
    rows = {}

    def on_step(step, met, stats):
        rows[step] = {"loss": met["loss"], "step_s": stats["step_s"]}
    reset_lm_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    print(f"{label} trainer starts with "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved")
    t0 = time.perf_counter()
    TRAIN.main(args, on_step=on_step)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if sorted(rows) != list(range(RECURRENT_TRAIN_STEPS)) or \
            not all(np.isfinite(r["loss"]) for r in rows.values()):
        raise AssertionError(f"{label}: trainer steps {rows}")
    step_s = statistics.median(rows[s]["step_s"]
                               for s in range(1, RECURRENT_TRAIN_STEPS))
    print(f"{label} trainer: python -m repro_torch.launch.train "
          f"{' '.join(args)}: losses {[round(r['loss'], 5) for r in rows.values()]}"
          f", step_s {[round(r['step_s'] * 1e3, 1) for r in rows.values()]} ms"
          f" (median after the first {step_s * 1e3:.1f} ms), "
          f"{batch * seq / step_s:.0f} training tokens/s, peak "
          f"{peak:.2f} GiB, wall {wall:.1f} s; launches {lm_launches()}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": step_s * 1e3, "tokens_s": batch * seq / step_s,
            "peak_gib": peak, "losses": [r["loss"] for r in rows.values()],
            "launches": lm_launches()}


def xlstm_phase(dev) -> dict:
    """Phase 14b (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.models import registry
    from repro_torch.nn import count_params
    from repro_torch.serve.lm import ServeConfig, ServeEngine
    blocks = block_checks(dev)
    cfg = get_config(RECURRENT_ARCHS[1])
    model = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16, device=dev)
    print(f"14b xlstm: {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads, vocab "
          f"{cfg.vocab_size}): {count_params(params) / 1e6:.1f} M parameters"
          f" in bf16; init peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (XLSTM_BATCH, XLSTM_PROMPT))
    engine = ServeEngine(model, params, ServeConfig(max_len=LM_MAX_LEN),
                         device=dev)
    reset_lm_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    toks, pre_ms, dec_ms, gen_ms = timed_generate(engine, prompts, XLSTM_NEW,
                                                  RECURRENT_RUNS)
    pre_ms, dec_ms = statistics.median(pre_ms), statistics.median(dec_ms)
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("xlstm generated tokens out of range")
    print(f"14b xlstm generate {XLSTM_BATCH} x {XLSTM_PROMPT} + {XLSTM_NEW} "
          f"(bf16; no kernel on this path): runs "
          f"{[round(v, 1) for v in gen_ms]} ms; prefill {pre_ms:.2f} ms, "
          f"decode step {dec_ms:.3f} ms (medians); peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches "
          f"{lm_launches()}")
    del engine, params, model
    gc.collect()
    torch.cuda.empty_cache()
    train = trainer_run("14b xlstm", cfg.name,
                        *RECURRENT_TRAIN[cfg.name], dev)
    return {"blocks": blocks, "prefill_ms": pre_ms, "decode_ms": dec_ms,
            "trainer": train}


def gemma2_phase(dev, mem_rate: float, bf16_rate: float,
                 l2_bytes: int) -> dict:
    """Phase 14c (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.models import lm as LM
    from repro_torch.models import registry
    from repro_torch.nn import count_params
    from repro_torch.serve.lm import ServeConfig, ServeEngine
    cfg = get_config(RECURRENT_ARCHS[2])
    # the trainer first, on an empty allocator: its peak is near the card's
    # size, so it must not meet segments held over from the serving runs
    train = trainer_run("14c gemma2", cfg.name,
                        *RECURRENT_TRAIN[cfg.name], dev)
    specs = LM.body_layout(cfg)
    n_bodies = cfg.n_layers // cfg.block_pattern
    n_local = n_bodies * sum(s.window is not None for s in specs)
    model = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16, device=dev)
    print(f"14c gemma2: {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, {n_local} of them local with window {cfg.sliding_window}"
          f"; d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, softcaps {cfg.attn_softcap} / "
          f"{cfg.final_softcap}, vocab {cfg.vocab_size}, tied head): "
          f"{count_params(params) / 1e9:.3f} B parameters in bf16; init peak"
          f" {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (GEMMA_BATCH, GEMMA_PROMPT))
    engine = ServeEngine(model, params, ServeConfig(max_len=LM_MAX_LEN),
                         device=dev)
    reset_lm_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    toks, pre_ms, dec_ms, gen_ms = timed_generate(engine, prompts, GEMMA_NEW,
                                                  RECURRENT_RUNS)
    pre_ms, dec_ms = statistics.median(pre_ms), statistics.median(dec_ms)
    launches = lm_launches()
    n = cfg.n_layers
    want = {"flash_attention": n * RECURRENT_RUNS,
            "flash_attention_wgmma": n * RECURRENT_RUNS,
            "flash_decode": n * GEMMA_NEW * RECURRENT_RUNS}
    print(f"14c gemma2 generate {GEMMA_BATCH} x {GEMMA_PROMPT} + {GEMMA_NEW} "
          f"(bf16): runs {[round(v, 1) for v in gen_ms]} ms; prefill "
          f"{pre_ms:.2f} ms, decode step {dec_ms:.3f} ms (medians); peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches "
          f"over {RECURRENT_RUNS} generate calls {launches}")
    if launches != want:
        raise AssertionError(f"gemma2 launches {launches}, expected {want}")
    rec: dict = {}
    step = n * (GEMMA_NEW - 1) + 1       # the last step's first global layer
    keep = {"flash_attention": set(range(n)), "grouped_matmul": set(),
            "flash_decode": {step}}
    rels = path_check("14c gemma2 bf16", engine, prompts, toks, rec, keep)
    windows = [a[3]["window"] for a in rec["flash_attention"]]
    if len(windows) != n or sum(w == cfg.sliding_window
                                for w in windows) != n_local \
            or any(a[3]["softcap"] != cfg.attn_softcap
                   for a in rec["flash_attention"]):
        raise AssertionError(f"gemma2 prefill attention windows {windows}")
    instances = {
        "flash_attention": kernel_instance(
            "gemma2 prefill (global layer 1)", "flash_attention",
            rec["flash_attention"][1], mem_rate, bf16_rate, l2_bytes),
        "flash_decode": kernel_instance(
            f"gemma2 decode step {GEMMA_NEW} (layer 1)", "flash_decode",
            rec["flash_decode"][step], mem_rate, bf16_rate, l2_bytes)}
    del rec

    # one prefill past the window, through the kernels against the plain
    # path: every logit
    long = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             (1, GEMMA_LONG))
    batch = {"tokens": torch.as_tensor(long, device=dev),
             "positions": torch.arange(GEMMA_LONG, device=dev)[None]}
    rec = {}
    with torch.no_grad():
        with lm_kernels_through(**plain_lm(rec, {
                "flash_attention": {0}, "grouped_matmul": set(),
                "flash_decode": set()})):
            want_l = model.prefill(engine.params, batch)[0]
        reset_lm_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_l = model.prefill(engine.params, batch)[0]
        torch.cuda.synchronize()
        long_ms = (time.perf_counter() - t0) * 1e3
    long_launches = lm_launches()
    ok, n_diff, n_close, long_rel = lm_compare([got_l], [want_l],
                                               LM_BF16_PATH_TOL)
    print(f"14c gemma2 prefill 1 x {GEMMA_LONG} (the {cfg.sliding_window}"
          f"-token window binds): kernel path {long_ms:.1f} ms (first call), "
          f"relative error {long_rel[0]:.2e} against the plain path (tol "
          f"{LM_BF16_PATH_TOL:g}), greedy tokens differing {n_diff} ({n_close}"
          f" at a near tie); launches {long_launches}")
    if not ok or long_launches.get("flash_attention_wgmma") != n:
        raise AssertionError(f"gemma2 long prefill: error {long_rel}, "
                             f"launches {long_launches}")
    # layer 0 is local: its attention alone, where the window binds
    local = rec["flash_attention"][0]
    if local[3]["window"] != cfg.sliding_window or \
            local[0].shape[2] != GEMMA_LONG:
        raise AssertionError(f"gemma2 long prefill layer 0: window "
                             f"{local[3]['window']}, q {local[0].shape}")
    instances["flash_attention_local"] = kernel_instance(
        f"gemma2 prefill 1 x {GEMMA_LONG} (local layer 0)",
        "flash_attention", local, mem_rate, bf16_rate, l2_bytes)
    del rec, local
    del want_l, got_l, engine, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill_ms": pre_ms, "decode_ms": dec_ms, "rel_err": max(rels),
            "long_rel_err": long_rel[0], "long_ms": long_ms,
            "launches": launches, "long_launches": long_launches,
            "instances": instances, "trainer": train}


def recurrent_phase(dev, mem_rate: float, bf16_rate: float) -> dict:
    """Phase 14: the recurrent, hybrid and gemma2 LMs (see the module
    docstring).  Returns their numbers for the result lines."""
    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 14 (recurrent, hybrid and gemma2 LMs): "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB still "
          f"allocated from earlier phases")
    l2_bytes = getattr(torch.cuda.get_device_properties(dev),
                       "L2_cache_size", 50 * 2**20)
    out = {"jamba": jamba_phase(dev, mem_rate, bf16_rate, l2_bytes)}
    print(smi_line())
    out["xlstm"] = xlstm_phase(dev)
    print(smi_line())
    out["gemma2"] = gemma2_phase(dev, mem_rate, bf16_rate, l2_bytes)
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 14 (recurrent, hybrid and gemma2 LMs): "
          f"{out['wall_s']:.1f} s wall")
    return out


def grid_positions(batch: int, grid: int, s_txt: int, dev):
    """(B, grid^2 + s_txt, 3) M-RoPE ids: an image of grid x grid patches
    at t = 0 with its (h, w) ids, then the text's (n, n, n) from the grid's
    largest id + 1."""
    import torch
    h, w = torch.meshgrid(torch.arange(grid), torch.arange(grid),
                          indexing="ij")
    img = torch.stack([torch.zeros(grid * grid, dtype=torch.int64),
                       h.reshape(-1), w.reshape(-1)], -1)
    txt = (grid + torch.arange(s_txt))[:, None].expand(s_txt, 3)
    return torch.cat([img, txt]).to(dev).expand(batch, -1, -1)


def mm_run(model, params, batch, step_positions, n_new: int, state,
           tokens=None):
    """`model.prefill(params, batch)`, its states copied into the first
    slots of the zeroed decode `state`, then `n_new` decode steps fed the
    greedy tokens, or `tokens` (B, n_new) where given; `step_positions(t)`
    gives step t's positions.  Returns (the tokens fed (B, n_new), float32
    logits of the prefill and of each step, prefill ms, each step's ms),
    times on the host clock around synchronised calls."""
    import torch
    from repro_torch.models.params import tree_map
    b = batch["tokens"].shape[0]
    dev = batch["tokens"].device

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def place(dst, src):
        dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
        return dst
    with torch.no_grad():
        (logits, pre, _), pre_ms = timed(model.prefill, params, batch)
        s0 = logits.shape[1]
        tree_map(place, state, pre)
        out = [logits.float()]
        tok = logits[:, -1].argmax(-1) if tokens is None else tokens[:, 0]
        del pre, logits
        fed, step_ms = [], []
        for t in range(n_new):
            fed.append(tok)
            db = {"tokens": tok[:, None], "positions": step_positions(t),
                  "cache_pos": torch.full((b,), s0 + t, dtype=torch.int64,
                                          device=dev)}
            (logits, state, _), ms = timed(model.decode, params, db, state)
            step_ms.append(ms)
            out.append(logits[:, -1].float())
            if t + 1 < n_new:
                tok = logits[:, -1].argmax(-1) if tokens is None \
                    else tokens[:, t + 1]
    return torch.stack(fed, 1), out, pre_ms, step_ms


def mm_generate(label: str, model, params, batch, step_positions,
                n_new: int, new_state, n_layers: int, mem_rate: float,
                bf16_rate: float, l2_bytes: int) -> dict:
    """MM_RUNS greedy runs of `mm_run` through the kernels (the first a
    warm-up; equal tokens; launches counted: flash_attention `n_layers` a
    prefill, all wgmma, flash_decode `n_layers` a step), then the plain
    path teacher-forced on those tokens: logits within MM_TOL x
    max|plain|.  The plain run's first flash_attention call and its last
    step's first flash_decode call are held alone and timed
    (`kernel_instance`).  `new_state()` gives a zeroed decode state."""
    import torch
    reset_lm_launches()
    torch.cuda.reset_peak_memory_stats()
    pre_ms, dec_ms, toks, got = [], [], None, None
    for r in range(MM_RUNS):
        fed, logits, p_ms, s_ms = mm_run(model, params, batch,
                                         step_positions, n_new, new_state())
        if toks is None:
            toks, got = fed, logits
        elif not torch.equal(fed, toks):
            raise AssertionError(f"{label}: runs gave different tokens")
        if r:
            pre_ms.append(p_ms)
            dec_ms += s_ms
        del logits
    launches = lm_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"flash_attention": n_layers * MM_RUNS,
            "flash_attention_wgmma": n_layers * MM_RUNS,
            "flash_decode": n_layers * n_new * MM_RUNS}
    pre_ms, dec_ms = statistics.median(pre_ms), statistics.median(dec_ms)
    b, s_tok = batch["tokens"].shape
    print(f"{label} prefill of {b} x {got[0].shape[1]} rows + {n_new} decode "
          f"steps (bf16): prefill {pre_ms:.2f} ms, decode step {dec_ms:.3f} "
          f"ms (medians of {MM_RUNS - 1} runs after a warm-up); peak "
          f"{peak:.2f} GiB; launches over {MM_RUNS} runs {launches}")
    if launches != want:
        raise AssertionError(f"{label} launches {launches}, expected {want}")
    rec: dict = {}
    last = n_layers * (n_new - 1)
    keep = {"flash_attention": {0}, "grouped_matmul": set(),
            "flash_decode": {last}}
    with lm_kernels_through(**plain_lm(rec, keep)):
        _, want_l, _, _ = mm_run(model, params, batch, step_positions, n_new,
                                 new_state(), toks)
    ok, n_diff, n_close, rels = lm_compare(got, want_l, MM_TOL)
    print(f"{label}: kernel path against the plain path teacher-forced on "
          f"the generated tokens: logit rms {rms(want_l[0]):.3f}, relative "
          f"error prefill {rels[0]:.2e}, decode steps max {max(rels[1:]):.2e}"
          f" (tol {MM_TOL:g}); greedy tokens differing {n_diff}, {n_close} "
          f"of them at a near tie")
    if not ok:
        raise AssertionError(f"{label}: kernel path differs from the plain "
                             f"path beyond {MM_TOL:g} x max|plain|")
    del got, want_l
    instances = {
        "flash_attention": kernel_instance(
            f"{label} prefill (layer 0)", "flash_attention",
            rec["flash_attention"][0], mem_rate, bf16_rate, l2_bytes),
        "flash_decode": kernel_instance(
            f"{label} decode step {n_new} (layer 0)", "flash_decode",
            rec["flash_decode"][last], mem_rate, bf16_rate, l2_bytes)}
    return {"prefill_ms": pre_ms, "decode_ms": dec_ms, "rel_err": max(rels),
            "tokens_differing": n_diff, "peak_gib": peak,
            "launches": launches, "instances": instances}


def qwen2vl_phase(dev, mem_rate: float, bf16_rate: float,
                  l2_bytes: int) -> dict:
    """Phase 15a (see the module docstring)."""
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.models import registry
    from repro_torch.nn import count_params
    cfg = get_config(MM_ARCHS[0]).replace(n_layers=QWEN_LAYERS)
    model = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16, device=dev)
    n_params = count_params(params)
    per_layer = count_params(params.tree()["layers"]) / cfg.n_layers
    print(f"15a qwen2-vl: {cfg.name} at full width, {cfg.n_layers} of its 80 "
          f"layers (d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, M-RoPE sections {cfg.mrope_sections}): "
          f"{n_params / 1e9:.3f} B parameters in bf16 "
          f"({2 * n_params / 1e9:.2f} GB; {per_layer / 1e6:.1f} M a layer, "
          f"so all 80 would take "
          f"{2 * (n_params + (80 - cfg.n_layers) * per_layer) / 1e9:.1f} GB)"
          f"; init peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
          f"GiB")
    gen = torch.Generator(device=dev).manual_seed(8)
    b, s_img = QWEN_BATCH, QWEN_GRID ** 2
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, QWEN_TEXT),
                                     generator=gen, device=dev),
             "patch_embeds": (torch.randn((b, s_img, cfg.d_model),
                                          generator=gen, device=dev)
                              * MM_EMBED_STD).to(torch.bfloat16),
             "positions": grid_positions(b, QWEN_GRID, QWEN_TEXT, dev)}
    next_id = QWEN_GRID + QWEN_TEXT
    max_len = s_img + QWEN_TEXT + QWEN_NEW
    print(f"15a qwen2-vl prompt: {s_img} patch embeddings (a {QWEN_GRID} x "
          f"{QWEN_GRID} grid at t = 0, (h, w) ids from the grid) and "
          f"{QWEN_TEXT} text tokens with ids from {QWEN_GRID}; decode "
          f"positions (B, 1, 3) from {next_id}")
    out = mm_generate(
        "15a qwen2-vl", model, params, batch,
        lambda t: torch.full((b, 1, 3), next_id + t, dtype=torch.int64,
                             device=dev),
        QWEN_NEW, lambda: model.init_state(b, max_len, torch.bfloat16, dev),
        cfg.n_layers, mem_rate, bf16_rate, l2_bytes)
    del params, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": n_params, "layer_params": per_layer, **out}


def seamless_phase(dev, mem_rate: float, bf16_rate: float,
                   l2_bytes: int) -> dict:
    """Phase 15b (see the module docstring)."""
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.launch.shapes import AUDIO_DEC_FRACTION
    from repro_torch.models import encdec as ED
    from repro_torch.models import registry
    from repro_torch.models.params import flatten_tree
    from repro_torch.nn import count_params
    from repro_torch.train import step as STEP
    cfg = get_config(MM_ARCHS[1])
    model = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16, device=dev)
    n_params = count_params(params)
    print(f"15b seamless: {cfg.name} at full width and depth "
          f"({cfg.encoder_layers} encoder + {cfg.n_layers} decoder layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff} ({cfg.act}, "
          f"{cfg.norm}), vocab {cfg.vocab_size}): {n_params / 1e9:.3f} B "
          f"parameters in bf16 ({2 * n_params / 1e9:.2f} GB); init peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    gen = torch.Generator(device=dev).manual_seed(9)
    b, s_enc = SEAMLESS_BATCH, SEAMLESS_ENC
    s_dec = max(128, s_enc // AUDIO_DEC_FRACTION)
    batch = {"frame_embeds": (torch.randn((b, s_enc, cfg.d_model),
                                          generator=gen, device=dev)
                              * MM_EMBED_STD).to(torch.bfloat16),
             "enc_positions": torch.arange(s_enc, device=dev).expand(b, -1),
             "tokens": torch.randint(0, cfg.vocab_size, (b, s_dec),
                                     generator=gen, device=dev),
             "positions": torch.arange(s_dec, device=dev).expand(b, -1)}
    max_len = s_dec + SEAMLESS_NEW
    out = mm_generate(
        "15b seamless", model, params, batch,
        lambda t: torch.full((b, 1), s_dec + t, dtype=torch.int64,
                             device=dev),
        SEAMLESS_NEW, lambda: model.init_state(b, max_len, torch.bfloat16,
                                               dev, enc_len=s_enc),
        cfg.n_layers, mem_rate, bf16_rate, l2_bytes)

    # the plain attention of the encoder (S_enc x S_enc) and of the
    # cross-attention (S_dec x S_enc), split out of one prefill by CUDA
    # events around each call
    spans = {"encoder": [], "cross": []}
    real = ED.attention_ref

    def timed_ref(q, k, v, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        o = real(q, k, v, **kw)
        ev[1].record()
        spans["encoder" if q.shape[2] == k.shape[2] else "cross"].append(ev)
        return o
    ED.attention_ref = timed_ref
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(params, batch)
            torch.cuda.synchronize()
            split_pre_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ED.attention_ref = real
    split = {k: sum(s.elapsed_time(e) for s, e in v)
             for k, v in spans.items()}
    print(f"15b seamless prefill {split_pre_ms:.2f} ms: plain encoder "
          f"attention {split['encoder']:.3f} ms over {len(spans['encoder'])}"
          f" calls ({b} x {cfg.n_heads} x {s_enc} x {s_enc}), plain "
          f"cross-attention {split['cross']:.3f} ms over "
          f"{len(spans['cross'])} calls ({s_dec} x {s_enc})")
    if [len(v) for v in spans.values()] != [cfg.encoder_layers,
                                            cfg.n_layers]:
        raise AssertionError(f"seamless attention calls "
                             f"{[len(v) for v in spans.values()]}")

    # one bf16 forward and backward of the train step on the same batch
    # (remat, chunked cross-entropy over the untied head)
    tb = dict(batch, labels=torch.randint(0, cfg.vocab_size, (b, s_dec),
                                          generator=gen, device=dev))
    grad_fn = STEP.make_grad_fn(model, STEP.TrainConfig(
        compute_dtype=torch.bfloat16, remat=True))
    train_ms = []
    for _ in range(2):      # the first call, then a steady one
        grads = None
        reset_lm_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, met = grad_fn(params.tree(), tb)
        torch.cuda.synchronize()
        train_ms.append((time.perf_counter() - t0) * 1e3)
    train_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    train_launches = lm_launches()
    bad = [k for k, g in flatten_tree(grads) if not bool(g.isfinite().all())]
    loss = float(met["loss"])
    gnorm = float(sum(g.float().square().sum()
                      for _, g in flatten_tree(grads))) ** 0.5
    print(f"15b seamless train step forward + backward {b} x {s_dec} "
          f"(bf16, remat, chunked CE): first call {train_ms[0]:.1f} ms, "
          f"second {train_ms[1]:.1f} ms; loss {loss:.4f}, gradient norm "
          f"{gnorm:.4g}, peak {train_peak:.2f} GiB; launches of the second "
          f"{train_launches}")
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_wgmma": 2 * cfg.n_layers}
    if not (bad == [] and math.isfinite(loss) and math.isfinite(gnorm)) \
            or train_launches != want:
        raise AssertionError(f"seamless train step: loss {loss}, "
                             f"non-finite gradients {bad[:5]}, launches "
                             f"{train_launches} (expected {want})")
    del grads, tb, params, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": n_params, **out, "split_prefill_ms": split_pre_ms,
            "encoder_attention_ms": split["encoder"],
            "cross_attention_ms": split["cross"],
            "train_first_ms": train_ms[0], "train_ms": train_ms[1],
            "train_loss": loss,
            "train_peak_gib": train_peak, "train_launches": train_launches}


def multimodal_phase(dev, mem_rate: float, bf16_rate: float) -> dict:
    """Phase 15: qwen2-vl and the encoder-decoder (see the module
    docstring).  Returns their numbers for the result lines."""
    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 15 (qwen2-vl and the encoder-decoder): "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB still "
          f"allocated from earlier phases")
    l2_bytes = getattr(torch.cuda.get_device_properties(dev),
                       "L2_cache_size", 50 * 2**20)
    out = {"qwen2vl": qwen2vl_phase(dev, mem_rate, bf16_rate, l2_bytes)}
    print(smi_line())
    out["seamless"] = seamless_phase(dev, mem_rate, bf16_rate, l2_bytes)
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 15 (qwen2-vl and the encoder-decoder): "
          f"{out['wall_s']:.1f} s wall")
    return out




def sharded_train(dev, sc) -> dict:
    """16a: one train step of full-width granite (float32 weights, bf16
    compute, remat, AdamW) with `sc` and without, from the same seeded
    weights and batch, one after the other."""
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.data.synthetic import token_batch
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import registry
    from repro_torch.models.params import flatten_tree
    from repro_torch.train import optim as OPT
    from repro_torch.train import step as STEP

    cfg = get_config(LM_ARCH)
    model = registry.build(cfg)
    batch = token_batch(0, 0, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    tc = STEP.TrainConfig(compute_dtype=torch.bfloat16, remat=True)
    opt = OPT.AdamWConfig(lr=TRAIN_LR, warmup_steps=1)
    n = cfg.n_layers
    want = {"flash_attention": 2 * n, "flash_attention_wgmma": 2 * n,
            "grouped_matmul": 9 * n, "grouped_matmul_wgmma": 9 * n,
            "grouped_matmul_dx": 3 * n, "grouped_matmul_dw": 3 * n,
            "grouped_matmul_dw_wgmma": 3 * n}
    runs, kept = {}, None
    for label, s in (("sharded", sc), ("unsharded", None)):
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        state = OPT.init(params)
        step = STEP.make_train_step(model, tc, opt, s)
        if s is not None:
            params, state = STEP.place_train_state(params, state, s)
        reset_lm_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, state, met = step(params, state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = lm_launches()
        del params
        # a second step from the first's results: the steady time (the
        # first also fills DTensor's sharding-propagation caches)
        t0 = time.perf_counter()
        p2, _, _ = step(p, state, batch)
        torch.cuda.synchronize()
        ms2 = (time.perf_counter() - t0) * 1e3
        del p2, state
        met = {k: float(v) for k, v in met.items()}
        leaves = {k: SH.full(v) for k, v in flatten_tree(SH.as_tree(p))}
        if s is not None:
            # the sharded run's parameters wait on the host
            leaves = {k: v.detach().to("cpu") for k, v in leaves.items()}
        del p
        runs[label] = {"ms": ms, "ms_second_step": ms2,
                       "loss": met["loss"], "aux": met["aux"],
                       "grad_norm": met["grad_norm"], "launches": counts,
                       "peak_gib": torch.cuda.max_memory_allocated(dev)
                       / 2**30}
        print(f"sharding 16a: {label} train step "
              f"({'ShardingConfig(1 x 1, fsdp, seq_parallel)' if s else 'sc=None'}"
              f"): {ms:.1f} ms, a second step {ms2:.1f} ms, peak "
              f"{runs[label]['peak_gib']:.2f} GiB, loss "
              f"{met['loss']:.6f}, grad_norm {met['grad_norm']:.5f}; "
              f"launches {counts}  [{smi_line()}]")
        extra = {k: v for k, v in counts.items() if k not in want}
        if {k: counts.get(k, 0) for k in want} != want or extra:
            raise AssertionError(f"16a {label}: launches {counts}, expected "
                                 f"{want}")
        if kept is None:
            kept = leaves
        else:
            worst, flips = 0.0, 0
            for k, b in leaves.items():
                a = kept[k].to(dev)
                d = float((a.float() - b.float()).abs().max())
                worst = max(worst, d / float(b.float().abs().max()))
                flips += int(((a.float() - b.float()).abs()
                               > TRAIN_LR).sum())
                if d > SHARD_TRAIN_TOL * float(b.float().abs().max()):
                    raise AssertionError(f"16a: leaf {k} differs by {d} "
                                         f"(max {float(b.abs().max())})")
            runs["leaf_rel_err"] = worst
            runs["updates_apart_more_than_lr"] = flips
        del leaves
        gc.collect()
        torch.cuda.empty_cache()
    rel = abs(runs["sharded"]["loss"] - runs["unsharded"]["loss"]) / \
        abs(runs["unsharded"]["loss"])
    runs["loss_rel_err"] = rel
    print(f"sharding 16a: loss rel err {rel:.3g} (gate {SHARD_LOSS_TOL:g}), "
          f"worst updated leaf {runs['leaf_rel_err']:.3g} of its max (gate "
          f"{SHARD_TRAIN_TOL:g}), elements apart by more than lr: "
          f"{runs['updates_apart_more_than_lr']}")
    if not rel <= SHARD_LOSS_TOL:
        raise AssertionError(f"16a: loss {runs['sharded']['loss']} vs "
                             f"{runs['unsharded']['loss']}")
    return runs


def sharded_serve(dev, sc) -> dict:
    """16b: prefill and decode steps of granite with `sc` and without: the
    launches of each, greedy tokens, and both engines teacher-forced on the
    unsharded tokens (logits at LM_BF16_PATH_TOL)."""
    import numpy as np
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.models import registry
    from repro_torch.serve.lm import ServeConfig, ServeEngine
    cfg = get_config(LM_ARCH)
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    n = cfg.n_layers
    want = {"flash_attention": n, "flash_attention_wgmma": n,
            "grouped_matmul": 3 * n, "grouped_matmul_wgmma": 3 * n,
            "flash_decode": n * LM_NEW}
    out, toks, engines = {}, {}, {}
    for label, s in (("unsharded", None), ("sharded", sc)):
        eng = ServeEngine(model, params, ServeConfig(max_len=LM_MAX_LEN),
                          device=dev, sc=s)
        eng.generate(prompts, 2)                      # warm-up
        reset_lm_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks[label] = eng.generate(prompts, LM_NEW)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = lm_launches()
        out[label] = {"generate_ms": ms, "launches": counts}
        print(f"sharding 16b: {label} generate {LM_BATCH} x {LM_PROMPT} + "
              f"{LM_NEW}: {ms:.1f} ms; launches {counts}  [{smi_line()}]")
        if {k: counts.get(k, 0) for k in want} != want:
            raise AssertionError(f"16b {label}: launches {counts}, "
                                 f"expected {want}")
        engines[label] = eng
    forced = {k: teacher_forced(e, prompts, toks["unsharded"])
              for k, e in engines.items()}
    ok, n_diff, n_close, rels = lm_compare(
        forced["sharded"], forced["unsharded"], LM_BF16_PATH_TOL)
    same = int((toks["sharded"] == toks["unsharded"]).sum())
    out.update({"tokens_equal": same, "tokens": int(toks["sharded"].size),
                "forced_max_rel": max(rels), "argmax_diff": n_diff,
                "argmax_near_ties": n_close})
    print(f"sharding 16b: greedy tokens equal {same} / "
          f"{toks['sharded'].size}; teacher-forced logits max rel err "
          f"{max(rels):.3g} (gate {LM_BF16_PATH_TOL:g}), argmax differs "
          f"{n_diff} ({n_close} near ties)")
    if not ok:
        raise AssertionError(f"16b: sharded vs unsharded logits {rels}")
    del engines, forced
    return out


def sharded_pieces(dev, mesh2, mesh3, module, tmp) -> dict:
    """16c-g: moe_apply_ep at ep = 1 against moe_apply_sorted; a one-stage
    pipelined_forward against the plain loop; compressed_psum at pod = 1
    against a CPU run; elastic.resume_or_init from a checkpoint saved
    without a mesh; the scene mesh and scheduler on one card."""
    import torch
    from repro_torch.checkpoint import elastic as EL
    from repro_torch.checkpoint import store
    from repro_torch.configs import get as get_config
    from repro_torch.distributed import compression as CMP
    from repro_torch.distributed import pipeline as PP
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import moe as MOE
    from repro_torch.models import registry
    from repro_torch.models.params import flatten_tree
    from repro_torch.serve.engine import PointCloudEngine
    from repro_torch.serve.scheduler import ServeScheduler
    from repro_torch.train import optim as OPT
    out = {}
    # 16c
    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(3)
    p32 = MOE.moe_init(gen, cfg)
    b, s = SHARD_EP_TOKENS
    x32 = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        p = {k: (v.to(dtype) if not isinstance(v, dict) else
                 {q: w.to(dtype) for q, w in v.items()})
             for k, v in p32.items()}
        x = x32.to(dtype)
        reset_lm_launches()
        with torch.no_grad():
            got, aux = MOE.moe_apply_ep(p, cfg, x, mesh=mesh2,
                                        capacity_factor=SHARD_EP_CAPACITY)
            ep_launches = lm_launches()
            reset_lm_launches()
            want, aux_w = MOE.moe_apply_sorted(
                p, cfg, x, capacity_factor=SHARD_EP_CAPACITY)
            sorted_launches = lm_launches()
        got, want = SH.full(got).float(), want.float()
        rel = float((got - want).abs().max() / want.abs().max())
        key = str(dtype).removeprefix("torch.")
        out[f"ep_{key}"] = {"rel_err": rel, "aux": float(SH.full(aux)),
                            "aux_sorted": float(aux_w)}
        print(f"sharding 16c: moe_apply_ep (ep 1, {b} x {s} x "
              f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.topk}, "
              f"{key}) vs moe_apply_sorted: max rel err {rel:.3g} (gate "
              f"{tol:g}); aux {float(SH.full(aux)):.5f} vs "
              f"{float(aux_w):.5f}; kernel launches of the EP path "
              f"{ep_launches}, of the sorted path {sorted_launches}")
        if not rel <= tol or ep_launches or \
                sorted_launches.get("grouped_matmul") != 3:
            raise AssertionError(f"16c {key}: rel err {rel}, launches "
                                 f"{ep_launches}")
    del p32, x32, p, x, got, want
    # 16d
    nb, bb, ss, dd = SHARD_PIPE
    w = (torch.randn((nb, dd, dd), generator=gen, device=dev)
         / dd ** 0.5).requires_grad_()
    xp = torch.randn((bb, ss, dd), generator=gen, device=dev)

    def body_fn(q, h):
        return torch.tanh(h @ q["w"])
    y = PP.pipelined_forward(body_fn, {"w": w}, xp, mesh3, n_micro=4)
    (y.square().sum()).backward()
    g_pipe = w.grad.clone()
    w.grad = None
    h = xp
    for i in range(nb):
        h = torch.tanh(h @ w[i])
    h.square().sum().backward()
    y, h = y.detach(), h.detach()
    fwd = float((y - h).abs().max() / h.abs().max())
    bwd = float((g_pipe - w.grad).abs().max() / w.grad.abs().max())
    out["pipeline"] = {"fwd_rel_err": fwd, "grad_rel_err": bwd}
    print(f"sharding 16d: pipelined_forward (1 stage, {nb} bodies of "
          f"{dd} x {dd}, x {bb} x {ss} x {dd}, 4 microbatches) vs the plain "
          f"loop: forward {fwd:.3g}, gradient {bwd:.3g} (gate 1e-5)")
    if not (fwd <= 1e-5 and bwd <= 1e-5):
        raise AssertionError(f"16d: {fwd} {bwd}")
    del w, xp, y, h, g_pipe
    # 16e
    group = mesh3.get_group("pod")
    xc = torch.randn((3, 1000), generator=gen, device=dev) * 1e-2
    err = torch.randn((3, 1000), generator=gen, device=dev) * 1e-4
    mean, err2 = CMP.compressed_psum(xc, group, err)
    q, sc_ = CMP._quantize_int8(xc.float() + err)
    q_c, sc_c = CMP._quantize_int8(xc.float().cpu() + err.cpu())
    mean_c = CMP._dequantize(q_c, sc_c, xc.shape, torch.float32)
    dq = int((q.cpu() != q_c).sum())
    ds = int((sc_.cpu() != sc_c).sum())
    dm = int((mean.cpu() != mean_c).sum())
    out["compressed"] = {"payload_differs": dq, "scales_differ": ds,
                         "mean_differs": dm, "payload": q.numel()}
    why = "" if not (dq or ds or dm) else (
        " (a float32 quotient or sum rounds differently on the card)")
    print(f"sharding 16e: compressed_psum at pod 1 on {tuple(xc.shape)}: "
          f"{dq} of {q.numel()} int8 payload elements, {ds} of "
          f"{sc_.numel()} scales and {dm} mean elements differ from a CPU "
          f"run of the same input{why}")
    if dq or ds or dm:
        raise AssertionError("16e: the card's int8 exchange differs from "
                             "the CPU's")
    # 16f
    small = registry.build(get_config(LM_ARCH, reduced=True))

    def init():
        return small.init(torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    saved = init()
    st = OPT.init(saved)
    st = st._replace(step=st.step + 7)
    root = str(Path(tmp) / "elastic")
    store.save(root, 7, saved)
    store.save(root + "/opt", 7, st)
    sc = SH.ShardingConfig(mesh2, fsdp=True)
    p, o, start = EL.resume_or_init(root, init, sc, LM_BATCH)
    equal = all(torch.equal(SH.full(a), b) for (_, a), (_, b) in zip(
        flatten_tree(SH.as_tree(p)), flatten_tree(saved.tree())))
    out["elastic"] = {"start_step": start, "params_equal": equal,
                      "opt_step": int(o.step)}
    print(f"sharding 16f: elastic.resume_or_init on the 1 x 1 mesh from a "
          f"checkpoint saved without one: start step {start}, params "
          f"bit-equal {equal}, opt step {int(o.step)}")
    if not (start == 7 and equal and int(o.step) == 7):
        raise AssertionError(f"16f: {out['elastic']}")
    # 16g
    scene_mesh = SH.make_scene_mesh()
    sched = ServeScheduler(PointCloudEngine(module, N_STAGES,
                                            flow="cuda_fused"),
                           max_batch=3)
    out["scene"] = {"scene_mesh": None if scene_mesh is None else
                    scene_mesh.size, "n_devices":
                    sched.stats()["n_devices"], "max_batch": sched.max_batch}
    print(f"sharding 16g: make_scene_mesh() -> {scene_mesh}; scheduler "
          f"n_devices {out['scene']['n_devices']}, max_batch "
          f"{sched.max_batch}")
    if scene_mesh is not None or out["scene"]["n_devices"] != 1 or \
            sched.max_batch != 3:
        raise AssertionError(f"16g: {out['scene']}")
    sched.close()
    return out


def sharding_phase(dev, module) -> dict:
    """Phase 16: the sharded entry points on one card (see the module
    docstring): NCCL at world 1, 1 x 1 and 1 x 1 x 1 meshes."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_device(dev.index or 0)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh2 = make_mesh((1, 1), ("data", "model"))
        mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"))
        print(f"phase 16 (sharding): NCCL world 1, meshes {mesh2} and "
              f"{mesh3}  [{smi_line()}]")
        sc = SH.ShardingConfig(mesh2, fsdp=True, seq_parallel=True)
        out = {"train": sharded_train(dev, sc)}
        out["serve"] = sharded_serve(dev, sc)
        out.update(sharded_pieces(dev, mesh2, mesh3, module, tmp))
    finally:
        dist.destroy_process_group()
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 16 (sharding): {out['wall_s']:.1f} s wall")
    return out


def lm_paths_build_report(libs, n_sm: int) -> None:
    """Phase 2, for phases 14 and 15: HGMMA, registers and spills of the
    flash_attention_wgmma instances that jamba (head_dim 128, G 4), gemma2
    (head_dim 256, G 2), qwen2-vl (head_dim 128, G 8) and seamless's
    decoder (head_dim 64, G 1) take, and registers and spills of the
    flash_decode instances of their decode steps."""
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import flash_decode as FDK
    from repro_torch.launch.shapes import AUDIO_DEC_FRACTION
    fa_regs = ptxas_kernels(build.build_log.get("flash_attention_wgmma", ""))
    fd_regs = ptxas_kernels(build.build_log.get("flash_decode", ""))
    for arch, batch, max_len in (
            (RECURRENT_ARCHS[0], JAMBA_BATCH, LM_MAX_LEN),
            (RECURRENT_ARCHS[2], GEMMA_BATCH, LM_MAX_LEN),
            (MM_ARCHS[0], QWEN_BATCH, QWEN_GRID ** 2 + QWEN_TEXT + QWEN_NEW),
            (MM_ARCHS[1], SEAMLESS_BATCH, SEAMLESS_NEW + max(
                128, SEAMLESS_ENC // AUDIO_DEC_FRACTION))):
        cfg = get_config(arch)
        hd, g = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
        name = f"flash_attention_wgmma_kernelILi{hd}E"
        regs = [v for k, v in fa_regs.items() if name in k]
        if len(regs) != 1:
            raise AssertionError(f"ptxas reports {len(regs)} kernels named "
                                 f"{name}")
        hgmma = sass_lines(libs["flash_attention_wgmma"], name, "HGMMA")
        if not hgmma:
            raise AssertionError(f"no HGMMA in {name}'s SASS")
        print(f"SASS: {name} ({arch}'s prefill: head_dim {hd}, G {g}) holds "
              f"{len(hgmma)} HGMMA instructions, e.g. "
              f"{hgmma[0].split(';')[0]}; ptxas: {regs[0][0]} registers, "
              f"spill stores/loads {regs[0][1]}/{regs[0][2]} bytes")
        plan = FDK.plan_launch(
            torch.empty((batch, cfg.n_heads, hd), dtype=torch.bfloat16,
                        device="cuda"),
            *[torch.empty((batch, max_len, cfg.n_kv_heads, hd),
                          dtype=torch.bfloat16, device="cuda")] * 2, n_sm)
        fd_name = fd_kernel_name(plan, True)
        fd = [v for k, v in fd_regs.items() if fd_name in k]
        if len(fd) != 1:
            raise AssertionError(f"ptxas reports {len(fd)} kernels named "
                                 f"{fd_name}")
        print(f"  ptxas: {fd_name} ({arch}'s decode step, {plan}): "
              f"{fd[0][0]} registers, spill stores/loads {fd[0][1]}/"
              f"{fd[0][2]} bytes")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.synthetic import city_scene
    from repro_torch.kernels import build
    from repro_torch.kernels.spconv import ref
    from repro_torch.kernels.spconv import spconv as K
    from repro_torch.models import minkunet as MU
    from repro_torch.serve.engine import PointCloudEngine

    # 1. device
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {name}  count={torch.cuda.device_count()}  torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    mem_rate, flop_rate = PEAKS["pcie" if "PCIe" in name else "sxm"]

    # 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} librar(y/ies) from csrc/ in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib, log in build.build_log.items():
        if lib == "flash_decode":
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    # flash_decode: one instance per (cache type, load width, loads a row,
    # heads a CTA); the decode step's shapes take one of them
    from repro_torch.configs import get as get_config
    from repro_torch.kernels.flash_decode import flash_decode as FDK
    lm = get_config(LM_ARCH)
    hd = lm.resolved_head_dim
    fd_plan = FDK.plan_launch(
        torch.empty((LM_BATCH, lm.n_heads, hd), dtype=torch.bfloat16,
                    device="cuda"),
        *[torch.empty((LM_BATCH, LM_MAX_LEN, lm.n_kv_heads, hd),
                      dtype=torch.bfloat16, device="cuda")] * 2,
        torch.cuda.get_device_properties(0).multi_processor_count)
    fd_name = fd_kernel_name(fd_plan, True)
    fd_regs = ptxas_kernels(build.build_log.get("flash_decode", ""))
    main = [v for k, v in fd_regs.items() if fd_name in k]
    if len(main) != 1:
        raise AssertionError(f"ptxas reports {len(main)} kernels named "
                             f"{fd_name}")
    spilled = sorted(k.split("flash_decode_kernel")[1] for k, v in
                     fd_regs.items() if v[1] or v[2])
    print(f"  ptxas: flash_decode_kernel: {len(fd_regs)} instances, the "
          f"decode step's ({fd_name.split('kernel')[1]}: {fd_plan}) "
          f"{main[0][0]} registers, spill stores/loads {main[0][1]}/"
          f"{main[0][2]} bytes; at most {max(v[0] for v in fd_regs.values())}"
          f" registers; instances with spills: {spilled}")
    # CTAs an SM by those registers (allocated 8 a thread at a time) and by
    # shared memory (228 KB an SM, 1 KB of it reserved a CTA), and CTA
    # slots on the card against the launch's CTAs
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    by_regs = 65536 // (-(-main[0][0] // 8) * 8 * FDK.THREADS)
    by_smem = 233472 // (fd_plan.smem + 1024)
    per_sm = min(by_regs, by_smem, 2048 // FDK.THREADS)
    print(f"  flash_decode occupancy (from ptxas): {per_sm} CTAs an SM "
          f"({by_regs} by registers, {by_smem} by shared memory), "
          f"{per_sm * n_sm} CTA slots on {n_sm} SMs for the decode step's "
          f"{fd_plan.ctas} CTAs")
    wide = [ln for ln in sass_lines(libs["flash_decode"], fd_name, "LDG")
            if ".128" in ln]                  # LDG.E.128..., LDGSTS...128
    if not wide:
        raise AssertionError(f"no 128-bit global load in {fd_name}'s SASS")
    print(f"SASS: {fd_name} holds {len(wide)} 128-bit global loads, e.g. "
          f"{wide[0].split(';')[0]}")
    # the bf16 grouped matmul runs on the tensor cores: HGMMA in its SASS
    hgmma = sass_lines(libs["grouped_matmul_wgmma"],
                       "grouped_matmul_wgmma_kernel", "HGMMA")
    if not hgmma:
        raise AssertionError("no HGMMA in grouped_matmul_wgmma_kernel's SASS")
    print(f"SASS: grouped_matmul_wgmma_kernel holds {len(hgmma)} HGMMA "
          f"instructions, e.g. {hgmma[0].split(';')[0]}")
    # so does the bf16 weight gradient of the train step
    dw_name = "grouped_matmul_dw_wgmma_kernel"
    dw_regs = [v for k, v in ptxas_kernels(build.build_log.get(
        "grouped_matmul_dw_wgmma", "")).items() if dw_name in k]
    if len(dw_regs) != 1:
        raise AssertionError(f"ptxas reports {len(dw_regs)} kernels named "
                             f"{dw_name}")
    hgmma = sass_lines(libs["grouped_matmul_dw_wgmma"], dw_name, "HGMMA")
    if not hgmma:
        raise AssertionError(f"no HGMMA in {dw_name}'s SASS")
    print(f"SASS: {dw_name} (the train step's dW) holds {len(hgmma)} HGMMA "
          f"instructions, e.g. {hgmma[0].split(';')[0]}; ptxas: "
          f"{dw_regs[0][0]} registers, spill stores/loads {dw_regs[0][1]}/"
          f"{dw_regs[0][2]} bytes")
    # so does the bf16 prefill's attention, in the head_dim instance it takes
    fa_name = f"flash_attention_wgmma_kernelILi{hd}E"
    fa_regs = [v for k, v in ptxas_kernels(build.build_log.get(
        "flash_attention_wgmma", "")).items() if fa_name in k]
    if len(fa_regs) != 1:
        raise AssertionError(f"ptxas reports {len(fa_regs)} kernels named "
                             f"{fa_name}")
    print(f"  ptxas: {fa_name} (the prefill's, head_dim {hd}): "
          f"{fa_regs[0][0]} registers, spill stores/loads {fa_regs[0][1]}/"
          f"{fa_regs[0][2]} bytes")
    hgmma = sass_lines(libs["flash_attention_wgmma"], fa_name, "HGMMA")
    if not hgmma:
        raise AssertionError(f"no HGMMA in {fa_name}'s SASS")
    print(f"SASS: {fa_name} holds {len(hgmma)} HGMMA instructions, e.g. "
          f"{hgmma[0].split(';')[0]}")
    lm_paths_build_report(
        libs, torch.cuda.get_device_properties(0).multi_processor_count)
    # the sparse conv runs on the tensor cores in TF32: HMMA ... TF32 in each
    # instance (column tile width, fused or not) that the MinkUNet path takes
    module = MU.minkunet_init(torch.Generator().manual_seed(0))
    tree = module.tree()
    sp_regs = ptxas_kernels(build.build_log.get("spconv_tc", ""))
    for cn in sorted({K.pick_cn(c) for c in conv_couts(tree)}):
        for fused in (1, 0):
            sp_name = f"spconv_fod_tc_kernelILi{cn}ELb{fused}E"
            regs = [v for k, v in sp_regs.items() if sp_name in k]
            if len(regs) != 1:
                raise AssertionError(f"ptxas reports {len(regs)} kernels "
                                     f"named {sp_name}")
            hmma = [ln for ln in sass_lines(libs["spconv_tc"], sp_name,
                                            "HMMA") if "TF32" in ln]
            if not hmma:
                raise AssertionError(f"no HMMA TF32 in {sp_name}'s SASS")
            print(f"SASS: {sp_name} holds {len(hmma)} HMMA TF32 "
                  f"instructions, e.g. {hmma[0].split(';')[0]}; ptxas: "
                  f"{regs[0][0]} registers, spill stores/loads {regs[0][1]}/"
                  f"{regs[0][2]} bytes")

    # fused_mlp: registers and spills of every instance; HMMA ... TF32 in each
    # tensor-core instance that the PointNet++(s) groups take
    from repro_torch.kernels.fused_mlp import fused_mlp as FK
    for lib in ("fused_mlp", "fused_mlp_tc"):
        for kname, (regs, st, ld) in ptxas_kernels(
                build.build_log.get(lib, "")).items():
            short = kname.split("_cu_")[-1] if "_cu_" in kname else kname
            print(f"  ptxas: {lib}: {short}: {regs} registers, spill "
                  f"stores/loads {st}/{ld} bytes")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for gname, widths, rows in PN_SEG_GROUPS:
        plan = FK.plan_mlp(widths, rows, torch.float32, n_sm)
        if plan.variant != "tc":
            raise AssertionError(f"PointNet++(s) {gname}: variant "
                                 f"{plan.variant}, expected tc")
        mlp_name = f"fused_mlp_tc_kernelILi{plan.rows}ELb0ELb0E"
        hmma = [ln for ln in sass_lines(libs["fused_mlp_tc"], mlp_name,
                                        "HMMA") if "TF32" in ln]
        if not hmma:
            raise AssertionError(f"no HMMA TF32 in {mlp_name}'s SASS")
        print(f"SASS: PointNet++(s) {gname} takes {mlp_name} ({plan}): "
              f"{len(hmma)} HMMA TF32 instructions, e.g. "
              f"{hmma[0].split(';')[0]}")

    scenes = {key: city_scene(*key)
              for key in (SCENE_A, SCENE_B) + SERVE_STREAM + SERVE_BATCH}

    # 3. kernels, on the inputs of every conv of one forward
    sites, fod_logits = record_sites(module, scenes[SCENE_A])
    dev = fod_logits.device
    names = site_names(tree)
    if not len(sites) == len(names) == 41:
        raise AssertionError(f"{len(sites)} conv sites recorded, "
                             f"{len(names)} named; expected 41")

    tf32_rate = TF32_PEAKS["pcie" if "PCIe" in name else "sxm"]
    print(f"kernel phase: {len(sites)} conv sites of one forward, tol "
          f"atol=rtol={TOL:g}; kernel times in ms as device time a call "
          f"({REPS} calls in one CUDA graph), plain and gemm-only with CUDA "
          f"events (mean of {REPS}); 'earlier' = the FMA kernel "
          f"(csrc/spconv.cu); errors as a fraction of max|plain|; bounds: "
          f"float32 FMAs at {flop_rate / 1e12:g} TFLOP/s and split-float TF32 "
          f"at 3 x FLOPs / {tf32_rate / 1e12:g} TFLOP/s, each against the "
          f"bytes at {mem_rate / 1e12:g} TB/s; row use = real rows / rows "
          f"computed at 64-row and at {K.SKIP_ROWS}-row skips; plan = variant"
          f"/n_split, then ran/CTAxR = CTAs that ran a pipeline stage / CTAs launched x the most rounds "
          f"of a cluster, counted by the kernel (one extra call with stats=)")
    print(f"{'site':14s} {'L':>1s} {'K':>2s} {'Cin':>4s} {'Cout':>4s} "
          f"{'M':>6s} {'nnz':>7s} {'plan: ran/CTAxR':>16s} {'err_f':>8s} {'err_b':>8s} "
          f"{'fused':>7s} {'base':>7s} {'earlier':>7s} {'plain_f':>7s} "
          f"{'gemm':>7s} {'b_f32':>7s} {'b_tc':>7s} {'ru64':>5s} "
          f"{'ru16':>5s} {'neg_err':>8s}")
    keys = ("fused", "base", "earlier_f", "earlier_b", "plain_f", "plain_b",
            "gemm", "bound_f", "bound_b", "bound_ops", "bound_tc_f",
            "bound_tc_b", "tc_ops", "bytes_f", "bytes_b", "flops",
            "dense_flops", "tc_flops", "nnz", "live64", "live16")
    totals = dict.fromkeys(keys, 0.0)
    totals.update(err_f=0.0, err_b=0.0, rel_f=0.0, rel_b=0.0)
    by_level: dict[int, dict] = {}
    controls = 0
    for nm, s in zip(names, sites):
        fe, inv, w, epi = s["features"], s["inv"], s["weights"], s["epi"]
        k, mrows = inv.shape
        cin, cout = w.shape[1], w.shape[2]
        plan_f = K.plan_for(fe, inv, w, fused=True)
        plan_b = K.plan_for(fe, inv, w, fused=False)
        if plan_f.variant != "tc" or plan_b.variant != "tc":
            raise AssertionError(f"{nm} takes {plan_f} / {plan_b}, not the "
                                 "tensor-core kernel")
        out_f = K.spconv_fod_fused_cuda(fe, inv, w, epi)
        ref_f = ref.spconv_fod_fused_ref(fe, inv, w, epi)
        out_b = K.spconv_fod_cuda(fe, inv, w)
        ref_b = ref.spconv_fod_ref(fe, inv, w)
        old_f = K.spconv_fod_kernel(fe, inv, w, epi, kind="fma", fused=True)
        old_b = K.spconv_fod_kernel(fe, inv, w, kind="fma", fused=False)
        torch.cuda.synchronize()
        for out, want, what in ((out_f, ref_f, "fused"),
                                (out_b, ref_b, "baseline"),
                                (old_f, ref_f, "fused FMA"),
                                (old_b, ref_b, "baseline FMA")):
            if not torch.allclose(out, want, atol=TOL, rtol=TOL):
                raise AssertionError(
                    f"{what} kernel disagrees with its plain version at {nm}"
                    f": max abs err {float((out - want).abs().max())}")
        err_f = float((out_f - ref_f).abs().max())
        err_b = float((out_b - ref_b).abs().max())
        rel_f = err_f / max(float(ref_f.abs().max()), 1e-30)
        rel_b = err_b / max(float(ref_b.abs().max()), 1e-30)
        del old_f, old_b
        # the kernel's own counts of the work it spread (one extra call)
        counts = torch.zeros(len(K.STATS), dtype=torch.int32, device=dev)
        K.spconv_fod_kernel(fe, inv, w, epi, kind="tc", fused=True,
                            stats=counts)
        counts = dict(zip(K.STATS, counts.tolist()))
        # negative control: the plan's last rank without its offsets must
        # fail the same check wherever those offsets hold an input
        last = list(range(plan_f.n_split - 1, k, plan_f.n_split))
        neg_err = float("nan")
        if bool((inv[last] >= 0).any()):
            inv_neg = inv.clone()
            inv_neg[last] = -1
            neg = K.spconv_fod_fused_cuda(fe, inv_neg, w, epi)
            torch.cuda.synchronize()
            if torch.allclose(neg, ref_f, atol=TOL, rtol=TOL):
                raise AssertionError(f"negative control accepted at {nm}: "
                                     f"the last rank's offsets {last} "
                                     "dropped")
            neg_err = float((neg - ref_f).abs().max())
            controls += 1
            del neg, inv_neg
        valid = inv >= 0
        nnz = int(valid.sum())
        rows_read = int(torch.unique(inv[valid]).numel())
        flops = 2.0 * nnz * cin * cout
        # rows computed: every row of each (tile, offset) slice that holds
        # an input, at the CTA's 64 rows and at a warp's 16
        tiles = -(-mrows // K.ROWS_PER_CTA)
        padded = torch.full((k, tiles * K.ROWS_PER_CTA), -1,
                            dtype=inv.dtype, device=inv.device)
        padded[:, :mrows] = inv
        live64 = int((padded.view(k, tiles, -1) >= 0).any(-1).sum())
        live_tiles = int((padded.view(k, tiles, -1) >= 0).any(-1).any(0)
                         .sum())
        live16 = int((padded.view(k, -1, K.SKIP_ROWS) >= 0).any(-1).sum())
        nbytes = 4 * (rows_read * cin + k * mrows + k * cin * cout
                      + mrows * cout)
        fused_bytes = nbytes + 4 * (2 * cout + mrows) \
            + (4 * mrows * cout if epi.residual is not None else 0)
        b_ops = flops / flop_rate * 1e3
        b_tc = 3 * flops / tf32_rate * 1e3
        b_bytes_f, b_bytes_b = (fused_bytes / mem_rate * 1e3,
                                nbytes / mem_rate * 1e3)
        gathered = fe[inv.clamp(min=0).long()] * valid[..., None]
        t = {"fused": graph_ms(lambda: K.spconv_fod_fused_cuda(fe, inv, w, epi),
                               REPS),
             "base": graph_ms(lambda: K.spconv_fod_cuda(fe, inv, w), REPS),
             "earlier_f": graph_ms(lambda: K.spconv_fod_kernel(
                 fe, inv, w, epi, kind="fma", fused=True), REPS),
             "earlier_b": graph_ms(lambda: K.spconv_fod_kernel(
                 fe, inv, w, kind="fma", fused=False), REPS),
             "plain_f": cuda_ms(
                 lambda: ref.spconv_fod_fused_ref(fe, inv, w, epi), REPS),
             "plain_b": cuda_ms(lambda: ref.spconv_fod_ref(fe, inv, w), REPS),
             "gemm": cuda_ms(
                 lambda: torch.einsum("kmc,kcd->md", gathered, w), REPS)}
        del gathered
        site = {**t, "bound_f": max(b_ops, b_bytes_f),
                "bound_b": max(b_ops, b_bytes_b), "bound_ops": b_ops,
                "bound_tc_f": max(b_tc, b_bytes_f),
                "bound_tc_b": max(b_tc, b_bytes_b), "tc_ops": b_tc,
                "bytes_f": b_bytes_f, "bytes_b": b_bytes_b, "flops": flops,
                "dense_flops": 2.0 * live64 * K.ROWS_PER_CTA * cin * cout,
                "tc_flops": 2.0 * live16 * K.SKIP_ROWS * (-(-cin // 8) * 8)
                * cout, "nnz": nnz, "live64": live64, "live16": live16}
        lvl = by_level.setdefault(level_of(nm), {**dict.fromkeys(keys, 0.0),
                                                 "sites": 0, "plans": set()})
        for key in keys:
            totals[key] += site[key]
            lvl[key] += site[key]
        lvl["sites"] += 1
        lvl["plans"].add(f"{mrows} rows, {live_tiles} live tiles: "
                         f"{plan_f.ctas} CTAs in clusters of "
                         f"{plan_f.n_split}; device counts: "
                         f"{counts['busy_ctas']} CTAs ran stages, at most "
                         f"{counts['max_stages']} stages a CTA, "
                         f"{counts['max_rounds']} rounds")
        for key, val in (("err_f", err_f), ("err_b", err_b), ("rel_f", rel_f),
                         ("rel_b", rel_b)):
            totals[key] = max(totals[key], val)
        plan_txt = (f"{plan_f.variant}/{plan_f.n_split} "
                    f"{counts['busy_ctas']}/{plan_f.ctas}x"
                    f"{counts['max_rounds']}")
        print(f"{nm:14s} {level_of(nm):1d} {k:2d} {cin:4d} {cout:4d} "
              f"{mrows:6d} {nnz:7d} {plan_txt:>16s} {rel_f:8.1e} "
              f"{rel_b:8.1e} {t['fused']:7.3f} {t['base']:7.3f} "
              f"{t['earlier_f']:7.3f} {t['plain_f']:7.3f} {t['gemm']:7.3f} "
              f"{site['bound_f']:7.4f} {site['bound_tc_f']:7.4f} "
              f"{nnz / max(1, live64 * K.ROWS_PER_CTA):5.3f} "
              f"{nnz / max(1, live16 * K.SKIP_ROWS):5.3f} {neg_err:8.2e}  "
              f"{NAMED.get(nm, '')}")
    if controls == 0:
        raise AssertionError("the negative control found no live site")
    print(f"negative control (the plan's last rank's offsets set to -1): "
          f"rejected at all {controls} sites where they hold an input")
    print(f"{'total':14s} real GFLOP {totals['flops'] / 1e9:.2f}  computed "
          f"GFLOP at 64-row skips {totals['dense_flops'] / 1e9:.2f}, by the "
          f"tensor-core kernel (16-row skips, Cin to 8) "
          f"{totals['tc_flops'] / 1e9:.2f}  fused {totals['fused']:.3f} ms  "
          f"base {totals['base']:.3f} ms  earlier fused "
          f"{totals['earlier_f']:.3f} ms, base {totals['earlier_b']:.3f} ms  "
          f"plain_f {totals['plain_f']:.3f} ms  plain_b "
          f"{totals['plain_b']:.3f} ms  gemm-only {totals['gemm']:.3f} ms")
    print(f"{'bounds':14s} split-float TF32: fused {totals['bound_tc_f']:.4f}"
          f" ms, base {totals['bound_tc_b']:.4f} ms (ops "
          f"{totals['tc_ops']:.4f}); float32 FMAs: fused "
          f"{totals['bound_f']:.4f} ms, base {totals['bound_b']:.4f} ms (ops "
          f"{totals['bound_ops']:.4f}); bytes fused {totals['bytes_f']:.4f}, "
          f"base {totals['bytes_b']:.4f}; max error fused {totals['err_f']:.2e}"
          f" ({totals['rel_f']:.2e} of max|plain|), base "
          f"{totals['err_b']:.2e} ({totals['rel_b']:.2e})")
    print("per level: fused ms (share), earlier ms, base ms, bound ms "
          "(TF32), row use at 64 / 16 rows, plans")
    for lv in sorted(by_level):
        d = by_level[lv]
        print(f"  level {lv}: {d['sites']:2d} sites  fused {d['fused']:.3f} "
              f"({d['fused'] / totals['fused']:.1%})  earlier "
              f"{d['earlier_f']:.3f} ({d['earlier_f'] / totals['earlier_f']:.1%}"
              f")  base {d['base']:.3f}  bound {d['bound_tc_f']:.4f}  row use "
              f"{d['nnz'] / max(1, d['live64'] * K.ROWS_PER_CTA):.2f} / "
              f"{d['nnz'] / max(1, d['live16'] * K.SKIP_ROWS):.2f}  "
              f"{'; '.join(sorted(d['plans']))}")

    # 4. main path
    engine = PointCloudEngine(module, N_STAGES, flow="cuda_fused")
    baseline = PointCloudEngine(module, N_STAGES, flow="cuda")
    order = [SCENE_A, SCENE_B, SCENE_A, SCENE_B, SCENE_A]
    K.reset_launch_counts()
    results = []
    for i, key in enumerate(order):
        coords, mask, feats = scenes[key]
        before = K.LAUNCHES["spconv_fod_fused"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, hit = engine.segment(coords, mask, feats)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        fused_launches = K.LAUNCHES["spconv_fod_fused"] - before
        results.append((key, preds, hit, ms))
        print(f"request {i}: scene {key} n={coords.shape[0]} bucket "
              f"{engine.ladder.bucket_for(coords.shape[0])} hit={hit} "
              f"latency {ms:.2f} ms fused launches {fused_launches}")
        if fused_launches != 41:
            raise AssertionError(f"request {i}: {fused_launches} fused "
                                 "launches, expected 41")
    coords, mask, feats = scenes[SCENE_A]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base_preds, _ = baseline.segment(coords, mask, feats)
    torch.cuda.synchronize()
    base_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(K.LAUNCHES)
    print(f"flow=cuda request: scene {SCENE_A} latency {base_ms:.2f} ms "
          f"(mapping miss in its own cache)")
    print(f"main-path launches: {launches}")
    if launches["spconv_fod_fused"] != 41 * len(order) or \
            launches["spconv_fod_fused_tc"] != 41 * len(order):
        raise AssertionError(f"fused launches {launches}: expected "
                             f"{41 * len(order)}, all on the tensor cores")
    if launches["spconv_fod"] != 41 or launches["spconv_fod_tc"] != 41:
        raise AssertionError(f"baseline launches {launches}: expected 41, "
                             "all on the tensor cores")
    hits = [hit for _, _, hit, _ in results]
    if hits != [False, False, True, True, True]:
        raise AssertionError(f"mapping-cache hits {hits}")
    print("mapping cache:", engine.cache_stats())
    hit_ms = [ms for _, _, hit, ms in results if hit]
    print(f"segment latency at the 65536 bucket: misses "
          f"{[round(ms, 2) for _, _, h, ms in results if not h]} ms, hits "
          f"{[round(ms, 2) for ms in hit_ms]} ms, median hit "
          f"{statistics.median(hit_ms):.2f} ms")

    # labels against the plain "fod" logits, on valid rows
    valid = torch.from_numpy(mask).to(fod_logits.device)
    for label, preds in (("cuda_fused", results[0][1]),
                         ("cuda_fused repeat", results[4][1]),
                         ("cuda", base_preds)):
        check_vs_fod(label, preds, fod_logits, valid)
    if not torch.equal(results[0][1], results[4][1]):
        raise AssertionError("repeat request gave different predictions")
    if not bool(torch.isfinite(fod_logits).all()):
        raise AssertionError("non-finite logits")

    # 4b. batched serving
    print(smi)
    serving = serving_phase(module, N_STAGES, scenes, engine,
                            with_profile="--profile" in argv)
    # 4c. the router; 4d. partitioning
    print(smi_line())
    routing = router_phase(module, N_STAGES, scenes, engine)
    print(smi_line())
    partition = partition_phase(module, N_STAGES, scenes[SCENE_A],
                                city_scene(OVERSIZED[0], OVERSIZED[1],
                                           extent=OVERSIZED[2]))
    # 4e. the v1 mapping engine
    print(smi_line())
    v1 = v1_phase(module, N_STAGES, scenes[SCENE_A], results[0][1],
                  fod_logits)

    point_launches, mlp = point_phases(dev, mem_rate, flop_rate, tf32_rate,
                                       "--profile" in argv)
    bf16_rate = BF16_PEAKS["pcie" if "PCIe" in name else "sxm"]
    lm_kernels = lm_phases(dev, mem_rate, bf16_rate, "--profile" in argv)
    # 12. the train step
    print(smi_line())
    train = train_phase(dev, mem_rate, bf16_rate, "--profile" in argv)
    # 13. the trainer entry point, and the four attention-only LM configs
    print(smi_line())
    train["trainer"] = trainer_phase(dev, bf16_rate)

    if "--profile" in argv:
        from torch.profiler import ProfilerActivity, profile
        coords, mask, feats = scenes[SCENE_A]
        fresh = PointCloudEngine(module, N_STAGES, flow="cuda_fused")
        for label, eng in (("hit", engine), ("miss", fresh)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _, hit = eng.segment(coords, mask, feats)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            if hit != (label == "hit"):
                raise AssertionError(f"profiled {label} came back hit={hit}")
            print(prof.key_averages().table(sort_by="cuda_time_total",
                                            row_limit=15))
            evs = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
            conv = [e for e in evs if "spconv_fod_tc_kernel" in e.name]

            def span_ms(es):
                return sum(e.time_range.end - e.time_range.start
                           for e in es) / 1e3
            print(f"segment {label} under the profiler: wall {wall:.2f} ms, "
                  f"device events {span_ms(evs):.3f} ms over {len(evs)} "
                  f"(busy {span_ms(evs) / wall:.3f}), spconv_fod_tc_kernel "
                  f"{span_ms(conv):.3f} ms over {len(conv)} launches")

    # 14. the recurrent, hybrid and gemma2 LMs, after the earlier phases'
    # objects are freed
    del sites, engine, baseline, results, base_preds, fod_logits
    print(smi_line())
    recurrent = recurrent_phase(dev, mem_rate, bf16_rate)
    print(smi_line())

    # 15. qwen2-vl (M-RoPE, patch embeddings) and the encoder-decoder
    multimodal = multimodal_phase(dev, mem_rate, bf16_rate)
    print(smi_line())

    # 16. the sharded entry points on one card
    sharding = sharding_phase(dev, module)

    # 17. result lines
    src = "src/repro_torch/kernels/spconv/csrc/spconv_tc.cu"
    plans = {f"level {lv}": sorted(d["plans"]) for lv, d in
             sorted(by_level.items())}
    route = (f"split-float TF32 tensor cores: 3 x FLOPs / "
             f"{tf32_rate / 1e12:g} TFLOP/s")
    kernels = [
        {"name": "spconv_fod_fused", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/spconv/spconv.py:190",
         "launches": launches["spconv_fod_fused"],
         "launches_by_variant": {v: launches[f"spconv_fod_fused_{v}"]
                                 for v in K.VARIANTS},
         "max_abs_err": totals["err_f"], "max_rel_err": totals["rel_f"],
         "ms": totals["fused"], "kernel_ms": totals["fused"],
         "earlier_ms": totals["earlier_f"],
         "earlier": "float32 FMA kernel, csrc/spconv.cu",
         "plain_ms": totals["plain_f"], "bound_ms": totals["bound_tc_f"],
         "bound_by": "operations" if totals["tc_ops"]
         >= totals["bytes_f"] else "bytes", "bound_route": route,
         "bound_f32_ms": totals["bound_f"],
         "library_ms": None, "gemm_only_ms": totals["gemm"], "plan": plans,
         "per": "one forward: sum over its 41 conv sites",
         "serve_launches": serving["launches"]["spconv_fod_fused"],
         "serve_scenes": serving["scenes"],
         "router_launches": routing["launches"]["spconv_fod_fused"],
         "router_scenes": routing["scenes"],
         "partition_launches": partition["launches"]["spconv_fod_fused"],
         "partition_chunks": partition["chunks"],
         "v1_launches": v1["launches"]["spconv_fod_fused"]},
        {"name": "spconv_fod", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/spconv/spconv.py:82",
         "launches": launches["spconv_fod"],
         "launches_by_variant": {v: launches[f"spconv_fod_{v}"]
                                 for v in K.VARIANTS},
         "max_abs_err": totals["err_b"], "max_rel_err": totals["rel_b"],
         "ms": totals["base"], "kernel_ms": totals["base"],
         "earlier_ms": totals["earlier_b"],
         "earlier": "float32 FMA kernel, csrc/spconv.cu",
         "plain_ms": totals["plain_b"], "bound_ms": totals["bound_tc_b"],
         "bound_by": "operations" if totals["tc_ops"]
         >= totals["bytes_b"] else "bytes", "bound_route": route,
         "bound_f32_ms": totals["bound_b"],
         "library_ms": None, "gemm_only_ms": totals["gemm"], "plan": plans,
         "per": "one forward: sum over its 41 conv sites"},
        {"name": "fused_mlp", "route": "cuda",
         "source": "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp_tc.cu",
         "replaces": "src/repro/kernels/fused_mlp/fused_mlp.py:42",
         "launches": point_launches["fused_mlp"],
         "launches_by_variant": {v: point_launches[f"fused_mlp_{v}"]
                                 for v in FK.VARIANTS},
         "max_abs_err": mlp["err"], "ms": mlp["ms"],
         "kernel_ms": mlp["ms"], "earlier_ms": mlp["fma"],
         "earlier": "float32 FMA kernel, csrc/fused_mlp.cu",
         "plain_ms": mlp["plain"], "bound_ms": mlp["bound"],
         "bound_by": "operations" if mlp["tc_ops"] >= mlp["bytes"]
         else "bytes", "bound_route": "split-float TF32 tensor cores: 3 x "
         f"FLOPs / {tf32_rate / 1e12:g} TFLOP/s",
         "bound_f32_ms": mlp["bound_f32"],
         "library_ms": mlp["cublas"],
         "library": "cuBLAS layer by layer (torch.addmm + relu_)",
         "timing": "device ms a call: 20 calls in one CUDA graph",
         "per": "one PointNet++(s) forward (16 x 4096): sum over its 6 "
                "groups"},
    ] + lm_kernels + [train["entry"]]
    steady = train["trainer"]["launches_steady_step"]
    paths = {"jamba_generate": recurrent["jamba"]["launches"],
             "jamba_train_step": recurrent["jamba"]["train_launches"],
             "gemma2_generate": recurrent["gemma2"]["launches"],
             "gemma2_prefill_4608": recurrent["gemma2"]["long_launches"],
             "xlstm_trainer_step": recurrent["xlstm"]["trainer"]["launches"],
             "gemma2_trainer_step": recurrent["gemma2"]["trainer"]["launches"]}
    mm_paths = {"qwen2vl_generate": multimodal["qwen2vl"]["launches"],
                "seamless_generate": multimodal["seamless"]["launches"],
                "seamless_train_step":
                    multimodal["seamless"]["train_launches"]}
    jam, gem, qwen, seam = (
        recurrent["jamba"]["instances"], recurrent["gemma2"]["instances"],
        multimodal["qwen2vl"]["instances"],
        multimodal["seamless"]["instances"])
    instances = {
        "flash_attention": {"jamba": jam["flash_attention"],
                            "gemma2": gem["flash_attention"],
                            "gemma2_local_4608":
                                gem["flash_attention_local"],
                            "qwen2vl": qwen["flash_attention"],
                            "seamless": seam["flash_attention"]},
        "flash_decode": {"jamba": jam["flash_decode"],
                         "gemma2": gem["flash_decode"],
                         "qwen2vl": qwen["flash_decode"],
                         "seamless": seam["flash_decode"]},
        "grouped_matmul": dict(zip(("jamba_w_in", "jamba_w_out"),
                                   jam["grouped_matmul"]))}

    def by_path(kname, counts_of):
        return {path: {k: v for k, v in counts.items()
                       if k.removeprefix(kname).strip("_") in
                       ("", "wgmma", "fma", "dx")}
                for path, counts in counts_of.items()}
    for entry in kernels:
        kname = entry["name"]
        if kname in ("flash_attention", "grouped_matmul", "flash_decode",
                     "grouped_matmul_dw"):
            entry["recurrent_launches"] = by_path(kname, paths)
        if kname in ("flash_attention", "flash_decode"):
            entry["multimodal_launches"] = by_path(kname, mm_paths)
        if kname in instances:
            entry["instances"] = instances[kname]
        if entry["name"] in ("flash_attention", "grouped_matmul",
                             "grouped_matmul_dw"):
            entry["trainer_launches"] = {
                k: v for k, v in steady.items()
                if k.removeprefix(entry["name"]).strip("_") in
                ("", "wgmma", "fma", "dx")}
    print(json.dumps({"v1": {k: v1[k] for k in ("times", "served",
                                                  "d2_points", "d2_err")},
                      "train": {k: train[k] for k in ("steps", "parity",
                                                      "trainer")},
                      "recurrent": {
                          "wall_s": recurrent["wall_s"],
                          **{arch: {k: v for k, v in recurrent[arch].items()
                                    if k != "instances"}
                             for arch in ("jamba", "xlstm", "gemma2")}},
                      "multimodal": {
                          "wall_s": multimodal["wall_s"],
                          **{arch: {k: v for k, v in multimodal[arch].items()
                                    if k != "instances"}
                             for arch in ("qwen2vl", "seamless")}},
                      "sharding": sharding}))
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
