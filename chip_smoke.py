#!/usr/bin/env python3
"""On-card smoke of the torch port: builds its kernels, holds each against
its plain PyTorch version, and drives the port's main paths — serving
TResNet-M at full width and depth, training ViT-B/16 at 512 px, training
TResNet-M at 224 px and serving its checkpoint, training TResNet-M on
real-data input (an image folder through the native dataplane, or CIFAR
pickles where the dataplane cannot be built), resuming it and serving the
resumed checkpoint, training ResNet-50 (the reference's default model)
and serving its checkpoint, the same short run under torchrun over NCCL,
the reference's ArcFace, CDR, Nested and PLC workloads on ResNet-50, and
serving over HTTP with hot reload, the fleet's drain token and admission
control, ViT-B/16 through the flash forward, training under injected
faults through the supervisor, the train→serve chaos scenario (a
trainer and serve replicas as processes sharing the card and one run
directory), and VGG19-BN, the arcface and nested heads on TResNet-M and
the ViT, the trainer's profiler window, `--debug_nans`,
`cli/verify_import.py`, the scaling levers, and the model options
(`--remat` on ViT-B/16 and ResNet-50, the MoE ViT-B/16, `--dropout`,
`--ln_bf16`), and serving through a CUDA graph per bucket with the hot
swap into the captured weights, the AOT sidecar, `--strict_compile`,
`--serve_devices` and a JAX-format msgpack checkpoint — on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and ignored):

1. device — CUDA is required (no CPU fallback); prints the card's name and
   power limit as nvidia-smi gives them;
2. build — the native dataplane's toolchain probed first (g++, jpeglib.h,
   png.h, -ljpeg, -lpng; printed, with os.cpu_count()): where libjpeg can
   be built against, `native/dataplane.cpp` is built with g++ beside the
   nvcc builds and phases 16-19 run on an image folder; where it cannot,
   they run on CIFAR-10's pickle layout instead (raw pixels, no decoder)
   and the train CLI on an image folder must exit rc 2 naming what is
   missing (the gate is the probe, never a caught exception). K1, K1s,
   K1r and K1d from `ops/csrc/fused_abn.cu` +
   `ops/csrc/fused_abn_train.cu` (with their header `fused_abn.cuh`), and
   K2-K4 from `ops/csrc/flash_attention.cu` + `ops/csrc/flash_fwd_sm90.cu` +
   `ops/csrc/flash_bwd_sm90.cu` (with their header `flash_sm90.cuh`), one
   nvcc per library, started together, for sm_90a (nvcc's register and
   shared-memory lines printed); then `cuobjdump -sass` of the flash
   library (from the toolkit nvcc came from, else Triton's copy; a missing
   tool fails the phase): the bf16 K2, K3 and K4 must hold `HGMMA` (wgmma)
   instructions, counted per kernel; their registers, shared memory and
   resident blocks per SM as the CUDA runtime reports them;
3. kernel vs plain (K1) — K1 against `fused_bn_leaky_relu_ref` at every
   ABN shape TResNet-M gives it at bucket 8 / 224 px, plus a ragged channel
   count and an odd row count, in f32 (atol/rtol 1e-5) and bf16 (compared
   in f32, atol/rtol 1e-2: one bf16 ulp of slack); per shape: max error,
   kernel and plain device µs (kernel durations from torch.profiler, mean
   of 20 calls, L2 warm as after the conv that feeds it), the kernel's wall
   µs as the host drives it (CUDA events, median of 20), the bound, the
   launch geometry K1's wrapper chose, and two yardsticks that do not
   compute K1's function: the device µs of an empty kernel launched with
   the same block and grid (the launch floor) and of `Tensor.copy_` of the
   same input (one read and one write of the same bytes);
4. the serving path — `cli/serve.py`'s selfcheck sequence in process:
   TResNet-M, 224 px, 2173 classes, bf16, uint8 wire, buckets 1/2/4/8,
   warmup → batcher thread → drain over 32 seeded requests. Every future is
   answered with finite probabilities and K1's launch count rose by exactly
   36 per forward (warmup buckets + served batches);
5. the serving slice, kernel vs plain — one bucket-8 batch through the
   served model with random non-degenerate weights, once with K1 and once
   with every ABN site calling the plain version on the same CUDA tensors;
   logits agree within 5% of their standard deviation (bf16 activations
   through 36 ABN sites; the two differ only where an f32 result rounds to
   bf16 on the other side of a tie); then the same weights in f32 on the
   CPU (the plain path the CPU tests hold against the JAX package) as the
   reference for two images: within 10% of the logits' spread, same top-1;
6. serving timings — the 36 K1 launches of one bucket-8 forward as a
   sequence (beside the same two yardsticks over the 36 inputs, and the
   host µs of issuing one launch through the wrapper, 36 in a row with
   nothing synchronized), and the served forward per bucket: device time
   (summed kernel durations from torch.profiler) and wall time as the host
   drives it (CUDA events), with the SM clock and power draw read beside
   them; the bucket-8 forward's device time by kernel family (K1, the
   convolutions, F.batch_norm, the rest with its largest kernels);
7. kernel vs plain (K2-K4) — the flash forward, dQ and dK/dV kernels
   against `flash_forward_ref` / `flash_dq_ref` / `flash_dkv_ref` at the
   slice's shape (B 32, T 1024, H 12, D 64), T 196 (one ragged tile), T 128,
   T 256 causal and T 320 causal (an odd count of streamed tiles through
   the bf16 backward's two-stage ring), in f32 (atol/rtol 1e-4: sums in
   another order) and bf16 (compared in f32: atol 1e-2, rtol 2e-2 — a few
   times the kernels' largest error, one bf16 ulp of the output), and over
   each whole tensor an RMS error within FLASH_RMS_TOL of the reference's
   RMS (for the gradients a 1% scale error, one dropped tile or P and dS
   left unrounded exceeds it); per shape: max errors beside the reference's largest
   value and the RMS ratio, kernel and plain device ms, the bound, and
   `F.scaled_dot_product_attention` forward and backward as the yardstick
   (the port never calls it); at the slice's shape in bf16, a second
   launch of K2, K3 and K4 on the same inputs must give the same bits (one
   block per output element, no atomics);
8. the training path — `cli/train.py`'s sequence in process: ViT-B/16,
   512 px (1024 tokens), 1000 classes, batch 32, bf16, `--flash_attention`,
   synthetic data of 256 images, one epoch at lr 0.01: 8 train steps and 2
   eval batches. The loss is finite, no step was skipped, `output.txt`,
   `history.json`, `meta.json` and `ckpt_e0.pt` with its sidecar are
   written and the checkpoint restores to the trained weights, and K2 rose
   by exactly 12 × (8 + 2) = 120, K3 and K4 by 12 × 8 = 96 each. The run
   writes into a temporary directory (its checkpoint is 350 MB); the small
   records go into the report;
9. the training slice, kernel vs plain — one train step at batch 8 from
   the same weights and batch, through K2-K4 and with `flash_attention`'s
   three wrappers swapped for their plain versions: loss within 1e-3 and
   grad norm within 1e-2 of each other, relatively (bf16 rounding of P and
   dS through 12 blocks), and the plain run launched no flash kernel;
10. training timings — the batch-32 train step: wall time (host clock,
   median of 5) and device time (torch.profiler), images/s, the device's
   busy share, the 12 launches each of K2/K3/K4 inside it against their
   bound, with the SM clock and power draw read beside them; and the host
   time of issuing one K2, K3 and K4 launch through its wrapper (12 in a
   row, no synchronize: checks, output allocation, tensor maps, launch);
   then the wall of one ViT train epoch (8 steps), with the synthetic
   images made on the step loop's thread and copied inside it, and with
   them made on the loader's threads and staged by the prefetcher, in
   turns (synchronous, threaded, threaded, synchronous);
11. kernel vs plain (K1s, K1r, K1d, and K1 in training) — the training
   passes around K1 (batch statistics; the backward's sums; dx) against
   `bn_stats_ref`, `abn_grad_sums_ref` and `abn_grad_input_ref`, and K1
   on those batch statistics against `fused_bn_leaky_relu_ref`, at every
   ABN shape of a batch-32 TResNet-M train step at 224 px, plus a ragged
   C and an odd M, then at every ABN shape of the real-data path's train
   step (phase 17: 256-px crops on an image folder, 32 px on CIFAR; their
   shapes recorded by hooks on one forward, as phase 3's), in f32 and
   bf16: statistics within 1e-5; dscale and dbias per channel within
   SUM_ULPS f32 ulps of the sum of the terms' magnitudes (sums in
   another order); dx and K1's y within 1e-5 in f32 and 1e-2 in bf16
   (compared in f32: one bf16 ulp); K1r + K1d also against the
   line-for-line `_bwd` (`fused_bn_leaky_relu_backward_ref`); a second
   launch of each gives the same bits (no floating-point atomics);
12. the TResNet-M training path — `cli/train.py`'s sequence in process:
   TResNet-M at full width and depth, 224 px, 2173 classes, batch 32,
   bf16, SGD momentum 0.9 at lr 0.01, synthetic data of 256 images: 8
   train steps and 2 eval batches. The loss is finite, no step was
   skipped, K1 rose by 36 × (8 + 2) and K1s, K1r and K1d by 36 × 8 each,
   no gradient was copied into another layout, the records and the
   checkpoint with its sidecar are written and restore to the trained
   weights; then `cli/serve.py`'s selfcheck over that `--ckpt` answers 8
   requests with finite probabilities (K1 36 per forward), and the
   served model's top-5 on one batch equals the trainer's own eval
   forward on it;
13. the TResNet-M training slice, kernel vs plain — one train step at
   batch 8 from the same weights and batch, through the four kernels and
   with their four wrappers swapped for the plain versions on the same
   CUDA tensors, in f32 and in bf16; the plain runs launch none of them.
   f32: loss within 1e-5, grad norm within 1e-2 and each of the 120
   running statistics' updates within 1e-3 of the plain run's (relative
   to the update's largest value). A batch-normalized net at random init
   amplifies a perturbation along its depth (each BN site's output
   divergence between the runs is recorded: in f32 it grows from 0 at the
   stem to about 5e-5 at the last site), and in bf16 the one-ulp
   differences of two rounding orders grow to tens of percent by stage 4,
   so bf16 checks the loss within 1e-2 and records the grad norm and the
   running statistics' divergence;
14. TResNet-M training timings — the batch-32 train step: wall (host
   clock, median of 5), device time, images/s, busy share; the 36
   launches each of K1, K1s, K1r and K1d inside the step against their
   byte bounds; the step's device time by kernel family; per bf16 shape
   of phase 11 and over the 36 sites in a row: each kernel, its plain
   version, and the yardsticks: `torch.batch_norm_stats` (mean and
   inv_std in one call) and `torch.var_mean(correction=0)` beside K1s,
   `torch.batch_norm_backward_reduce` (K1r's two sums without the gate, in
   one call) beside K1r, the backward of `F.batch_norm(training=True)` (no
   gate) beside K1r + K1d; one kernel a call of K1s and K1r (each a single
   launch that finalizes its own sums), in the timed regions and at most
   36 each in the step; the host µs of one K1s and one K1r wrapper call
   (36 in a row, nothing synchronized);
15. (the dataplane's probe and build run with phase 2)
16. loader — the input's images/s with 1 and 4 threads: on an image
   folder, the dataplane's native threads over a 4-class fixture tree of
   256 train and 64 val JPEGs (copies of the 8 committed ~500x375 fixtures
   in `tests/data/torch_port_jpeg/`), batches of 32, RandomResizedCrop
   (256), uint8; on CIFAR, the loader's worker threads over 256 train and
   64 test images written from a seed;
17. the real-data training path — `cli/train.py`'s sequence in process on
   that data: TResNet-M at full width (2173 classes on the folder, with
   train crops at 256 px and eval at 224, the baseline preset; 10 classes
   at 32 px on CIFAR), batch 32, bf16, loader threads, device prefetch, the
   train-time flip, tensorboard, 2 epochs of 8 steps and 2 eval batches.
   K1 rose by 36 × (8 + 2) × 2 and K1s, K1r and K1d by 36 × 8 × 2; the loss
   is finite, no step was skipped, the flip is on and its masks
   (`flip_mask` of the run's seed and step) flip some samples, not all,
   `ckpt_e0`, `ckpt_e1`, `ckpt_best` with sidecars, `meta.json` and
   the `tb/` events are written and the last checkpoint restores to the
   trained state; then its step on a staged batch: wall, device time,
   busy share, the four ABN kernels 36 launches each a step and their
   device ms, the step by kernel family, and the time the step loop
   waited on the prefetch queue per step. On CIFAR the same step is also
   timed at the folder's shapes (256-px uint8 crops of random pixels,
   flip on, 2173 classes);
18. resume — a run stopped after epoch 0, then `--resume` its `ckpt_e0.pt`
   into a new directory: the state restored equals the saved one bitwise
   (weights, momentum on the card in f32, step, opt_count), it continues
   at epoch 1, and the first batch and flip mask it trains on equal those
   the uninterrupted run of phase 17 saw at the same step;
19. the resumed checkpoint served — `cli/serve.py`'s selfcheck over it (8
   requests, K1 36 a forward) and the same top-5 as the trainer's own eval
   forward on 8 val images;
20. the ResNet-50 training path — `cli/train.py`'s sequence in process:
   ResNet-50 at full width and depth (torchvision v1.5), 224 px, 2173
   classes, batch 64, bf16, synthetic data of 512 images: 8 train steps
   and 2 eval batches. The loss is finite, no step was skipped, none of
   K1-K4, K1s, K1r and K1d launched (this path runs no TPU kernel: its
   convolutions are cuDNN's and its 53 BNs plain PyTorch, as they are
   XLA in the JAX package), the records and the checkpoint are written
   and restore to the trained state; then `cli/serve.py --model resnet50
   --ckpt` answers 8 requests and its top-5 on 8 val images equals the
   trainer's own eval forward;
21. ResNet-50 training timings — the train step at batch 128 (the
   per-chip batch of the JAX bench), bf16, 224 px, uint8 wire: wall (host
   clock, median of 5), device time, busy share, images/s, kernel
   launches a step; by family: the convolutions (by kernel name, in the
   step), the 53 BN sites' forward and backward in a row outside the step
   at its shapes, the rest; and the convolutions' tensor-core bound (their
   forward, dgrad and wgrad operations over the bf16 peak);
22. torchrun — `python -m torch.distributed.run --nproc_per_node 1 -m
   ...cli.train` (NCCL, world 1) and the same command as a plain process:
   ResNet-50, f32, 224 px, 4 steps of batch 32 (4 epochs of one step),
   same seed and data. The torchrun run reports `ddp=nccl` and the plain
   one `ddp=off`; the per-step losses and the last checkpoints'
   parameters and running statistics are bitwise equal, as measured on
   an H100 (the largest difference is printed). The process group, DDP
   or NCCL failing fails the phase;
23-25. the ArcFace, CDR and Nested paths — `cli/train.py`'s sequence in
   process for each, on ResNet-50 at full width and depth, 224 px, bf16,
   uint8 wire, synthetic data from the seed, with each preset's recipe:
   arcface (2173 classes, a 256-d embedding, s 30, m 0.5, easy margin,
   Adam 1e-3, batch 32), cdr (100 classes, noise rate 0.2, SGD 0.1, batch
   64), nested (2173 classes, σ 100, freeze-BN, batch 64, eval first and
   after the epoch through the all-K sweep, best-only checkpoints); 8
   steps and 2 eval batches each. The loss is finite, no step was
   skipped, none of the seven kernels launched (these paths run no TPU
   kernel: the heads, CDR's mask and the all-K sweep are jnp under XLA in
   the JAX package), the records and the checkpoint are written and
   restore to the trained state; arcface and nested: `cli/serve.py
   <workload> --ckpt` answers 8 requests and its top-5 on 8 val images
   equals the trainer's own eval forward; cdr, after the epoch: one
   batch's gradients masked by `cdr_mask_` on the card and, copied to the
   CPU, by the same plain function there give the same threshold and
   masked gradients bitwise, and the share of the selected elements kept
   is 0.8 within 1e-6; nested: best_k lies in [0, 2047] and the k that
   `nested_k` gives each step varied across the steps.
   Then each step at its preset batch (32 / 128 / 128): wall (host clock,
   median of 5), device time, busy share, images/s, launches; and the
   device ms of what each adds: the ArcFace head's forward and backward,
   CDR's mask of one step's gradients (|g·v| and its concatenation, the
   sort, the whole mask) against its byte bound, and the nested all-K
   sweep of one 64-image eval batch against its bound and the bytes of its
   (B, 128, C) tiles;
26. the PLC path — `cli/train.py plc` in process (PLCTrainer) on
   ResNet-50 at full width and depth, 224 px, 14 classes (Clothing1M's),
   bf16, uint8 wire, 512 synthetic images from the seed at batch 64, two
   epochs with one warmup epoch: one ordered f(x) pass over the train set
   and one LRT correction. The loss is finite, no step was skipped, none
   of the seven kernels launched (PLC is numpy on the host, an eval
   forward and a probe MLP in the JAX package); `corrected` and `delta`
   are recorded, `plc_labels.npy` holds 512 labels and `meta.json` δ; the
   ordered pass's logits, in dataset order, equal the eval forward of
   the same images in the same batches on the card within
   PLC_LOGIT_TOL; `--auto_resume --epochs 3` restores the saved labels
   and δ; `cli/serve.py plc --ckpt` answers 8 requests with the
   trainer's top-5. Then the η probe (`eta_approximation`) fit on the
   card on (512, 2048) features from the seed, against the same fit on
   the CPU from the same init (PLC_ETA_TOL), and type-1 noise injected by
   `PLCTrainer(cfg, eta=...)` from the card's η: the count and the labels
   of the CPU's `label_noise` bitwise. Timings: the ordered pass's step
   at batch 128 (device ms, wall ms, images/s) and the whole pass through
   the loader, the probe fit, and the host ms of `lrt_correction` and
   `prob_correction` on (1,000,000, 14) f32 logits;
27. the HTTP serve path — (a) phase 12's TResNet-M checkpoint copied
   into a watch dir and served in process as `cli/serve.py --watch --port
   --fleet_dir --admission_deadline_ms` wires it (`cli/serve.py::Serving`:
   the engine, a `CheckpointWatcher`, a `FleetMember`, an
   `AdmissionController`, `serve/http.py` on a free port; 224 px, 2173
   classes, bf16, uint8 wire, buckets 1/2/4/8), every launch count set
   to 0 just before; (b) 8 sequential requests (admission's first
   measured service rate), then 16 from 4 client threads — 8 JPEGs of
   500x375 and 8 PNGs, one grayscale and one RGBA, made from the seed
   with PIL — all 200; the wire arrays the server hands the engine are
   bitwise the smoke's own PIL decode + the port's val transform, and
   each answer's top-1 equals the engine's direct `submit` of that array,
   probabilities within HTTP_TOL; (c) `/healthz`: ok, the checkpoint's
   sha256 and epoch, the watcher alive, leader, serving; `/metrics` holds
   the serve_, engine_, watcher_, fleet_ and admission_ families; (d) a
   later epoch with changed weights published as a trainer does (bytes,
   then sidecar): generation and digest move to it, the answers are a
   direct forward of the new weights', the drain token is released; a
   newer torn candidate becomes `*.corrupt`, `reloads_rejected` rises by
   1, the generation stays, requests still get 200; (e) a second engine
   with a queue of 4, its batcher held until a burst of 64 concurrent
   requests has been answered or queued: 4 × 200, the rest 503 busy with
   `Retry-After: 1`, those through an admission controller with a 1-ms
   deadline shed with `shed_tenant`; over (a)-(e) K1 rose by exactly 36
   a forward (warmups, both engines' batches, the direct forward) and no
   other kernel launched; (g) timings: client ms per request (p50, p99)
   at concurrency 1 and 8 and images/s, host ms of decode + transform
   per image, the served forward's device ms per bucket used; (f) after
   the in-process drain, `cli/serve.py --watch --port --fleet_dir --out`
   as a subprocess on the card: /healthz, one POST 200 (epoch 1), SIGTERM
   → rc 0 and `drained clean`, its events (`SCENARIO_EVENTS`) hold
   serve_ready, verify_ok, swap, drain_begin and drain_end and pass the
   schema; (h) ViT-B/16 at 512 px (1024 tokens), bf16, through
   `build_engine` with `model.flash_attention` set: K2 12 × the forwards
   (warmups and 8 selfcheck requests) and nothing else, then one batch of
   8 through K2 and through its plain version: probabilities within
   VIT_SERVE_TOL, top-5 equality and top-1 agreement reported, and the
   forward's wall and device ms with K2's share;
28. a `{"kernels": [...]}` line (K1-K4, K1s, K1r, K1d; each with its
   launches on the ResNet-50, ArcFace, CDR, Nested and PLC paths: 0, on
   the HTTP serve path (`serve_http_path_launches`: K1 36 a forward, the
   others 0) and on the ViT serve leg (`vit_serve_path_launches`: K2 12
   a forward, the others 0) and on the recovery path of phase 29
   (`recovery_path_launches`) and on phase 31's legs
   (`vgg_nested_path_launches`, `tresnet_arcface_path_launches`,
   `tresnet_nested_path_launches`, `vit_arcface_path_launches`,
   `debug_nans_path_launches`, `profile_window_path_launches`) and on
   phase 32 (b)'s (`grad_accum_path_launches`: the K1 family 36 × 4 a
   step) and on phase 35's (`model_axis_path_launches`) and phase 36's
   (`pipeline_path_launches`: 0), then `{"ok":
   true, "device": {...}}` last;
29. (run before the summary line) the recovery chain on the card —
   (a) `Trainer` on TResNet-M at full width (224 px, 2173 classes, bf16,
   batch 32, 256 synthetic images: 8 steps an epoch, 2 epochs) with
   `--fault_spec nan_loss@step=2..3,ckpt_io@epoch=1`, every launch count
   set to 0 just before the run: steps 2-3 are skipped (the parameters
   and buffers bitwise equal before step 2 and after step 3, the
   sentinel counts 2), the counts are exactly the path's (K1 36 a train
   step and eval batch, K1s/K1r/K1d 36 a train step, K2-K4 0), then
   `restore_latest` quarantines the torn `ckpt_e1.pt` and falls back to
   `ckpt_e0.pt`; the longest silent stretch between the heartbeat's
   touches (from its arming) is measured; (b) `cli/supervise.py` over
   `cli/train.py --multihost --auto_resume` as subprocesses on the card
   (TResNet-M as in (a), 3 epochs, FLEET_* for an elastic pod of one,
   zero backoffs, MAX_RESTARTS 5, `--hang_timeout_s` T = the larger of
   RECOVERY_T_MIN_S and twice (a)'s stretch) with `--fault_spec
   nan_loss@step=2..3,loader_io@batch=5,peer_slow@step=12,ckpt_io@epoch=1,
   sigterm@step=19`: `restarts.log` reads rc 1, 7, 143 (restarts) then
   rc 0 (exit), `ckpt_e1.pt.corrupt` exists and the last run resumed
   from `ckpt_e0.pt` at epoch 1, `history.json` holds epochs 0-2 once,
   the generation file reads 3, the membership `gen=3 world=0` beside a
   lease, the supervisor exits 0; the phase prints its time;
30. (run before the summary line) the train→serve chaos scenario:
   `cli/scenario.py --device cuda` as a subprocess over SCENARIO_SPEC
   (one elastic trainer host under `cli/supervise.py`, TResNet-M at
   224 px and 2173 classes, batch 32, 4 epochs of 8 steps, f32, with
   `ckpt_io@epoch=0,nan_loss@step=2..3,host_lost@step=12,
   publish_corrupt@epoch=2`; two serve replicas `cli/serve.py --watch
   --port --fleet_dir` on the same card, the autoscaler armed up to 3,
   admission at 250 ms, `watcher_io@poll=3` on replica 0; 4 rps offered;
   a drain of replica 1 at the first publish, the drain-token holder
   SIGKILLed once a wave is in flight after 40 s, a spike to 12 rps at
   35 s): rc 0 and a green line naming S1-S5; events.jsonl holds
   publish_torn, quarantine, drain_token_acquire, spike_load, scale_out,
   a `kill_replica_during_wave@` firing with its target, the drained
   replica's relaunch and the lost host's relaunch; the `lint` event's
   rc is 0; every child's banner names cuda. It prints the phase's wall,
   per good publish the seconds until each replica serves it, the lowest
   availability window, request p50/p99, each restart's rc and the
   seconds from the spike to `scale_out`, each beside the card. The
   children are processes of their own: no launch counter sees them;
31. this slice's paths, every launch count set to 0 just before each leg
   — (a) `cli/train.py nested --model vgg19_bn` in process at full width
   (cfg E, 224 px, 2173 classes, bf16, batch 64, dropout 0.5: 8 steps,
   the all-K eval first and after the epoch) through `train_main_path`:
   none of the seven kernels launched (JAX's VGG BNs are XLA), the 32
   frozen BN tensors bitwise unchanged, `ckpt_best.pt` served by
   `cli/serve.py nested --model vgg19_bn --ckpt` with the trainer's top-5;
   its train step's wall (host clock) and device ms (CUDA events) and
   images/s; (b) TResNet-M under arcface and under nested with freeze-BN
   at the serving configuration (224 px, 2173 classes, bf16, batch 32):
   K1, K1s, K1r and K1d at their 36 sites a step (K1 36 an eval batch),
   the 48 frozen tensors bitwise unchanged and all 36 ABNs' running means
   moved, each checkpoint served (K1 36 a forward) with the trainer's
   top-5; (c) ViT-B/16 under arcface at 512 px with `--flash_attention`,
   2 steps and one eval batch: K2 12 a forward, K3 and K4 12 a backward,
   nothing else; (d) run first, right after the build (repeated profiler
   sessions in one process stop recording device activity): `--profile_steps
   4` on the ResNet-50 baseline step at batch 128 (6 steps, steps 2-5
   captured), CUDA events around each step: the capture lands at
   `<out>/profile/<host>.trace.json.gz` and the window closes,
   `obs/trace.py` parses it into steps 2-5 whose six buckets sum to their
   walls, and its device-lane total is within PROF_TOL of the events';
   the breakdown is printed; (e) `cli/train.py --debug_nans` on TResNet-M
   (224 px, batch 8) with `nan_loss@step=1`: step 0 clean under the mode
   (the K1 family's 36 sites, their outputs checked), step 1 raises
   FloatingPointError naming `full_like` (a process would exit rc 1); (f)
   `cli/verify_import.py` on the card (TF32 off) over resnet50, vgg19_bn
   and tresnet_m checkpoints the oracles write with random weights: PASS,
   rc 0 each; a file with a renamed key: rc 2;
32. (run before the summary line) the scaling levers, through
   `cli/train.py`'s parser and `Trainer`, every launch count set to 0
   just before each leg — (a) the ResNet-50 baseline step at batch 128
   (224 px, 2173 classes, bf16, uint8 wire) at `--grad_accum 4`
   (microbatches of 32) beside `--grad_accum 1`: wall (host clock), device
   ms (CUDA events), images/s and `torch.cuda.max_memory_allocated` over a
   step, none of the seven kernels; (b) TResNet-M at the serving
   configuration, batch 32, `--grad_accum 4` through `train_main_path`:
   K1, K1s, K1r and K1d 36 × 4 a step (K1 36 an eval batch), then one
   more step whose K1s output at the first site (microbatch 8) is held
   against its plain version on the same input within SUM_ULPS f32 ulps
   of its sums; (c) phase 22's run at `--grad_accum 2` as a plain process
   and under torchrun world 1 with `--zero_opt on --grad_reduce_dtype
   bfloat16` (both the identity at world 1): bitwise, over 4 f32 steps;
   and `--grad_accum 1` against the plain step written out, bitwise over
   two steps of ResNet-50 (f32, batch 8); (d) ResNet-50's train state
   saved synchronously and asynchronously: the step loop's blocking ms at
   `save` for each, the file verified after `wait()`, `publish` emitted
   only once the sidecar had landed, and `--resume` continuing from it
   for an epoch; (e) `--h2d-overlap` off and on over CIFAR-10 pickles
   (ResNet-18's CIFAR stem, batch 16): the step loop's prefetch wait ms a
   step, and the 16 batches' checksums equal. Each line beside the card's
   name and power limit;
33. (run before the summary line) the model options, through
   `cli/train.py`'s parser and `Trainer`, every launch count set to 0
   just before each leg — (a) ViT-B/16 at 512 px, batch 32, bf16,
   `--flash_attention`: one step with and without `--remat` from the same
   seed and batch, states bitwise equal, K2/K3/K4 24/12/12 a remat step
   and 12/12/12 a plain one (checked), peak allocated memory and wall /
   device ms of each; (b) ResNet-50 at batch 128 (224 px, 2173 classes,
   bf16) with and without `--remat`: one step (cuDNN deterministic for
   it) with parameters and running statistics bitwise equal, then peak
   memory and wall / device ms of each; (c) ViT-B/16 with `--moe_experts
   8 --moe_top_k 2` through `Trainer.run()` (2 steps, 1 eval batch):
   the loss finite, the balance penalty at init within [top_k, E] a
   block (0.24-0.96 weighted), K2 12 a forward and K3/K4 12 a step
   (checked), the step's wall / device ms, and the experts' card route
   (cuBLAS bf16 products with f32 output) against the f32 product of the
   same bf16 operands on one block's input, within MOE_ROUTE_TOL of the
   output's largest value;
   (d) `--dropout 0.1 --remat` against `--dropout 0.1` over two steps of
   ViT-B/16 (512 px, batch 8, flash), bitwise; (e) `--ln_bf16` eval
   logits bitwise those without it; (f) every rejection of the options
   exits rc 2;
34. (run before the summary line) serving's remaining surface, every
   launch count set to 0 just before each main-path leg — (a) TResNet-M
   (224 px, 2173 classes, bf16, uint8 wire, buckets 1/2/4/8) through
   `build_engine` and `warmup()`: one eager pass and one CUDA graph
   capture a bucket (checked: 4 captures, 0 builds), then 2 batches of
   every bucket as replays (K1 36 × (4 eager + 8 replays), checked), each
   replay's top-k against the eager predict on the same images (bitwise,
   or within one bf16 ulp of the largest score, reported), and per bucket
   the wall (CUDA events, median of 20) and device ms (torch.profiler) of
   the eager forward and of copy-in + replay, with the busy share of
   each; the same for ViT-B/16 at 512 px with the flash forward at bucket
   8 (K2 12 a forward); (b) a second set of weights swapped in at a batch
   boundary: copied into the captured tensors, no capture recorded, the
   answers the new weights' eager predict; (c) the AOT sidecar: a cold
   boot (a process with an empty build dir) banks the kernel libraries,
   a warm boot (another, nvcc hidden) loads them, builds nothing, sets
   `aot_hit` and answers as the cold one; both timed to the first
   answer; (d) a dropped graph recaptured in steady state: counted in
   `recompiles`, and rc 2 from `cli/serve.py --strict_compile`; (e)
   `--serve_devices 1` answers as 0, beyond the cards is rc 2; (f) a
   ResNet-50 train state written as the JAX package writes it (flax's
   msgpack, with its sidecar) served through `--ckpt`: top-5 bitwise the
   same weights' `.pt`;
35. (run before the summary line) the model axis on the one card, its
   bodies over N shards held by one process (the seams
   `ring_attention_shards`, `moe_mlp_shards`, `arc_margin_ce_shards`;
   the card's one process cannot run two NCCL ranks) — the references
   first (the plain versions through the same Function and the same
   ring, and `flash_attention` on the whole T): (a)
   `flash_attention_with_lse` at (32, 1024, 12, 64) bf16 (ViT-B/16 at
   512 px): out bitwise `flash_attention`'s, lse within LSE_TOL of the
   plain version's, its backward under a nonzero lse cotangent within
   LSE_GRAD_TOL of the plain backward; then every launch count set to 0
   and (b) run, its K2/K3/K4 launches each kernel's
   `model_axis_path_launches` (2² + 4² = 20 each, checked): the flash
   ring's forward and backward over 2 and 4 token shards at that shape
   against the same ring on the plain versions (phase 7's FLASH_TOL and
   FLASH_RMS_TOL) and against `flash_attention` on the whole T
   (RING_TOL), each N's device ms (CUDA events) beside
   `flash_attention`'s forward + backward; (c) the EP combine over 2 and
   4 expert shards of phase 33's MoE config (8 experts of 384, top-2, a
   (32, 1024, 768) bf16 block input) against the one-shard `moe_mlp`
   (MOE_ROUTE_TOL of the largest output), with each one's device ms; (d)
   the partial-FC CE at B 128, D 256, C 100,000 over 4 shards against
   the dense margin + CE in f32, each feature drawn near its label's
   weight row so that the reference's top-1 and top-3 counts are nonzero
   and differ (checked): loss, counts and gradients within CE_TOL, the
   gradients' RMS shares (and that of the weight rows no label names)
   within CE_RMS_TOL, the peak allocated memory of one shard's block
   beside the dense path's, and both times; (e) `cli/train.py --mp 2` on
   the one card exits rc 2 with the mesh text, `--mp 1` trains (rc 0);
36. (run before the summary line) GPipe on the one card, ViT-B/16 (12
   blocks, dim 768, 12 heads) at 224 px (196 tokens), batch 32, bf16 —
   every launch count set to 0 first, read after (d) (the kernels line's
   `pipeline_path_launches`: 0 for every kernel, since JAX's pipelined
   blocks run dense attention, no flash): (a) the executor's S stages in
   one process (`ops/pipeline.py::gpipe_shards`, the seam no CLI path
   reaches) at (S, M) = (2, 4) and (4, 8), forward and backward, against
   the sequential 12-block stack on the same weights and input: out, the
   input's and every block parameter's gradient within PIPE_TOL
   (microbatching changes cuBLAS's shapes, so not bitwise), the tick
   count M + S − 1, device ms (CUDA events) and peak allocated memory
   beside the sequential stack's; (b) `cli/train.py baseline --model
   vit_b16 --pp_microbatches 4` at world 1 (JAX's S = 1 fallback): 8
   steps and 2 eval batches, its checkpoint, then `--auto_resume
   --epochs 2` continues from it, the losses finite; (c) `arcface
   --pp_microbatches 2`: 2 steps, then the eval scores (labels=None)
   against the dense margin head on the model's own embedding; (d) the
   rc-2 legs, each with JAX's text: `--pp_stages 2` on one card,
   `--pp_stages` without `--pp_microbatches`, `--model resnet50
   --pp_microbatches 2`, `--grad_accum 2 --pp_microbatches 2`.

Numerics on the card: `torch.backends.cudnn.allow_tf32 = False` and
`torch.backends.cuda.matmul.allow_tf32 = False` (f32 convolutions and
matmuls are compared in full f32). Device times come from torch.profiler;
a region a profiler session recorded no kernel for runs again in a fresh
session, and is timed with CUDA events if that fails too (`DeviceTimer`;
`profiler_serve` / `profiler_train` in the report list such regions).
Details land in `chiprun_out/chip_smoke.json`.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)
ABN_OPS_PER_ELEMENT = 6  # sub, mul, fma (2), compare, mul by slope
REPS = 20
SERVE_ARGV = ["baseline", "--model", "tresnet_m", "--image_size", "224",
              "--num_classes", "2173", "--dtype", "bfloat16",
              "--input_dtype", "uint8", "--buckets", "1,2,4,8",
              "--max_batch", "8", "--selfcheck", "32", "--device", "cuda"]
ABN_SITES = 36  # stem + abn1 of 21 blocks + abn2 of 14 bottlenecks
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 dense tensor cores (data sheet)
TRAIN_ARGV = ["baseline", "--dataset", "synthetic", "--synthetic_size", "256",
              "--model", "vit_b16", "--image_size", "512",
              "--num_classes", "1000", "--batchsize", "32",
              "--flash_attention", "--dtype", "bfloat16", "--epochs", "1",
              "--lr", "0.01", "--device", "cuda"]
VIT_BLOCKS = 12
TRAIN_STEPS, EVAL_BATCHES = 8, 2  # 256 / 32 train images, max(64, 32) / 32 val
# (B, T, H, causal): the slice's shape, one ragged tile, one aligned tile
# pair, causal over four tiles, causal over five
FLASH_CASES = [(32, 1024, 12, False), (2, 196, 12, False),
               (2, 128, 12, False), (2, 256, 12, True), (2, 320, 12, True)]
# dtype name -> (O atol, gradient atol, rtol), compared in f32; and the
# limits on RMS(kernel - plain) / RMS(plain) over each tensor, (O,
# gradients), plus 1e-6 for references that are all but zero (T = 1's
# gradients). bf16: the kernels' gradients sit near 2e-4 (logged per case
# below), while a dQ 1% off, one dropped tile or dS left unrounded exceeds
# 1e-3 (tests/test_torch_port_cuda.py); O sits near 2e-3, as K2's running
# max rounds P against another offset than the plain version's
FLASH_TOL = {"float32": (1e-4, 1e-4, 1e-4), "bfloat16": (1e-2, 1e-2, 2e-2)}
FLASH_RMS_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (5e-3, 1e-3)}
FLASH_REPS = 5
STEP_REPS = 3
TRESNET_TRAIN_ARGV = ["baseline", "--dataset", "synthetic", "--synthetic_size",
                      "256", "--model", "tresnet_m", "--image_size", "224",
                      "--num_classes", "2173", "--batchsize", "32",
                      "--dtype", "bfloat16", "--epochs", "1", "--lr", "0.01",
                      "--device", "cuda"]
PALLAS = "ddp_classification_pytorch_tpu/ops/pallas_kernels.py"
# the training passes around K1: (kind, wrapper, kernel-name part of all
# its launches, part of its one counted launch a call, the jnp they stand
# for, f32 operations an element, (M×C tensors, f32 (C,) vectors) moved)
ABN_TRAIN_KERNELS = (
    ("k1s", "bn_stats", "abn_stats_", "abn_stats_kernel",
     PALLAS + ":140-143", 3, (1, 3)),
    ("k1r", "abn_grad_sums", "abn_grad_sums_", "abn_grad_sums_kernel",
     PALLAS + ":103-109", 7, (3, 4)),
    ("k1d", "abn_grad_input", "abn_grad_input", "abn_grad_input",
     PALLAS + ":113-117", 10, (4, 5)),
)
# K1r's f32 sums over up to 1e5 rows, in another order than the plain
# version's: per channel within SUM_ULPS f32 ulps (2^-24) of the sum of the
# terms' magnitudes (a row dropped or counted twice moves a sum by about
# that sum / M, above this limit below M ≈ 1e6)
SUM_ULPS = 16
# the four wrappers of a TResNet-M train step, in ABN_COUNTS order
ABN_WRAPPERS = ("fused_bn_leaky_relu", "bn_stats", "abn_grad_sums",
                "abn_grad_input")
RETRY_SESSIONS = 2  # fresh profiler sessions for regions a session missed
MARK = "spin_kernel"  # torch.cuda._sleep's kernel, DeviceTimer's marker
MARKS_PER_EDGE = 2  # markers at each edge of a region: one lost still shows it
PAD_KERNELS = 8  # kernels outside every region at each end of a session
SCORE_ELEMENTWISE_OPS = 5  # per score: scale, mask/max, subtract, exp, sum/mul
# phase 20: ResNet-50 as the reference's workloads train it (224 px, 2173
# classes, bf16): 512 images at batch 64 are TRAIN_STEPS steps, its val set
# of 128 EVAL_BATCHES batches
RESNET_TRAIN_ARGV = ["baseline", "--dataset", "synthetic", "--synthetic_size",
                     "512", "--model", "resnet50", "--image_size", "224",
                     "--num_classes", "2173", "--batchsize", "64",
                     "--dtype", "bfloat16", "--epochs", "1", "--lr", "0.01",
                     "--device", "cuda"]
RESNET_SERVE_ARGV = ["resnet50" if a == "tresnet_m" else a for a in SERVE_ARGV]
RESNET_BNS = 53  # the stem + 3 a bottleneck × 16 + 4 shortcuts
RESNET_STEP_BATCH = 128  # the per-chip batch bench.py:1129 picks
# phase 22: the same short run as a plain process and under torchrun
# (world 1, NCCL): f32, 4 epochs of one step (history.json keeps each
# epoch's loss unrounded), the last checkpoint compared
DDP_ARGV = ["baseline", "--dataset", "synthetic", "--synthetic_size", "32",
            "--model", "resnet50", "--image_size", "224", "--num_classes",
            "2173", "--batchsize", "32", "--dtype", "float32", "--epochs",
            "4", "--lr", "0.01", "--keep_checkpoints", "1", "--device", "cuda"]
DDP_STEPS = 4
# phases 23-25: the reference's ArcFace, CDR and Nested workloads on
# ResNet-50 at full width and depth (torchvision v1.5), 224 px, bf16, uint8
# wire, synthetic data from the seed; each preset's own recipe (arcface:
# a 256-d embedding, s 30, m 0.5, easy margin, Adam 1e-3; cdr: 100
# classes, noise rate 0.2, SGD 0.1; nested: σ 100, freeze-BN, eval first,
# best-only checkpoints) at TRAIN_STEPS steps and EVAL_BATCHES eval
# batches: 256 images at batch 32, 512 at batch 64
HEAD_COMMON = ["--dataset", "synthetic", "--model", "resnet50",
               "--image_size", "224", "--dtype", "bfloat16",
               "--input_dtype", "uint8", "--epochs", "1", "--device", "cuda"]
HEAD_ARGV = {
    "arcface": ["arcface", *HEAD_COMMON, "--synthetic_size", "256",
                "--num_classes", "2173", "--batchsize", "32"],
    "cdr": ["cdr", *HEAD_COMMON, "--synthetic_size", "512", "--batchsize",
            "64"],
    "nested": ["nested", *HEAD_COMMON, "--synthetic_size", "512",
               "--num_classes", "2173", "--batchsize", "64"],
}
HEAD_STEP_BATCH = {"arcface": 32, "cdr": 128, "nested": 128}  # the presets'
CDR_KEEP_TOL = 1e-6  # the share of |g·v| kept: 0.8 within this
NESTED_EVAL_BATCH = 64
# phase 26: PLC on ResNet-50 at full width and depth, 224 px, 14 classes
# (Clothing1M's), bf16, uint8 wire: 512 synthetic images at batch 64, two
# epochs with one warmup epoch, so one ordered f(x) pass and one LRT
# correction
PLC_ARGV = ["plc", "--dataset", "synthetic", "--model", "resnet50",
            "--image_size", "224", "--dtype", "bfloat16", "--input_dtype",
            "uint8", "--synthetic_size", "512", "--num_classes", "14",
            "--batchsize", "64", "--epochs", "2", "--plc_warmup_epochs", "1",
            "--device", "cuda"]
PLC_CLASSES, PLC_N = 14, 512
PLC_STEP_BATCH = 128  # the preset's batch
PLC_FEATURES = 2048  # ResNet-50's pooled features: the η probe's input
PLC_ETA_TOL = 1e-4  # the probe's η on the card vs the CPU (f32, no TF32)
PLC_LOGIT_TOL = 1e-2  # the ordered pass vs the eval forward, bf16 logits
PLC_HOST_ROWS = 1_000_000  # Clothing1M's train set: the host corrections
# phase 29: the recovery chain on TResNet-M as phase 12 trains it. (a) in
# process: 2 epochs with a nan_loss window over steps 2-3 and the epoch-1
# checkpoint torn; (b) the supervisor over the CLI with every host-side
# fault, 3 epochs
RECOVERY_ARGV = [a if b != "--epochs" else "2" for b, a in
                 zip([None] + TRESNET_TRAIN_ARGV, TRESNET_TRAIN_ARGV)] + [
    "--log_every", "4", "--fault_spec", "nan_loss@step=2..3,ckpt_io@epoch=1"]
RECOVERY_SPEC = ("nan_loss@step=2..3,loader_io@batch=5,peer_slow@step=12,"
                 "ckpt_io@epoch=1,sigterm@step=19")
# the hang timeout's floor, seconds. (a)'s stretch is a warm process's;
# each of (b)'s children starts cold (CUDA context, allocator, the
# restore of a 270-MB checkpoint) before its first touch, and a
# restarted child has taken more than 20 s to it on the card's host
RECOVERY_T_MIN_S = 60.0
RECOVERY_RCS = [1, 7, 143, 0]  # loader_io, peer_slow, sigterm, done
# phase 30: JAX drills 8 and 9 merged onto one trainer host (NCCL refuses
# two ranks on one card, so host 1's faults moved to host 0) at the serving
# configuration. A pod of one restarts in ≈ 25 s and then publishes its 4
# epochs within seconds, so the timeline is set to that: the drain fires at
# the first (torn) publish, the spike while the lost host restarts, and the
# wave kill stays armed from 40 s until the first wave is in flight
SCENARIO_SPEC = {
    "trainer": {"hosts": 1, "elastic": True, "min_processes": 1, "epochs": 4,
                "model": "tresnet_m", "variant": "imagenet",
                "num_classes": 2173, "image_size": 224, "batchsize": 32,
                "synthetic_size": 256, "relaunch_lost": True,
                "fault_specs": {"0": "ckpt_io@epoch=0,nan_loss@step=2..3,"
                                     "host_lost@step=12,"
                                     "publish_corrupt@epoch=2"}},
    "serve": {"replicas": 2, "poll_s": 1.0, "queue_depth": 16,
              "max_batch": 8, "buckets": "1,8", "max_replicas": 3,
              "fleet_ttl_s": 6.0, "admission_deadline_ms": 250.0,
              "scale_out_deadline_s": 60.0,
              "fault_specs": {"0": "watcher_io@poll=3"}},
    "load": {"rps": 4.0, "timeout_s": 20.0},
    "availability": {"floor": 0.5, "window_s": 10.0, "min_samples": 3},
    "adopt_deadline_s": 120.0, "deadline_s": 600.0,
    "timeline": [{"at": "publish:0", "action": "drain_replica", "replica": 1},
                 {"at": "t:40", "action": "kill_replica_during_wave"},
                 {"at": "t:35", "action": "spike_load", "rps": 12.0}],
}
SCENARIO_EVENTS = ("publish_torn", "quarantine", "drain_token_acquire",
                   "spike_load", "scale_out", "host_relaunch", "lint")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*a) -> None:
    print(*a, flush=True)


def abn_bound_ms(shapes, itemsize: int):
    """Least time the card needs for K1 over `shapes`, and what bounds it:
    the larger of bytes moved (x read once, y written once, 4 f32 (C,)
    vectors) over the memory rate and f32 operations over the f32 peak."""
    nbytes = sum(int(np.prod(s)) * 2 * itemsize + 4 * s[1] * 4 for s in shapes)
    ops = sum(int(np.prod(s)) * ABN_OPS_PER_ELEMENT for s in shapes)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def abn_geometry(fused_abn, x, y, args):
    """The launch geometry K1's wrapper chose for x (and its output y)."""
    return fused_abn.launch_geometry(
        x, [t.data_ptr() for t in (x, y, *args[1:5])])


def abn_yardsticks(torch, fused_abn, x, geom):
    """Closures for the two yardsticks beside K1 at x's shape, neither of
    which computes K1's function: an empty kernel launched with K1's block
    and grid (the launch floor), and `torch.Tensor.copy_` of x into a
    tensor like it (one read and one write of the same bytes, what a
    PyTorch elementwise pass reaches there)."""
    out = torch.empty_like(x)
    return {"floor": lambda: fused_abn.launch_floor(x, geom),
            "copy": lambda: out.copy_(x)}


# the served forward's kernels by family, matched on the kernel's name in
# this order: K1, convolutions (cuDNN's kernels and the cuBLAS products it
# and the SE and head layers call), F.batch_norm's, and the rest
FORWARD_FAMILIES = (
    ("k1", ("fused_abn_fwd_kernel",)),
    ("convolutions", ("xmma_fprop", "conv2d", "implicit_gemm", "nvjet",
                      "gemm", "Gemv", "cudnn", "nchwToNhwc", "nhwcToNchw")),
    ("batch_norm", ("batch_norm",)),
)


# a TResNet-M train step's kernels by family: K1 and its training passes,
# then the convolutions forward and backward (cuDNN's fprop, dgrad and
# wgrad kernels and the cuBLAS products), and the rest
TRAIN_FAMILIES = (
    ("k1", ("fused_abn_fwd_kernel",)),
    ("k1s", ("abn_stats_",)),
    ("k1r", ("abn_grad_sums_",)),
    ("k1d", ("abn_grad_input",)),
    ("convolutions", FORWARD_FAMILIES[1][1] + ("xmma", "dgrad", "wgrad",
                                               "cutlass")),
)


def forward_families(kernels, reps: int, families=FORWARD_FAMILIES) -> dict:
    """Device ms per call of each of `families` and of the rest, from one
    DeviceTimer region's (µs, name) records, with the launches per call
    and the largest of the rest by name."""
    fam = {name: [0.0, 0] for name, _ in families}
    fam["rest"] = [0.0, 0]
    rest = {}
    for dur, kname in kernels:
        key = next((name for name, parts in families
                    if any(p in kname for p in parts)), "rest")
        fam[key][0] += dur / reps / 1e3
        fam[key][1] += 1
        if key == "rest":
            short = kname.removeprefix("void ")[:100]
            rest[short] = rest.get(short, 0.0) + dur / reps / 1e3
    out = {name: {"ms": ms, "launches": n / reps}
           for name, (ms, n) in fam.items()}
    out["rest_largest_ms"] = dict(sorted(rest.items(),
                                         key=lambda kv: -kv[1])[:8])
    return out


def flash_bound_ms(kind: str, bh: int, t: int, d: int, itemsize: int,
                   causal: bool):
    """Least time the card needs for one K2 ("fwd"), K3 ("dq") or K4
    ("dkv") launch: the largest of the bytes moved (each operand read once,
    each output written once, the f32 row statistics) over the memory rate,
    the products' operations over the tensor-core bf16 rate (CUDA-core f32
    rate for f32 operands), and the per-score elementwise f32 operations
    over the f32 rate. Causal counts the T(T+1)/2 scores this data needs."""
    scores = bh * (t * (t + 1) // 2 if causal else t * t)
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    operands = {"fwd": 4, "dq": 5, "dkv": 6}[kind]  # (BH, T, D) in + out
    stats = {"fwd": 1, "dq": 2, "dkv": 2}[kind]     # lse / delta rows
    nbytes = operands * bh * t * d * itemsize + stats * bh * t * 4
    mm_rate = BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(products * 2 * scores * d / mm_rate,
                               SCORE_ELEMENTWISE_OPS * scores / F32_OPS_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def host_ms(torch, fn, reps: int = 5) -> float:
    """Median host-clock time of `fn` ending in a synchronize (for work
    that reads the device from the host inside it, as the train step does)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def wall_ms(torch, fn, reps: int = REPS) -> float:
    """Median time of `fn` as the host drives it: CUDA events around each
    call with nothing queued ahead, so the host's launch overhead counts —
    what a request sees."""
    fn()
    events = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
              for _ in range(reps)]
    for s, e in events:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


class DeviceTimer:
    """Device time per call of labelled regions: the summed durations of the
    kernels each region launches, read by torch.profiler (CUPTI) — the
    card's busy time, whatever gaps the host leaves. All regions share ONE
    profiler session (in one process, repeated sessions stopped recording
    device activity after about sixteen). A region runs its calls and
    synchronizes inside a `record_function` range, with 2 ms idle on each
    side, and launches MARKS_PER_EDGE one-thread marker kernels
    (`torch.cuda._sleep`, MARK) just before its calls and as many just
    after them: a kernel counts toward the region whose two runs of
    markers enclose it on the device's own timeline (`region_spans`), so
    no host timestamp is needed (the profiler places device records off
    the host clock, by up to 21.7 ms in the runs seen; `lag_us` keeps, per
    region, the first marker's device start less the range's host start). The
    range's own mirror on the device timeline (a span from its first
    kernel to its last, gaps included) is not a kernel and is left out.

    The profiler loses a device record now and then (seen on the card: a
    marker — in 3 of 4 sessions of a TResNet-M train step's 83 regions —,
    one of a region's five launches, all of a small region's; and, in every
    session of one run, one edge's two markers, most likely the session's
    last records). A lost marker leaves its edge's run one shorter, and
    each session opens and closes with PAD_KERNELS kernels outside every
    region (`_pad`), so its first and last records are none of a region's;
    a session whose runs do not pair up counts as having recorded nothing,
    and a region's record is whole only if each kernel name in it ran a
    multiple of its calls (`whole`). The regions a session did not record
    whole run again, all in one fresh session, up to RETRY_SESSIONS times,
    keeping the fuller record; one still partial is used as it is (and
    listed), one still empty is timed with CUDA events around its calls
    issued back to back (the host's gaps between them included, so at most
    the wall time: an upper bound on its device time) and reports no kernel
    names. `count` returns the wrappers' launch counters; each region's
    rise over its timed calls is kept in `launched`, so a caller can check
    what such a region launched."""

    def __init__(self, torch, count=None):
        from torch.profiler import ProfilerActivity, profile, record_function

        self.torch = torch
        self.record_function = record_function
        self.new_session = lambda: profile(activities=[ProfilerActivity.CPU,
                                                       ProfilerActivity.CUDA])
        self.prof = self.new_session()
        self.count = count or (lambda: ())
        self.regions = []
        self.launched = {}
        self.per_kernel = {}
        self.retried = []
        self.partial = []
        self.event_timed = []
        self.lag_us = {}

    def __enter__(self):
        self.prof.__enter__()
        self._pad()
        return self

    def __exit__(self, *exc):
        self._pad()
        self.prof.__exit__(*exc)

    def _pad(self) -> None:
        """PAD_KERNELS small fills outside every region, then a synchronize."""
        t = self.torch.empty(PAD_KERNELS, device="cuda")
        for i in range(PAD_KERNELS):
            t[i:i + 1].fill_(0.0)
        self.torch.cuda.synchronize()

    def _rise(self, before) -> tuple:
        return tuple(a - b for a, b in zip(self.count(), before))

    def _record(self, label: str, fn, reps: int) -> None:
        fn()  # warm, outside the region
        self.torch.cuda.synchronize()
        time.sleep(0.002)
        before = self.count()
        with self.record_function(label):
            for _ in range(MARKS_PER_EDGE):  # MARK, before
                self.torch.cuda._sleep(1)
            for _ in range(reps):
                fn()
            for _ in range(MARKS_PER_EDGE):  # MARK, after
                self.torch.cuda._sleep(1)
            self.torch.cuda.synchronize()
        self.launched[label] = self._rise(before)
        time.sleep(0.002)

    def run(self, label: str, fn, reps: int = REPS) -> None:
        self._record(label, fn, reps)
        self.regions.append((label, fn, reps))

    def _attribute(self, prof, regions) -> dict:
        """label -> [(µs, kernel name)] of each region's kernels in the
        session `prof`, which recorded `regions` in this order."""
        cuda = self.torch.autograd.DeviceType.CUDA
        events = prof.events()
        labels = {label for label, *_ in regions}
        ranges = {e.name: e.time_range for e in events
                  if e.name in labels and e.device_type != cuda}
        device = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name)
                        for e in events
                        if e.device_type == cuda and e.name not in labels)
        names = [n for _, _, n in device]
        spans = region_spans(names, len(regions))
        if spans is None or set(ranges) != labels:
            runs = [b - a + 1 for a, b in marker_runs(names)]
            log(f"[timing] torch.profiler session: "
                f"{sum(MARK in n for n in names)} markers in {len(runs)} runs "
                f"(lengths, first and last: {runs[:4]} {runs[-4:]}) and "
                f"{len(ranges)} ranges for {len(regions)} regions")
            return {label: [] for label in labels}
        found = {}
        for (label, *_), (first, lo, hi) in zip(regions, spans):
            found[label] = [(d, n) for _, d, n in device[lo:hi]]
            self.lag_us[label] = device[first][0] - ranges[label].start
        return found

    def _event_ms(self, label: str, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        before = self.count()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        self.launched[label] = self._rise(before)
        return start.elapsed_time(end) / reps

    def results(self) -> dict:
        """label -> (device ms per call, names of the kernels it ran, or
        None for a region timed with CUDA events)."""
        found = self._attribute(self.prof, self.regions)
        missing = [r for r in self.regions if not whole(found[r[0]], r[2])]
        for _ in range(RETRY_SESSIONS):
            if not missing:
                break
            self.retried += [label for label, *_ in missing]
            with self.new_session() as prof:
                self._pad()
                for region in missing:
                    self._record(*region)
                self._pad()
            again = self._attribute(prof, missing)
            for label, _, reps in missing:  # keep the fuller record
                if (whole(again[label], reps)
                        or len(again[label]) > len(found[label])):
                    found[label] = again[label]
            missing = [r for r in missing if not whole(found[r[0]], r[2])]
        self.partial = [label for label, _, reps in self.regions
                        if found[label] and not whole(found[label], reps)]
        out = {}
        for label, fn, reps in self.regions:
            mine = found[label]
            if mine:
                out[label] = (sum(d for d, _ in mine) / reps / 1e3,
                              [n for _, n in mine])
                self.per_kernel[label] = (mine, reps)
            else:
                self.event_timed.append(label)
                out[label] = (self._event_ms(label, fn, reps), None)
        if self.retried:
            log(f"[timing] torch.profiler's first session left "
                f"{sorted(set(self.retried))} empty or with a kernel count "
                f"that is no multiple of the calls; after {RETRY_SESSIONS} "
                f"more, still partial: {self.partial}, still empty (timed "
                f"with CUDA events): {self.event_timed}")
        return out

    def record(self) -> dict:
        """The regions that needed another session, stayed partial or
        were timed with CUDA events, and the range of `lag_us`."""
        lag = list(self.lag_us.values())
        return {"retried": self.retried, "partial": self.partial,
                "event_timed": self.event_timed,
                "lag_us": [min(lag), max(lag)] if lag else None}

    def kernel_ms(self, label: str, part: str):
        """(device ms per call, launches per call) of the kernels of region
        `label` whose name holds `part` (after `results`)."""
        check(label in self.per_kernel,
              f"torch.profiler recorded no kernel for {label} in "
              f"{1 + RETRY_SESSIONS} sessions")
        mine, reps = self.per_kernel[label]
        hit = [d for d, n in mine if part in n]
        return sum(hit) / reps / 1e3, len(hit) / reps


def marker_runs(names):
    """(first, last) index of each maximal stretch of consecutive markers
    in a device-ordered list of kernel names."""
    runs, i = [], 0
    while i < len(names):
        if MARK not in names[i]:
            i += 1
            continue
        j = i
        while j + 1 < len(names) and MARK in names[j + 1]:
            j += 1
        runs.append((i, j))
        i = j + 1
    return runs


def region_spans(names, n: int):
    """For the device-ordered kernel names of a session that recorded n
    regions: per region (index of its first marker, then the slice bounds
    of the kernels between its runs of markers), or None where the runs do
    not pair up. The region's calls separate its two runs and the next
    region's warm call separates it from the next, so a run that lost a
    marker still counts; kernels before the first run and after the last
    (the session's padding) belong to no region."""
    runs = marker_runs(names)
    if len(runs) != 2 * n:
        return None
    return [(a[0], a[1] + 1, b[0]) for a, b in zip(runs[::2], runs[1::2])]


def whole(kernels, reps: int) -> bool:
    """Whether a region's record is whole: not empty, and each kernel name
    launched a multiple of `reps` times, as every call of a region runs
    the same kernels (a record the profiler lost breaks this)."""
    counts = {}
    for _, name in kernels:
        counts[name] = counts.get(name, 0) + 1
    return bool(counts) and all(c % reps == 0 for c in counts.values())


def clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def randomize_(torch, model, seed: int) -> None:
    """Random non-degenerate weights (the recipe of the oracle tests):
    fan-in-scaled normal conv/linear weights, BN γ ~ U(0.5, 1.5), biases
    ~ N(0, 0.1), running mean ~ N(0, 0.2), running var ~ U(0.5, 2)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                new = torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5
            elif name.endswith("weight"):
                new = torch.rand(p.shape, generator=gen) + 0.5
            else:
                new = torch.randn(p.shape, generator=gen) * 0.1
            p.copy_(new)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.2)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) * 1.5 + 0.5)



CSRC = "ddp_classification_pytorch_tpu_torch/ops/csrc/"
FLASH_KERNELS = (  # (kind, wrapper attribute, kernel name part, TPU kernel,
    # the bf16 kernel's source)
    ("fwd", "flash_forward", "flash_fwd_kernel",
     "ddp_classification_pytorch_tpu/ops/flash_attention.py:79",
     CSRC + "flash_fwd_sm90.cu"),
    ("dq", "flash_dq", "flash_dq_kernel",
     "ddp_classification_pytorch_tpu/ops/flash_attention.py:192",
     CSRC + "flash_bwd_sm90.cu"),
    ("dkv", "flash_dkv", "flash_dkv_kernel",
     "ddp_classification_pytorch_tpu/ops/flash_attention.py:238",
     CSRC + "flash_bwd_sm90.cu"),
)
# the bf16 K2 (flash_fwd_sm90.cu), K3 and K4 (flash_bwd_sm90.cu), whose
# SASS must hold wgmma
WGMMA_KERNELS = ("flash_fwd_kernel_sm90", "flash_dq_kernel_sm90",
                 "flash_dkv_kernel_sm90")


def find_cuobjdump(build) -> str:
    """cuobjdump beside the nvcc that built the kernels, else the copy in
    Triton's package; neither fails the phase."""
    places = [os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")]
    try:
        import triton

        places.append(os.path.join(os.path.dirname(triton.__file__),
                                   "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for path in places:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(f"chip_smoke: no cuobjdump at {places}")


def hgmma_counts(tool: str, lib: str) -> dict:
    """HGMMA instructions in the SASS of each WGMMA_KERNELS function."""
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = next((k for k in WGMMA_KERNELS if k in name), None)
            if current:
                counts.setdefault(current, 0)
        elif current and "HGMMA" in line:
            counts[current] += 1
    return counts


def flash_counts(fa):
    return tuple(getattr(fa, attr).launches for _, attr, *_ in FLASH_KERNELS)


def flash_vs_plain(torch, fa, device):
    """Phase 7: K2-K4 against their plain versions at FLASH_CASES in f32
    and bf16. Returns per-case rows (errors, bound) and, per case, the
    closures the timing phase runs: kernel, plain and the SDPA yardstick."""
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(2)
    d = fa.HEAD_DIM
    rows, timed = [], []
    for b, t, h, causal in FLASH_CASES:
        bh, scale = b * h, d ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v, do = (torch.randn(bh, t, d, device=device, generator=gen)
                           .to(dtype) for _ in range(4))
            out, lse = fa.flash_forward(q, k, v, scale, causal)
            dsum = (do.float() * out.float()).sum(-1, keepdim=True)
            got = {"o": out, "lse": lse,
                   "dq": fa.flash_dq(q, k, v, do, lse, dsum, scale, causal)}
            got["dk"], got["dv"] = fa.flash_dkv(q, k, v, do, lse, dsum, scale,
                                                causal)
            want = dict(zip(("o", "lse"),
                            fa.flash_forward_ref(q, k, v, scale, causal)))
            want["dq"] = fa.flash_dq_ref(q, k, v, do, lse, dsum, scale, causal)
            want["dk"], want["dv"] = fa.flash_dkv_ref(q, k, v, do, lse, dsum,
                                                      scale, causal)
            torch.cuda.synchronize()
            o_tol, g_tol, rtol = FLASH_TOL[dname]
            errs, refs, rms = {}, {}, {}
            for key, val in got.items():
                check(val.dtype == (torch.float32 if key == "lse" else dtype),
                      f"flash {key} dtype {val.dtype}")
                diff = val.float() - want[key].float()
                errs[key] = diff.abs().max().item()
                refs[key] = want[key].float().abs().max().item()
                ref_rms = want[key].float().pow(2).mean().sqrt().item()
                err_rms = diff.pow(2).mean().sqrt().item()
                rms[key] = err_rms / max(ref_rms, 1e-30)
                log(f"[flash] {b}x{t}x{h}x{d} causal={causal} {dname} {key}: "
                    f"max |err| {errs[key]:.6g}, max |ref| {refs[key]:.6g}, "
                    f"RMS err / RMS ref {rms[key]:.6g}")
                atol = {"o": o_tol, "lse": 1e-4}.get(key, g_tol)
                torch.testing.assert_close(val.float(), want[key].float(),
                                           atol=atol,
                                           rtol=1e-4 if key == "lse" else rtol)
                rms_tol = FLASH_RMS_TOL[dname][key != "o"]
                check(err_rms <= rms_tol * ref_rms + 1e-6,
                      f"flash {key} {dname} {b}x{t}x{h}: RMS error {err_rms} > "
                      f"{rms_tol} x RMS {ref_rms}")
            row = {"shape": [b, t, h, d], "causal": causal, "dtype": dname,
                   "max_abs_err": errs, "max_abs_ref": refs,
                   "rms_err_over_rms_ref": rms}
            for kind, *_ in FLASH_KERNELS:
                row[f"bound_ms_{kind}"], row[f"bound_by_{kind}"] = \
                    flash_bound_ms(kind, bh, t, d, q.element_size(), causal)
            rows.append(row)
            args = (q, k, v, do, lse, dsum, scale, causal)
            q4, k4, v4 = (x.clone().view(b, h, t, d).requires_grad_()
                          for x in (q, k, v))
            do4 = do.view(b, h, t, d)
            sdpa_out = F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=causal,
                                                      scale=scale)
            timed.append({
                "k_fwd": lambda a=args: fa.flash_forward(*a[:3], a[6], a[7]),
                "k_dq": lambda a=args: fa.flash_dq(*a),
                "k_dkv": lambda a=args: fa.flash_dkv(*a),
                "p_fwd": lambda a=args: fa.flash_forward_ref(*a[:3], a[6], a[7]),
                "p_dq": lambda a=args: fa.flash_dq_ref(*a),
                "p_dkv": lambda a=args: fa.flash_dkv_ref(*a),
                "sdpa_fwd": lambda x=(q4, k4, v4), c=causal, sc=scale:
                    F.scaled_dot_product_attention(*x, is_causal=c, scale=sc),
                "sdpa_bwd": lambda o=sdpa_out, x=(q4, k4, v4), g=do4:
                    torch.autograd.grad(o, x, g, retain_graph=True),
            })
            if (b, t, h, causal) == FLASH_CASES[0] and dtype == torch.bfloat16:
                again = (*fa.flash_forward(q, k, v, scale, causal),
                         fa.flash_dq(q, k, v, do, lse, dsum, scale, causal),
                         *fa.flash_dkv(q, k, v, do, lse, dsum, scale, causal))
                torch.cuda.synchronize()
                check(all(torch.equal(a, got[key]) for a, key in
                          zip(again, ("o", "lse", "dq", "dk", "dv"))),
                      "K2/K3/K4 not bitwise deterministic across two launches")
                row["bitwise_repeat"] = True
                log(f"[flash] {b}x{t}x{h}x{d} {dname}: a second K2 + K3 + K4 "
                    f"launch gives the same bits")
            log(f"[flash] {b}x{t}x{h}x{d} causal={causal} {dname}: kernels "
                f"agree with the plain versions, max |err| {json.dumps(errs)}")
    return rows, timed


def same_state(torch, a, b) -> bool:
    """Two train states (`TrainState.state_dict()` layouts) hold the same
    bits: model tensors, the optimizer's momentum, step and opt_count."""
    def equal(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(equal(x[k], y[k]) for k in x)
        if isinstance(x, torch.Tensor):
            return torch.equal(x.cpu(), y.cpu())
        return x == y

    return all(equal(a[k], b[k]) for k in ("model", "optimizer", "step",
                                           "opt_count"))


def train_main_path(torch, device, train_cli, checkpoint, argv, counters,
                    want, tag, then=None, before=None, files=(),
                    ckpt_name=None, trainer_cls=None):
    """Phases 8, 12 and 17: cli/train.py's sequence for `argv` in process,
    into a temporary directory (a checkpoint is hundreds of MB): epochs of
    TRAIN_STEPS steps and EVAL_BATCHES eval batches. `counters` names the
    wrappers whose launches the run must raise by exactly `want` (set to 0
    just before it). The loss is finite, no step was skipped, the records,
    the last epoch's checkpoint (or `ckpt_name`) with its sidecar and
    `files` are written, and the checkpoint restores to the trained state
    (weights, optimizer state, counters). `before(trainer)` runs just before the run, `then(trainer,
    ckpt)` after it, before the directory goes, and returns more of the
    record. `trainer_cls` is the CLI's choice for the workload (Trainer
    unless given). Returns the trainer, its config and the record (with
    the small records' text)."""
    from ddp_classification_pytorch_tpu_torch.train.loop import Trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        cfg = train_cli.config_from_args(
            train_cli.build_parser().parse_args(argv + ["--out", tmp]))
        trainer = (trainer_cls or Trainer)(cfg, device)
        check(trainer.steps_per_epoch == TRAIN_STEPS
              and len(trainer.val_loader) == EVAL_BATCHES,
              f"{trainer.steps_per_epoch} train steps / "
              f"{len(trainer.val_loader)} eval batches, expected "
              f"{TRAIN_STEPS} / {EVAL_BATCHES}")
        if before:
            before(trainer)
        for f in counters.values():  # count only the main path's
            f.launches = 0
        t0 = time.perf_counter()
        last = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        log(f"[{tag}] epoch {cfg.run.epochs - 1}: {json.dumps(last)}")
        check(all(np.isfinite(v) for k, v in last.items()
                  if k == "loss" or k.startswith("val_")),
              f"non-finite loss or eval metric: {last}")
        check(last["step_ok"] == 1.0 and trainer.sentinel.skipped_total == 0,
              f"skipped steps: step_ok mean {last['step_ok']}")
        check(launches == want, f"launches {launches}, expected {want}")
        ckpt_name = ckpt_name or f"ckpt_e{cfg.run.epochs - 1}.pt"
        names = ("output.txt", "history.json", "meta.json", ckpt_name,
                 ckpt_name + ".sha256", *files)
        for n in names:
            check(os.path.exists(os.path.join(tmp, n)), f"train wrote no {n}")
        ckpt = os.path.join(tmp, ckpt_name)
        check(same_state(torch, checkpoint.restore(ckpt),
                         trainer.state.state_dict()),
              "checkpoint does not restore the trained state")
        more = then(trainer, ckpt) if then else {}
        records = {}
        for n in names[:3]:  # the small records ride in the report
            with open(os.path.join(tmp, n)) as f:
                records[n] = f.read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    record = {"argv": argv, "epoch": last, "launches": launches,
              "wall_s": wall,
              "images_per_s": TRAIN_STEPS * cfg.data.batch_size
              / last["epoch_time"]} | more
    log(f"[{tag}] {json.dumps(record)}")
    record["records"] = records
    return trainer, cfg, record


def train_slice(torch, fa, device, cfg, train_ds):
    """Phase 9: one train step at batch 8 through K2-K4 and through the
    plain versions, from the same weights and batch."""
    from ddp_classification_pytorch_tpu_torch.train.state import create_train_state
    from ddp_classification_pytorch_tpu_torch.train.steps import make_train_step

    items = [train_ds[i] for i in range(8)]
    images = torch.from_numpy(np.stack([im for im, _ in items])).to(device)
    labels = torch.from_numpy(np.asarray([lb for _, lb in items], np.int32)).to(device)
    step = make_train_step(cfg)
    metrics = []
    for plain in (False, True):
        state = create_train_state(cfg, device, TRAIN_STEPS)
        before = flash_counts(fa)
        saved = {attr: getattr(fa, attr) for _, attr, *_ in FLASH_KERNELS}
        if plain:
            for _, attr, *_ in FLASH_KERNELS:
                setattr(fa, attr, getattr(fa, attr + "_ref"))
        try:
            m = step(state, images, labels)
            torch.cuda.synchronize()
        finally:
            for attr, fn in saved.items():
                setattr(fa, attr, fn)
        grew = tuple(a - b for a, b in zip(flash_counts(fa), before))
        check(grew == ((0, 0, 0) if plain else (VIT_BLOCKS,) * 3),
              f"{'plain' if plain else 'kernel'} step launched {grew}")
        check(float(m["step_ok"]) == 1.0, "slice step skipped")
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        del state
    kern, ref = metrics
    rel = {k: abs(kern[k] - ref[k]) / abs(ref[k]) for k in kern}
    log(f"[train-slice] kernel {json.dumps(kern)} plain {json.dumps(ref)} "
        f"relative diff {json.dumps(rel)}")
    check(rel["loss"] <= 1e-3 and rel["grad_norm"] <= 1e-2,
          f"train slice disagrees: {rel}")
    return {"kernel": kern, "plain": ref, "relative_diff": rel}


def abn_train_bound_ms(kind: str, shapes, itemsize: int):
    """Least time the card needs for K1s, K1r or K1d over `shapes`, and what
    bounds it: the larger of the bytes moved (each M×C tensor and f32 (C,)
    vector read or written once) over the memory rate and the f32
    operations over the f32 peak."""
    _, _, _, _, _, ops, (tensors, vecs) = next(
        k for k in ABN_TRAIN_KERNELS if k[0] == kind)
    elements = sum(int(np.prod(s)) for s in shapes)
    nbytes = elements * tensors * itemsize + sum(vecs * s[1] * 4 for s in shapes)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = elements * ops / F32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def abn_train_inputs(torch, fused_abn, shape, dtype, device, gen, slope):
    """One ABN site's training tensors at `shape` ((N, C, H, W) channels_last
    or (M, C) rows): x, g (y's gradient, in y's layout), y = K1's plain
    version on x's batch statistics, scale, bias, mean, var, inv_std."""
    c = shape[1]
    if len(shape) == 4:
        n, _, h, w = shape
        x = (torch.randn((n, h, w, c), device=device, generator=gen) * 1.5
             + 0.3).to(dtype).permute(0, 3, 1, 2)
    else:
        x = (torch.randn(shape, device=device, generator=gen) * 1.5
             + 0.3).to(dtype)
    scale = torch.rand(c, device=device, generator=gen) + 0.5
    bias = torch.rand(c, device=device, generator=gen) - 0.5
    mean, var, inv = fused_abn.bn_stats_ref(x)
    # in x's strides, as K1's output has them (at 1x1 spatial the plain
    # version's differ in the size-1 dims, which the wrappers refuse)
    y = torch.empty_like(x).copy_(fused_abn.fused_bn_leaky_relu_ref(
        x, scale, bias, mean, var, 1e-5, slope))
    g = torch.empty_like(x).normal_(generator=gen)
    return x, g, y, scale, bias, mean, var, inv


def abn_train_closures(torch, fused_abn, t, slope, ds, db):
    """What phase 14 times at one site: each kernel, its plain version, and
    four PyTorch calls beside them: `torch.batch_norm_stats` (K1s's mean
    and inv_std in one call, without var) and `torch.var_mean(correction=0)`
    (its mean and biased variance by another formula, without inv_std);
    `torch.batch_norm_backward_reduce` (Σg and Σg·(x − mean) in one call:
    K1r's sums without the LeakyReLU gate, reading g and x but not y) and
    the backward of `F.batch_norm(training=True)` (a BN's dx, dγ and dβ
    without the gate: a yardstick beside K1r + K1d, not the same
    function)."""
    import torch.nn.functional as F

    x, g, y, scale, bias, mean, var, inv = t
    dims = (0, 2, 3) if x.dim() == 4 else (0,)
    xr = x.detach().clone().requires_grad_()
    w, b = (v.clone().requires_grad_() for v in (scale, bias))
    out = F.batch_norm(xr, None, None, w, b, training=True, eps=1e-5)
    return {
        "k_k1s": lambda: fused_abn.bn_stats(x),
        "p_k1s": lambda: fused_abn.bn_stats_ref(x),
        "k_k1r": lambda: fused_abn.abn_grad_sums(g, y, x, mean, inv, slope),
        "p_k1r": lambda: fused_abn.abn_grad_sums_ref(g, y, x, mean, inv, slope),
        "k_k1d": lambda: fused_abn.abn_grad_input(g, y, x, scale, mean, inv, ds,
                                                  db, slope),
        "p_k1d": lambda: fused_abn.abn_grad_input_ref(g, y, x, scale, mean, inv,
                                                      ds, db, slope),
        "var_mean": lambda: torch.var_mean(x, dim=dims, correction=0),
        "bn_stats": lambda: torch.batch_norm_stats(x, 1e-5),
        "bn_bwd_reduce": lambda: torch.batch_norm_backward_reduce(
            g, x, mean, inv, scale, False, True, True),
        "bn_bwd": lambda: torch.autograd.grad(out, (xr, w, b), g,
                                              retain_graph=True),
    }


def abn_train_vs_plain(torch, fused_abn, device, shapes, slope, ragged=True):
    """Phase 11: K1s, K1r, K1d and K1 (on the batch statistics, as training
    calls it) against their plain versions at every distinct ABN shape of
    `shapes` (those of one TResNet-M train step), plus a ragged C and an
    odd M where `ragged`, in f32 and bf16; a second launch must give the
    same bits. Returns per-case rows, the bf16 cases' closures for phase
    14, and each kernel's largest error."""
    gen = torch.Generator(device=device).manual_seed(3)
    rows_of = fused_abn._rows
    cases = sorted(set(shapes), key=lambda s: (-s[2], s[1]))
    if ragged:
        cases += [(393, 48), (1001, 37)]
    rows, timed = [], []
    max_err = {"k1": 0.0, "k1s": 0.0, "k1r": 0.0, "k1d": 0.0}
    for shape in cases:
        for dtype, stats_tol, dx_tol in ((torch.float32, 1e-5, 1e-5),
                                         (torch.bfloat16, 1e-5, 1e-2)):
            dname = str(dtype).split(".")[-1]
            t = abn_train_inputs(torch, fused_abn, shape, dtype, device, gen,
                                 slope)
            x, g, y, scale, bias, mean, var, inv = t
            fwd = (x, scale, bias, mean, var, 1e-5, slope)
            yk = fused_abn.fused_bn_leaky_relu(*fwd)
            stats = fused_abn.bn_stats(x)
            ds, db = fused_abn.abn_grad_sums(g, y, x, mean, inv, slope)
            dx = fused_abn.abn_grad_input(g, y, x, scale, mean, inv, ds, db,
                                          slope)
            again = (fused_abn.fused_bn_leaky_relu(*fwd),
                     *fused_abn.bn_stats(x),
                     *fused_abn.abn_grad_sums(g, y, x, mean, inv, slope),
                     fused_abn.abn_grad_input(g, y, x, scale, mean, inv, ds, db,
                                              slope))
            want_stats = fused_abn.bn_stats_ref(x)
            want_ds, want_db = fused_abn.abn_grad_sums_ref(g, y, x, mean, inv,
                                                           slope)
            want_dx = fused_abn.abn_grad_input_ref(g, y, x, scale, mean, inv,
                                                   ds, db, slope)
            oracle = fused_abn.fused_bn_leaky_relu_backward_ref(
                g, x, y, scale, mean, inv, slope)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in
                      zip(again, (yk, *stats, ds, db, dx))),
                  f"K1/K1s/K1r/K1d {shape} {dname}: a second launch gave "
                  f"other bits")
            # K1 within phase 3's tolerances, dx's (y: its plain version)
            check(yk.dtype == dtype and yk.shape == x.shape,
                  f"K1 output {yk.dtype} {yk.shape}")
            errs = {"y": (yk.float() - y.float()).abs().max().item()}
            torch.testing.assert_close(yk.float(), y.float(), atol=dx_tol,
                                       rtol=dx_tol)
            for name, a, b in zip(("mean", "var", "inv_std"), stats, want_stats):
                errs[name] = (a - b).abs().max().item()
                torch.testing.assert_close(a, b, atol=stats_tol, rtol=stats_tol)
            dy = fused_abn._gated(rows_of(g), rows_of(y), slope)
            terms = {"dbias": dy, "dscale": dy * (rows_of(x) - mean) * inv}
            for name, a, b, o in (("dscale", ds, want_ds, oracle[1]),
                                  ("dbias", db, want_db, oracle[2])):
                limit = SUM_ULPS * 2.0 ** -24 * terms[name].abs().sum(0)
                errs[name] = (a - b).abs().max().item()
                errs[name + "_vs_bwd"] = (a - o).abs().max().item()
                check(bool(((a - b).abs() <= limit).all()
                           and ((a - o).abs() <= limit).all()),
                      f"K1r {name} {shape} {dname}: off its plain version by "
                      f"{errs[name]}, off _bwd by {errs[name + '_vs_bwd']}")
            check(dx.dtype == dtype and dx.stride() == x.stride(),
                  f"K1d output {dx.dtype} {dx.stride()}")
            for name, want in (("dx", want_dx), ("dx_vs_bwd", oracle[0])):
                errs[name] = (dx.float() - want.float()).abs().max().item()
                torch.testing.assert_close(dx.float(), want.float(),
                                           atol=dx_tol, rtol=dx_tol)
            for kind, keys in (("k1", ("y",)), ("k1s", ("mean", "var", "inv_std")),
                               ("k1r", ("dscale", "dbias")), ("k1d", ("dx",))):
                max_err[kind] = max(max_err[kind], *(errs[k] for k in keys))
            row = {"shape": list(shape), "dtype": dname, "max_abs_err": errs,
                   "bitwise_repeat": True,
                   "sites_per_step": shapes.count(shape)}
            for kind, *_ in ABN_TRAIN_KERNELS:
                row[f"bound_us_{kind}"] = abn_train_bound_ms(
                    kind, [shape], x.element_size())[0] * 1e3
            rows.append(row)
            if dtype == torch.bfloat16:
                timed.append((row, abn_train_closures(torch, fused_abn, t,
                                                      slope, ds, db)))
        log(f"[abn-train] {shape}: K1, K1s, K1r, K1d agree with the plain "
            f"versions, K1r and K1d with _bwd (f32, bf16); a second launch "
            f"gives the same bits")
    return rows, timed, max_err


def serve_trained_checkpoint(torch, fused_abn, device, serve_cli, k1,
                             trainer, ckpt, images, serve_argv=SERVE_ARGV,
                             k1_per_forward=ABN_SITES):
    """Phases 12, 19 and 20: cli/serve.py's selfcheck over the checkpoint
    the trainer wrote (8 requests with finite probabilities, K1
    `k1_per_forward` times a forward: 36 for TResNet-M, 0 for ResNet-50),
    then `images` (8 uint8 val images) through the served model and the
    trainer's own eval forward: the same top-5."""
    from ddp_classification_pytorch_tpu_torch.train.steps import (
        make_topk_predict_step,
    )

    copies = fused_abn.FusedBNLeakyReLU.layout_copies
    check(copies == 0, f"{copies} gradients copied into y's layout")
    argv = serve_argv[:serve_argv.index("--selfcheck")] + [
        "--ckpt", ckpt, "--selfcheck", "8", "--device", "cuda"]
    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(argv))
    before = k1.launches
    engine = serve_cli.build_engine(cfg, device)
    engine.warmup()
    preds = serve_cli.run_selfcheck(engine, cfg, 8)
    forwards = len(engine.buckets) + engine.metrics.batches
    check(len(preds) == 8 and all(
        p.scores.shape == (5,) and np.isfinite(p.scores).all()
        and (p.scores >= 0).all() and p.scores.sum() <= 1.0 + 1e-3
        for p in preds), "served checkpoint: invalid probabilities")
    check(k1.launches - before == k1_per_forward * forwards,
          f"served checkpoint: K1 rose by {k1.launches - before} over "
          f"{forwards} forwards")
    predict = make_topk_predict_step(cfg, 5)
    imgs = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    served_p, served_i = predict(engine._state, imgs)
    own_p, own_i = predict(trainer.state.model.eval(), imgs)
    torch.cuda.synchronize()
    check(torch.equal(served_i, own_i), f"served top-5 {served_i.tolist()} "
          f"!= the trainer's {own_i.tolist()}")
    return {"layout_copies": copies, "served_requests": len(preds),
            "served_forwards": forwards, "served_top5_equal": True,
            "served_max_prob_diff": (served_p - own_p).abs().max().item()}


def tresnet_train_slice(torch, fused_abn, device, cfg, train_ds, wrappers):
    """Phase 13: one TResNet-M train step at batch 8 from the same weights
    and batch, through K1, K1s, K1r and K1d and with the four wrappers
    swapped for their plain versions on the same CUDA tensors, in f32 and
    in bf16; with each BN site's output divergence between the two runs
    (max |kernel − plain| / max |plain|) along the depth."""
    import copy

    from ddp_classification_pytorch_tpu_torch.models.tresnet import BatchNorm
    from ddp_classification_pytorch_tpu_torch.train.state import create_train_state
    from ddp_classification_pytorch_tpu_torch.train.steps import make_train_step

    items = [train_ds[i] for i in range(8)]
    images = torch.from_numpy(np.stack([im for im, _ in items])).to(device)
    labels = torch.from_numpy(np.asarray([lb for _, lb in items],
                                         np.int32)).to(device)
    out = {}
    for dtype in ("float32", "bfloat16"):
        dcfg = copy.deepcopy(cfg)
        dcfg.model.dtype = dtype
        step = make_train_step(dcfg)
        runs, kernel_outs, divergence = [], [], []
        for plain in (False, True):
            state = create_train_state(dcfg, device, TRAIN_STEPS)
            start = {k: b.clone() for k, b in state.model.named_buffers()
                     if k.endswith(("running_mean", "running_var"))}

            def site(_m, _a, y, plain=plain):
                if not plain:
                    kernel_outs.append(y.detach().clone())
                    return
                k = kernel_outs[len(divergence)]
                divergence.append(((k.float() - y.float()).abs().max()
                                   / y.float().abs().max()).item())

            hooks = [m.register_forward_hook(site)
                     for m in state.model.modules() if isinstance(m, BatchNorm)]
            before = [f.launches for f in wrappers]
            if plain:
                for name in ABN_WRAPPERS:
                    setattr(fused_abn, name, getattr(fused_abn, name + "_ref"))
            try:
                m = step(state, images, labels)
                torch.cuda.synchronize()
            finally:
                for name, f in zip(ABN_WRAPPERS, wrappers):
                    setattr(fused_abn, name, f)
                for hk in hooks:
                    hk.remove()
            grew = tuple(f.launches - b for f, b in zip(wrappers, before))
            check(grew == ((0,) * 4 if plain else (ABN_SITES,) * 4),
                  f"{'plain' if plain else 'kernel'} {dtype} step launched "
                  f"{grew}")
            check(float(m["step_ok"]) == 1.0, "slice step skipped")
            moved = {k: b.float() - start[k].float()
                     for k, b in state.model.named_buffers() if k in start}
            runs.append(({k: float(m[k]) for k in ("loss", "grad_norm")}, moved))
            del state
        del kernel_outs
        (kern, kmoved), (ref, rmoved) = runs
        check(len(rmoved) == 2 * (ABN_SITES + 24) and len(divergence) == 60,
              f"{len(rmoved)} running statistics, {len(divergence)} BN sites")
        rel = {k: abs(kern[k] - ref[k]) / abs(ref[k]) for k in kern}
        # each running statistic's update (ra after − ra before =
        # 0.1·(batch − ra)) against the plain run's, relative to that
        # update's largest value
        rel["running_stats"] = max(
            (kmoved[k] - rmoved[k]).abs().max().item()
            / max(rmoved[k].abs().max().item(), 1e-12) for k in rmoved)
        out[dtype] = {"kernel": kern, "plain": ref, "relative_diff": rel,
                      "bn_output_divergence": divergence}
        log(f"[tresnet-slice] {dtype}: kernel {json.dumps(kern)} plain "
            f"{json.dumps(ref)} relative diff {json.dumps(rel)}; BN output "
            f"divergence at sites 1, 20, 40, 60: "
            f"{[divergence[i] for i in (0, 19, 39, 59)]}")
        if dtype == "float32":
            check(rel["loss"] <= 1e-5 and rel["grad_norm"] <= 1e-2
                  and rel["running_stats"] <= 1e-3,
                  f"TResNet-M f32 train slice disagrees: {rel}")
        else:
            check(rel["loss"] <= 1e-2,
                  f"TResNet-M bf16 train slice: loss off by {rel['loss']}")
    return out


def vit_epoch_walls(torch, trainer) -> dict:
    """Phase 10's last part: the wall of one ViT train epoch (8 steps, no
    eval) with the synthetic images made on the step loop's thread and
    copied inside it (the loader at 0 workers, prefetch depth 0: the path
    before the loader had threads), and with them made on the loader's
    threads and staged by the prefetcher (the trainer's settings), in
    turns: synchronous, threaded, threaded, synchronous."""
    loader, staged = trainer.train_loader, trainer.train_prefetch
    setting = {"synchronous": (0, 0),
               "threaded": (loader.num_workers, staged.depth)}
    walls = {k: [] for k in setting}
    for i, label in enumerate(("synchronous", "threaded", "threaded",
                               "synchronous")):
        loader.num_workers, staged.depth = setting[label]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_epoch(1 + i)
        torch.cuda.synchronize()
        walls[label].append(time.perf_counter() - t0)
    loader.num_workers, staged.depth = setting["threaded"]
    rec = {"steps": TRAIN_STEPS, "wall_s": walls,
           "loader_workers": setting["threaded"][0],
           "prefetch_depth": setting["threaded"][1]}
    log(f"[vit-epoch] ViT-B/16 train epoch wall, synthetic data made on the "
        f"step loop's thread vs on the loader's threads: {json.dumps(rec)}")
    return rec


FIXTURE_JPEGS = os.path.join("tests", "data", "torch_port_jpeg")
IF_CLASSES, IF_TRAIN, IF_VAL = 4, 64, 16  # per class: 256 train, 64 val files
# the image-folder path: batch 32, train crops RandomResizedCrop(256), eval
# resize 256 + center 224 (the baseline preset's quirk), bf16
IF_BATCH, IF_CROP, IF_IMAGE = 32, 256, 224
IF_ARGV = ["baseline", "--dataset", "imagefolder", "--model", "tresnet_m",
           "--image_size", str(IF_IMAGE), "--crop_size", str(IF_CROP),
           "--batchsize", str(IF_BATCH), "--dtype", "bfloat16", "--lr", "0.01",
           "--device", "cuda"]
# where the probe finds no libjpeg: the same path on CIFAR-10's pickle
# layout (raw pixels, no decoder), 32 px and 10 classes
CIFAR_ARGV = ["baseline", "--dataset", "cifar10", "--model", "tresnet_m",
              "--batchsize", str(IF_BATCH), "--dtype", "bfloat16", "--lr",
              "0.01", "--device", "cuda"]


def fixture_tree(root: str):
    """A 4-class image folder of 256 train and 64 val JPEGs, copies of the
    8 committed photo-sized fixtures (the port writes no JPEG). Returns
    (train_dir, val_dir)."""
    import glob

    files = sorted(glob.glob(os.path.join(REPO, FIXTURE_JPEGS, "*.jpg")))
    check(len(files) == 8, f"{len(files)} JPEG fixtures, expected 8")
    for split, n in (("train", IF_TRAIN), ("val", IF_VAL)):
        for c in range(IF_CLASSES):
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d)
            for i in range(n):
                shutil.copy(files[(c * n + i) % len(files)],
                            os.path.join(d, f"{i:03d}.jpg"))
    return os.path.join(root, "train"), os.path.join(root, "val")


def first_batch_recorder(trainer, seen: dict):
    """Wrap the trainer's train step to keep, for the first step of epoch 1
    (state.step == TRAIN_STEPS), a digest of its uint8 batch and the flip
    mask that step draws (`flip_mask` of the run's seed and that step)."""
    import hashlib

    from ddp_classification_pytorch_tpu_torch.train.steps import flip_mask

    inner = trainer.train_step

    def step(state, images, labels, flip=None):
        if state.step == TRAIN_STEPS:
            seen["batch_sha256"] = hashlib.sha256(
                images.cpu().numpy().tobytes()).hexdigest()
            seen["labels"] = labels.cpu().tolist()
            seen["flip"] = flip_mask(trainer.cfg.run.seed, state.step,
                                     images.shape[0]).astype(int).tolist()
        return inner(state, images, labels, flip)

    trainer.train_step = step


def cli_refuses_folders(train_cli) -> dict:
    """Where the probe found no libjpeg: the train CLI on an image folder
    exits rc 2 and names what is missing (the fixture tree is there; the
    dataplane is not), through the dataplane (baseline) and through the
    item route's decoder (the cdr transform): no PIL fallback."""
    import contextlib
    import io

    rec = {}
    for route, extra, names in (("dataplane", [], "native/dataplane.cpp"),
                                ("decoder", ["--transform", "cdr"],
                                 "data/csrc/decode.cpp")):
        root = tempfile.mkdtemp(prefix="chip_smoke_nojpeg_")
        err = io.StringIO()
        try:
            train_dir, val_dir = fixture_tree(root)
            with contextlib.redirect_stderr(err):
                try:
                    train_cli.main(IF_ARGV + extra + [
                        "--train_dir", train_dir, "--val_dir", val_dir,
                        "--epochs", "1", "--out", os.path.join(root, "out")])
                    rc = 0
                except SystemExit as e:
                    rc = e.code
        finally:
            shutil.rmtree(root, ignore_errors=True)
        msg = err.getvalue().strip().splitlines()[0] if err.getvalue() else ""
        check(rc == 2 and "-ljpeg" in msg and "jpeglib.h" in msg
              and names in msg,
              f"train CLI on a folder without libjpeg ({route}): rc {rc}, "
              f"{msg!r}")
        log(f"[dataplane] the train CLI on an image folder ({route}): "
            f"rc {rc}: {msg}")
        rec[route] = {"rc": rc, "message": msg}
    return rec


def time_train_step(torch, step_fn, state, images, labels, abn_counts,
                    what: str):
    """The train step on one staged batch: wall (host clock, median of 5),
    device time, busy share, images/s; the four ABN kernels 36 launches
    each a step and their device ms; the step by kernel family. Returns the
    record and the profiler's."""
    def rstep():
        return step_fn(state, images, labels)

    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    wall = host_ms(torch, rstep)
    label = "real-data train step"
    with DeviceTimer(torch, abn_counts) as timer:
        timer.run(label, rstep, reps=STEP_REPS)
    dev = timer.results()[label][0]
    check(timer.launched[label] == (ABN_SITES * STEP_REPS,) * 4,
          f"ABN launches over {STEP_REPS} steps: {timer.launched[label]}")
    bsz = images.shape[0]
    step = {"batch": bsz, "train_px": images.shape[1], "wall_ms": wall,
            "device_ms": dev, "device_busy": dev / wall,
            "images_per_s": bsz / wall * 1e3, "launches_per_step": ABN_SITES}
    for kind, part in (("k1", "fused_abn_fwd"),
                       *((k, p) for k, _, p, *_ in ABN_TRAIN_KERNELS)):
        ms, seen = timer.kernel_ms(label, part)
        check(seen <= ABN_SITES, f"{seen} {part} kernels a step")
        step[f"{kind}_x36_ms"] = ms
        step[f"{kind}_launches_seen_per_step"] = seen
    step["by_family"] = forward_families(*timer.per_kernel[label],
                                         families=TRAIN_FAMILIES)
    log(f"[timing] {what}: {json.dumps(step)}")
    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    return step, timer.record()


def write_cifar10(root: str, seed: int) -> str:
    """CIFAR-10's pickle layout (`cifar-10-batches-py/`: five train batches
    and `test_batch`) holding IF_CLASSES·IF_TRAIN train and IF_CLASSES·IF_VAL
    test images of random uint8 pixels with labels 0-9, made from `seed`.
    Returns the directory to pass as --train_dir."""
    import pickle

    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    n_train = IF_CLASSES * IF_TRAIN
    sizes = [n_train // 5 + (i < n_train % 5) for i in range(5)]
    for name, n in [(f"data_batch_{i + 1}", k) for i, k in enumerate(sizes)] + [
            ("test_batch", IF_CLASSES * IF_VAL)]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         "labels": rng.integers(0, 10, n).tolist()}, f)
    return root


def real_data_phases(torch, device, native, train_cli, serve_cli, checkpoint,
                     fused_abn, k1, wrappers, abn_counts, name,
                     source: str) -> dict:
    """Phases 16-19 on real-data input: `source` "imagefolder" (a fixture
    tree through the native dataplane) where the probe found libjpeg,
    else "cifar10" (CIFAR-10's pickle layout: raw uint8 pixels, no
    decoder; 32 px, 10 classes). The loader's images/s, the training path
    (2 epochs, then its step timed), a run stopped after epoch 0 and
    resumed, and the resumed checkpoint served."""
    from ddp_classification_pytorch_tpu_torch.train.loop import Trainer
    from ddp_classification_pytorch_tpu_torch.train.steps import (
        _train_flip_enabled,
        flip_mask,
        make_train_step,
    )

    out = {"source": source}
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        bsz = IF_BATCH
        if source == "imagefolder":
            from ddp_classification_pytorch_tpu_torch.data.imagefolder import (
                ImageFolderDataset,
            )

            train_dir, val_dir = fixture_tree(root)
            argv = IF_ARGV + ["--train_dir", train_dir, "--val_dir", val_dir]
            serve_argv = SERVE_ARGV
            ds = ImageFolderDataset.from_root(train_dir)
            px, what = IF_CROP, (f"native dataplane, JPEGs of ~500x375 to "
                                 f"RandomResizedCrop({IF_CROP})")

            def batcher(threads):
                b = native.NativeBatcher(ds, "baseline", True, IF_IMAGE,
                                         IF_CROP, seed=999, num_threads=threads,
                                         out_dtype="uint8")
                return lambda idx, k: b(idx, 0, k)
        else:
            from ddp_classification_pytorch_tpu_torch.data.cifar import (
                CIFARDataset,
            )
            from ddp_classification_pytorch_tpu_torch.data.loader import Loader
            from ddp_classification_pytorch_tpu_torch.data.transforms import (
                build_transform,
            )

            argv = CIFAR_ARGV + ["--train_dir", write_cifar10(root, 999)]
            serve_argv = [{"224": "32", "2173": "10"}.get(a, a)
                          for a in SERVE_ARGV]
            ds = CIFARDataset(root, True, build_transform(
                "cifar", True, 32, out_dtype="uint8"))
            px, what = 32, "CIFAR pickles, pad-4 random crop 32, numpy"

            def batcher(threads):
                ld = Loader(ds, bsz, num_workers=threads)
                return lambda idx, k: ld._load_batch(k, idx)

        # ------------------------------------------------ 16. loader --
        idx = np.random.default_rng(0).permutation(len(ds))
        rates = {}
        for threads, n in ((1, 4), (4, 8)):
            load = batcher(threads)
            images, _ = load(idx[:bsz], 0)
            check(images.shape == (bsz, px, px, 3) and images.dtype == np.uint8
                  and images.reshape(bsz, -1).any(axis=1).all(),
                  f"{source} batch {images.shape} {images.dtype}")
            t0 = time.perf_counter()
            for k in range(n):
                load(np.roll(idx, -bsz * k)[:bsz], k)
            rates[threads] = bsz * n / (time.perf_counter() - t0)
        out["loader"] = {"images_per_s_by_threads": rates,
                         "cpu_count": os.cpu_count(),
                         "what": f"{what}, uint8 wire, batch {bsz}"}
        log(f"[loader] {json.dumps(out['loader'])}")

        # ------------------------------- 17. the real-data training path --
        seen_straight = {}
        want = {"k1": 2 * ABN_SITES * (TRAIN_STEPS + EVAL_BATCHES),
                "k1s": 2 * ABN_SITES * TRAIN_STEPS,
                "k1r": 2 * ABN_SITES * TRAIN_STEPS,
                "k1d": 2 * ABN_SITES * TRAIN_STEPS}

        def then(trainer, ckpt):
            import glob

            d = os.path.dirname(ckpt)
            events = glob.glob(os.path.join(d, "tb", "events.out.tfevents.*"))
            check(len(events) == 1, f"tensorboard events: {events}")
            with open(os.path.join(d, "output.txt")) as f:
                check(("# native C++ dataplane active" in f.read())
                      == (source == "imagefolder"),
                      "output.txt and the dataplane line disagree")
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
            check(meta["last_epoch"] == 1, f"meta.json {meta}")
            # the masks the run's 16 steps drew (flip_mask of its seed)
            check(_train_flip_enabled(trainer.cfg), "the train flip is off")
            flipped = int(sum(flip_mask(trainer.cfg.run.seed, k, bsz).sum()
                              for k in range(2 * TRAIN_STEPS)))
            total = 2 * TRAIN_STEPS * bsz
            check(0 < flipped < total, f"{flipped} of {total} samples flipped")
            staged = trainer.train_prefetch
            return {"meta": meta, "flipped": flipped, "samples": total,
                    "input_wait_ms_per_step":
                        staged.waited_s / staged.batches * 1e3,
                    "first_batch_epoch1": seen_straight}

        fused_abn.FusedBNLeakyReLU.layout_copies = 0
        trainer, cfg, rec = train_main_path(
            torch, device, train_cli, checkpoint,
            argv + ["--epochs", "2", "--tensorboard"],
            dict(zip(("k1", "k1s", "k1r", "k1d"), wrappers)), want,
            f"{source}-train", then=then,
            before=lambda tr: first_batch_recorder(tr, seen_straight),
            files=("ckpt_e0.pt", "ckpt_best.pt", "ckpt_best.pt.sha256", "tb"))
        check(len(seen_straight) == 3, "the first step of epoch 1 not seen")
        # gradients copied into y's layout by the ABN Function (reported)
        rec["layout_copies"] = fused_abn.FusedBNLeakyReLU.layout_copies

        # the real-data step: wall, device time, the four ABN kernels
        it = iter(trainer.train_prefetch)
        images, labels = next(it)
        it.close()
        check(tuple(images.shape) == (bsz, px, px, 3), f"{images.shape}")
        rec["step"], rec["profiler"] = time_train_step(
            torch, trainer.train_step, trainer.state, images, labels,
            abn_counts, f"{name}: TResNet-M train step on {source} data, "
            f"batch {bsz} at {px} px, bf16")
        out["train"] = rec
        del trainer, images, labels
        if source != "imagefolder":
            # the main path's step shapes without a decoder: 256-px uint8
            # train crops of random pixels, the flip on (an image-folder
            # config), a fresh TResNet-M train state
            from ddp_classification_pytorch_tpu_torch.train.state import (
                create_train_state,
            )

            cfg = train_cli.config_from_args(train_cli.build_parser(
            ).parse_args(IF_ARGV + ["--train_dir", "unused"]))
            check(_train_flip_enabled(cfg), f"no flip at {IF_CROP} px")
            state = create_train_state(cfg, device, TRAIN_STEPS)
            gen = torch.Generator(device=device).manual_seed(5)
            images = torch.randint(0, 256, (bsz, IF_CROP, IF_CROP, 3),
                                   dtype=torch.uint8, device=device,
                                   generator=gen)
            labels = torch.randint(0, cfg.data.num_classes, (bsz,),
                                   device=device, generator=gen).int()
            step_fn = make_train_step(cfg)
            out["step_at_main_path_shapes"], out["profiler_main_shapes"] = \
                time_train_step(torch, step_fn, state, images, labels,
                                abn_counts, f"{name}: TResNet-M train step at "
                                f"the image-folder shapes (batch {bsz}, "
                                f"{IF_CROP}-px uint8 crops of random pixels, "
                                f"flip), bf16")
            del state, images, labels

        # ---------------------------------------------------- 18. resume --
        stopped, resumed = (tempfile.mkdtemp(prefix="chip_smoke_resume_")
                            for _ in range(2))
        try:
            def trainer_for(extra):
                return Trainer(train_cli.config_from_args(
                    train_cli.build_parser().parse_args(argv + extra)), device)

            t0 = time.perf_counter()
            trainer_for(["--epochs", "1", "--out", stopped]).run()
            ckpt0 = os.path.join(stopped, "ckpt_e0.pt")
            saved = checkpoint.restore(ckpt0)
            tr = trainer_for(["--epochs", "2", "--resume", ckpt0,
                              "--out", resumed])
            check(tr.start_epoch == 1, f"resumed at epoch {tr.start_epoch}")
            check(same_state(torch, tr.state.state_dict(), saved),
                  "the resumed state is not the saved one, bitwise")
            check(all(t.device.type == "cuda" and t.dtype == torch.float32
                      for st in tr.state.optimizer.state.values()
                      for t in st.values() if isinstance(t, torch.Tensor)),
                  "momentum not restored on the card in f32")
            seen_resumed = {}
            first_batch_recorder(tr, seen_resumed)
            last = tr.run()
            torch.cuda.synchronize()
            check(seen_resumed == seen_straight,
                  f"first batch after resume {seen_resumed} != the "
                  f"uninterrupted run's {seen_straight}")
            check(np.isfinite(last["loss"]) and last["step_ok"] == 1.0,
                  f"resumed epoch: {last}")
            with open(os.path.join(resumed, "history.json")) as f:
                hist = json.load(f)
            check(hist["loss"][0] is None and hist["loss"][1] is not None,
                  f"resumed history {hist['loss']}")
            ckpt1 = os.path.join(resumed, "ckpt_e1.pt")
            check(same_state(torch, checkpoint.restore(ckpt1),
                             tr.state.state_dict()), "ckpt_e1 after resume")
            out["resume"] = {"start_epoch": tr.start_epoch, "epoch1": last,
                             "restored_bitwise": True,
                             "first_batch_and_flip_equal": True,
                             "wall_s": time.perf_counter() - t0}
            log(f"[resume] {json.dumps(out['resume'])}")

            # ------------------------ 19. serving the resumed checkpoint --
            it = iter(tr.val_loader)
            val_images = next(it)[0][:8]
            it.close()
            out["serve"] = serve_trained_checkpoint(
                torch, fused_abn, device, serve_cli, k1, tr, ckpt1, val_images,
                serve_argv)
            log(f"[resume] served {json.dumps(out['serve'])}")
        finally:
            shutil.rmtree(stopped, ignore_errors=True)
            shutil.rmtree(resumed, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def resnet_step_timing(torch, device, train_cli, card: str) -> dict:
    """Phase 21: the ResNet-50 train step at batch RESNET_STEP_BATCH, bf16,
    224 px, uint8 wire: wall (host clock, median of 5), device time, busy
    share, images/s, kernel launches a step, the step's device time by
    kernel family (convolutions by name, the rest), and the 53 BN sites'
    forward and backward in a row outside the step (plain PyTorch, as the
    step runs them) at the step's shapes; the convolutions' tensor-core
    bound (their operations, forward and both backward products, over the
    bf16 peak). `card` (name and power limit, as nvidia-smi gives them)
    heads the printed line."""
    from ddp_classification_pytorch_tpu_torch.models.batchnorm import BatchNorm
    from ddp_classification_pytorch_tpu_torch.train.state import create_train_state
    from ddp_classification_pytorch_tpu_torch.train.steps import make_train_step

    n = RESNET_STEP_BATCH
    argv = list(RESNET_TRAIN_ARGV)
    argv[argv.index("--batchsize") + 1] = str(n)
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(argv))
    state = create_train_state(cfg, device, 1)
    step_fn = make_train_step(cfg)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(
        0, 256, (n, 224, 224, 3), dtype=np.uint8)).to(device)
    labels = torch.from_numpy(
        rng.integers(0, cfg.data.num_classes, n).astype(np.int32)).to(device)

    def rstep():
        return step_fn(state, images, labels)

    # the shapes the step gives each BN and conv, from hooks on one forward
    bn_in, conv_ops = [], [0]
    bns = [m for m in state.model.modules() if isinstance(m, BatchNorm)]
    check(len(bns) == RESNET_BNS, f"{len(bns)} BatchNorms in ResNet-50")

    def conv_hook(m, args, out):
        k = m.weight[0].numel()  # Cin·kh·kw
        # forward, plus dgrad and wgrad (no dgrad for the stem's input)
        products = 2 if m is state.model.backbone.conv1 else 3
        conv_ops[0] += products * 2 * out.numel() * k

    hooks = [m.register_forward_pre_hook(
        lambda _m, args: bn_in.append(tuple(args[0].shape))) for m in bns]
    hooks += [m.register_forward_hook(conv_hook) for m in state.model.modules()
              if isinstance(m, torch.nn.Conv2d)]
    m = rstep()
    for hk in hooks:
        hk.remove()
    check(float(m["step_ok"]) == 1.0, "ResNet-50 timing step skipped")
    # the 53 BN sites alone: forward then backward, in the step's dtype
    gen = torch.Generator(device=device).manual_seed(5)
    sites = []
    for bn, shape in zip(bns, bn_in):
        b, c, h, w = shape
        x = torch.randn((b, h, w, c), device=device, generator=gen).to(
            torch.bfloat16).permute(0, 3, 1, 2).requires_grad_()
        sites.append((bn, x, torch.randn_like(x)))

    def bn_chain():
        for bn, x, g in sites:
            bn(x).backward(g)

    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    wall = host_ms(torch, rstep)
    with DeviceTimer(torch) as timer:
        timer.run("resnet50 train step", rstep, reps=STEP_REPS)
        timer.run("resnet50 BN chain", bn_chain, reps=STEP_REPS)
    res = timer.results()
    dev = res["resnet50 train step"][0]
    check(res["resnet50 train step"][1] is not None,
          "torch.profiler recorded no kernel of the ResNet-50 step")
    fam = forward_families(*timer.per_kernel["resnet50 train step"],
                           families=TRAIN_FAMILIES[4:])
    conv_ms = fam["convolutions"]["ms"]
    bn_ms = res["resnet50 BN chain"][0]
    launches = len(res["resnet50 train step"][1]) / STEP_REPS
    rec = {"batch": n, "px": 224, "dtype": "bfloat16", "wall_ms": wall,
           "device_ms": dev, "device_busy": dev / wall,
           "images_per_s": n / wall * 1e3, "launches_per_step": launches,
           "by_family": {
               "convolutions": fam["convolutions"],
               "bn_statistics_and_normalisation_alone": {
                   "ms": bn_ms, "sites": RESNET_BNS,
                   "launches": (len(res["resnet50 BN chain"][1]) / STEP_REPS
                                if res["resnet50 BN chain"][1] else None)},
               "rest": {"ms": dev - conv_ms - bn_ms},
               "non_convolution_in_step": fam["rest"],
               "rest_largest_ms": fam["rest_largest_ms"]},
           "conv_operations": conv_ops[0],
           "conv_bound_ms": conv_ops[0] / BF16_OPS_PER_S * 1e3,
           "profiler": timer.record()}
    log(f"[timing] {card}: ResNet-50 train step, batch {n}, bf16, 224 px "
        f"(bn_statistics_and_normalisation_alone: the 53 BN sites' forward "
        f"and backward in a row outside the step, at its shapes; rest: the "
        f"step less the convolutions and that): {json.dumps(rec)}")
    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    return rec


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_group(cmd, timeout_s: float):
    """Run `cmd` in a session of its own; on the time limit the whole
    group (torchrun and its workers) is killed. Returns (rc, out, err)."""
    import signal

    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise RuntimeError(f"chip_smoke: {cmd[:6]} ran past {timeout_s} s:\n"
                           f"{out[-2000:]}\n{err[-2000:]}") from None
    return proc.returncode, out, err


def ddp_vs_plain(torch, checkpoint, argv=DDP_ARGV, torchrun_extra=(),
                 tag="ddp") -> dict:
    """Phase 22: DDP_ARGV as a plain process and under `python -m
    torch.distributed.run --nproc_per_node 1` (NCCL, world 1), same seed
    and data: each epoch's (= step's) loss and the last checkpoint's
    parameters and running statistics bitwise equal (the largest
    difference is reported). The torchrun run must report `ddp=nccl`:
    nothing falls back to the plain process. Phase 32 (c) runs it on
    `argv` with `torchrun_extra` given to the torchrun run only."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    mod = ["-m", "ddp_classification_pytorch_tpu_torch.cli.train"]
    cmds = {"plain": [sys.executable] + mod,
            "torchrun": [sys.executable, "-m", "torch.distributed.run",
                         "--nproc_per_node", "1", "--master_addr",
                         "127.0.0.1", "--master_port", str(free_port())] + mod}
    extra = {"plain": [], "torchrun": list(torchrun_extra)}
    runs = {}
    try:
        for kind, cmd in cmds.items():
            out = os.path.join(tmp, kind)
            t0 = time.perf_counter()
            rc, stdout, stderr = run_group(
                cmd + argv + extra[kind] + ["--out", out], 600)
            check(rc == 0, f"[{tag}] {kind} run: rc {rc}\n{stdout[-3000:]}\n"
                           f"{stderr[-3000:]}")
            with open(os.path.join(out, "history.json")) as f:
                losses = json.load(f)["loss"]
            runs[kind] = {"wall_s": time.perf_counter() - t0,
                          "banner": next(ln for ln in stdout.splitlines()
                                         if ln.startswith("[trainer] workload")),
                          "losses": losses,
                          "state": checkpoint.restore(os.path.join(
                              out, f"ckpt_e{DDP_STEPS - 1}.pt"))}
            log(f"[{tag}] {kind}: {runs[kind]['banner']}; losses {losses}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    plain, tr = runs["plain"], runs["torchrun"]
    check("world=1 ddp=nccl" in tr["banner"],
          f"torchrun run not over NCCL: {tr['banner']}")
    check("world=1 ddp=off" in plain["banner"],
          f"plain run joined a group: {plain['banner']}")
    check(len(plain["losses"]) == len(tr["losses"]) == DDP_STEPS,
          f"losses {plain['losses']} / {tr['losses']}")
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(tr["losses"], plain["losses"]))
    a, b = plain["state"], tr["state"]
    check((a["step"], a["opt_count"]) == (b["step"], b["opt_count"])
          == (DDP_STEPS, DDP_STEPS), "step counts differ")
    keys = [k for k in a["model"] if k.startswith("backbone.")]
    check(sorted(a["model"]) == sorted(b["model"]) and len(keys) == len(
        a["model"]), "checkpoint keys differ (or carry a module. prefix)")
    diffs = {k: (a["model"][k].float() - b["model"][k].float()).abs().max().item()
             for k in keys}
    worst = max(diffs, key=diffs.get)
    bitwise = all(torch.equal(a["model"][k], b["model"][k]) for k in keys)
    rec = {"loss_max_rel_diff": loss_rel, "state_max_abs_diff": diffs[worst],
           "state_worst_tensor": worst, "bitwise_equal": bitwise,
           "losses_plain": plain["losses"], "losses_torchrun": tr["losses"],
           "wall_s": {k: r["wall_s"] for k, r in runs.items()},
           "banners": {k: r["banner"] for k, r in runs.items()}}
    log(f"[{tag}] torchrun (world 1, NCCL) vs plain: {json.dumps(rec)}")
    # bitwise, as measured on an NVIDIA H100: a limit of 1e-4 would let a
    # world-1 group that perturbs the step pass
    check(loss_rel == 0.0, f"per-step losses differ by {loss_rel} relatively")
    check(bitwise, f"final state differs by up to {diffs[worst]} ({worst})")
    return rec


def head_main_path(torch, device, train_cli, serve_cli, checkpoint,
                   fused_abn, k1, counters, workload) -> dict:
    """Phases 23-25: `workload`'s cli/train.py sequence (HEAD_ARGV) through
    `train_main_path` with every kernel's count 0; arcface and nested then
    serve the checkpoint (`serve_trained_checkpoint`), cdr holds one
    step's mask on the card against the CPU after the epoch
    (`cdr_mask_vs_cpu`); nested records the k each step drew (`nested_k`
    at its step, as the flip masks come from `flip_mask`) and its best K."""
    from ddp_classification_pytorch_tpu_torch.ops.nested import nested_k

    def then(tr, ckpt):
        if workload == "cdr":
            return {"cdr_mask": cdr_mask_vs_cpu(torch, tr, device)}
        return serve_trained_checkpoint(
            torch, fused_abn, device, serve_cli, k1, tr, ckpt,
            np.stack([tr.val_ds[i][0] for i in range(8)]),
            [workload if a == "baseline" else a for a in RESNET_SERVE_ARGV],
            k1_per_forward=0)

    trainer, cfg, rec = train_main_path(
        torch, device, train_cli, checkpoint, HEAD_ARGV[workload],
        counters, dict.fromkeys(counters, 0), f"{workload}-train", then,
        ckpt_name="ckpt_best.pt" if workload == "nested" else None)
    m = cfg.model
    if workload == "arcface":
        check((m.head, m.arc_embed_dim, m.arc_s, m.arc_m, m.arc_easy_margin,
               cfg.optim.optimizer, cfg.optim.lr, trainer.state.model.margin
               .weight.shape) == ("arcface", 256, 30.0, 0.5, True, "adam",
                                  1e-3, (cfg.data.num_classes, 256)),
              "arcface: not the preset's head and optimizer")
    if workload == "cdr":
        check((cfg.optim.grad_transform, cfg.optim.noise_rate,
               cfg.data.num_classes, cfg.optim.optimizer, cfg.optim.lr)
              == ("cdr", 0.2, 100, "sgd", 0.1), "cdr: not the preset")
    if workload == "nested":
        best = rec["epoch"]["best_k"]
        check(m.freeze_bn and m.nested_std == 100.0 and cfg.run.eval_first,
              "nested: not the preset")
        check(0 <= best <= 2047, f"nested: best_k {best}")
        ks = [nested_k(cfg.run.seed, s, trainer.state.model.feat_dim,
                       m.nested_std) for s in range(trainer.state.step)]
        check(len(ks) == TRAIN_STEPS and len(set(ks)) > 1,
              f"nested: k over the steps {ks}")
        rec["ks"] = ks
    del trainer
    torch.cuda.empty_cache()
    return rec


def _grads_of_one_batch(torch, model, images, labels):
    """One training forward and backward of `model` (no update)."""
    import torch.nn.functional as F

    from ddp_classification_pytorch_tpu_torch.train.steps import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        device_input_epilogue,
    )

    dev = images.device
    mean, std = (torch.from_numpy(a).view(1, 3, 1, 1).to(dev)
                 for a in (IMAGENET_MEAN, IMAGENET_STD))
    model.train()
    model.zero_grad(set_to_none=True)
    x = device_input_epilogue(images.permute(0, 3, 1, 2), mean, std)
    F.cross_entropy(model(x).float(), labels.long()).backward()
    return [p for p in model.parameters()]


def cdr_mask_vs_cpu(torch, trainer, device) -> dict:
    """Phase 24's mask check, after the timed epoch: the gradients of one
    training forward and backward of the trained model on a batch of the
    run's size (uint8 pixels from the seed), masked by `cdr_mask_` at the
    step's ratio and clip on the card and, copied to the CPU first, by the
    same plain function there. The share of the selected elements (2-D and
    4-D) whose |g·v| reaches the card's threshold is 1 − noise rate within
    CDR_KEEP_TOL, and the CPU gives the card's threshold and masked
    gradients bitwise."""
    from ddp_classification_pytorch_tpu_torch.ops.cdr import (
        cdr_clip,
        cdr_mask_,
        cdr_metric,
    )

    cfg, state = trainer.cfg, trainer.state
    o, n = cfg.optim, cfg.data.batch_size
    rng = np.random.default_rng(cfg.run.seed)
    images = torch.from_numpy(rng.integers(
        0, 256, (n, 224, 224, 3), dtype=np.uint8)).to(device)
    labels = torch.from_numpy(rng.integers(
        0, cfg.data.num_classes, n).astype(np.int32)).to(device)
    params = _grads_of_one_batch(torch, state.model, images, labels)
    pairs = [(p.detach(), p.grad) for p in params if p.grad is not None]
    ratio = 1.0 - o.noise_rate
    clip = cdr_clip(o.noise_rate, o.num_gradual, o.cdr_dead_schedule,
                    state.opt_count, state.steps_per_epoch)
    host = [(v.to("cpu", copy=True), g.to("cpu", copy=True))
            for v, g in pairs]
    metric = cdr_metric(pairs)
    thresh = cdr_mask_(pairs, ratio, clip)
    keep = (metric >= thresh).sum().item() / metric.numel()
    t0 = time.perf_counter()
    host_thresh = cdr_mask_(host, ratio, clip)
    cpu_s = time.perf_counter() - t0
    same = torch.equal(thresh.cpu(), host_thresh) and all(
        torch.equal(g.cpu(), h) for (_, g), (_, h) in zip(pairs, host))
    state.model.zero_grad(set_to_none=True)
    rec = {"selected_elements": metric.numel(), "ratio": ratio, "clip": clip,
           "threshold": thresh.item(), "kept_share": keep,
           "card_equals_cpu_bitwise": same, "cpu_mask_s": cpu_s}
    log(f"[cdr-train] one step's mask, card vs CPU: {json.dumps(rec)}")
    check(abs(keep - ratio) <= CDR_KEEP_TOL,
          f"cdr: kept share {keep}, expected {ratio}")
    check(same, "cdr: the card's mask differs from the CPU's")
    return rec


def head_step_timing(torch, device, train_cli, workload: str,
                     card: str) -> dict:
    """The workload's train step at its preset batch (HEAD_STEP_BATCH),
    bf16, 224 px, uint8 wire: wall (host clock, median of 5), device time,
    busy share, images/s, launches a step; and the device ms of what the
    workload adds: the ArcFace head's forward and backward (embedding,
    margin, CE) at the batch's embedding; CDR's mask of one step's
    gradients (|g·v| and its concatenation, the sort for the threshold,
    the masking) against its byte bound; the nested all-K sweep of one
    eval batch (NESTED_EVAL_BATCH) against its bound and beside the bytes
    its (B, 128, C) tiles move."""
    import torch.nn.functional as F

    from ddp_classification_pytorch_tpu_torch.ops import cdr as cdr_ops
    from ddp_classification_pytorch_tpu_torch.ops.nested import (
        nested_all_k_counts,
    )
    from ddp_classification_pytorch_tpu_torch.train.state import create_train_state
    from ddp_classification_pytorch_tpu_torch.train.steps import make_train_step

    n = HEAD_STEP_BATCH[workload]
    argv = list(HEAD_ARGV[workload])
    argv[argv.index("--batchsize") + 1] = str(n)
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(argv))
    state = create_train_state(cfg, device, 1)
    step_fn = make_train_step(cfg)
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(
        0, 256, (n, 224, 224, 3), dtype=np.uint8)).to(device)
    labels = torch.from_numpy(
        rng.integers(0, cfg.data.num_classes, n).astype(np.int32)).to(device)

    def rstep():
        return step_fn(state, images, labels)

    check(float(rstep()["step_ok"]) == 1.0, f"{workload} timing step skipped")
    model = state.model
    gen = torch.Generator(device=device).manual_seed(7)
    extra, bounds = {}, {}
    if workload == "arcface":
        feats = torch.randn(n, model.backbone.num_features, device=device,
                            generator=gen).requires_grad_()

        def head():
            F.cross_entropy(model.margin(model.embedding(feats), labels),
                            labels.long()).backward()

        extra["arcface head forward+backward"] = head
    if workload == "cdr":
        params = _grads_of_one_batch(torch, model, images, labels)
        pairs = [(p.detach(), p.grad.clone()) for p in params]
        metric = cdr_ops.cdr_metric(pairs)
        sel = metric.numel()
        extra["cdr |g·v| and concatenation"] = lambda: cdr_ops.cdr_metric(pairs)
        extra["cdr threshold (sort)"] = lambda: cdr_ops.cdr_threshold(metric, 0.8)
        extra["cdr mask, whole"] = lambda: cdr_ops.cdr_mask_(pairs, 0.8, 0.8)
        # read v and g once, write the masked g once
        bounds["cdr mask, whole"] = {
            "bytes": 3 * sel * 4, "bound_by": "bytes",
            "bound_ms": 3 * sel * 4 / HBM_BYTES_PER_S * 1e3,
            "selected_elements": sel}
    if workload == "nested":
        b = NESTED_EVAL_BATCH
        model.eval()
        with torch.no_grad():
            from ddp_classification_pytorch_tpu_torch.train.steps import (
                IMAGENET_MEAN,
                IMAGENET_STD,
                device_input_epilogue,
            )
            mean, std = (torch.from_numpy(a).view(1, 3, 1, 1).to(device)
                         for a in (IMAGENET_MEAN, IMAGENET_STD))
            feats = model.features(device_input_epilogue(
                images[:b].permute(0, 3, 1, 2), mean, std))
        w = model.classifier_weight.detach()
        c, d = w.shape
        valid = torch.ones(b, device=device)

        def sweep():
            with torch.no_grad():
                return nested_all_k_counts(feats, w, labels[:b], 128, valid)

        extra["nested all-K sweep, eval batch"] = sweep
        # per (row, K, class): the product, the running sum, the carry,
        # the compare and the finite test; inputs read once, (D,) counts out
        ops = 5 * b * d * c
        nbytes = (b * d + c * d) * 4 + b * 8 + 2 * d * 4
        tile = b * 128 * c * 4
        bounds["nested all-K sweep, eval batch"] = {
            "operations": ops, "bytes": nbytes,
            "bound_ms": max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": ("operations" if ops / F32_OPS_PER_S
                         > nbytes / HBM_BYTES_PER_S else "bytes"),
            "tile_bytes": tile, "blocks": d // 128,
            # one pass over every block's (B, 128, C) f32 tile
            "one_tile_pass_ms": tile * (d // 128) / HBM_BYTES_PER_S * 1e3,
            "batch": b}
    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    wall = host_ms(torch, rstep)
    label = f"{workload} train step"
    with DeviceTimer(torch) as timer:
        timer.run(label, rstep, reps=STEP_REPS)
        for name, fn in extra.items():
            timer.run(name, fn, reps=STEP_REPS)
    res = timer.results()
    dev = res[label][0]
    check(res[label][1] is not None,
          f"torch.profiler recorded no kernel of the {workload} step")
    rec = {"batch": n, "px": 224, "dtype": "bfloat16", "wall_ms": wall,
           "device_ms": dev, "device_busy": dev / wall,
           "images_per_s": n / wall * 1e3,
           "launches_per_step": len(res[label][1]) / STEP_REPS,
           "parts_ms": {name: res[name][0] for name in extra},
           "parts_launches": {name: (len(res[name][1]) / STEP_REPS
                                     if res[name][1] else None)
                              for name in extra},
           "bounds": bounds, "profiler": timer.record()}
    log(f"[timing] {card}: {workload} train step, batch {n}, bf16, 224 px: "
        f"{json.dumps(rec)}")
    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    del state
    torch.cuda.empty_cache()
    return rec


def plc_main_path(torch, device, train_cli, serve_cli, checkpoint, fused_abn,
                  k1, counters) -> dict:
    """Phase 26: `cli/train.py plc`'s sequence (PLC_ARGV: PLCTrainer, two
    epochs, warmup 1) through `train_main_path` with every kernel's count
    0; then, before its directory goes: the correction's record
    (`corrected`, `delta`) and `plc_labels.npy` (512 labels); the ordered
    pass's logits in dataset order against the eval forward of the same
    images in the same batches on the card (PLC_LOGIT_TOL); `--auto_resume
    --epochs 3` restores the saved labels and δ; `cli/serve.py plc --ckpt`
    answers 8 requests with the trainer's top-5."""
    from ddp_classification_pytorch_tpu_torch.train.plc_loop import PLCTrainer
    from ddp_classification_pytorch_tpu_torch.train.steps import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        device_input_epilogue,
    )

    def then(tr, ckpt):
        out = os.path.dirname(ckpt)
        labels = np.load(os.path.join(out, "plc_labels.npy"))
        with open(os.path.join(out, "meta.json")) as f:
            saved_delta = json.load(f)["plc_delta"]
        check(labels.shape == (PLC_N,) and np.array_equal(
            labels, tr.train_ds.labels), f"plc_labels.npy: {labels.shape}")
        check(saved_delta == tr.delta, f"meta δ {saved_delta} != {tr.delta}")
        # the ordered pass against the plain eval forward, batch by batch
        t0 = time.perf_counter()
        f_x = tr.predict_train_logits()
        pass_s = time.perf_counter() - t0
        mean, std = (torch.from_numpy(a).view(1, 3, 1, 1).to(device)
                     for a in (IMAGENET_MEAN, IMAGENET_STD))
        model, b = tr.state.model.eval(), tr.cfg.data.batch_size
        err, bitwise = 0.0, True
        with torch.no_grad():
            for start in range(0, PLC_N, b):
                imgs = np.stack([tr.train_ds[i][0]
                                 for i in range(start, start + b)])
                x = torch.from_numpy(imgs).to(device).permute(0, 3, 1, 2)
                want = model(device_input_epilogue(x, mean, std)).float().cpu()
                got = torch.from_numpy(f_x[start:start + b]).float()
                err = max(err, (got - want).abs().max().item())
                bitwise = bitwise and torch.equal(got, want)
        check(f_x.shape == (PLC_N, PLC_CLASSES) and err <= PLC_LOGIT_TOL,
              f"plc: ordered pass {f_x.shape} off the eval forward by {err}")
        # --auto_resume --epochs 3: the labels and δ come back, no injection
        argv = PLC_ARGV + ["--out", out, "--epochs", "3", "--auto_resume"]
        cfg = train_cli.config_from_args(
            train_cli.build_parser().parse_args(argv))
        again = PLCTrainer(cfg, device)
        check(again.start_epoch == 2 and again.delta == saved_delta
              and np.array_equal(again.train_ds.labels, labels)
              and again.injected == 0,
              f"plc: auto-resume at epoch {again.start_epoch}, δ {again.delta}")
        del again
        served = serve_trained_checkpoint(
            torch, fused_abn, device, serve_cli, k1, tr, ckpt,
            np.stack([tr.val_ds[i][0] for i in range(8)]),
            ["plc" if a == "baseline" else str(PLC_CLASSES)
             if a == "2173" else a for a in RESNET_SERVE_ARGV],
            k1_per_forward=0)
        return {"plc_labels": int(labels.shape[0]), "plc_delta": saved_delta,
                "ordered_pass_s": pass_s, "ordered_pass_max_abs_err": err,
                "ordered_pass_bitwise": bitwise, "resumed_epoch": 2,
                "resumed_delta": saved_delta} | served

    trainer, cfg, rec = train_main_path(
        torch, device, train_cli, checkpoint, PLC_ARGV, counters,
        dict.fromkeys(counters, 0), "plc-train", then,
        files=("plc_labels.npy",), trainer_cls=PLCTrainer)
    last = rec["epoch"]
    check("corrected" in last and "delta" in last
          and len(trainer.corrections_per_epoch) == 1,
          f"plc: no correction record in {last}")
    check((cfg.plc.correction, cfg.data.num_classes, cfg.optim.lr,
           cfg.optim.milestones) == ("lrt", 14, 0.01, (10, 20)),
          "plc: not the preset")
    rec["corrections_per_epoch"] = trainer.corrections_per_epoch
    del trainer
    torch.cuda.empty_cache()
    return rec


def plc_noise_and_timing(torch, device, train_cli, card: str) -> dict:
    """Phase 26's second half. The η probe (`eta_approximation`) fit on the
    card on (512, 2048) features from the seed with 14 classes, against
    the same fit on the CPU from the same init (PLC_ETA_TOL); a PLCTrainer
    with type-1 noise injected from the card's η: its count and labels
    equal the CPU's `label_noise` on that η bitwise. Then the timings: the
    ordered pass's step at the preset's batch (device ms a batch, wall ms,
    images/s) and the whole pass over the set through the loader; the
    probe fit; the host ms of `lrt_correction` (and the softmax before
    it) and of `prob_correction` on (PLC_HOST_ROWS, 14) f32 logits."""
    from ddp_classification_pytorch_tpu_torch.data.synthetic import (
        SyntheticDataset,
    )
    from ddp_classification_pytorch_tpu_torch.ops import labelnoise as ln
    from ddp_classification_pytorch_tpu_torch.train.plc_loop import PLCTrainer
    from ddp_classification_pytorch_tpu_torch.train.steps import make_predict_step

    rng = np.random.default_rng(26)
    feats = rng.normal(size=(PLC_N, PLC_FEATURES)).astype(np.float32)
    ys = rng.integers(0, PLC_CLASSES, PLC_N)
    init = {k: v.numpy() for k, v in
            ln.probe_init(PLC_FEATURES, PLC_CLASSES, 0, seed=77).items()}
    fit = lambda dev: ln.eta_approximation(  # noqa: E731
        feats, ys, PLC_CLASSES, device=dev, init=init)
    eta_card = fit(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eta_card = fit(device)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    eta_cpu = fit(torch.device("cpu"))
    fit_cpu_ms = (time.perf_counter() - t0) * 1e3
    eta_err = float(np.abs(eta_card - eta_cpu).max())
    check(eta_card.shape == (PLC_N, PLC_CLASSES) and eta_err <= PLC_ETA_TOL,
          f"plc: η on the card off the CPU's by {eta_err}")
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
        PLC_ARGV + ["--out", tempfile.mkdtemp(prefix="chip_smoke_plc_")]))
    cfg.plc.noise_type, cfg.run.write_records = 1, False
    try:
        tr = PLCTrainer(cfg, device, eta=eta_card)
        clean = SyntheticDataset(PLC_N, 224, PLC_CLASSES,
                                 seed=cfg.run.seed).labels
        want, _, count = ln.label_noise(clean, eta_card, 1, cfg.plc.noise_factor,
                                        np.random.default_rng(cfg.run.seed))
        check(tr.injected == count > 0 and np.array_equal(
            tr.train_ds.labels, want), f"plc: injected {tr.injected}, the "
            f"CPU's label_noise {count}")
        # the ordered pass at the preset's batch: one resident batch, then
        # the whole set through the loader and the prefetcher
        tr.cfg.data.batch_size = PLC_STEP_BATCH
        step = make_predict_step(tr.cfg)
        imgs = torch.from_numpy(rng.integers(
            0, 256, (PLC_STEP_BATCH, 224, 224, 3), dtype=np.uint8)).to(device)
        one = lambda: step(tr.state, imgs)  # noqa: E731
        wall = host_ms(torch, one)
        label = "plc ordered pass, one batch"
        with DeviceTimer(torch) as timer:
            timer.run(label, one, reps=STEP_REPS)
        res = timer.results()
        check(res[label][1] is not None,
              "torch.profiler recorded no kernel of the ordered pass")
        dev = res[label][0]
        tr.predict_train_logits()  # the loader's first pass, untimed
        t0 = time.perf_counter()
        tr.predict_train_logits()
        whole_s = time.perf_counter() - t0
        injected = tr.injected
        del tr
    finally:
        shutil.rmtree(cfg.run.out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    logits = np.random.default_rng(27).normal(
        0, 2, (PLC_HOST_ROWS, PLC_CLASSES)).astype(np.float32)
    labels = np.random.default_rng(28).integers(0, PLC_CLASSES, PLC_HOST_ROWS)

    def softmax():
        z = logits - logits.max(axis=1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=1, keepdims=True)
        return p

    def host(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    p = softmax()
    rec = {"eta_max_abs_err": eta_err, "eta_fit_card_ms": fit_ms,
           "eta_fit_cpu_ms": fit_cpu_ms, "injected": injected,
           "injected_equals_cpu": True,
           "ordered_pass_batch": PLC_STEP_BATCH,
           "ordered_pass_device_ms": dev, "ordered_pass_wall_ms": wall,
           "ordered_pass_device_busy": dev / wall,
           "ordered_pass_images_per_s": PLC_STEP_BATCH / wall * 1e3,
           "ordered_pass_launches": len(res[label][1]) / STEP_REPS,
           "whole_pass_images": PLC_N, "whole_pass_s": whole_s,
           "whole_pass_images_per_s": PLC_N / whole_s,
           "host_rows": PLC_HOST_ROWS,
           "host_softmax_ms": host(softmax),
           "host_lrt_correction_ms": host(
               lambda: ln.lrt_correction(labels, p, 0.3, 0.1)),
           "host_prob_correction_ms": host(
               lambda: ln.prob_correction(labels, logits,
                                          np.random.default_rng(0))),
           "profiler": timer.record()}
    log(f"[timing] {card}: plc ordered pass and corrections: "
        f"{json.dumps(rec)}")
    return rec


# phase 27: the HTTP serve path in process (serve/http.py over the engine,
# the checkpoint watcher, a fleet member and admission control), TResNet-M
# as phase 4 serves it, over phase 12's checkpoint; then the CLI with
# --watch --port as a subprocess, and ViT-B/16 served through K2
HTTP_ARGV = SERVE_ARGV[:SERVE_ARGV.index("--selfcheck")] + ["--device", "cuda"]
HTTP_CLIENTS, HTTP_REQUESTS = 4, 16  # (b): 8 JPEGs of 500x375, 8 PNGs
HTTP_WARM = 8  # sequential requests first: admission's measured rate
HTTP_BURST, HTTP_BURST_QUEUE = 64, 4  # (e)
HTTP_TOL = 1e-2  # served vs direct probabilities, bf16
HTTP_DEADLINE_MS = 60000  # the main server's admission deadline: no shed
HTTP_TIMED = {1: 32, 8: 64}  # (g): requests at each client concurrency
HTTP_FAMILIES = ("serve_", "engine_", "watcher_", "fleet_", "admission_")
VIT_SERVE_ARGV = ["baseline", "--model", "vit_b16", "--image_size", "512",
                  "--num_classes", "1000", "--dtype", "bfloat16",
                  "--input_dtype", "uint8", "--buckets", "1,2,4,8",
                  "--max_batch", "8", "--selfcheck", "8", "--device", "cuda"]
VIT_SERVE_TOL = 1e-2  # K2 vs its plain version, served probabilities, bf16


def http_images(seed: int):
    """(kind, encoded bytes) of HTTP_REQUESTS images made from `seed` with
    PIL: 8 JPEGs of 500x375 (the fixture images' size) and 8 non-square
    PNGs, the first grayscale, the second RGBA."""
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)

    def picture(w, h):
        smooth = rng.integers(0, 256, (6, 8, 3)).astype(np.uint8)
        arr = np.asarray(Image.fromarray(smooth).resize((w, h), Image.BILINEAR))
        noise = rng.integers(-16, 17, arr.shape)
        return np.clip(arr.astype(np.int16) + noise, 0, 255).astype(np.uint8)

    out = []
    for i in range(HTTP_REQUESTS):
        buf = io.BytesIO()
        if i < HTTP_REQUESTS // 2:
            Image.fromarray(picture(500, 375)).save(buf, format="JPEG",
                                                    quality=90)
            out.append(("jpeg", buf.getvalue()))
            continue
        j = i - HTTP_REQUESTS // 2
        img = Image.fromarray(picture(300 + 24 * j, 260 + 10 * j))
        if j == 0:
            img = img.convert("L")
        elif j == 1:
            img.putalpha(Image.fromarray(picture(*img.size)[..., 0]))
        img.save(buf, format="PNG")
        out.append((img.mode, buf.getvalue()))
    return out


def pil_wire(data: bytes, transform) -> np.ndarray:
    """The smoke's own decode: PIL to RGB, then the port's val transform."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    return transform(np.asarray(img, np.uint8), np.random.default_rng(0))


def http_call(base: str, method: str, path: str, body=None, headers=None):
    """(status, Retry-After, JSON body or text, client ms) of one request."""
    import urllib.request
    from urllib.error import HTTPError

    req = urllib.request.Request(base + path, data=body, method=method,
                                 headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, hdrs, raw = r.status, r.headers, r.read()
    except HTTPError as e:
        code, hdrs, raw = e.code, e.headers, e.read()
    ms = (time.perf_counter() - t0) * 1e3
    payload = (json.loads(raw) if hdrs.get("Content-Type") == "application/json"
               else raw.decode())
    return code, hdrs.get("Retry-After"), payload, ms


def pil_route(data: bytes, resize: int, crop: int) -> np.ndarray:
    """A yardstick for the host's per-image work, not the port's route:
    PIL's own decode, BILINEAR resize of the shorter side and center crop
    in C (the JAX front end's `resize_center_crop`, `transforms.py:83-91`
    there)."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    w, h = img.size
    nw, nh = ((resize, int(h * resize / w)) if w < h
              else (int(w * resize / h), resize))
    img = img.resize((nw, nh), Image.BILINEAR)
    x, y = (nw - crop) // 2, (nh - crop) // 2
    return np.asarray(img.crop((x, y, x + crop, y + crop)), np.uint8)


def nearest_rank(values, q: float) -> float:
    s = sorted(values)
    return float(s[int(round(q / 100 * (len(s) - 1)))])


def wait_for(cond, timeout_s: float, what: str):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise RuntimeError(f"chip_smoke: timed out after {timeout_s} s waiting "
                       f"for {what}")


def serve_http_phase(torch, device, serve_cli, checkpoint, counters, root,
                     card, name) -> dict:
    """Phase 27 (a)-(g): the in-process server over phase 12's checkpoint
    in `root`/run; returns the record (with `launches`: every counter's
    rise over (a)-(e))."""
    from ddp_classification_pytorch_tpu_torch.data.transforms import (
        build_transform,
    )
    from ddp_classification_pytorch_tpu_torch.serve import http as http_mod
    from ddp_classification_pytorch_tpu_torch.serve.engine import ServingEngine
    from ddp_classification_pytorch_tpu_torch.serve.fleet import (
        AdmissionController,
        wave_token_path,
    )
    from ddp_classification_pytorch_tpu_torch.serve.metrics import ServeMetrics
    from ddp_classification_pytorch_tpu_torch.train.state import (
        create_served_model,
    )
    from ddp_classification_pytorch_tpu_torch.train.steps import (
        make_topk_predict_step,
    )

    run, fleet_dir = os.path.join(root, "run"), os.path.join(root, "fleet")
    src = os.path.join(run, "ckpt_e0.pt")
    digest0 = checkpoint.file_digest(src)
    port = free_port()
    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(
        HTTP_ARGV + ["--watch", run, "--port", str(port), "--reload_poll_s",
                     "0.2", "--fleet_dir", fleet_dir,
                     "--admission_deadline_ms", str(HTTP_DEADLINE_MS),
                     "--admission_tenants", "a:3,b:1"]))
    h, k = cfg.data.image_size, cfg.serve.topk
    transform = build_transform("baseline", train=False, image_size=h,
                                crop_size=cfg.data.train_crop_size,
                                out_dtype="uint8")
    images = http_images(cfg.run.seed)
    expected = [pil_wire(data, transform) for _, data in images]
    base = f"http://127.0.0.1:{port}"
    rec = {"argv": HTTP_ARGV, "card": card}

    def post(i, tenant="a"):
        return http_call(base, "POST", "/predict", images[i][1],
                         {"X-Tenant": tenant})

    def all_ok(answers, gen, digest, what):
        bad = [(c, p) for c, _, p, _ in answers
               if c != 200 or p["generation"] != gen or p["digest"] != digest]
        check(not bad, f"{what}: {bad[:2]}")

    # ------------------------------------------------- (a) the server --
    for f in counters.values():  # count only this path's launches
        f.launches = 0
    t0 = time.perf_counter()
    serving = serve_cli.Serving(cfg, device)
    engine, watcher, fleet = serving.engine, serving.watcher, serving.fleet
    metrics = engine.metrics
    check(watcher.loaded_epoch == 0, f"restore_initial served epoch "
          f"{watcher.loaded_epoch}, expected phase 12's 0")
    engine.warmup()
    serving.start()
    rec["startup_s"] = time.perf_counter() - t0
    direct_forwards = 0
    engine2 = None
    try:
        # ------------------------------------------ (b) the requests --
        warm = [post(i % HTTP_REQUESTS) for i in range(HTTP_WARM)]
        all_ok(warm, 0, digest0, "sequential requests")
        seen = []
        inner = engine.transform

        def recording(arr, rng):  # what the server hands the engine
            out = inner(arr, rng)
            seen.append(out)
            return out

        engine.transform = recording
        with ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            answers = list(pool.map(post, range(HTTP_REQUESTS)))
        engine.transform = inner
        all_ok(answers, 0, digest0, "concurrent requests")
        check(sorted(a.tobytes() for a in seen)
              == sorted(e.tobytes() for e in expected),
              "the server's wire arrays differ from PIL decode + the port's "
              "val transform")
        direct = [f.result(timeout=120) for f in
                  [engine.submit(w) for w in expected]]
        diffs = []
        for (_, _, body, _), p in zip(answers, direct):
            check(body["topk"][0][0] == int(p.indices[0]),
                  f"HTTP top-1 {body['topk'][0]} != direct {p.indices[0]}")
            diffs.append(float(np.abs(np.asarray([s for _, s in body["topk"]])
                                      - p.scores).max()))
        check(max(diffs) <= HTTP_TOL, f"HTTP vs direct scores {max(diffs)}")
        rec["requests"] = {"n": len(answers) + len(warm),
                           "kinds": [kd for kd, _ in images],
                           "wire_bitwise_pil": True, "top1_equal_direct": True,
                           "max_score_diff_vs_direct": max(diffs)}
        log(f"[serve-http] (b) {HTTP_WARM} sequential + {HTTP_REQUESTS} "
            f"requests from {HTTP_CLIENTS} threads: 200, wire arrays bitwise "
            f"PIL + the port's transform, top-1 = direct submit, max |Δp| "
            f"{max(diffs):.3g}")

        # --------------------------------------------- (c) /healthz --
        health = http_call(base, "GET", "/healthz")[2]
        check(health["ok"] is True and health["digest"] == digest0
              and health["generation"] == 0 and health["watcher_alive"] is True
              and health["fleet_role"] == "leader"
              and health["wave_state"] == "serving",
              f"/healthz: {json.dumps(health)[:400]}")
        text = http_call(base, "GET", "/metrics")[2]
        families = sorted({line.split()[0].split("{")[0]
                           for line in text.splitlines()
                           if line and not line.startswith("#")})
        missing = [p for p in HTTP_FAMILIES
                   if not any(f.startswith(p) for f in families)]
        check(not missing, f"/metrics lacks {missing}")
        rec["healthz"], rec["metric_families"] = health, families
        log(f"[serve-http] (c) /healthz ok, digest {digest0[:12]}…, "
            f"generation 0, watcher alive, leader, serving; /metrics "
            f"{len(families)} families")

        # ------------------------------------------ (d) hot reload --
        stage = os.path.join(root, "stage")
        os.makedirs(stage, exist_ok=True)

        def publish(sd, epoch, tear=False):
            # as a trainer publishes: the bytes, then the sidecar
            path = os.path.join(stage, f"ckpt_e{epoch}.pt")
            checkpoint.save(sd, path)
            if tear:
                with open(path, "r+b") as fh:
                    fh.seek(100)
                    fh.write(b"\xde\xad\xbe\xef")
            for p in (path, checkpoint.checksum_path(path)):
                os.replace(p, os.path.join(run, os.path.basename(p)))
            return os.path.join(run, os.path.basename(path))

        sd = checkpoint.model_state(checkpoint.restore(src))
        new_sd = {n: (t * 1.25 if t.is_floating_point()
                      and "running" not in n else t) for n, t in sd.items()}
        t0 = time.perf_counter()
        e1 = publish(new_sd, 1)
        wait_for(lambda: watcher.loaded_epoch == 1, 120, "the swap to epoch 1")
        rec["reload_s"] = time.perf_counter() - t0
        digest1 = checkpoint.file_digest(e1)
        with ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            answers = list(pool.map(post, range(8)))
        all_ok(answers, 1, digest1, "after the swap")
        new_model = create_served_model(cfg, device, new_sd)
        predict = make_topk_predict_step(cfg, k)
        batch = torch.from_numpy(np.stack(expected[:8])).to(device)
        p_new, i_new = predict(new_model, batch)
        direct_forwards += 1
        p_new, i_new = p_new.cpu().numpy(), i_new.cpu().numpy()
        diff = max(float(np.abs(np.asarray([s for _, s in b["topk"]])
                                - p_new[j]).max())
                   for j, (_, _, b, _) in enumerate(answers))
        check(all(b["topk"][0][0] == int(i_new[j, 0])
                  for j, (_, _, b, _) in enumerate(answers))
              and diff <= HTTP_TOL,
              f"answers after the swap are not the new weights' (|Δp| {diff})")
        check(not os.path.exists(wave_token_path(fleet_dir))
              and fleet.state == "serving" and fleet.generation == 1,
              f"drain token not released: state {fleet.state}, generation "
              f"{fleet.generation}")
        health = http_call(base, "GET", "/healthz")[2]
        check(health["generation"] == 1 and health["digest"] == digest1
              and health["lease_generation"] == 1, f"/healthz after the "
              f"swap: {health['generation']} {health['digest'][:12]}")
        rejected = metrics.reloads_rejected
        e2 = publish({n: t * 1.5 if t.is_floating_point() and "running"
                      not in n else t for n, t in sd.items()}, 2, tear=True)
        wait_for(lambda: os.path.exists(e2 + ".corrupt"), 120,
                 "the torn epoch 2 to be quarantined")
        wait_for(lambda: metrics.reloads_rejected == rejected + 1, 10,
                 "reloads_rejected to rise")
        after = [post(i) for i in range(2)]
        all_ok(after, 1, digest1, "after the torn candidate")
        check(watcher.loaded_epoch == 1 and metrics.reloads_rejected
              == rejected + 1 and metrics.reloads == 1,
              f"torn candidate: epoch {watcher.loaded_epoch}, rejected "
              f"{metrics.reloads_rejected}")
        rec["reload"] = {"epoch1_digest": digest1, "max_score_diff_vs_new":
                         diff, "torn_quarantined": True,
                         "reloads": metrics.reloads,
                         "reloads_rejected": metrics.reloads_rejected}
        log(f"[serve-http] (d) epoch 1 swapped in {rec['reload_s']:.2f} s "
            f"after publishing (answers = the new weights, |Δp| {diff:.3g}; "
            f"drain token released); torn epoch 2 quarantined, "
            f"reloads_rejected {metrics.reloads_rejected}, still epoch 1")

        # --------------------------------------- (e) backpressure --
        # a second engine over the new weights with a queue of
        # HTTP_BURST_QUEUE, its batcher held until the burst has been
        # answered or queued: the queue fills, the rest are refused
        bcfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(
            HTTP_ARGV + ["--ckpt", e1, "--queue_depth", str(HTTP_BURST_QUEUE)]))
        engine2 = ServingEngine.from_config(bcfg, new_model, predict, device,
                                            metrics=ServeMetrics())
        engine2.warmup()  # its graphs, before the batcher runs
        shedder = AdmissionController(engine2, tenants="a:3,b:1",
                                      deadline_ms=1.0, rate_fn=lambda: 1.0)
        servers = [http_mod.start_server(engine2, 0),
                   http_mod.start_server(engine2, 0, admission=shedder)]
        bases = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
        try:
            with ThreadPoolExecutor(HTTP_BURST) as pool:
                futs = [pool.submit(http_call, bases[i % 4 == 3], "POST",
                                    "/predict", images[i % HTTP_REQUESTS][1],
                                    {"X-Tenant": "b"}) for i in range(HTTP_BURST)]
                wait_for(lambda: sum(f.done() for f in futs)
                         == HTTP_BURST - HTTP_BURST_QUEUE
                         and engine2.queue_depth == HTTP_BURST_QUEUE, 120,
                         "the burst to fill the queue")
                engine2.start()
                burst = [f.result() for f in futs]
        finally:
            for s in servers:
                s.shutdown()
                s.server_close()
            engine2.drain()
        busy = [(c, ra, p) for c, ra, p, _ in burst if c == 503]
        ok = [p for c, _, p, _ in burst if c == 200]
        shed = [p for c, ra, p in busy if "est_wait_ms" in p]
        check(len(ok) == HTTP_BURST_QUEUE and len(busy) == HTTP_BURST - len(ok)
              and all(ra == "1" and p["state"] == "busy" for _, ra, p in busy),
              f"burst: {len(ok)} answered, {len(busy)} busy, "
              f"{[(c, ra) for c, ra, _ in busy][:3]}")
        check(shed and all(p["shed_tenant"] == "b" for p in shed),
              "no admission shed with shed_tenant")
        rec["burst"] = {"requests": HTTP_BURST, "queue_depth": HTTP_BURST_QUEUE,
                        "answered": len(ok), "busy": len(busy),
                        "admission_shed": len(shed)}
        log(f"[serve-http] (e) burst of {HTTP_BURST} against queue_depth "
            f"{HTTP_BURST_QUEUE}: {len(ok)} × 200, {len(busy)} × 503 busy "
            f"(Retry-After: 1), {len(shed)} of them shed by admission "
            f"(shed_tenant b)")

        # the launches of (a)-(e): K1 36 a forward, nothing else
        forwards = (len(engine.buckets) + metrics.batches
                    + len(engine2.buckets) + engine2.metrics.batches
                    + direct_forwards)
        launches = {kd: f.launches for kd, f in counters.items()}
        want = dict.fromkeys(counters, 0) | {"k1": ABN_SITES * forwards}
        check(launches == want, f"HTTP path launches {launches}, expected "
              f"{want} ({forwards} forwards)")
        rec.update(launches=launches, forwards=forwards)
        del new_model

        # ----------------------------------------------- (g) timings --
        def per_image_ms(fn):
            out = []
            for _, data in images:
                runs = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    fn(data)
                    runs.append((time.perf_counter() - t0) * 1e3)
                out.append(statistics.median(runs))
            half = HTTP_REQUESTS // 2
            return {"median": statistics.median(out),
                    "jpeg_500x375": statistics.median(out[:half]),
                    "png": statistics.median(out[half:])}

        rng0 = np.random.default_rng(0)
        timing = {
            "decode_transform_ms": per_image_ms(lambda d: engine.transform(
                http_mod.decode_image(d), rng0)),
            "decode_only_ms": per_image_ms(http_mod.decode_image),
            "yardstick_pil_route_ms": per_image_ms(lambda d: pil_route(
                d, cfg.data.train_crop_size, h))}
        for conc, n in HTTP_TIMED.items():
            t0 = time.perf_counter()
            with ThreadPoolExecutor(conc) as pool:
                res = list(pool.map(lambda i: post(i % HTTP_REQUESTS), range(n)))
            wall = time.perf_counter() - t0
            check(all(c == 200 for c, *_ in res), f"timed run at {conc}: "
                  f"{[c for c, *_ in res if c != 200][:3]}")
            lat = [ms for *_, ms in res]
            timing[f"concurrency_{conc}"] = {
                "requests": n, "p50_ms": nearest_rank(lat, 50),
                "p99_ms": nearest_rank(lat, 99), "images_per_s": n / wall}
        served = engine._state
        buckets = sorted(engine.seen_buckets)
        with DeviceTimer(torch, lambda: (counters["k1"].launches,)) as timer:
            for b in buckets:
                im = torch.zeros((b, h, h, 3), dtype=torch.uint8, device=device)
                timer.run(f"forward {b}", lambda im=im: predict(served, im),
                          reps=10)
        res = timer.results()
        timing["forward_device_ms"] = {b: res[f"forward {b}"][0]
                                       for b in buckets}
        timing["bucket_hist"] = metrics.snapshot()["bucket_hist"]
        rec["timing"] = timing
        rec["profiler"] = timer.record()
        log(f"[timing] {card}: HTTP serve path, TResNet-M 224 px bf16 "
            f"(client ms per request through urllib, admission and the "
            f"watcher on; decode_transform_ms: PIL + the val transform on "
            f"the host, per image, decode_only_ms its PIL decode; "
            f"yardstick_pil_route_ms: PIL's decode + resize + crop in C, "
            f"the JAX front end's host ops, not the port's route; "
            f"forward_device_ms: the served forward per bucket used): "
            f"{json.dumps(timing)}")
        log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    finally:
        serving.drain()
    return rec


def serve_cli_http(root, card) -> dict:
    """Phase 27 (f): `cli/serve.py --watch --port --fleet_dir --out` as a
    subprocess on the card: one POST answered, SIGTERM drains with rc 0,
    and its events (SCENARIO_EVENTS) hold the serve path's records."""
    import signal

    from ddp_classification_pytorch_tpu_torch.obs.events import (
        read_events,
        validate_events,
    )

    port = free_port()
    events = os.path.join(root, "cli_events.jsonl")
    cmd = [sys.executable, "-m", "ddp_classification_pytorch_tpu_torch.cli.serve",
           *HTTP_ARGV, "--watch", os.path.join(root, "run"), "--port",
           str(port), "--fleet_dir", os.path.join(root, "cli_fleet"),
           "--out", os.path.join(root, "cli_out"), "--reload_poll_s", "0.5"]
    env = dict(os.environ, SCENARIO_EVENTS=events, SCENARIO_SOURCE="replica0",
               PYTHONPATH=REPO)
    base = f"http://127.0.0.1:{port}"
    data = http_images(1)[0][1]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        def up():
            check(proc.poll() is None, "the serve CLI exited early")
            try:
                return http_call(base, "GET", "/healthz")[2]
            except OSError:
                return None

        health = wait_for(up, 300, "the serve CLI's /healthz")
        ready_s = time.perf_counter() - t0
        code, _, body, ms = http_call(base, "POST", "/predict", data)
        check(code == 200 and len(body["topk"]) == 5
              and body["generation"] == 1, f"CLI POST: {code} {body}")
        check(health["ok"] and health["fleet_role"] == "leader",
              f"CLI /healthz {health}")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    check(proc.returncode == 0 and "[serve] drained clean" in out,
          f"serve CLI rc {proc.returncode}:\n{out[-1500:]}\n{err[-1500:]}")
    log_ = read_events(events)
    kinds = [r["kind"] for r in log_]
    need = ("serve_ready", "verify_ok", "swap", "drain_begin", "drain_end")
    check(all(kd in kinds for kd in need) and not validate_events(log_),
          f"CLI events {kinds}: {validate_events(log_)}")
    rec = {"ready_s": ready_s, "post_ms": ms, "generation": body["generation"],
           "rc": proc.returncode, "events": kinds}
    log(f"[serve-http] (f) {card}: cli/serve.py --watch --port as a "
        f"subprocess: /healthz after {ready_s:.1f} s, one POST 200 in "
        f"{ms:.1f} ms (epoch 1), SIGTERM rc 0, drained clean; events {kinds}")
    return rec


def vit_serve_leg(torch, device, serve_cli, fa, counters, card) -> dict:
    """Phase 27 (h): ViT-B/16 at 512 px (1024 tokens), bf16, served through
    `build_engine` from a config with `model.flash_attention`: K2 12 times
    a forward; then one batch of 8 with `flash_forward` and with its plain
    version, the served top-5 and probabilities compared."""
    from ddp_classification_pytorch_tpu_torch.train.steps import (
        make_topk_predict_step,
    )

    cfg = serve_cli.config_from_args(
        serve_cli.build_parser().parse_args(VIT_SERVE_ARGV))
    cfg.model.flash_attention = True  # the CLI keeps JAX's default, off
    for f in counters.values():
        f.launches = 0
    engine = serve_cli.build_engine(cfg, device)
    engine.warmup()
    preds = serve_cli.run_selfcheck(engine, cfg, 8)
    forwards = len(engine.buckets) + engine.metrics.batches
    launches = {kd: f.launches for kd, f in counters.items()}
    want = dict.fromkeys(counters, 0) | {"fwd": VIT_BLOCKS * forwards}
    check(launches == want and all(np.isfinite(p.scores).all() for p in preds),
          f"ViT serve launches {launches}, expected {want}")
    model = engine._state
    predict = make_topk_predict_step(cfg, 5)
    h = cfg.data.image_size
    imgs = torch.from_numpy(np.random.default_rng(cfg.run.seed).integers(
        0, 256, (8, h, h, 3)).astype(np.uint8)).to(device)
    kp, ki = predict(model, imgs)
    before = fa.flash_forward.launches
    kernel = fa.flash_forward
    fa.flash_forward = fa.flash_forward_ref
    try:
        pp, pi = predict(model, imgs)
        torch.cuda.synchronize()
    finally:
        fa.flash_forward = kernel
    check(fa.flash_forward.launches == before, "the plain forward launched K2")
    diff = (kp - pp).abs().max().item()
    top5 = bool(torch.equal(ki, pi))
    top1 = (ki[:, 0] == pi[:, 0]).float().mean().item()
    check(diff <= VIT_SERVE_TOL, f"ViT served probabilities, K2 vs plain: "
          f"max |Δp| {diff}")
    wall = wall_ms(torch, lambda: predict(model, imgs))
    with DeviceTimer(torch, lambda: (fa.flash_forward.launches,)) as timer:
        timer.run("vit forward 8", lambda: predict(model, imgs), reps=5)
    dev = timer.results()["vit forward 8"][0]
    k2_ms, k2_n = timer.kernel_ms("vit forward 8", "flash_fwd_kernel")
    rec = {"argv": VIT_SERVE_ARGV, "flash_attention": True, "launches": launches,
           "forwards": forwards, "top5_equal_plain": top5,
           "top1_agreement_plain": top1, "max_prob_diff_plain": diff,
           "forward8_wall_ms": wall, "forward8_device_ms": dev,
           "k2_x12_ms": k2_ms, "k2_launches_per_forward": k2_n}
    log(f"[serve-http] (h) {card}: ViT-B/16 512 px bf16 served with "
        f"flash_attention: {json.dumps(rec)}")
    del engine, model
    torch.cuda.empty_cache()
    return rec


# phase 29: the recovery chain on the card, (a) in process for the launch
# counts and the skipped window, (b) the supervisor over the CLI for the
# exit-code contract

def recovery_in_process(torch, device, train_cli, checkpoint, counters,
                        card: str) -> dict:
    """Phase 29 (a): RECOVERY_ARGV through `Trainer` into a temporary
    directory, every count in `counters` set to 0 just before `run()`: the
    counts are exactly the TResNet-M path's (K1 36 a train step and eval
    batch, K1s/K1r/K1d 36 a train step, the others 0; a skipped step
    still runs its forward and backward), the sentinel skips steps 2 and
    3, the model's parameters and buffers are bitwise equal before step 2
    and after step 3, and `restore_latest` quarantines the torn
    `ckpt_e1.pt` and restores `ckpt_e0.pt`. Returns the record, with the
    longest silent stretch between the heartbeat's touches (from the
    Trainer's construction, when it is armed)."""
    from ddp_classification_pytorch_tpu_torch.train.loop import Trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
    try:
        cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
            RECOVERY_ARGV + ["--out", tmp]))
        touches = [time.monotonic()]
        trainer = Trainer(cfg, device)
        check(trainer.steps_per_epoch == TRAIN_STEPS
              and len(trainer.val_loader) == EVAL_BATCHES and trainer.chaos,
              f"{trainer.steps_per_epoch} steps, {len(trainer.val_loader)} "
              f"eval batches, plan {trainer.chaos!s}")
        touch, step_fn, window = (trainer._heartbeat.touch, trainer.train_step,
                                  {})

        def timed_touch():
            touches.append(time.monotonic())
            touch()

        def watched_step(state, *args, **kw):
            # bitwise copies on the card before step 2 and after step 3
            if state.step == 2:
                window["before"] = [t.clone() for t in
                                    state.model.state_dict().values()]
            out = step_fn(state, *args, **kw)
            if state.step == 4:
                window["after"] = [t.clone() for t in
                                   state.model.state_dict().values()]
            return out

        trainer._heartbeat.touch, trainer.train_step = timed_touch, watched_step
        for f in counters.values():  # count only the main path's
            f.launches = 0
        t0 = time.perf_counter()
        last = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        epochs = cfg.run.epochs
        want = dict.fromkeys(counters, 0) | {
            "k1": ABN_SITES * epochs * (TRAIN_STEPS + EVAL_BATCHES),
            "k1s": ABN_SITES * epochs * TRAIN_STEPS,
            "k1r": ABN_SITES * epochs * TRAIN_STEPS,
            "k1d": ABN_SITES * epochs * TRAIN_STEPS}
        check(launches == want, f"recovery launches {launches}, expected "
                                f"{want}")
        check(trainer.sentinel.skipped_total == 2
              and trainer.state.step == epochs * TRAIN_STEPS,
              f"skipped {trainer.sentinel.skipped_total} steps of "
              f"{trainer.state.step}, expected 2 (steps 2-3) of "
              f"{epochs * TRAIN_STEPS}")
        check(len(window) == 2 and all(
            torch.equal(a, b) for a, b in zip(window["before"],
                                              window["after"])),
              "the nan_loss window changed the parameters or buffers")
        check(np.isfinite(last["loss"]) and last["step_ok"] == 1.0,
              f"epoch {epochs - 1}: {last}")
        torn = os.path.join(tmp, "ckpt_e1.pt")
        check(checkpoint.verify(torn) is not None,
              "ckpt_io left ckpt_e1.pt verifying")
        _, next_epoch = checkpoint.CheckpointManager(tmp).restore_latest(
            trainer.state)
        check(next_epoch == 1 and os.path.exists(torn + ".corrupt")
              and not os.path.exists(torn)
              and same_state(torch, checkpoint.restore(
                  os.path.join(tmp, "ckpt_e0.pt")),
                  trainer.state.state_dict()),
              f"restore_latest: next epoch {next_epoch}, expected ckpt_e1.pt "
              "quarantined and ckpt_e0.pt restored")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gaps = np.diff(touches)
    rec = {"argv": RECOVERY_ARGV, "launches": launches, "wall_s": wall,
           "epoch": last, "skipped_steps": trainer.sentinel.skipped_total,
           "touches": len(touches) - 1,
           "slowest_silent_s": float(gaps.max()),
           "first_silent_s": float(gaps[0]), "card": card}
    log(f"[recovery] (a) {json.dumps(rec)}")
    return rec


def recovery_supervised(hang_s: float, card: str) -> dict:
    """Phase 29 (b): `cli/supervise.py` over the train CLI as subprocesses
    on the card (TResNet-M as RECOVERY_ARGV, 3 epochs, `--multihost` on
    an elastic pod of one, `--hang_timeout_s hang_s`, RECOVERY_SPEC):
    restarts at rc 1, 7 and 143, then exit 0; the torn checkpoint
    quarantined and the last run resumed from ckpt_e0.pt; history,
    generation, membership and lease as the contract says. peer_slow
    stalls hang_s + 5 s plus the watchdog's poll period (hang_s / 4), so
    the watchdog fires inside the stall whatever the phase of its poll."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_drill_")
    out = os.path.join(tmp, "run")
    argv = [a if b != "--epochs" else "3" for b, a in zip(
        [None] + TRESNET_TRAIN_ARGV, TRESNET_TRAIN_ARGV)] + [
        "--log_every", "4", "--out", out, "--multihost",
        "--hang_timeout_s", str(hang_s), "--fault_spec", RECOVERY_SPEC]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CHAOS_", "FLEET_"))
           and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                         "MASTER_PORT")}
    env.update(FLEET_COORDINATOR=f"127.0.0.1:{free_port()}",
               FLEET_NUM_PROCESSES="1", FLEET_PROCESS_ID="0",
               FLEET_ELASTIC="1", CHAOS_PEER_SLOW_S=str(hang_s * 1.25 + 5),
               RUNTIME_BACKOFF_S="0", OUTAGE_BACKOFF_S="0",
               REFORM_BACKOFF_S="0", MAX_RESTARTS="5")
    t0, launched = time.perf_counter(), time.time()
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "ddp_classification_pytorch_tpu_torch.cli.supervise", *argv],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            stdout, stderr = proc.communicate()
            raise RuntimeError(f"chip_smoke: the supervised drill ran past "
                               f"600 s:\n{stdout[-3000:]}\n{stderr[-3000:]}")
        wall = time.perf_counter() - t0
        tail = f"\n{stdout[-4000:]}\n{stderr[-4000:]}"
        check(proc.returncode == 0, f"supervisor rc {proc.returncode}{tail}")
        with open(os.path.join(out, "restarts.log")) as f:
            lines = f.read().splitlines()
        fields = [dict(t.split("=", 1) for t in line.split()[1:])
                  for line in lines]
        # each child's wall, launch (after the backoff) to exit: the first
        # is a cold start and 5 steps, which bounds its first silent stretch
        ended = [datetime.fromisoformat(line.split()[0]).timestamp()
                 for line in lines]
        starts = [launched] + [e + float(f["backoff"].rstrip("s"))
                               for e, f in zip(ended, fields)]
        run_walls = [e - b for b, e in zip(starts, ended)]
        check([int(f["rc"]) for f in fields] == RECOVERY_RCS
              and [f["action"] for f in fields] == ["restart"] * 3 + ["exit"],
              f"restarts.log: {lines}{tail}")
        last_run = stdout.rsplit("[fleet] rendezvous ok", 1)[-1]
        check(os.path.exists(os.path.join(out, "ckpt_e1.pt.corrupt"))
              and "quarantined corrupt checkpoint " + os.path.join(
                  out, "ckpt_e1.pt") in last_run
              and f"auto-resumed from {out} at epoch 1" in last_run,
              f"the last run did not resume from ckpt_e0.pt{tail}")
        with open(os.path.join(out, "history.json")) as f:
            history = json.load(f)
        check(len(history["loss"]) == 3 and None not in history["loss"],
              f"history.json: {history}")
        with open(os.path.join(out, "generation")) as f:
            generation = f.read().strip()
        with open(os.path.join(out, "fleet", "membership")) as f:
            membership = f.read().strip()
        check(generation == "3" and membership == "gen=3 world=0"
              and os.path.exists(os.path.join(out, "fleet", "lease.p0")),
              f"generation {generation!r}, membership {membership!r}")
        chaos_lines = [ln for ln in stderr.splitlines()
                       if ln.startswith(("# chaos", "# trainer["))]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"argv": argv, "hang_timeout_s": hang_s,
           "peer_slow_s": hang_s * 1.25 + 5, "restarts_log": lines,
           "chaos": chaos_lines, "membership": membership,
           "generation": int(generation), "run_walls_s": run_walls,
           "wall_s": wall, "card": card}
    log(f"[recovery] (b) {json.dumps(rec)}")
    return rec


# phase 30: the train→serve chaos scenario, every actor a process on the card

def scenario_phase(card: str) -> dict:
    """Phase 30: `cli/scenario.py` over SCENARIO_SPEC as a subprocess on the
    card; checks the verdict, the events the spec's faults must leave and
    every child's device, and returns the run's numbers
    (`scenario/report.py`) with the restart log."""
    from ddp_classification_pytorch_tpu_torch.obs.events import read_events
    from ddp_classification_pytorch_tpu_torch.scenario.report import (
        timeline_report,
    )
    from ddp_classification_pytorch_tpu_torch.scenario.spec import parse_spec
    from ddp_classification_pytorch_tpu_torch.scenario.supervisor import (
        banner_devices,
    )

    tmp = tempfile.mkdtemp(prefix="chip_smoke_scenario_")
    out = os.path.join(tmp, "run")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CHAOS_", "FLEET_", "SCENARIO_"))
           and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                         "MASTER_PORT")}
    cmd = [sys.executable, "-m",
           "ddp_classification_pytorch_tpu_torch.cli.scenario",
           "--scenario_spec", json.dumps(SCENARIO_SPEC), "--out", out,
           "--device", "cuda"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            stdout, stderr = proc.communicate(
                timeout=SCENARIO_SPEC["deadline_s"] + 240)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            stdout, stderr = proc.communicate()
            raise RuntimeError(f"chip_smoke: the scenario ran past its "
                               f"deadline:\n{stdout[-3000:]}\n"
                               f"{stderr[-3000:]}")
        wall = time.perf_counter() - t0
        tail = f"\n{stdout[-4000:]}\n{stderr[-6000:]}"
        green = [ln for ln in stdout.splitlines()
                 if ln.startswith("[scenario] GREEN:")]
        check(proc.returncode == 0 and green
              and all(f"S{i}" in green[0] for i in range(1, 6)),
              f"scenario rc {proc.returncode}, green {green}{tail}")
        events = read_events(os.path.join(out, "events.jsonl"))
        kinds = {e["kind"] for e in events}
        check(all(k in kinds for k in SCENARIO_EVENTS),
              f"events lack {[k for k in SCENARIO_EVENTS if k not in kinds]}"
              f"{tail}")
        fired = [e for e in events if e["kind"] == "timeline"]
        wave = [e for e in fired if e["action"].startswith(
            "kill_replica_during_wave@") and e.get("target")]
        drain = [e for e in fired if e["action"].startswith("drain_replica@")]
        check(wave and drain, f"timeline firings {fired}{tail}")
        target = "replica{}".format(SCENARIO_SPEC["timeline"][0]["replica"])
        relaunched = [e for e in events if e["kind"] == "replica_start"
                      and e["replica"] == target
                      and e["ts"] > drain[0]["ts"]]
        check(relaunched, f"{target} was not relaunched after its drain{tail}")
        check([e["rc"] for e in events if e["kind"] == "lint"] == [0],
              f"lint events {[e for e in events if e['kind'] == 'lint']}")
        devices = {}
        for name in sorted(os.listdir(out)):
            if name.endswith(".log") and name.startswith(("host", "replica")):
                with open(os.path.join(out, name)) as f:
                    devices[name] = banner_devices(f.read())
        who = {w for seen in devices.values() for w, _ in seen}
        check(who == {"trainer", "serve"} and all(
            d == "cuda" for seen in devices.values() for _, d in seen),
            f"children's devices {devices}")
        report = timeline_report(events, parse_spec(SCENARIO_SPEC))
        with open(os.path.join(out, "restarts.log")) as f:
            restarts = f.read().splitlines()
        host_rcs = [int(t.split("=", 1)[1]) for line in restarts
                    for t in line.split() if t.startswith("rc=")]
    finally:
        # the run's logs and events (not its checkpoints) for a post-mortem
        keep = os.path.join(REPO, "chiprun_out", "scenario")
        shutil.rmtree(keep, ignore_errors=True)
        os.makedirs(keep, exist_ok=True)
        for name in (os.listdir(out) if os.path.isdir(out) else []):
            if name.endswith((".log", ".jsonl")):
                shutil.copy(os.path.join(out, name), keep)
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"spec": SCENARIO_SPEC, "wall_s": wall, "green": green[0],
           "events": len(events), "event_kinds": sorted(kinds),
           "wave_kill": wave[0], "drain": drain[0], "devices": devices,
           "restarts_log": restarts, "trainer_rcs": host_rcs,
           "report": report, "card": card}
    return rec


# ------------------------------------------------------------- phase 31 --
# this slice's paths. (a) VGG19-BN (cfg E) under the nested recipe at full
# width: 224 px, 2173 classes, bf16, batch 64 — 512 images are TRAIN_STEPS
# steps, its 128 val images EVAL_BATCHES batches; the reference's dropout
# 0.5 (JAX `factory.py:61-62`)
VGG_ARGV = ["nested", "--dataset", "synthetic", "--synthetic_size", "512",
            "--model", "vgg19_bn", "--image_size", "224", "--num_classes",
            "2173", "--batchsize", "64", "--dtype", "bfloat16", "--epochs",
            "1", "--device", "cuda"]
VGG_SERVE_ARGV = ["nested" if a == "baseline" else
                  "vgg19_bn" if a == "tresnet_m" else a for a in SERVE_ARGV]
VGG_FROZEN = 32  # the 16 BNs' γ/β the freeze-BN filter matches
# (b) TResNet-M under arcface and under nested with freeze-BN at the
# serving configuration: 256 images at batch 32, each preset's optimizer
TRESNET_HEAD_ARGV = {w: [w, *TRESNET_TRAIN_ARGV[1:TRESNET_TRAIN_ARGV.index(
    "--lr")], "--device", "cuda"] for w in ("arcface", "nested")}
TRESNET_FROZEN = 48  # the 24 identity BNs' γ/β (bn2, bn3, bn_down)
# (c) ViT-B/16 under arcface at 512 px with the flash kernels: 64 images at
# batch 32 are 2 steps, its 32 val images one eval batch
VIT_ARC_ARGV = ["arcface", "--dataset", "synthetic", "--synthetic_size", "64",
                "--model", "vit_b16", "--image_size", "512", "--num_classes",
                "1000", "--batchsize", "32", "--flash_attention", "--dtype",
                "bfloat16", "--epochs", "1", "--device", "cuda"]
VIT_ARC_STEPS, VIT_ARC_EVALS = 2, 1
# (d) the profiler window on the ResNet-50 baseline step at batch 128:
# 768 images are 6 steps, so steps 2-5 are captured
PROF_ARGV = [a if b not in ("--synthetic_size", "--batchsize") else
             {"--synthetic_size": "768", "--batchsize": "128"}[b]
             for b, a in zip([None] + RESNET_TRAIN_ARGV, RESNET_TRAIN_ARGV)
             ] + ["--profile_steps", "4"]
PROF_STEPS, PROF_FIRST = 6, 2
PROF_TOL = 0.10  # the trace's device-lane total vs CUDA events, relatively
# (e) --debug_nans on TResNet-M (224 px, batch 8): step 0 clean under the
# mode, step 1 poisoned by nan_loss, which must raise naming full_like
NAN_ARGV = ["baseline", "--dataset", "synthetic", "--synthetic_size", "16",
            "--model", "tresnet_m", "--image_size", "224", "--num_classes",
            "2173", "--batchsize", "8", "--dtype", "bfloat16", "--epochs",
            "1", "--device", "cuda", "--debug_nans", "--fault_spec",
            "nan_loss@step=1"]
# (f) cli/verify_import.py on the oracles' checkpoints (random weights)
VERIFY_ARCHS = ("resnet50", "vgg19_bn", "tresnet_m")


def frozen_snapshot(torch, model):
    """{name: copy} of the params freeze-BN leaves out of the update."""
    from ddp_classification_pytorch_tpu_torch.train.schedule import (
        frozen_bn_names,
    )

    params = dict(model.named_parameters())
    return {n: params[n].detach().clone() for n in frozen_bn_names(model)}


def event_step_ms(torch, fn, reps: int = STEP_REPS) -> float:
    """Device ms of one call of `fn` between two CUDA events (the device's
    gaps inside the call included), median of `reps`."""
    fn()
    torch.cuda.synchronize()
    events = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
              for _ in range(reps)]
    for s, e in events:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def vgg_nested_path(torch, device, train_cli, serve_cli, checkpoint,
                    fused_abn, k1, counters, card) -> dict:
    """Phase 31 (a): VGG19-BN under the nested recipe through
    `train_main_path` (none of the seven kernels: JAX's VGG BNs are XLA);
    its 32 frozen tensors bitwise unchanged; the checkpoint served with
    the trainer's top-5; then its train step's wall and device ms."""
    from ddp_classification_pytorch_tpu_torch.models.vgg import Dropout

    kept = {}

    def before(tr):
        kept.update(frozen_snapshot(torch, tr.state.model))
        check(len(kept) == VGG_FROZEN, f"vgg: {len(kept)} frozen tensors")

    def then(tr, ckpt):
        params = dict(tr.state.model.named_parameters())
        moved = [n for n, v in kept.items() if not torch.equal(params[n], v)]
        check(not moved, f"vgg: frozen tensors moved: {moved[:4]}")
        return serve_trained_checkpoint(
            torch, fused_abn, device, serve_cli, k1, tr, ckpt,
            np.stack([tr.val_ds[i][0] for i in range(8)]), VGG_SERVE_ARGV,
            k1_per_forward=0) | {"frozen_unchanged": len(kept)}

    trainer, cfg, rec = train_main_path(
        torch, device, train_cli, checkpoint, VGG_ARGV, counters,
        dict.fromkeys(counters, 0), "vgg-nested-train", then, before=before,
        ckpt_name="ckpt_best.pt")
    model = trainer.state.model
    drops = [m.p for m in model.modules() if isinstance(m, Dropout)]
    check((cfg.model.arch, cfg.model.head, cfg.model.freeze_bn, drops,
           model.feat_dim) == ("vgg19_bn", "nested", True, [0.5], 4096),
          f"vgg: not the nested recipe on VGG19-BN ({drops})")
    n = cfg.data.batch_size
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.integers(0, 256, (n, 224, 224, 3),
                                           dtype=np.uint8)).to(device)
    labels = torch.from_numpy(rng.integers(0, 2173, n).astype(np.int32)
                              ).to(device)

    def rstep():
        return trainer.train_step(trainer.state, images, labels)

    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    wall = host_ms(torch, rstep)
    dev = event_step_ms(torch, rstep)
    rec["step"] = {"batch": n, "px": 224, "dtype": "bfloat16",
                   "wall_ms": wall, "device_ms_events": dev,
                   "images_per_s": n / wall * 1e3}
    log(f"[vgg] {card}: VGG19-BN nested train step, batch {n}, bf16, 224 "
        f"px: wall {wall:.2f} ms, device {dev:.2f} ms (CUDA events), "
        f"{n / wall * 1e3:.1f} images/s")
    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    del trainer, model
    torch.cuda.empty_cache()
    return rec


def tresnet_head_path(torch, device, train_cli, serve_cli, checkpoint,
                      fused_abn, k1, counters, workload: str) -> dict:
    """Phase 31 (b): TResNet-M under `workload` (arcface, or nested with
    freeze-BN) through `train_main_path`: the K1 family at its 36 sites a
    step (K1 36 an eval batch too), the frozen tensors bitwise unchanged,
    every ABN's running statistics moved; the checkpoint served (K1 36 a
    forward) with the trainer's top-5."""
    from ddp_classification_pytorch_tpu_torch.models.tresnet import FusedABN

    kept, stats = {}, {}
    evals = EVAL_BATCHES * (2 if workload == "nested" else 1)  # eval first
    want = dict.fromkeys(counters, 0) | {
        "k1": ABN_SITES * (TRAIN_STEPS + evals),
        "k1s": ABN_SITES * TRAIN_STEPS, "k1r": ABN_SITES * TRAIN_STEPS,
        "k1d": ABN_SITES * TRAIN_STEPS}

    def abns(model):
        return {n: m for n, m in model.named_modules()
                if isinstance(m, FusedABN)}

    def before(tr):
        if tr.cfg.model.freeze_bn:
            kept.update(frozen_snapshot(torch, tr.state.model))
        stats.update({n: m.running_mean.clone()
                      for n, m in abns(tr.state.model).items()})

    def then(tr, ckpt):
        params = dict(tr.state.model.named_parameters())
        moved = [n for n, v in kept.items() if not torch.equal(params[n], v)]
        check(not moved, f"{workload}: frozen tensors moved: {moved[:4]}")
        now = abns(tr.state.model)
        still = [n for n, v in stats.items()
                 if torch.equal(now[n].running_mean, v)]
        check(len(stats) == ABN_SITES and not still,
              f"{workload}: ABN running means that did not move: {still}")
        return serve_trained_checkpoint(
            torch, fused_abn, device, serve_cli, k1, tr, ckpt,
            np.stack([tr.val_ds[i][0] for i in range(8)]),
            [workload if a == "baseline" else a for a in SERVE_ARGV]) | {
            "frozen_unchanged": len(kept), "abn_stats_moved": len(stats)}

    trainer, cfg, rec = train_main_path(
        torch, device, train_cli, checkpoint, TRESNET_HEAD_ARGV[workload],
        counters, want, f"tresnet-{workload}-train", then, before=before,
        ckpt_name="ckpt_best.pt" if workload == "nested" else None)
    check(cfg.model.freeze_bn == (workload == "nested")
          and len(kept) == (TRESNET_FROZEN if cfg.model.freeze_bn else 0),
          f"{workload}: freeze_bn {cfg.model.freeze_bn}, {len(kept)} frozen")
    del trainer
    torch.cuda.empty_cache()
    return rec


def vit_arcface_path(torch, device, train_cli, counters, card) -> dict:
    """Phase 31 (c): ViT-B/16 under arcface at 512 px with the flash
    kernels, 2 steps and one eval batch through cli/train.py's sequence:
    K2 12 a forward, K3 and K4 12 a backward, nothing else."""
    from ddp_classification_pytorch_tpu_torch.train.loop import Trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_vitarc_")
    try:
        cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
            VIT_ARC_ARGV + ["--out", tmp]))
        trainer = Trainer(cfg, device)
        check(trainer.steps_per_epoch == VIT_ARC_STEPS
              and len(trainer.val_loader) == VIT_ARC_EVALS,
              f"vit arcface: {trainer.steps_per_epoch} steps")
        for f in counters.values():  # count only this path's
            f.launches = 0
        t0 = time.perf_counter()
        last = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = dict.fromkeys(counters, 0) | {
        "fwd": VIT_BLOCKS * (VIT_ARC_STEPS + VIT_ARC_EVALS),
        "dq": VIT_BLOCKS * VIT_ARC_STEPS, "dkv": VIT_BLOCKS * VIT_ARC_STEPS}
    check(launches == want, f"vit arcface launches {launches}, want {want}")
    check(np.isfinite(last["loss"]) and last["step_ok"] == 1.0
          and trainer.state.model.margin.weight.shape == (1000, 256),
          f"vit arcface: {last}")
    rec = {"argv": VIT_ARC_ARGV, "epoch": last, "launches": launches,
           "wall_s": wall}
    log(f"[vit-arcface] {card}: {json.dumps(rec)}")
    del trainer
    torch.cuda.empty_cache()
    return rec


def profile_window_phase(torch, device, counters, card) -> dict:
    """Phase 31 (d): `--profile_steps 4` on the ResNet-50 baseline step at
    batch 128 through the Trainer, CUDA events around each step: the
    capture lands and the window closes; `obs/trace.py` parses it into
    steps 2-5 whose six buckets sum to their walls; its device-lane total
    agrees with the events' within PROF_TOL. Run before any other
    profiler session of this process."""
    import socket

    from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
    from ddp_classification_pytorch_tpu_torch.obs import trace
    from ddp_classification_pytorch_tpu_torch.train.loop import Trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_prof_")
    try:
        cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
            PROF_ARGV + ["--out", tmp]))
        trainer = Trainer(cfg, device)
        check(trainer.steps_per_epoch == PROF_STEPS
              and trainer._prof_start_step == PROF_FIRST,
              f"profile: {trainer.steps_per_epoch} steps, window from "
              f"{trainer._prof_start_step}")
        events, inner = {}, trainer.train_step

        def timed(state, images, labels):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            n = state.step
            s.record()
            out = inner(state, images, labels)
            e.record()
            events[n] = (s, e)
            return out

        trainer.train_step = timed
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        last = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        check(launches == dict.fromkeys(counters, 0),
              f"profile: launches {launches}")
        check(not trainer._prof_active and trainer._prof_steps == 0,
              "profile: the window did not close inside epoch 0")
        path = os.path.join(tmp, "profile",
                            f"{socket.gethostname()}.trace.json.gz")
        check(os.path.exists(path), f"profile: no capture at {path}")
        t1 = time.perf_counter()
        rows = trace.breakdown_from_torch_trace(path)
        parse_s = time.perf_counter() - t1
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = list(range(PROF_FIRST, PROF_FIRST + 4))
    check([r["step"] for r in rows] == steps,
          f"profile: parsed steps {[r['step'] for r in rows]}, want {steps}")
    for r in rows:
        total = sum(r[b] for b in trace.BUCKETS)
        check(abs(total - r["step_ms"]) <= 1e-9 * max(r["step_ms"], 1.0),
              f"profile: step {r['step']} buckets sum to {total}, wall "
              f"{r['step_ms']}")
    ev_ms = {n: s.elapsed_time(e) for n, (s, e) in events.items()}
    lane = sum(r["step_ms"] for r in rows)
    evs = sum(ev_ms[n] for n in steps)
    ratio = lane / evs
    check(abs(ratio - 1.0) <= PROF_TOL,
          f"profile: device-lane {lane:.2f} ms vs CUDA events {evs:.2f} ms")
    agg = trace.aggregate(rows)
    rec = {"argv": PROF_ARGV, "launches": launches, "rows": rows,
           "breakdown_ms": agg,
           "event_ms": {str(n): ev_ms[n] for n in steps},
           "lane_over_events": ratio, "trace_bytes": size,
           "parse_s": parse_s, "run_wall_s": wall, "epoch": last}
    log(f"[profile] {card}: ResNet-50 baseline train step, batch 128, bf16, "
        f"224 px, steps {steps[0]}-{steps[-1]} captured "
        f"({size / 1e6:.1f} MB gz, parsed in {parse_s:.2f} s): breakdown "
        f"(ms, mean a step) {json.dumps(agg)}")
    log(f"[profile] {card}: device-lane {lane / 4:.3f} ms a step vs CUDA "
        f"events {evs / 4:.3f} ms (ratio {ratio:.4f})")
    del trainer
    torch.cuda.empty_cache()
    return rec


def debug_nans_phase(torch, train_cli, counters, card) -> dict:
    """Phase 31 (e): `cli/train.py --debug_nans` on TResNet-M with a
    nan_loss fault at step 1: step 0 runs clean under the mode (the K1
    family's 36 sites, their outputs checked), step 1 raises
    FloatingPointError naming `full_like` instead of being skipped."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nans_")
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    msg = None
    try:
        train_cli.main(NAN_ARGV + ["--out", tmp])
    except FloatingPointError as e:
        msg = str(e)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    want = dict.fromkeys(counters, 0) | dict.fromkeys(
        ("k1", "k1s", "k1r", "k1d"), 2 * ABN_SITES)
    check(msg is not None and "full_like" in msg,
          f"debug_nans: the nan_loss step did not raise naming the op ({msg})")
    check(launches == want, f"debug_nans: launches {launches}, want {want}")
    rec = {"argv": NAN_ARGV, "error": msg, "launches": launches,
           "wall_s": wall}
    log(f"[debug-nans] {card}: {json.dumps(rec)}")
    torch.cuda.empty_cache()
    return rec


def verify_import_phase(torch, card) -> dict:
    """Phase 31 (f): each oracle (random weights, `torch.save`d) through
    `cli/verify_import.py` on the card: PASS, rc 0; a file with a renamed
    key: rc 2."""
    import contextlib
    import io

    from ddp_classification_pytorch_tpu_torch.cli import verify_import
    from ddp_classification_pytorch_tpu_torch.models import torch_oracle as to

    make = {"resnet50": lambda: to.make_torch_resnet("resnet50", 1000),
            "vgg19_bn": lambda: to.make_torch_vgg19_bn(1000),
            "tresnet_m": lambda: to.make_torch_tresnet_m(1000)}

    def run(argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                verify_import.main(argv)
                rc = 0
            except SystemExit as e:
                rc = e.code
        return rc, out.getvalue().strip(), err.getvalue().strip()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_verify_")
    rec = {}
    try:
        for i, arch in enumerate(VERIFY_ARCHS):
            if arch == "vgg19_bn":  # randomize_ fills every tensor it
                # reads; built on meta, its 143 M parameters skip their init
                with torch.device("meta"):
                    oracle = make[arch]().to_empty(device="cpu")
            else:  # TResNet-M's blur filter is no parameter: built for real
                oracle = make[arch]()
            to.randomize_(oracle, seed=i)
            path = os.path.join(tmp, f"{arch}.pth")
            torch.save(oracle.state_dict(), path)
            del oracle
            t0 = time.perf_counter()
            rc, out, err = run([path, "--arch", arch])
            rec[arch] = {"rc": rc, "line": out,
                         "wall_s": time.perf_counter() - t0}
            log(f"[verify-import] {card}: {arch}: rc {rc}: {out}")
            check(rc == 0 and out.startswith("PASS"),
                  f"verify_import {arch}: rc {rc} {out} {err}")
            if arch == "resnet50":
                sd = torch.load(path)
                sd["layer1.0.conv9.weight"] = sd.pop("layer1.0.conv1.weight")
                bad = os.path.join(tmp, "renamed.pth")
                torch.save(sd, bad)
                rc, out, err = run([bad, "--arch", arch])
                rec["renamed_key"] = {"rc": rc, "stderr": err[-400:]}
                log(f"[verify-import] renamed key: rc {rc}")
                check(rc == 2 and "layer1.0.conv9.weight" in err,
                      f"verify_import renamed key: rc {rc} {err[-300:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def slice15_phase(torch, device, train_cli, serve_cli, checkpoint, fused_abn,
                  k1, counters, card) -> dict:
    """Phase 31's legs (a)-(c), (e), (f); (d) ran first (see main)."""
    t0 = time.perf_counter()
    rec = {"vgg_nested": vgg_nested_path(
        torch, device, train_cli, serve_cli, checkpoint, fused_abn, k1,
        counters, card)}
    for w in ("arcface", "nested"):
        rec[f"tresnet_{w}"] = tresnet_head_path(
            torch, device, train_cli, serve_cli, checkpoint, fused_abn, k1,
            counters, w)
    rec["vit_arcface"] = vit_arcface_path(torch, device, train_cli, counters,
                                          card)
    rec["debug_nans"] = debug_nans_phase(torch, train_cli, counters, card)
    rec["verify_import"] = verify_import_phase(torch, card)
    rec["legs_s"] = time.perf_counter() - t0
    return rec


# ------------------------------------------------------------- phase 32 --
# the scaling levers. (a) the ResNet-50 baseline step at batch 128 (224 px,
# 2173 classes, bf16, uint8 wire) at --grad_accum 4 (microbatches of 32)
# beside --grad_accum 1
ACCUM_R50_ARGV = [a if b not in ("--synthetic_size", "--batchsize") else
                  {"--synthetic_size": "256", "--batchsize": "128"}[b]
                  for b, a in zip([None] + RESNET_TRAIN_ARGV, RESNET_TRAIN_ARGV)]
ACCUM_K = 4
# (b) TResNet-M at the serving configuration, batch 32, --grad_accum 4:
# the K1 family at its 36 sites once a microbatch
ACCUM_TRESNET_ARGV = TRESNET_TRAIN_ARGV + ["--grad_accum", str(ACCUM_K)]
# (c) phase 22's run under torchrun world 1 with every lever against the
# plain process at --grad_accum 2 (ZeRO-1 and the wire are the identity
# at world 1), and --grad_accum 1 against the plain step written out
ACCUM_DDP_ARGV = DDP_ARGV + ["--grad_accum", "2"]
LEVERS_TORCHRUN = ["--zero_opt", "on", "--grad_reduce_dtype", "bfloat16"]
PLAIN_STEP_ARGV = [a if b != "--batchsize" else "8"
                   for b, a in zip([None] + DDP_ARGV, DDP_ARGV)]
# (e) --h2d-overlap on CIFAR-10 pickles (no dataplane on the card's
# machine): 256 images at batch 16, 16 batches, ResNet-18's CIFAR stem
OVERLAP_ARGV = ["baseline", "--dataset", "cifar10", "--model", "resnet18",
                "--batchsize", "16", "--dtype", "bfloat16", "--epochs", "1",
                "--device", "cuda"]
OVERLAP_BATCHES = 16


def _trainer(train_cli, argv, device, out=None):
    from ddp_classification_pytorch_tpu_torch.train.loop import Trainer

    tmp = out or tempfile.mkdtemp(prefix="chip_smoke_levers_")
    cfg = train_cli.config_from_args(
        train_cli.build_parser().parse_args(argv + ["--out", tmp]))
    return Trainer(cfg, device), tmp


def accum_step_timing(torch, device, train_cli, counters, card) -> dict:
    """Phase 32 (a): the ResNet-50 baseline step at batch 128 through the
    trainer's own step at --grad_accum 4 and 1 on one random uint8 batch:
    wall (host clock, median of 5), device ms (CUDA events around the
    step, median of STEP_REPS), images/s, and the peak of
    `torch.cuda.max_memory_allocated` over one step; no kernel of the
    seven launches (a ResNet)."""
    n = RESNET_STEP_BATCH
    rng = np.random.default_rng(32)
    images = torch.from_numpy(rng.integers(0, 256, (n, 224, 224, 3),
                                           dtype=np.uint8)).to(device)
    labels = torch.from_numpy(rng.integers(0, 2173, n).astype(np.int32)
                              ).to(device)
    rec = {}
    for k in (ACCUM_K, 1):
        trainer, tmp = _trainer(train_cli, ACCUM_R50_ARGV + [
            "--grad_accum", str(k)], device)
        shutil.rmtree(tmp, ignore_errors=True)
        check(trainer.cfg.parallel.grad_accum == k
              and trainer.cfg.data.batch_size == n, "phase 32 (a) config")

        def step():
            return trainer.train_step(trainer.state, images, labels)

        for f in counters.values():
            f.launches = 0
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        m = step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        wall = host_ms(torch, step)
        dev = event_step_ms(torch, step)
        check(float(m["step_ok"]) == 1.0, f"K={k}: step skipped")
        check(all(f.launches == 0 for f in counters.values()),
              f"K={k}: a kernel launched on the ResNet-50 step")
        rec[f"k{k}"] = {"batch": n, "microbatch": n // k, "wall_ms": wall,
                        "device_ms": dev, "images_per_s": n / wall * 1e3,
                        "peak_allocated_gb": peak / 1e9,
                        "allocated_before_gb": base / 1e9,
                        "loss": float(m["loss"])}
        del trainer, step, m
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[accum] {card}: ResNet-50 train step, batch {n}, bf16, 224 px, "
        f"--grad_accum {ACCUM_K} vs 1: {json.dumps(rec)}")
    return rec


def accum_tresnet_path(torch, device, train_cli, checkpoint, fused_abn,
                       counters, card) -> dict:
    """Phase 32 (b): TResNet-M at batch 32 with --grad_accum 4 through
    `train_main_path` (8 steps, 2 eval batches): K1, K1s, K1r and K1d at
    their 36 sites once a microbatch, 36 × 4 a step (K1 36 an eval batch
    too), K2-K4 0; then one more step with K1s's output at the first site
    (microbatch 8) held against its plain version on the same input."""
    per_step = ABN_SITES * ACCUM_K
    want = dict.fromkeys(counters, 0) | {
        "k1": per_step * TRAIN_STEPS + ABN_SITES * EVAL_BATCHES,
        "k1s": per_step * TRAIN_STEPS, "k1r": per_step * TRAIN_STEPS,
        "k1d": per_step * TRAIN_STEPS}

    def then(tr, ckpt):
        real, seen = fused_abn.bn_stats, []

        def recorded(x, *a, **kw):
            out = real(x, *a, **kw)
            if not seen:
                seen.append((x.detach().clone(), [o.clone() for o in out]))
            return out

        rng = np.random.default_rng(33)
        images = torch.from_numpy(rng.integers(0, 256, (32, 224, 224, 3),
                                               dtype=np.uint8)).to(device)
        labels = torch.from_numpy(rng.integers(0, 2173, 32).astype(
            np.int32)).to(device)
        before = {k: f.launches for k, f in counters.items()}
        # the wrapper counts under its module name, so the recorder carries
        # the count while it stands in
        recorded.launches = real.launches
        fused_abn.bn_stats = recorded
        try:
            m = tr.train_step(tr.state, images, labels)
            torch.cuda.synchronize()
        finally:
            fused_abn.bn_stats = real
            real.launches = recorded.launches
        step_counts = {k: f.launches - before[k] for k, f in counters.items()}
        check(float(m["step_ok"]) == 1.0, "phase 32 (b): step skipped")
        check(step_counts == dict.fromkeys(counters, 0) | dict.fromkeys(
            ("k1", "k1s", "k1r", "k1d"), per_step),
            f"one step's launches {step_counts}, expected {per_step} each")
        x, got = seen[0]
        check(x.shape[0] == 32 // ACCUM_K, f"K1s's input {tuple(x.shape)}")
        mean, var, inv = fused_abn.bn_stats_ref(x)
        xf = fused_abn._rows(x).float()
        ulps = SUM_ULPS * 2.0 ** -24
        lim_mean = ulps * xf.abs().mean(0)
        lim_var = ulps * (xf * xf).mean(0) + 2 * mean.abs() * lim_mean
        errs = {name: (a - b).abs().max().item()
                for name, a, b in zip(("mean", "var", "inv_std"), got,
                                      (mean, var, inv))}
        check(bool(((got[0] - mean).abs() <= lim_mean).all()
                   and ((got[1] - var).abs() <= lim_var).all()),
              f"K1s at microbatch 8 off its plain version: {errs}")
        lim_inv = 0.5 * inv ** 3 * lim_var + 4 * 2.0 ** -24 * inv
        check(bool(((got[2] - inv).abs() <= lim_inv).all()),
              f"K1s inv_std at microbatch 8 off its plain version: {errs}")
        return {"step_launches": step_counts, "k1s_input": list(x.shape),
                "k1s_max_abs_err": errs, "k1s_limit": f"{SUM_ULPS} f32 ulps "
                "of the sums of |x| and x^2 (var: and 2|mean| that of the "
                "mean; inv_std: its derivative times that)"}

    _, _, rec = train_main_path(torch, device, train_cli, checkpoint,
                                ACCUM_TRESNET_ARGV, counters, want,
                                "accum-tresnet", then)
    log(f"[accum-tresnet] {card}: K1/K1s/K1r/K1d {per_step} a step "
        f"(36 sites x {ACCUM_K} microbatches), K1s at microbatch "
        f"{32 // ACCUM_K} vs plain {json.dumps(rec['k1s_max_abs_err'])}")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def plain_step_bitwise(torch, device, train_cli) -> dict:
    """Phase 32 (c): --grad_accum 1 (every lever at its default) is the
    plain step: three Trainers of ResNet-50 (f32, 224 px, batch 8) from
    the seed, two stepping through their train step (the control) and one
    through the plain sequence written out (epilogue, forward, CE,
    backward, lr, SGD); after two steps the three states are bitwise
    equal. cuDNN runs deterministic algorithms for this leg (its default
    may sum a weight gradient in another order call to call)."""
    import torch.nn.functional as F

    from ddp_classification_pytorch_tpu_torch.data.transforms import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [_trainer(train_cli, PLAIN_STEP_ARGV + extra, device)
                for extra in (["--grad_accum", "1"], [], [])]
        for _, tmp in runs:
            shutil.rmtree(tmp, ignore_errors=True)
        (a, _), (c, _), (b, _) = runs
        check(type(a.state.optimizer) is torch.optim.SGD
              and a.state.ddp is None, "phase 32 (c): a lever is on at its "
              "default")
        mean, std = (torch.from_numpy(v).view(1, 3, 1, 1).to(device)
                     for v in (IMAGENET_MEAN, IMAGENET_STD))
        rng = np.random.default_rng(34)
        for _ in range(2):
            images = torch.from_numpy(rng.integers(
                0, 256, (8, 224, 224, 3), dtype=np.uint8)).to(device)
            labels = torch.from_numpy(rng.integers(0, 2173, 8).astype(
                np.int32)).to(device)
            for tr in (a, c):
                tr.train_step(tr.state, images, labels)
            st = b.state
            x = (images.permute(0, 3, 1, 2).float() / 255.0 - mean) / std
            st.model.train()
            st.model.zero_grad(set_to_none=True)
            F.cross_entropy(st.model(x).float(), labels.long()).backward()
            st.set_lrs()
            st.optimizer.step()
            st.opt_count += 1
            st.step += 1
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    sa, sb, sc = (t.state.state_dict() for t in (a, b, c))
    worst = max((sa["model"][k].float() - sb["model"][k].float()).abs().max()
                .item() for k in sa["model"])
    rec = {"bitwise_equal": same_state(torch, sa, sb),
           "control_bitwise_equal": same_state(torch, sa, sc),
           "max_abs_diff": worst, "steps": 2, "argv": PLAIN_STEP_ARGV}
    log(f"[accum] --grad_accum 1 vs the plain step written out: "
        f"{json.dumps(rec)}")
    check(rec["control_bitwise_equal"], "two runs of the step differ")
    check(rec["bitwise_equal"], "--grad_accum 1 is not bitwise the plain step")
    del a, b, c, runs
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def async_ckpt_leg(torch, device, train_cli, checkpoint, counters,
                   card) -> dict:
    """Phase 32 (d): ResNet-50's train state (224 px, 2173 classes, bf16,
    after one step at batch 64) saved synchronously and asynchronously:
    the step loop's blocking ms at `save` for each, and the background
    write's ms until `wait()` returns; the async file verifies, `publish`
    was emitted with its sidecar already on disk, meta names it, and
    `cli/train.py --resume` continues from it for one epoch (8 steps, 2
    eval batches)."""
    from ddp_classification_pytorch_tpu_torch.train.checkpoint import (
        CheckpointManager)

    trainer, tmp = _trainer(train_cli, RESNET_TRAIN_ARGV, device)
    rng = np.random.default_rng(35)
    images = torch.from_numpy(rng.integers(0, 256, (64, 224, 224, 3),
                                           dtype=np.uint8)).to(device)
    labels = torch.from_numpy(rng.integers(0, 2173, 64).astype(np.int32)
                              ).to(device)
    trainer.train_step(trainer.state, images, labels)
    torch.cuda.synchronize()
    published, real_emit = [], checkpoint.emit

    def emit(kind, **kw):
        if kind == "publish":
            published.append(checkpoint.verify(kw["path"]) is None)
        real_emit(kind, **kw)

    rec = {}
    checkpoint.emit = emit
    try:
        for mode in ("sync", "async"):
            mgr = CheckpointManager(os.path.join(tmp, mode),
                                    async_save=mode == "async")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(trainer.state, 0)
            blocked = (time.perf_counter() - t0) * 1e3
            mgr.wait()
            rec[mode] = {"blocking_ms": blocked,
                         "until_landed_ms": (time.perf_counter() - t0) * 1e3,
                         "bytes": os.path.getsize(mgr.epoch_path(0))}
            check(checkpoint.verify(mgr.epoch_path(0)) is None,
                  f"{mode} checkpoint does not verify")
            check(mgr.read_meta().get("last_epoch") == 0, "meta not written")
    finally:
        checkpoint.emit = real_emit
    check(published == [True, True], f"publish before its sidecar: {published}")
    ckpt = os.path.join(tmp, "async", "ckpt_e0.pt")
    check(same_state(torch, checkpoint.restore(ckpt),
                     trainer.state.state_dict()),
          "async checkpoint does not hold the train state")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    resumed, rtmp = _trainer(train_cli, RESNET_TRAIN_ARGV + [
        "--epochs", "2", "--resume", ckpt], device)
    check(resumed.start_epoch == 1 and resumed.state.step == 1,
          f"--resume: epoch {resumed.start_epoch}, step {resumed.state.step}")
    for f in counters.values():
        f.launches = 0
    last = resumed.run()
    check(last["step_ok"] == 1.0 and np.isfinite(last["loss"]),
          f"resumed epoch: {last}")
    check(resumed.state.step == 1 + TRAIN_STEPS
          and checkpoint.verify(os.path.join(rtmp, "ckpt_e1.pt")) is None,
          "the resumed run's checkpoint")
    rec["resumed"] = {"epoch": last, "step": resumed.state.step}
    rec["publish_after_sidecar"] = published
    del resumed
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(rtmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[async-ckpt] {card}: ResNet-50 train state, save blocking ms "
        f"sync {rec['sync']['blocking_ms']:.1f} vs async "
        f"{rec['async']['blocking_ms']:.1f}: {json.dumps(rec)}")
    return rec


def overlap_leg(torch, device, train_cli, card) -> dict:
    """Phase 32 (e): --h2d-overlap off and on over CIFAR-10 pickles (256
    images of random pixels from a seed, batch 16): the trainer's own
    prefetcher and step for the epoch's 16 batches, the step loop's
    prefetch wait ms a step, and a checksum of each batch on the card,
    equal with the overlap off and on (and the overlap's fetcher thread
    seen)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_cifar_")
    rec = {}
    try:
        write_cifar10(root, 32)
        for on in (False, True):
            trainer, tmp = _trainer(train_cli, OVERLAP_ARGV + [
                "--train_dir", root] + (["--h2d-overlap"] if on else []),
                device)
            pf = trainer.train_prefetch
            check(pf.overlap == on and trainer.steps_per_epoch
                  == OVERLAP_BATCHES, "phase 32 (e) config")
            trainer.train_loader.set_epoch(0)
            sums, w0, b0 = [], pf.waited_s, pf.batches
            t0 = time.perf_counter()
            it = iter(pf)
            try:
                for images, labels in it:
                    w = torch.arange(1, images.shape[0] + 1, device=device)
                    sums.append(torch.stack([
                        (images.flatten(1).to(torch.int64).sum(1) * w).sum(),
                        (labels.to(torch.int64) * w).sum()]))
                    trainer.train_step(trainer.state, images, labels)
                fetch = pf.fetch_thread
            finally:
                it.close()
            torch.cuda.synchronize()
            n = pf.batches - b0
            rec["on" if on else "off"] = {
                "batches": n, "wait_ms_per_step": (pf.waited_s - w0) / n * 1e3,
                "loop_ms_per_step": (time.perf_counter() - t0) / n * 1e3,
                "fetch_thread": fetch is not None,
                "checksums": torch.stack(sums).cpu().tolist()}
            check(n == OVERLAP_BATCHES and (fetch is not None) == on,
                  f"overlap {on}: {n} batches, fetcher {fetch}")
            trainer._teardown()
            del trainer
            shutil.rmtree(tmp, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(rec["on"]["checksums"] == rec["off"]["checksums"],
          "the overlap changed the batches or their order")
    log(f"[h2d-overlap] {card}: prefetch wait ms a step off "
        f"{rec['off']['wait_ms_per_step']:.3f}, on "
        f"{rec['on']['wait_ms_per_step']:.3f}; the first {OVERLAP_BATCHES} "
        f"batches' checksums equal: {json.dumps(rec)}")
    return rec


def slice16_phase(torch, device, train_cli, checkpoint, fused_abn, counters,
                  card) -> dict:
    """Phase 32 (a)-(e); (b) is the main path of `grad_accum_path_launches`."""
    t0 = time.perf_counter()
    rec = {"resnet50_accum": accum_step_timing(torch, device, train_cli,
                                               counters, card),
           "tresnet_accum": accum_tresnet_path(
               torch, device, train_cli, checkpoint, fused_abn, counters,
               card)}
    rec["world1_levers"] = ddp_vs_plain(torch, checkpoint, ACCUM_DDP_ARGV,
                                        LEVERS_TORCHRUN, tag="levers")
    check("grad_accum=2 zero=False wire=bfloat16" in
          rec["world1_levers"]["banners"]["torchrun"],
          "the torchrun run did not take the levers")
    rec["grad_accum_1"] = plain_step_bitwise(torch, device, train_cli)
    rec["async_ckpt"] = async_ckpt_leg(torch, device, train_cli, checkpoint,
                                       counters, card)
    rec["h2d_overlap"] = overlap_leg(torch, device, train_cli, card)
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# ------------------------------------------------------------- phase 33 --
# the model options. (a) ViT-B/16, 512 px (1024 tokens: K2-K4), batch 32,
# bf16, flash, with and without --remat
VIT_OPT_ARGV = ["baseline", "--dataset", "synthetic", "--synthetic_size",
                "64", "--model", "vit_b16", "--image_size", "512",
                "--num_classes", "1000", "--batchsize", "32",
                "--flash_attention", "--dtype", "bfloat16", "--epochs", "1",
                "--device", "cuda"]
# (c) the MoE ViT-B/16: 2 train steps and one eval batch through run()
VIT_MOE_ARGV = VIT_OPT_ARGV + ["--moe_experts", "8", "--moe_top_k", "2"]
VIT_MOE_STEPS, VIT_MOE_EVALS = 2, 1
MOE_ROUTE_TOL = 1e-2  # × max |f32-route output|: bf16 outputs, one ulp 2^-8
# (d) dropout with and without remat, batch 8
VIT_DROP_ARGV = [a if b != "--batchsize" else "8"
                 for b, a in zip([None] + VIT_OPT_ARGV, VIT_OPT_ARGV)] + [
    "--dropout", "0.1"]
# (f) each option's rejections (rc 2), on tiny synthetic runs
OPTION_REJECTIONS = [
    ["--model", "resnet18", "--moe_experts", "4"],
    ["--model", "vit_b16", "--moe_experts", "5"],
    ["--model", "vit_b16", "--moe_experts", "4", "--dropout", "0.1"],
    ["--model", "vit_b16", "--moe_experts", "4", "--moe_top_k", "5"],
    ["--model", "vit_b16", "--moe_experts", "4", "--moe_aux_weight", "-1"],
    ["--mp", "2"]]


def _reset(counters):
    for f in counters.values():
        f.launches = 0


def _step_metrics(torch, device, trainer, images, labels) -> dict:
    """Peak `max_memory_allocated` over one step (after one warm step),
    wall (host clock, median of 5) and device ms (CUDA events, median of
    STEP_REPS) of the trainer's own step on one batch."""
    def step():
        return trainer.train_step(trainer.state, images, labels)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    return {"peak_allocated_gb": peak / 1e9, "allocated_before_gb": base / 1e9,
            "wall_ms": host_ms(torch, step),
            "device_ms": event_step_ms(torch, step)}


def _random_batch(torch, device, n, size, classes, seed):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.integers(0, 256, (n, size, size, 3),
                                           dtype=np.uint8)).to(device)
    labels = torch.from_numpy(rng.integers(0, classes, n).astype(np.int32)
                              ).to(device)
    return images, labels


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def remat_pair(torch, device, train_cli, counters, argv, want, tag, card,
               deterministic=False) -> dict:
    """One step of `argv` with and without `--remat` from the same seed on
    one batch: the states after it bitwise equal (or, if not, the largest
    difference over each tensor's largest update), the launches of that
    step (held to `want[remat]`), then the step's peak memory and times."""
    size = int(argv[argv.index("--image_size") + 1])
    n = int(argv[argv.index("--batchsize") + 1])
    classes = int(argv[argv.index("--num_classes") + 1])
    images, labels = _random_batch(torch, device, n, size, classes, 33)
    rec, states, before = {}, {}, None
    for remat in (False, True):
        trainer, tmp = _trainer(train_cli, argv + (["--remat"] if remat
                                                   else []), device)
        shutil.rmtree(tmp, ignore_errors=True)
        check(trainer.cfg.model.remat is remat, f"{tag}: --remat not set")
        if before is None:
            before = {k: v.detach().clone() for k, v in
                      trainer.state.model.state_dict().items()}
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic or prev
        try:
            _reset(counters)
            m = trainer.train_step(trainer.state, images, labels)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = prev
        launches = {k: f.launches for k, f in counters.items()}
        check(float(m["step_ok"]) == 1.0, f"{tag} remat={remat}: skipped")
        check(launches == want[remat], f"{tag} remat={remat}: launches "
              f"{launches}, want {want[remat]}")
        states[remat] = {k: v.detach().clone() for k, v in
                         trainer.state.model.state_dict().items()}
        key = "remat" if remat else "plain"
        rec[key] = {"launches": launches, "loss": float(m["loss"])} | \
            _step_metrics(torch, device, trainer, images, labels)
        del trainer, m
        _free()
    bitwise = all(torch.equal(states[False][k], states[True][k])
                  for k in states[False])
    worst = max(((states[False][k].float() - states[True][k].float())
                 .abs().max() / (states[False][k].float() - before[k].float())
                 .abs().max().clamp_min(1e-30)).item()
                for k in states[False] if states[False][k].is_floating_point())
    rec |= {"argv": argv, "bitwise_equal": bitwise,
            "max_diff_over_largest_update": worst,
            "peak_ratio": rec["remat"]["peak_allocated_gb"]
            / rec["plain"]["peak_allocated_gb"],
            "device_ms_added": rec["remat"]["device_ms"]
            - rec["plain"]["device_ms"]}
    log(f"[{tag}] {card}: {json.dumps(rec)}")
    check(bitwise or worst <= 1e-6, f"{tag}: remat step differs from the "
          f"plain step by {worst} of an update")
    del states, before
    _free()
    return rec


def moe_vit_path(torch, device, train_cli, counters, card) -> dict:
    """Phase 33 (c): the MoE ViT-B/16 through `Trainer.run()`, the
    penalty at init, the step's times, and the experts' card route against
    the f32 route on one block's input."""
    from ddp_classification_pytorch_tpu_torch.models import vit
    from ddp_classification_pytorch_tpu_torch.ops import moe

    trainer, tmp = _trainer(train_cli, VIT_MOE_ARGV, device)
    try:
        check(trainer.steps_per_epoch == VIT_MOE_STEPS
              and len(trainer.val_loader) == VIT_MOE_EVALS,
              f"moe: {trainer.steps_per_epoch} steps")
        model = trainer.state.model
        backbone = model.backbone
        images, labels = _random_batch(torch, device, 32, 512, 1000, 35)
        x = (images.permute(0, 3, 1, 2).float() / 255.0 - 0.45) / 0.25
        # the penalty at init, and one block's input for the route check
        seen = {}
        hook = backbone.blocks[0].register_forward_pre_hook(
            lambda mod, args: seen.setdefault("x", args[0].detach()))
        model.train()
        with torch.no_grad():
            model(x)
        hook.remove()
        aux = float(vit.pop_moe_aux(model))
        weighted = trainer.cfg.model.moe_aux_weight * aux
        # each block's E·Σ f_e·p_e lies in [top_k, E]: top_k (2) under a
        # uniform router, more as the top-k experts' probability grows
        k, e = trainer.cfg.model.moe_top_k, trainer.cfg.model.moe_experts
        check(0.99 * k * VIT_BLOCKS <= aux <= e * VIT_BLOCKS,
              f"moe: penalty {aux} at init outside [top_k, E] a block")
        blk = backbone.blocks[0]
        with torch.no_grad():
            y = blk.ln2(seen["x"]).to(blk.dtype)
            gates = moe.topk_gates(moe.router_logits(y, blk.moe_router), 2)
            args = (y, gates, blk.moe_w_in, blk.moe_b_in, blk.moe_w_out,
                    blk.moe_b_out, blk.dtype)
            card_out = moe.moe_mlp(*args)
            card_ms = event_step_ms(torch, lambda: moe.moe_mlp(*args))
            card_route = moe._product
            moe._product = lambda a, b: torch.matmul(a.float(), b.float())
            try:
                f32_out = moe.moe_mlp(*args)
                f32_ms = event_step_ms(torch, lambda: moe.moe_mlp(*args))
            finally:
                moe._product = card_route
        ref = f32_out.float()
        route_err = (card_out.float() - ref).abs().max().item()
        route_scale = ref.abs().max().item()
        check(route_err <= MOE_ROUTE_TOL * route_scale,
              f"moe: card route {route_err} off the f32 route "
              f"(scale {route_scale})")
        del seen, y, gates, args, card_out, f32_out, ref
        _reset(counters)
        t0 = time.perf_counter()
        last = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        want = dict.fromkeys(counters, 0) | {
            "fwd": VIT_BLOCKS * (VIT_MOE_STEPS + VIT_MOE_EVALS),
            "dq": VIT_BLOCKS * VIT_MOE_STEPS, "dkv": VIT_BLOCKS * VIT_MOE_STEPS}
        check(launches == want, f"moe launches {launches}, want {want}")
        check(np.isfinite(last["loss"]) and last["step_ok"] == 1.0,
              f"moe: {last}")
        _reset(counters)
        m = trainer.train_step(trainer.state, images, labels)
        torch.cuda.synchronize()
        step_launches = {k: f.launches for k, f in counters.items()}
        check(step_launches == dict.fromkeys(counters, 0) | {
            "fwd": VIT_BLOCKS, "dq": VIT_BLOCKS, "dkv": VIT_BLOCKS},
            f"moe step launches {step_launches}")
        check(np.isfinite(float(m["loss"])), "moe: step loss not finite")
        rec = {"argv": VIT_MOE_ARGV, "epoch": last, "launches": launches,
               "step_launches": step_launches, "run_wall_s": wall,
               "aux_at_init": aux, "weighted_aux_at_init": weighted,
               "route_max_abs_err": route_err, "route_scale": route_scale,
               "route_tol": MOE_ROUTE_TOL, "card_route_fwd_ms": card_ms,
               "f32_route_fwd_ms": f32_ms,
               "params": sum(p.numel() for p in model.parameters())} | \
            _step_metrics(torch, device, trainer, images, labels)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[moe] {card}: {json.dumps(rec)}")
    del trainer
    _free()
    return rec


def dropout_remat_bitwise(torch, device, train_cli) -> dict:
    """Phase 33 (d): two steps of `--dropout 0.1` with and without
    `--remat` from one seed: bitwise equal states (the recompute reused
    the forward's masks)."""
    states = {}
    for remat in (False, True):
        trainer, tmp = _trainer(train_cli, VIT_DROP_ARGV + (
            ["--remat"] if remat else []), device)
        shutil.rmtree(tmp, ignore_errors=True)
        for s in range(2):
            images, labels = _random_batch(torch, device, 8, 512, 1000, 40 + s)
            m = trainer.train_step(trainer.state, images, labels)
            check(float(m["step_ok"]) == 1.0, "dropout step skipped")
        torch.cuda.synchronize()
        states[remat] = trainer.state.state_dict()
        del trainer
        _free()
    rec = {"argv": VIT_DROP_ARGV, "steps": 2,
           "bitwise_equal": same_state(torch, states[False], states[True])}
    log(f"[dropout] --dropout 0.1 --remat vs --dropout 0.1: {json.dumps(rec)}")
    check(rec["bitwise_equal"], "--dropout with --remat differs from "
          "--dropout alone")
    return rec


def ln_bf16_bitwise(torch, device, train_cli) -> dict:
    """Phase 33 (e): eval logits of ViT-B/16 (512 px, bf16, flash) from one
    seed with and without `--ln_bf16`: bitwise."""
    from ddp_classification_pytorch_tpu_torch.models.factory import build_model
    from ddp_classification_pytorch_tpu_torch.train.state import init_weights_

    images, _ = _random_batch(torch, device, 8, 512, 1000, 45)
    x = (images.permute(0, 3, 1, 2).float() / 255.0 - 0.45) / 0.25
    logits = {}
    for flag in (False, True):
        cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
            VIT_OPT_ARGV + (["--ln_bf16"] if flag else [])))
        check(cfg.model.ln_bf16 is flag, "--ln_bf16 not set")
        model = init_weights_(build_model(cfg.model, 1000, 512),
                              torch.Generator().manual_seed(cfg.run.seed))
        model = model.to(device).eval()
        with torch.no_grad():
            logits[flag] = model(x)
        del model
    rec = {"bitwise_equal": torch.equal(logits[False], logits[True]),
           "logits_std": logits[False].float().std().item()}
    log(f"[ln-bf16] eval logits with and without --ln_bf16: {json.dumps(rec)}")
    check(rec["bitwise_equal"], "--ln_bf16 changed the logits")
    return rec


def option_rejections(train_cli) -> dict:
    """Phase 33 (f): each option's rejection exits rc 2."""
    import contextlib
    import io

    rcs = {}
    for extra in OPTION_REJECTIONS:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_reject_")
        argv = ["baseline", "--dataset", "synthetic", "--synthetic_size", "8",
                "--image_size", "32", "--num_classes", "10", "--batchsize",
                "4", "--epochs", "1", "--device", "cuda", "--out", tmp] + extra
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                train_cli.main(argv)
            rc = 0
        except SystemExit as e:
            rc = e.code
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        rcs[" ".join(extra)] = {"rc": rc, "stderr": err.getvalue().strip()}
        check(rc == 2, f"{extra}: rc {rc}, want 2")
    log(f"[options] rejections: {json.dumps(rcs)}")
    return rcs


def slice17_phase(torch, device, train_cli, counters, card) -> dict:
    """Phase 33 (a)-(f); (a) and (c) are the main paths of
    `vit_remat_step_launches` and `vit_moe_path_launches`."""
    t0 = time.perf_counter()
    zero = dict.fromkeys(counters, 0)
    vit_want = {False: zero | {"fwd": VIT_BLOCKS, "dq": VIT_BLOCKS,
                               "dkv": VIT_BLOCKS},
                True: zero | {"fwd": 2 * VIT_BLOCKS, "dq": VIT_BLOCKS,
                              "dkv": VIT_BLOCKS}}
    rec = {"vit_remat": remat_pair(torch, device, train_cli, counters,
                                   VIT_OPT_ARGV, vit_want, "remat-vit", card)}
    rec["resnet50_remat"] = remat_pair(
        torch, device, train_cli, counters, ACCUM_R50_ARGV,
        {False: zero, True: zero}, "remat-resnet50", card, deterministic=True)
    rec["moe"] = moe_vit_path(torch, device, train_cli, counters, card)
    rec["dropout_remat"] = dropout_remat_bitwise(torch, device, train_cli)
    rec["ln_bf16"] = ln_bf16_bitwise(torch, device, train_cli)
    rec["rejections"] = option_rejections(train_cli)
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# ------------------------------------------------------------- phase 34 --
def flax_train_state(sd, convert) -> dict:
    """The tree the JAX package's trainer writes (flax's `to_state_dict`
    of its TrainState: step, params, batch_stats, opt_state) for a port
    model's f32 `state_dict`: each parameter at its flax path
    (`models/convert.py::flax_path`) in flax's layout (conv OIHW → HWIO,
    Linear (O, I) → (I, O)), each BN's running statistics under
    `batch_stats` as `mean` / `var`, and SGD momentum's zero trace."""
    params, stats = {}, {}
    for name, t in sd.items():
        stem, leaf = name.rsplit(".", 1)
        a = t.detach().cpu().numpy()
        if leaf in ("running_mean", "running_var"):
            tree = stats
            path = convert.flax_path(f"{stem}.weight").rsplit("/", 1)[0] + (
                "/mean" if leaf == "running_mean" else "/var")
        else:
            tree, path = params, convert.flax_path(name)
            if a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                a = a.T
        *outer, last = path.split("/")
        for key in outer:
            tree = tree.setdefault(key, {})
        tree[last] = np.ascontiguousarray(a)

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                for k, v in tree.items()}

    return {"step": np.asarray(0, np.int32), "params": params,
            "batch_stats": stats, "opt_state": {"0": {"trace": zeros(params)},
                                                "1": {}}}


GRAPH_ARGV = SERVE_ARGV  # TResNet-M, 224 px, 2173 classes, bf16, buckets 1-8
GRAPH_BUCKETS = (1, 2, 4, 8)
VIT_GRAPH_ARGV = ["8" if a == "1,2,4,8" else a for a in VIT_SERVE_ARGV]
GRAPH_ROUNDS = 2  # replays of every bucket on the counted main path
MSGPACK_ARGV = RESNET_SERVE_ARGV  # ResNet-50, 224 px, 2173 classes, bf16
# a serve boot in a process of its own, timed from its first line to the
# first answer: the kernel build directory and nvcc as the caller gives
# them (argv: repo, build dir, the serve CLI's argv as JSON, "1" to hide
# nvcc — the toolkit's default install included)
BOOT_CHILD = r"""
import json, os, sys, time
t0 = time.perf_counter()
repo, build_dir, argv, hide = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), sys.argv[4]
sys.path.insert(0, repo)
from ddp_classification_pytorch_tpu_torch.ops import _build
_build.BUILD_DIR = build_dir
if hide == "1":
    _build.DEFAULT_CUDA_HOME = os.path.join(build_dir, "no-cuda-toolkit")
    try:
        _build.find_nvcc()
        sys.exit("nvcc is still found")
    except _build.BuildError:
        pass
import numpy as np
import torch
from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(argv))
engine = serve_cli.build_engine(cfg, torch.device("cuda"))
engine.warmup()
h = cfg.data.image_size
img = np.random.default_rng(0).integers(0, 256, (h, h, 3)).astype(np.uint8)
future = engine.submit(img)
engine.process_once()
pred = future.result(timeout=120)
first = time.perf_counter() - t0
banner = serve_cli.warm_banner(engine)
engine.drain()
print(json.dumps({"first_answer_s": first, "boot": engine.boot,
                  "aot_hit": engine.aot_hit, "banner": banner,
                  "built": sorted(os.listdir(build_dir)),
                  "indices": pred.indices.tolist(),
                  "scores": pred.scores.tolist()}))
"""


def _zero(counters) -> None:
    for f in counters.values():
        f.launches = 0


def _serve_batch(engine, imgs):
    """One batch of len(imgs) requests through `process_once` (no
    batcher thread): one padded bucket, one replay."""
    futures = [engine.submit(im) for im in imgs]
    check(engine.process_once() == len(imgs), "a batch was split")
    return [f.result(timeout=120) for f in futures]


def _stack(preds):
    return (np.stack([p.scores for p in preds]),
            np.stack([p.indices for p in preds]))


def _agree(scores, indices, ref_scores, ref_indices, what: str) -> dict:
    """Replay against eager: bitwise, or within one bf16 ulp of the
    largest score where a library picked another algorithm under capture
    (then reported)."""
    bitwise = (np.array_equal(scores, ref_scores)
               and np.array_equal(indices, ref_indices))
    diff = float(np.abs(scores - ref_scores).max())
    ulp = float(2.0 ** (np.floor(np.log2(float(ref_scores.max()))) - 7))
    check(bitwise or diff <= ulp, f"{what}: scores {diff} apart, more than "
          f"one bf16 ulp ({ulp}) of the largest score")
    return {"bitwise": bitwise, "max_score_diff": diff, "ulp_bound": ulp,
            "indices_equal": bool(np.array_equal(indices, ref_indices))}


def graph_leg(torch, device, serve_cli, counters, argv, kind, per_forward,
              tag, card, flash=False):
    """Phase 34 (a) for one model: the engine's warmup (one eager pass and
    one capture per bucket), GRAPH_ROUNDS batches of every bucket as
    replays (every counter 0 just before, read just after: `kind`
    `per_forward` a forward that ran, the others 0), each replay against
    the eager predict on the same images, then the wall (CUDA events,
    median of REPS) and device ms (torch.profiler) of the eager forward and
    of copy-in + replay, from a device-resident input. Returns (record,
    engine, cfg, the images, the answers)."""
    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(argv))
    cfg.model.flash_attention = flash
    _zero(counters)
    t0 = time.perf_counter()
    engine = serve_cli.build_engine(cfg, device)
    engine.warmup()
    warm_s = time.perf_counter() - t0
    buckets = engine.buckets
    check(engine.graph_mode and engine.boot["captures"] == len(buckets)
          and sorted(engine._graphs) == [(0, b) for b in buckets],
          f"{tag}: warmup captured {engine.boot['captures']} graphs for "
          f"buckets {list(buckets)}")
    check(engine.boot["builds"] == 0, f"{tag}: warmup built "
          f"{engine.boot['builds']} libraries (phase 2 built them all)")
    h = cfg.data.image_size
    rng = np.random.default_rng(34)
    imgs = {b: rng.integers(0, 256, (b, h, h, 3)).astype(np.uint8)
            for b in buckets}
    answers = {}
    for _ in range(GRAPH_ROUNDS):
        for b in buckets:
            answers[b] = _serve_batch(engine, imgs[b])
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    replays = GRAPH_ROUNDS * len(buckets)
    want = dict.fromkeys(counters, 0) | {
        kind: per_forward * (len(buckets) + replays)}
    check(launches == want, f"{tag}: launches {launches}, expected {want} "
          f"({len(buckets)} eager warmup forwards + {replays} replays)")
    predict, model = engine._predict, engine._state
    xs = {b: torch.from_numpy(imgs[b]).to(device) for b in buckets}
    rows = {}
    for b in buckets:
        ep, ei = predict(model, xs[b])
        rows[b] = _agree(*_stack(answers[b]), ep.cpu().numpy(),
                         ei.cpu().numpy(), f"{tag} bucket {b}")

    def replay(b):
        g = engine._graphs[(0, b)]
        g.static_in.copy_(xs[b])
        g.graph.replay()

    for b in buckets:
        rows[b]["eager_wall_ms"] = wall_ms(torch, lambda b=b: predict(model, xs[b]))
        rows[b]["graph_wall_ms"] = wall_ms(torch, lambda b=b: replay(b))
    with DeviceTimer(torch) as timer:
        for b in buckets:
            timer.run(f"eager {b}", lambda b=b: predict(model, xs[b]), reps=10)
            timer.run(f"graph {b}", lambda b=b: replay(b), reps=10)
    res = timer.results()
    part = "fused_abn" if kind == "k1" else "flash_fwd_kernel"
    for b in buckets:
        r = rows[b]
        r["eager_device_ms"], r["graph_device_ms"] = (res[f"eager {b}"][0],
                                                      res[f"graph {b}"][0])
        r["eager_busy"] = r["eager_device_ms"] / r["eager_wall_ms"]
        r["graph_busy"] = r["graph_device_ms"] / r["graph_wall_ms"]
        r["graph_seen_by_profiler"] = res[f"graph {b}"][1] is not None
        if r["graph_seen_by_profiler"]:
            _, n = timer.kernel_ms(f"graph {b}", part)
            r[f"{kind}_per_replay_seen"] = n
            check(n == per_forward, f"{tag} bucket {b}: {n} {part} kernels "
                  f"a replay, expected {per_forward}")
        log(f"[graph] {card}: {tag} bucket {b}: {json.dumps(r)}")
    rec = {"argv": argv, "flash_attention": flash, "warmup_s": warm_s,
           "boot": engine.boot, "launches": launches, "replays": replays,
           "buckets": rows, "profiler": timer.record()}
    return rec, engine, cfg, imgs, answers


def hot_swap_leg(torch, device, engine, cfg, imgs, card) -> dict:
    """Phase 34 (b): a second set of weights swapped in at a batch
    boundary: copied into the captured model's tensors (the served object
    stays), no capture recorded, the answers the new weights' eager
    predict."""
    from ddp_classification_pytorch_tpu_torch.train.state import (
        create_served_model,
    )

    new = create_served_model(cfg, device)
    randomize_(torch, new, seed=2)
    served, total = engine._state, engine.compile_sentinel.total
    b = engine.buckets[-1]
    t0 = time.perf_counter()
    engine.swap_state(new, digest="swap", generation=1)
    got = _serve_batch(engine, imgs[b])
    swap_s = time.perf_counter() - t0
    check(all(p.digest == "swap" and p.generation == 1 for p in got),
          "the swapped batch does not carry the new provenance")
    check(engine._state is served and engine.compile_sentinel.total == total
          and engine.metrics.recompiles == 0,
          f"the swap rebound the model or recorded "
          f"{engine.compile_sentinel.total - total} events")
    ep, ei = engine._predict(new, torch.from_numpy(imgs[b]).to(device))
    rec = _agree(*_stack(got), ep.cpu().numpy(), ei.cpu().numpy(),
                 "hot swap") | {"bucket": b, "swap_and_batch_s": swap_s,
                                "captures_recorded": 0}
    log(f"[graph] {card}: (b) hot swap at a batch boundary: {json.dumps(rec)}")
    del new
    return rec


def strict_leg(serve_cli, engine, imgs, card) -> dict:
    """Phase 34 (d): a dropped graph (the engine's test hook) recaptured in
    steady state: counted in `recompiles` without --strict_compile; rc 2
    from cli/serve.py with it (the hook dropping every graph right after
    warmup, the selfcheck's batch then capturing)."""
    from ddp_classification_pytorch_tpu_torch.serve.engine import ServingEngine

    b = engine.buckets[-1]
    engine.drop_graph(b)
    got = _serve_batch(engine, imgs[b])
    check(engine.metrics.recompiles == 1 and engine.fatal_error is None
          and len(got) == b, f"a steady-state capture without "
          f"--strict_compile: recompiles {engine.metrics.recompiles}")
    warmup = ServingEngine.warmup

    def dropping(self):
        warmup(self)
        for bucket in self.buckets:
            self.drop_graph(bucket)

    ServingEngine.warmup = dropping
    try:
        rc = 0
        try:
            # one batch of all 8: the batcher waits for company
            serve_cli.main(GRAPH_ARGV[:GRAPH_ARGV.index("--selfcheck")]
                           + ["--selfcheck", "8", "--device", "cuda",
                              "--batch_timeout_ms", "2000",
                              "--strict_compile"])
        except SystemExit as e:
            rc = e.code
    finally:
        ServingEngine.warmup = warmup
    check(rc == 2, f"--strict_compile over a steady-state capture: rc {rc}")
    rec = {"recompiles_without_flag": 1, "rc_with_flag": rc}
    log(f"[graph] {card}: (d) steady-state capture: {json.dumps(rec)}")
    return rec


def serve_devices_leg(torch, device, serve_cli, imgs, answers, card) -> dict:
    """Phase 34 (e): --serve_devices 1 answers as the default 0 (every
    card: one here) did; more than the cards is rc 2."""
    argv = GRAPH_ARGV + ["--serve_devices", "1"]
    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(argv))
    engine = serve_cli.build_engine(cfg, device)
    engine.warmup()
    b = engine.buckets[-1]
    got = _serve_batch(engine, imgs[b])
    engine.drain()
    same = _agree(*_stack(got), *_stack(answers[b]), "--serve_devices 1 vs 0")
    check(same["bitwise"], "--serve_devices 1 and 0 answer differently")
    rc = 0
    try:
        serve_cli.main(argv[:-1] + [str(torch.cuda.device_count() + 1)])
    except SystemExit as e:
        rc = e.code
    check(rc == 2, f"--serve_devices beyond the cards: rc {rc}")
    rec = {"serve_devices_1_equals_0": True, "dp": engine.dp,
           "rc_beyond": rc}
    log(f"[graph] {card}: (e) serve devices: {json.dumps(rec)}")
    return rec


def aot_leg(card) -> dict:
    """Phase 34 (c): a cold boot (an empty build dir, nvcc there) banks the
    kernel libraries into --aot_cache; a warm boot (another empty build
    dir, nvcc hidden) loads them, builds nothing, sets aot_hit, captures
    its graphs and answers as the cold one did. Each boot is a process of
    its own, timed to its first answer."""
    root = tempfile.mkdtemp(prefix="chip_smoke_aot_")
    side = os.path.join(root, "aot")
    argv = GRAPH_ARGV + ["--aot_cache", side]
    plain = os.environ.copy()
    hidden = {k: v for k, v in plain.items()
              if k not in ("CUDA_HOME", "CUDA_PATH")}
    hidden["PATH"] = os.pathsep.join(
        p for p in plain.get("PATH", "").split(os.pathsep)
        if "cuda" not in p.lower())
    boots = {}
    try:
        for name, env, hide in (("cold", plain, "0"), ("warm", hidden, "1")):
            build_dir = os.path.join(root, f"build_{name}")
            os.makedirs(build_dir)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", BOOT_CHILD, REPO, build_dir,
                 json.dumps(argv), hide], env=env, cwd=root,
                capture_output=True, text=True, timeout=900)
            check(proc.returncode == 0, f"{name} boot rc {proc.returncode}: "
                  f"{proc.stderr[-3000:]}")
            boots[name] = json.loads(proc.stdout.strip().splitlines()[-1])
            boots[name]["process_s"] = time.perf_counter() - t0
            log(f"[aot] {card}: {name} boot: {boots[name]['banner']}; first "
                f"answer {boots[name]['first_answer_s']:.2f} s after the "
                f"process's first line ({boots[name]['process_s']:.2f} s of "
                f"process)")
        cold, warm = boots["cold"], boots["warm"]
        banked = sorted(f for f in os.listdir(side) if f.endswith(".so"))
        check(cold["boot"]["builds"] >= 1 and not cold["aot_hit"] and banked,
              f"cold boot: {cold['boot']}, banked {banked}")
        check(warm["aot_hit"] and warm["boot"]["builds"] == 0
              and warm["boot"]["captures"] == len(GRAPH_BUCKETS)
              and "from the AOT sidecar, 0 builds" in warm["banner"],
              f"warm boot: {warm['boot']} {warm['banner']}")
        check(warm["indices"] == cold["indices"]
              and warm["scores"] == cold["scores"],
              "warm and cold boots answer differently")
        rec = {"banked": banked, "cold": cold, "warm": warm}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rec


def msgpack_leg(torch, device, serve_cli, card) -> dict:
    """Phase 34 (f): a ResNet-50 train state as the JAX package's trainer
    writes it (`flax_train_state`, `train/flax_msgpack.py::packb`: flax's
    bytes, with its sha256 sidecar) and the same f32 weights as the
    port's `.pt`, each served through cli/serve.py's `--ckpt`: the same
    top-k, bitwise."""
    from ddp_classification_pytorch_tpu_torch.models import convert
    from ddp_classification_pytorch_tpu_torch.train import (
        checkpoint,
        flax_msgpack,
    )
    from ddp_classification_pytorch_tpu_torch.train.state import (
        create_served_model,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_msgpack_")
    try:
        cfg32 = serve_cli.config_from_args(serve_cli.build_parser().parse_args(
            MSGPACK_ARGV + ["--dtype", "float32"]))
        model = create_served_model(cfg32, torch.device("cpu"))
        randomize_(torch, model, seed=3)
        sd = model.state_dict()
        data = flax_msgpack.packb(flax_train_state(sd, convert))
        paths = {"msgpack": os.path.join(root, "ckpt_e0.msgpack"),
                 "pt": os.path.join(root, "ckpt_e0.pt")}
        with open(paths["msgpack"], "wb") as f:
            f.write(data)
        with open(checkpoint.checksum_path(paths["msgpack"]), "w") as f:
            f.write(hashlib.sha256(data).hexdigest() + "\n")
        checkpoint.save(sd, paths["pt"])
        h = cfg32.data.image_size
        imgs = np.random.default_rng(35).integers(0, 256, (8, h, h, 3)).astype(
            np.uint8)
        served = {}
        for kind, path in paths.items():
            cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(
                MSGPACK_ARGV + ["--ckpt", path, "--aot_cache", "off"]))
            engine = serve_cli.build_engine(cfg, device)
            engine.warmup()
            served[kind] = _stack(_serve_batch(engine, imgs))
            engine.drain()
        same = _agree(*served["msgpack"], *served["pt"], ".msgpack vs .pt")
        check(same["bitwise"], ".msgpack and .pt serve different top-k")
        rec = {"bytes": len(data), "top5_equal_pt": True,
               "top1": served["msgpack"][1][:, 0].tolist()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[msgpack] {card}: (f) a JAX-format ResNet-50 train state "
        f"({rec['bytes']} bytes) served through --ckpt: top-5 bitwise the "
        f".pt's")
    return rec


def slice18_phase(torch, device, serve_cli, counters, card) -> dict:
    """Phase 34 (a)-(f); (a) is the main path of
    `serve_graph_path_launches` (K1 36 a TResNet-M forward, K2 12 a ViT
    forward, the others 0)."""
    t0 = time.perf_counter()
    tres, engine, cfg, imgs, answers = graph_leg(
        torch, device, serve_cli, counters, GRAPH_ARGV, "k1", ABN_SITES,
        "TResNet-M", card)
    rec = {"tresnet": tres}
    rec["hot_swap"] = hot_swap_leg(torch, device, engine, cfg, imgs, card)
    rec["strict"] = strict_leg(serve_cli, engine, imgs, card)
    engine.drain()
    del engine
    rec["serve_devices"] = serve_devices_leg(torch, device, serve_cli, imgs,
                                             answers, card)
    vit, engine, *_ = graph_leg(torch, device, serve_cli, counters,
                                VIT_GRAPH_ARGV, "fwd", VIT_BLOCKS, "ViT-B/16",
                                card, flash=True)
    engine.drain()
    del engine
    rec["vit"] = vit
    rec["launches"] = {k: tres["launches"][k] + vit["launches"][k]
                       for k in counters}
    gc.collect()
    torch.cuda.empty_cache()
    rec["aot"] = aot_leg(card)
    rec["msgpack"] = msgpack_leg(torch, device, serve_cli, card)
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# ------------------------------------------------------------- phase 35 --
RING_SHAPE = (32, 1024, 12, 64)  # ViT-B/16 at 512 px: B, T, H, D
RING_SHARDS = (2, 4)
LSE_TOL = 1e-4  # lse, f32 statistics of bf16 scores
# dQ/dK/dV under an lse cotangent, the kernels against the plain versions
# forwards included, bf16 (atol, RMS): the plain forward's own out feeds
# Δ, so the f32 dS of the two sides differ by more than on phase 7's
# shared inputs and their bf16 roundings straddle more: dQ/dK near 1.3e-3,
# dV (no Δ) near 1.7e-4 (an H100). The gradients are held at phase 7's
# limits against K2 with the plain backwards (the same out, lse and Δ:
# near 1.5e-4); this all-plain comparison is the extra one
LSE_GRAD_TOL = (1e-2, 2e-3)
# the ring against flash_attention on the whole T, bf16: each side rounds
# dQ/dK/dV (and out) to bf16 once, at different points of the sum (the
# ring after its f32 sum over visits), so the two sit up to one bf16
# rounding apart: (atol, RMS err / RMS ref)
RING_TOL = {"out": (1e-2, 5e-3), "grad": (2e-2, 5e-3)}
MOE_SHAPE = (32, 1024, 768)  # phase 33's MoE ViT-B/16 block input
MOE_EXPERTS, MOE_TOP_K = 8, 2  # H = 4·768 / 8 = 384 an expert
EP_SHARDS = (2, 4)
CE_B, CE_D, CE_C, CE_SHARDS = 128, 256, 100_000, 4
CE_TOL = 1e-4  # partial-FC vs dense, f32 (loss, gradients)
# the gradients' RMS err / RMS ref, partial-FC vs dense, f32: the sums run
# in another order (near 2e-6 on the CPU at this size)
CE_RMS_TOL = 1e-5
CE_NOISE = (0.6, 1.6)  # each row's feature: its label's unit row + σ·noise
MP_ARGV = ["baseline", "--dataset", "synthetic", "--synthetic_size", "8",
           "--model", "vit_b16", "--image_size", "64", "--num_classes", "10",
           "--batchsize", "4", "--epochs", "1", "--flash_attention",
           "--device", "cuda"]


def _rel(got, want) -> dict:
    """max |err|, max |ref| and RMS err / RMS ref of two tensors."""
    d = got.float() - want.float()
    ref = want.float()
    return {"max_abs_err": d.abs().max().item(),
            "max_abs_ref": ref.abs().max().item(),
            "rms_ratio": (d.pow(2).mean().sqrt()
                          / ref.pow(2).mean().sqrt().clamp_min(1e-30)).item()}


def _check_close(tag, got, want, key_tol) -> dict:
    """Each name's (got, want) within its (atol, RMS) of `key_tol`: max
    |err| within atol + rtol·|ref| (FLASH_TOL's bf16 rtol) and RMS err
    within RMS × RMS ref."""
    out = {}
    for name, (g, w) in zip(key_tol, zip(got, want)):
        r = _rel(g, w)
        atol, rms = key_tol[name]
        torch_ok = (g.float() - w.float()).abs().le(
            atol + FLASH_TOL["bfloat16"][2] * w.float().abs()).all().item()
        check(torch_ok and r["rms_ratio"] <= rms,
              f"{tag} {name}: {json.dumps(r)} (atol {atol}, RMS {rms})")
        out[name] = r
    return out


def model_axis_phase(torch, device, train_cli, counters, card) -> dict:
    """Phase 35 (a)-(e), the model axis's bodies at full width on the one
    card, N shards in one process (the seams `ring_attention_shards`,
    `moe_mlp_shards`, `arc_margin_ce_shards`: no CLI path reaches them).
    The references and (a) run first; then every count is set to 0 and
    (b) the flash ring's forward and backward over 2 and 4 shards run,
    its K2/K3/K4 launches `model_axis_path_launches`; (c) and (d) launch
    none of them."""
    import contextlib
    import io

    from ddp_classification_pytorch_tpu_torch.ops import attention as att
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa
    from ddp_classification_pytorch_tpu_torch.ops import moe
    from ddp_classification_pytorch_tpu_torch.ops import arcface
    from ddp_classification_pytorch_tpu_torch.ops import sharded_head as sh
    from ddp_classification_pytorch_tpu_torch.models.vit import xavier_uniform_

    t0 = time.perf_counter()
    rec = {}
    b, t, h, d = RING_SHAPE
    gen = torch.Generator(device=device).manual_seed(35)
    q, k, v, do = (torch.randn(RING_SHAPE, device=device, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    g_lse = torch.randn((b, h, t), device=device, generator=gen)

    def lse_grads(fn):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out, lse = fn(*xs)
        torch.autograd.backward([out, lse], [do, g_lse])
        return out.detach(), lse.detach(), *[x.grad for x in xs]

    def rings():
        out = {}
        for n in RING_SHARDS:
            chunks = [list(x.chunk(n, dim=1)) for x in (q, k, v, do)]
            outs, grads = att.ring_attention_shards(*chunks, use_flash=True)
            out[n] = [torch.cat(outs, 1)] + [torch.cat(g, 1) for g in grads]
        return out

    def plain_runs(names):
        """lse_grads and rings with the wrappers `names` swapped for their
        plain versions."""
        wrappers = {nm: getattr(fa, nm) for nm in names}
        for nm in names:
            setattr(fa, nm, getattr(fa, nm + "_ref"))
        try:
            return lse_grads(fa.flash_attention_with_lse), rings()
        finally:
            for nm, fn in wrappers.items():
                setattr(fa, nm, fn)

    # references: the plain versions through the same Function and the
    # same ring, forwards and backwards; K2 with the plain backwards, so
    # that K3/K4 and their plain versions see the same out, lse and Δ;
    # and flash_attention (the kernels) on the whole T
    plain, plain_rings = plain_runs(("flash_forward", "flash_dq",
                                     "flash_dkv"))
    plain_bwd, plain_bwd_rings = plain_runs(("flash_dq", "flash_dkv"))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    whole_out = fa.flash_attention(*xs)
    whole_out.backward(do)
    whole = (whole_out.detach(), *[x.grad for x in xs])
    del xs, whole_out
    got_a = lse_grads(fa.flash_attention_with_lse)
    torch.cuda.synchronize()

    # ----- the counted main path: (b), the flash ring with the kernels
    _reset(counters)
    shards = rings()
    torch.cuda.synchronize()
    launches = {kk: f.launches for kk, f in counters.items()}
    visits = sum(n * n for n in RING_SHARDS)  # N shards × N visits
    want = dict.fromkeys(counters, 0) | {"fwd": visits, "dq": visits,
                                        "dkv": visits}
    check(launches == want, f"model axis launches {launches}, want {want}")
    rec["launches"] = launches

    # (a) out = flash_attention's (the same K2), lse and the gradients
    # (with a nonzero lse cotangent) against the plain versions
    check(torch.equal(got_a[0], whole[0]),
          "flash_attention_with_lse's out is not flash_attention's")
    lse_err = _rel(got_a[1], plain[1])
    check(lse_err["max_abs_err"] <= LSE_TOL * max(1.0, lse_err["max_abs_ref"]),
          f"lse off its plain version: {json.dumps(lse_err)}")
    o_tol, g_tol, _ = FLASH_TOL["bfloat16"]
    o_rms, g_rms = FLASH_RMS_TOL["bfloat16"]
    grad_tol = dict.fromkeys(("dq", "dk", "dv"), (g_tol, g_rms))
    check(torch.equal(got_a[0], plain_bwd[0]) and torch.equal(
        got_a[1], plain_bwd[1]), "K2 not bitwise the same in two runs")
    rec["with_lse"] = {"lse": lse_err} | _check_close(
        "with_lse", got_a[2:], plain_bwd[2:], grad_tol)
    rec["with_lse"]["vs_all_plain"] = _check_close(
        "with_lse vs all plain", got_a[2:], plain[2:],
        dict.fromkeys(("dq", "dk", "dv"), LSE_GRAD_TOL))
    log(f"[model-axis] (a) flash_attention_with_lse {list(RING_SHAPE)} bf16: "
        f"out bitwise flash_attention's; {json.dumps(rec['with_lse'])}")

    # (b) the ring over N shards against the same ring on the plain
    # versions at phase 7's limits (out against the plain forwards, the
    # gradients against the plain backwards after K2), and against
    # flash_attention on the whole T
    rec["ring"] = {}
    for n, got in shards.items():
        plain_errs = _check_close(f"ring N={n} vs plain ring", got[:1],
                                  plain_rings[n][:1], {"out": (o_tol, o_rms)})
        plain_errs |= _check_close(f"ring N={n} vs plain backward ring",
                                   got[1:], plain_bwd_rings[n][1:], grad_tol)
        errs = _check_close(f"ring N={n}", got, whole,
                            {"out": RING_TOL["out"], "dq": RING_TOL["grad"],
                             "dk": RING_TOL["grad"], "dv": RING_TOL["grad"]})
        chunks = [list(x.chunk(n, dim=1)) for x in (q, k, v, do)]
        ring_ms = event_step_ms(torch, lambda c=chunks: att.ring_attention_shards(
            *c, use_flash=True))
        rec["ring"][n] = {"errors_vs_plain_ring": plain_errs,
                          "errors": errs, "fwd_bwd_ms": ring_ms,
                          "k2_k3_k4_each": n * n}
        log(f"[model-axis] (b) flash ring N={n} {list(RING_SHAPE)} bf16 vs "
            f"the plain ring: {json.dumps(plain_errs)}; vs flash_attention "
            f"on the whole T: {json.dumps(errs)}; forward + "
            f"backward {ring_ms:.3f} ms ({card})")
    del shards, plain_rings, plain_bwd_rings

    def whole_fwd_bwd():
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        fa.flash_attention(*xs).backward(do)

    rec["flash_attention_fwd_bwd_ms"] = event_step_ms(torch, whole_fwd_bwd)
    log(f"[model-axis] (b) flash_attention on the whole T, forward + "
        f"backward {rec['flash_attention_fwd_bwd_ms']:.3f} ms ({card})")
    del q, k, v, do, g_lse, got_a, plain, plain_bwd, whole
    _free()

    # (c) the EP combine over N shards against the one-shard moe_mlp
    bb, tt, c = MOE_SHAPE
    hid = 4 * c // MOE_EXPERTS
    x = torch.randn(MOE_SHAPE, device=device, generator=gen).to(torch.bfloat16)
    w_in = xavier_uniform_(torch.empty(MOE_EXPERTS, c, hid, device=device))
    w_out = xavier_uniform_(torch.empty(MOE_EXPERTS, hid, c, device=device))
    b_in = torch.randn(MOE_EXPERTS, hid, device=device, generator=gen) * 0.1
    b_out = torch.randn(MOE_EXPERTS, c, device=device, generator=gen) * 0.1
    router = xavier_uniform_(torch.empty(c, MOE_EXPERTS, device=device))
    with torch.no_grad():
        gates = moe.topk_gates(moe.router_logits(x, router), MOE_TOP_K)
        one = moe.moe_mlp(x, gates, w_in, b_in, w_out, b_out)
        rec["ep"] = {"one_shard_ms": event_step_ms(
            torch, lambda: moe.moe_mlp(x, gates, w_in, b_in, w_out, b_out))}
        for n in EP_SHARDS:
            banks = [tuple(t_.chunk(n)[i] for t_ in (w_in, b_in, w_out, b_out))
                     for i in range(n)]
            got = moe.moe_mlp_shards(x, gates, banks)
            err = _rel(got, one)
            check(err["max_abs_err"] <= MOE_ROUTE_TOL * err["max_abs_ref"],
                  f"EP N={n}: {json.dumps(err)} (tol {MOE_ROUTE_TOL} × max)")
            rec["ep"][n] = err | {"ms": event_step_ms(
                torch, lambda bk=banks: moe.moe_mlp_shards(x, gates, bk))}
    log(f"[model-axis] (c) EP combine {list(MOE_SHAPE)} bf16, "
        f"{MOE_EXPERTS} experts of {hid}, top-{MOE_TOP_K}, vs one shard: "
        f"{json.dumps(rec['ep'])} ({card})")
    del x, w_in, w_out, b_in, b_out, router, gates, one
    _free()

    # (d) the partial-FC CE against the dense margin + CE, f32; each
    # feature near its label's weight row, σ spread over CE_NOISE, so that
    # some rows rank their label first, some second or third, some lower
    weight = torch.randn(CE_C, CE_D, device=device, generator=gen)
    labels = torch.randint(0, CE_C, (CE_B,), device=device, generator=gen)
    unit = torch.nn.functional.normalize(weight[labels], dim=1)
    sigma = torch.linspace(*CE_NOISE, CE_B, device=device)[:, None]
    feats = unit + sigma * torch.randn(CE_B, CE_D, device=device,
                                       generator=gen) / CE_D ** 0.5
    del unit, sigma

    def dense():
        f, w = feats.clone().requires_grad_(), weight.clone().requires_grad_()
        logits = arcface.arc_margin_logits(f, w, labels)
        loss = torch.nn.functional.cross_entropy(logits, labels)
        loss.backward()
        top = torch.topk(logits.detach(), 3, dim=1).indices
        hit = top == labels[:, None]
        return loss.detach(), hit[:, 0].sum(), hit.any(1).sum(), f.grad, w.grad

    def sharded():
        f, w = feats.clone().requires_grad_(), weight.clone().requires_grad_()
        loss, t1, t3 = sh.arc_margin_ce_shards(f, list(w.chunk(CE_SHARDS)),
                                               labels)
        loss.backward()
        return loss.detach(), t1, t3, f.grad, w.grad

    def peak(fn):
        _free()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated(device) - base) / 1e6

    want_ce, dense_mb = peak(dense)

    def one_shard():  # shard 0's own block: what a rank of N holds
        with torch.no_grad():
            logits, _ = sh._local_margin_logits(
                feats, weight.chunk(CE_SHARDS)[0], labels, 0, 30.0, 0.5,
                False)
            return torch.exp(logits - logits.amax(1, keepdim=True)).sum(1)

    _, shard_mb = peak(one_shard)
    def dense_forward():
        with torch.no_grad():
            return arcface.arc_margin_logits(feats, weight, labels)

    _, dense_fwd_mb = peak(dense_forward)
    got_ce, all_shards_mb = peak(sharded)
    check(0 < int(want_ce[1]) < int(want_ce[2]) < CE_B,
          f"partial-FC reference counts top-1 {int(want_ce[1])}, top-3 "
          f"{int(want_ce[2])} of {CE_B}: the count check would be empty")
    other = torch.ones(CE_C, dtype=torch.bool, device=device)
    other[labels] = False  # the weight rows no label names
    pairs = list(zip(("loss", "top1", "top3", "dfeatures", "dweight"),
                     got_ce, want_ce))
    pairs.append(("dweight_other_rows", got_ce[4][other], want_ce[4][other]))
    errs = {}
    for name, g, w in pairs:
        e = _rel(g, w)
        check(e["max_abs_err"] <= CE_TOL * max(1.0, e["max_abs_ref"]),
              f"partial-FC {name}: {json.dumps(e)}")
        if name.startswith("d"):
            check(e["rms_ratio"] <= CE_RMS_TOL,
                  f"partial-FC {name}: {json.dumps(e)} (RMS {CE_RMS_TOL})")
        errs[name] = e
    del other, pairs
    rec["partial_fc"] = {
        "shape": [CE_B, CE_D, CE_C], "shards": CE_SHARDS, "errors": errs,
        "loss": float(want_ce[0]), "top1": int(want_ce[1]),
        "top3": int(want_ce[2]),
        "one_shard_forward_peak_mb": shard_mb,
        "dense_forward_peak_mb": dense_fwd_mb,
        "dense_fwd_bwd_peak_mb": dense_mb,
        "in_process_shards_fwd_bwd_peak_mb": all_shards_mb,
        "dense_ms": event_step_ms(torch, dense),
        "sharded_in_process_ms": event_step_ms(torch, sharded)}
    log(f"[model-axis] (d) partial-FC CE B={CE_B} D={CE_D} C={CE_C} over "
        f"{CE_SHARDS} shards vs dense margin + CE: "
        f"{json.dumps(rec['partial_fc'])} ({card})")
    del feats, weight, labels, want_ce, got_ce
    _free()

    # (e) the CLI: --mp 2 on one card is rc 2 with the mesh text; --mp 1
    # trains as before
    rcs = {}
    for mp in ("2", "1"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                train_cli.main(MP_ARGV + ["--mp", mp, "--out", tmp])
            rc = 0
        except SystemExit as e:
            rc = e.code
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        rcs[mp] = {"rc": rc, "stderr": err.getvalue().strip()[-300:]}
    check(rcs["2"]["rc"] == 2 and "mesh 0×2×1 does not cover 1 devices"
          in rcs["2"]["stderr"], f"--mp 2 on one card: {rcs['2']}")
    check(rcs["1"]["rc"] == 0, f"--mp 1: {rcs['1']}")
    rec["cli"] = rcs
    log(f"[model-axis] (e) --mp 2 rc {rcs['2']['rc']} "
        f"({rcs['2']['stderr'][-80:]}); --mp 1 rc {rcs['1']['rc']}")
    rec["phase_s"] = time.perf_counter() - t0
    return rec


PIPE_SHAPE = (32, 196, 768)  # ViT-B/16 at 224 px: B, T, C
PIPE_SCHEDULES = ((2, 4), (4, 8))  # (stages, microbatches)
# (max |err| / max |ref|, RMS err / RMS ref) of the pipelined stack
# against the sequential one, bf16: each microbatch's products run at
# another cuBLAS shape, so a block's outputs may round one bf16 ulp (2^-8)
# apart and the 12 blocks carry it on; the parameter gradients also sum
# M microbatch products in another order
PIPE_TOL = {"out": (3e-2, 5e-3), "grad": (6e-2, 1e-2)}
PIPE_ARGV = ["baseline", "--dataset", "synthetic", "--synthetic_size", "256",
             "--model", "vit_b16", "--image_size", "224", "--num_classes",
             "1000", "--batchsize", "32", "--dtype", "bfloat16", "--epochs",
             "1", "--pp_microbatches", "4", "--device", "cuda"]
PIPE_ARC_ARGV = ["arcface", "--dataset", "synthetic", "--synthetic_size",
                 "64", "--model", "vit_b16", "--image_size", "224",
                 "--num_classes", "100", "--batchsize", "32", "--dtype",
                 "bfloat16", "--epochs", "1", "--pp_microbatches", "2",
                 "--device", "cuda"]
PIPE_ARC_STEPS = 2
PIPE_TINY = ["--dataset", "synthetic", "--synthetic_size", "8",
             "--image_size", "32", "--num_classes", "4", "--batchsize", "4",
             "--epochs", "1", "--device", "cuda"]
PIPE_REJECTIONS = [  # (argv, JAX's text)
    (["baseline", "--model", "vit_b16", "--pp_stages", "2",
      "--pp_microbatches", "2"], "mesh 0×1×2 does not cover 1 devices"),
    (["baseline", "--model", "vit_b16", "--pp_stages", "2"],
     "--pp_stages requires --pp_microbatches"),
    (["baseline", "--model", "resnet50", "--pp_microbatches", "2"],
     "pipeline parallelism (--pp_microbatches) requires a ViT arch with a "
     "homogeneous block stack; got 'resnet50'"),
    (["baseline", "--model", "vit_b16", "--grad_accum", "2",
      "--pp_microbatches", "2"],
     "grad-accum-indivisible: grad_accum > 1 does not compose with the "
     "pipeline schedule")]


def _cli_rc(train_cli, argv) -> dict:
    """`cli/train.py` in process: its rc and the end of its stderr."""
    import contextlib
    import io

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pp_")
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            train_cli.main(argv + ["--out", tmp])
        rc = 0
    except SystemExit as e:
        rc = e.code
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"rc": rc, "stderr": err.getvalue().strip()[-300:]}


def pipeline_executor_leg(torch, device, card) -> dict:
    """Phase 36 (a): `gpipe_shards` at (S, M) in PIPE_SCHEDULES against
    the sequential stack of ViT-B/16's 12 blocks, forward and backward."""
    from ddp_classification_pytorch_tpu_torch.models.pipeline_vit import GPipeViT
    from ddp_classification_pytorch_tpu_torch.ops import pipeline
    from ddp_classification_pytorch_tpu_torch.train.state import init_weights_

    model = GPipeViT("vit_b16", 0, 224, 1, torch.bfloat16)
    init_weights_(model, torch.Generator().manual_seed(36))
    model.to(device)
    blocks = [model.blocks[str(i)] for i in range(model.depth)]
    params = [p for b in blocks for p in b.parameters()]
    gen = torch.Generator(device=device).manual_seed(36)
    x = torch.randn(PIPE_SHAPE, device=device, generator=gen).to(torch.bfloat16)
    g = torch.randn(PIPE_SHAPE, device=device, generator=gen).to(torch.bfloat16)

    def block_fn(block, h):
        return block(h)[0]

    def sequential():
        for p in params:
            p.grad = None
        h = x.clone().requires_grad_()
        out = pipeline.stage_apply(block_fn, blocks, h)
        out.backward(g)
        return out.detach(), h.grad, [p.grad for p in params]

    def piped(s, m):
        n = len(blocks) // s
        return pipeline.gpipe_shards(
            block_fn, [blocks[i * n:(i + 1) * n] for i in range(s)], x, m, g)

    def peak(fn):
        _free()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated(device) - base) / 1e6

    (want_out, want_dx, want_grads), seq_mb = peak(sequential)
    rec = {"shape": list(PIPE_SHAPE), "blocks": len(blocks),
           "sequential": {"fwd_bwd_ms": event_step_ms(torch, sequential),
                          "peak_mb": seq_mb}}

    def close(tag, got, want, tol):
        e = _rel(got, want)
        check(e["max_abs_err"] <= tol[0] * max(e["max_abs_ref"], 1e-30)
              and e["rms_ratio"] <= tol[1],
              f"pipeline {tag}: {json.dumps(e)} (tol {tol})")
        return e

    for s, m in PIPE_SCHEDULES:
        run, mb = peak(lambda: piped(s, m))
        check(run.ticks == pipeline.ticks(s, m) == m + s - 1,
              f"(S, M) = ({s}, {m}): {run.ticks} ticks")
        errs = {"out": close(f"({s},{m}) out", run.out, want_out,
                             PIPE_TOL["out"]),
                "dx": close(f"({s},{m}) dx", run.dx, want_dx,
                            PIPE_TOL["grad"])}
        grads = [gr for stage in run.grads for gr in stage]
        check(len(grads) == len(want_grads), "gradient count")
        worst = None
        for i, (gp, wp) in enumerate(zip(grads, want_grads)):
            e = close(f"({s},{m}) grad {i}", gp, wp, PIPE_TOL["grad"])
            if worst is None or e["rms_ratio"] > worst["rms_ratio"]:
                worst = e | {"param": i}
        errs["worst_param_grad"] = worst
        rec[f"S{s}_M{m}"] = {"ticks": run.ticks, "errors": errs,
                             "fwd_bwd_ms": event_step_ms(
                                 torch, lambda: piped(s, m)),
                             "peak_mb": mb}
        del run
        log(f"[pipeline] (a) gpipe_shards S={s} M={m} {list(PIPE_SHAPE)} "
            f"bf16 vs the sequential {len(blocks)} blocks: "
            f"{json.dumps(rec[f'S{s}_M{m}'])} ({card})")
    log(f"[pipeline] (a) sequential {len(blocks)} blocks: "
        f"{json.dumps(rec['sequential'])} ({card})")
    del model, blocks, params, x, g, want_out, want_dx, want_grads
    _free()
    return rec


def pipeline_arcface_leg(torch, device, train_cli, card) -> dict:
    """Phase 36 (c): `arcface --pp_microbatches 2` on one card, 2 steps;
    its labels=None scores against the dense margin head on the model's
    own embedding."""
    from ddp_classification_pytorch_tpu_torch.models.heads import ArcMarginHead

    tr, tmp = _trainer(train_cli, PIPE_ARC_ARGV, device)
    try:
        tr.train_loader.set_epoch(0)
        it = iter(tr.train_prefetch)
        try:
            batches = [next(it) for _ in range(PIPE_ARC_STEPS)]
        finally:
            it.close()
        losses = [float(tr.train_step(tr.state, im, lb)["loss"])
                  for im, lb in batches]
        check(all(np.isfinite(losses)), f"arcface pipeline losses {losses}")
        model = tr.state.model.eval()
        images = batches[0][0]
        with torch.no_grad():
            x = images.permute(0, 3, 1, 2).float() / 255.0
            scores = model(x)
            emb = model.features(x)
            dense = ArcMarginHead(*model.margin.weight.shape,
                                  s=model.margin.s).to(device)
            dense.weight.copy_(model.margin.weight)
            want = dense(emb)
        e = _rel(scores, want)
        check(e["max_abs_err"] <= 1e-5 * max(1.0, e["max_abs_ref"]),
              f"arcface pipeline scores vs the dense head: {json.dumps(e)}")
        rec = {"losses": losses, "scores_vs_dense": e,
               "shape": list(scores.shape)}
    finally:
        tr._close()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[pipeline] (c) arcface --pp_microbatches 2, {PIPE_ARC_STEPS} "
        f"steps: {json.dumps(rec)} ({card})")
    return rec


def pipeline_phase(torch, device, train_cli, checkpoint, counters,
                   card) -> dict:
    """Phase 36 (a)-(d); the counts, set to 0 before (a) and read after
    (d), are the kernels line's `pipeline_path_launches` (all 0)."""
    t0 = time.perf_counter()
    _reset(counters)
    rec = {"executor": pipeline_executor_leg(torch, device, card)}

    def resume(tr, ckpt):
        out = os.path.dirname(ckpt)
        cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
            PIPE_ARGV + ["--out", out, "--epochs", "2", "--auto_resume"]))
        from ddp_classification_pytorch_tpu_torch.train.loop import Trainer

        again = Trainer(cfg, device)
        check(again.start_epoch == 1, f"auto_resume starts at epoch "
              f"{again.start_epoch}, not 1")
        last = again.run()
        check(all(np.isfinite(v) for k, v in last.items()
                  if k == "loss" or k.startswith("val_")),
              f"resumed epoch not finite: {last}")
        return {"resumed": last, "resumed_step": again.state.step}

    trainer, _, rec["train"] = train_main_path(
        torch, device, train_cli, checkpoint, PIPE_ARGV, counters,
        dict.fromkeys(counters, 0), "pipeline-train", resume)
    del trainer
    _free()
    rec["arcface"] = pipeline_arcface_leg(torch, device, train_cli, card)
    _free()
    rec["rejections"] = {}
    for argv, text in PIPE_REJECTIONS:
        got = _cli_rc(train_cli, argv + PIPE_TINY)
        check(got["rc"] == 2 and text in got["stderr"],
              f"{' '.join(argv)}: {got}, want rc 2 with {text!r}")
        rec["rejections"][" ".join(argv[1:])] = got
    log(f"[pipeline] (d) {json.dumps(rec['rejections'])}")
    rec["launches"] = {k: f.launches for k, f in counters.items()}
    check(all(v == 0 for v in rec["launches"].values()),
          f"pipeline path launches {rec['launches']}, want 0 each")
    rec["phase_s"] = time.perf_counter() - t0
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this script runs on the "
              "card only, with no CPU fallback", file=sys.stderr)
        return 1
    from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
    from ddp_classification_pytorch_tpu_torch.data import native
    from ddp_classification_pytorch_tpu_torch.models import tresnet
    from ddp_classification_pytorch_tpu_torch.ops import fused_abn
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa
    from ddp_classification_pytorch_tpu_torch.train.state import create_served_model
    from ddp_classification_pytorch_tpu_torch.train.steps import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        device_input_epilogue,
        make_topk_predict_step,
    )
    from ddp_classification_pytorch_tpu_torch.utils.backend_probe import (
        resolve_device,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {}
    k1 = fused_abn.fused_bn_leaky_relu

    # -------------------------------------------------------- 1. device --
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(card)
    log(f"[device] {name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    report["card"] = card
    device = resolve_device("cuda")

    # --------------------------------------------------------- 2. build --
    def timed_build(build):
        t0 = time.perf_counter()
        return build(), time.perf_counter() - t0

    # the dataplane's toolchain, probed before anything relies on it:
    # phases 16-19 take an image folder only where libjpeg can be built
    # against, else CIFAR pickles
    probe = native.probe_toolchain()
    dataplane_ok = bool(probe["g++"] and probe["jpeglib.h"] and probe["-ljpeg"])
    where = ("an image folder" if dataplane_ok else
             "CIFAR pickles: no libjpeg to build the dataplane against, "
             "image-folder training SKIPPED")
    log(f"[dataplane] probe: {json.dumps(probe)}; os.cpu_count() "
        f"{os.cpu_count()}; phases 16-19 on {where}")
    report["dataplane"] = {"probe": probe, "cpu_count": os.cpu_count(),
                           "image_folder_phases": dataplane_ok}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one compiler per source, together
        dp_build = (pool.submit(timed_build, native.get_lib)
                    if dataplane_ok else None)
        builds = list(pool.map(timed_build, (fused_abn.build, fa.build)))
        if dp_build is not None:
            dp_lib, dp_s = dp_build.result()
            report["dataplane"].update(
                library=os.path.relpath(dp_lib._name, REPO), build_s=dp_s,
                png=bool(dp_lib.dp_has_png()))
            log(f"[dataplane] built {report['dataplane']['library']} in "
                f"{dp_s:.2f} s (PNG decode: {report['dataplane']['png']})")
    build_s = time.perf_counter() - t0
    for lib, secs in builds:
        log(f"[build] {os.path.relpath(lib, REPO)} in {secs:.2f} s")
        with open(lib + ".log") as f:
            for line in f.read().splitlines():
                log(f"[build] nvcc: {line}")
    log(f"[build] all in {build_s:.2f} s")
    report["build_s"] = build_s
    from ddp_classification_pytorch_tpu_torch.ops import _build

    hgmma = hgmma_counts(find_cuobjdump(_build), builds[1][0])
    log(f"[build] HGMMA instructions in the SASS: {json.dumps(hgmma)}")
    check(all(hgmma.get(k, 0) > 0 for k in WGMMA_KERNELS),
          f"bf16 K2/K3/K4 SASS without wgmma: {hgmma}")
    report["hgmma"] = hgmma
    resources = fa.kernel_resources()
    log(f"[build] bf16 K2/K3/K4 registers, shared memory, blocks per SM: "
        f"{json.dumps(resources)}")
    report["kernel_resources"] = resources

    # ---------------------------- 31 (d). the profiler window, run first --
    # before any other profiler session of this process: repeated sessions
    # in one process stop recording device activity (DeviceTimer)
    t0 = time.perf_counter()
    prof_rec = profile_window_phase(
        torch, device, dict(zip(("k1", "k1s", "k1r", "k1d"), (
            getattr(fused_abn, n) for n in ABN_WRAPPERS))) | {
            kind: getattr(fa, attr) for kind, attr, *_ in FLASH_KERNELS},
        card)
    prof_rec["phase_s"] = time.perf_counter() - t0
    log(f"[profile] phase 31 (d) took {prof_rec['phase_s']:.1f} s")

    # ABN shapes come from the model itself: hooks on one forward of a
    # second instance of the served model (phases 5 and 6 reuse it),
    # outside the counted run; at bucket 8 and 224 px here, and at batch
    # 32 on the real-data path's train crops for phase 11
    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(SERVE_ARGV))
    model = create_served_model(cfg, device)
    predict = make_topk_predict_step(cfg, cfg.serve.topk)

    def abn_shapes(n, px):
        seen = []
        hooks = [m.register_forward_pre_hook(
            lambda _m, args: seen.append(tuple(args[0].shape)))
            for m in model.modules() if isinstance(m, tresnet.FusedABN)]
        predict(model, torch.zeros((n, px, px, 3), dtype=torch.uint8,
                                   device=device))
        for hk in hooks:
            hk.remove()
        check(len(seen) == ABN_SITES,
              f"{len(seen)} ABN sites in one forward, expected {ABN_SITES}")
        return seen

    h = cfg.data.image_size
    shapes = abn_shapes(8, h)
    # the train crops of phase 17: RandomResizedCrop(256) on an image
    # folder, 32 px on CIFAR
    real_data_shapes = {px: abn_shapes(IF_BATCH, px) for px in (IF_CROP, 32)}

    # ------------------------------------------ 3. kernel vs plain (K1) --
    gen = torch.Generator(device=device).manual_seed(0)
    ragged = [(393, 48), (1001, 37)]  # odd M; C = 48 and a C off every vector width
    cases = sorted(set(shapes), key=lambda s: (-s[2], s[1])) + ragged
    max_err = 0.0
    per_shape = []
    for shape in cases:
        c = shape[1]

        def vec(lo, hi):
            return torch.rand(c, device=device, generator=gen) * (hi - lo) + lo

        scale, bias = vec(0.5, 1.5), vec(-0.5, 0.5)
        mean, var = vec(-0.5, 0.5), vec(0.5, 2.0)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            if len(shape) == 4:  # (N, C, H, W) channels_last, as the model has it
                n, _, hh, ww = shape
                x = (torch.randn((n, hh, ww, c), device=device, generator=gen)
                     * 1.5 + 0.3).to(dtype).permute(0, 3, 1, 2)
            else:  # (M, C) rows
                x = (torch.randn(shape, device=device, generator=gen)
                     * 1.5 + 0.3).to(dtype)
            args = (x, scale, bias, mean, var, 1e-5, tresnet.SLOPE)
            y, ref = k1(*args), fused_abn.fused_bn_leaky_relu_ref(*args)
            torch.cuda.synchronize()
            check(y.dtype == dtype and y.shape == x.shape, f"K1 output {shape}")
            err = (y.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=tol)
            max_err = max(max_err, err)
            geom = abn_geometry(fused_abn, x, y, args)
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "geometry": geom._asdict(),
                   "kernel_wall_us": wall_ms(torch, lambda: k1(*args)) * 1e3,
                   "bound_us": abn_bound_ms([shape], x.element_size())[0] * 1e3,
                   "sites_per_forward": shapes.count(shape)}
            per_shape.append((row, args, abn_yardsticks(torch, fused_abn, x, geom)))
            # device times: phase 6
        log(f"[k1] {shape}: K1 agrees with the plain version (f32, bf16)")

    # -------------------------------------------------- 4. the main path --
    k1.launches = 0  # count only the main path's launches
    t0 = time.perf_counter()
    engine = serve_cli.build_engine(cfg, device)
    engine.warmup()
    preds = serve_cli.run_selfcheck(engine, cfg, 32)
    wall = time.perf_counter() - t0
    launches = k1.launches
    forwards = len(engine.buckets) + engine.metrics.batches
    snap = engine.metrics.snapshot(engine.queue_depth)
    log(engine.metrics.log_line(engine.queue_depth))
    check(len(preds) == 32 and engine.metrics.completed == 32,
          "not every request was answered")
    check(all(p.scores.shape == (5,) and np.isfinite(p.scores).all()
              and (p.scores >= 0).all() and p.scores.sum() <= 1.0 + 1e-3
              for p in preds), "non-finite or invalid probabilities")
    check(launches == ABN_SITES * forwards,
          f"K1 launched {launches} times over {forwards} forwards "
          f"({len(engine.buckets)} warmup + {engine.metrics.batches} batches), "
          f"expected {ABN_SITES * forwards}")
    lat = sorted(p.latency_ms for p in preds)
    serve = {"requests": 32, "forwards": forwards, "launches": launches,
             "first_batch_ms": lat[0], "last_batch_ms": lat[-1],
             "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
             "bucket_hist": snap["bucket_hist"], "wall_s": wall,
             "selfcheck_images_per_s": 32 / wall}
    log(f"[serve] {name}: {json.dumps(serve)}")
    report["serve"] = serve

    # ------------------------------------- 5. the slice, kernel vs plain --
    randomize_(torch, model, seed=1)
    rng = np.random.default_rng(cfg.run.seed)
    batch = torch.from_numpy(
        rng.integers(0, 256, (8, h, h, 3)).astype(np.uint8)).to(device)
    mean = torch.from_numpy(IMAGENET_MEAN).view(1, 3, 1, 1).to(device)
    std = torch.from_numpy(IMAGENET_STD).view(1, 3, 1, 1).to(device)

    def logits():
        with torch.inference_mode():
            x = device_input_epilogue(batch.permute(0, 3, 1, 2), mean, std)
            return model(x).float()

    before = k1.launches
    with_kernel = logits()
    check(k1.launches == before + ABN_SITES, "kernel forward skipped K1")
    tresnet.fused_bn_leaky_relu = fused_abn.fused_bn_leaky_relu_ref
    try:
        with_plain = logits()
    finally:
        tresnet.fused_bn_leaky_relu = k1
    check(k1.launches == before + ABN_SITES, "plain forward launched K1")
    spread = with_plain.std().item()
    diff = (with_kernel - with_plain).abs().max().item()
    log(f"[slice] logits std {spread:.6g}, max |kernel - plain| {diff:.6g}, "
        f"top-1 agreement "
        f"{(with_kernel.argmax(1) == with_plain.argmax(1)).float().mean().item()}")
    check(torch.isfinite(with_kernel).all().item(), "non-finite logits")
    check(spread > 1e-3, f"degenerate logits (std {spread})")
    check(diff <= 0.05 * spread,
          f"slice logits disagree: max diff {diff} > 5% of std {spread}")
    report["slice"] = {"logits_std": spread, "max_abs_diff": diff}

    # the same weights in f32 on the CPU (plain ABN, which the CPU tests
    # hold against the JAX package) as the reference for two images: the
    # bf16 card forward stays within 10% of the logits' spread
    # (bf16 rounding through ~70 conv/norm layers) and agrees on top-1
    ref_cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(
        SERVE_ARGV[:-2] + ["--dtype", "float32", "--device", "cpu"]))
    ref_model = create_served_model(ref_cfg, torch.device("cpu"),
                                    state_dict=model.state_dict())
    with torch.inference_mode():
        x = device_input_epilogue(batch[:2].cpu().permute(0, 3, 1, 2),
                                  mean.cpu(), std.cpu())
        ref_logits = ref_model(x).float()
    ref_spread = ref_logits.std().item()
    ref_diff = (with_kernel[:2].cpu() - ref_logits).abs().max().item()
    top1 = (with_kernel[:2].cpu().argmax(1) == ref_logits.argmax(1)).all().item()
    log(f"[slice] card bf16 vs CPU f32 reference (2 images): max |diff| "
        f"{ref_diff:.6g}, logits std {ref_spread:.6g}, top-1 equal {top1}")
    check(ref_diff <= 0.1 * ref_spread and top1,
          f"served logits off the f32 CPU reference: {ref_diff} vs std "
          f"{ref_spread}, top-1 equal {top1}")
    report["slice"].update(ref_max_abs_diff=ref_diff, ref_logits_std=ref_spread)

    # ------------------------------------------------------ 6. timings --
    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    sites = []
    for shape in shapes:  # the 36 launches of one bucket-8 forward, in order
        n, c, hh, ww = shape
        x = torch.randn((n, hh, ww, c), device=device,
                        generator=gen).to(torch.bfloat16).permute(0, 3, 1, 2)
        vecs = [torch.rand(c, device=device, generator=gen) + 0.5
                for _ in range(4)]
        sites.append((x, *vecs, 1e-5, tresnet.SLOPE))
    site_outs = [k1(*a) for a in sites]
    site_yards = [abn_yardsticks(torch, fused_abn, a[0], abn_geometry(
        fused_abn, a[0], y, a)) for a, y in zip(sites, site_outs)]
    del site_outs
    plain = fused_abn.fused_bn_leaky_relu_ref
    served = engine._state
    bucket_imgs = {b: torch.zeros((b, h, h, 3), dtype=torch.uint8, device=device)
                   for b in engine.buckets}
    seq = {"wall_ms": wall_ms(torch, lambda: [k1(*a) for a in sites]),
           "bound_ms": abn_bound_ms(shapes, 2)[0],
           "bound_by": abn_bound_ms(shapes, 2)[1]}
    forward = {b: {"wall_ms": wall_ms(torch, lambda im=im: predict(served, im))}
               for b, im in bucket_imgs.items()}
    # host time of issuing one K1 launch through its wrapper: the 36 sites
    # in a row with nothing synchronized (the median of 5 such rows)
    rows_us = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in sites:
            k1(*a)
        rows_us.append((time.perf_counter() - t0) / ABN_SITES * 1e6)
    torch.cuda.synchronize()
    seq["host_us_per_launch"] = statistics.median(rows_us)
    with DeviceTimer(torch, lambda: (k1.launches,)) as timer:  # device
        # times, host overhead aside
        for i, (row, args, yard) in enumerate(per_shape):
            timer.run(f"k1 {i}", lambda a=args: k1(*a))
            timer.run(f"plain {i}", lambda a=args: plain(*a))
            for key, fn in yard.items():
                timer.run(f"{key} {i}", fn)
        timer.run("k1 seq", lambda: [k1(*a) for a in sites])
        timer.run("plain seq", lambda: [plain(*a) for a in sites])
        for key in ("floor", "copy"):
            timer.run(f"{key} seq", lambda k=key: [y[k]() for y in site_yards])
        for b, im in bucket_imgs.items():
            timer.run(f"forward {b}", lambda im=im: predict(served, im), reps=10)
    res = timer.results()
    del sites, site_yards
    for label, (_, names) in res.items():  # attribution check: K1 regions
        if label.startswith("k1 "):           # hold exactly their launches
            want = REPS * (ABN_SITES if label == "k1 seq" else 1)
            if names is None:  # timed with CUDA events: the counter speaks
                check(timer.launched[label] == (want,),
                      f"region {label}: {timer.launched[label]} K1 launches, "
                      f"want {want}")
            else:
                check(len(names) == want
                      and all("fused_abn" in n for n in names),
                      f"profiler region {label}: {len(names)} kernels, want "
                      f"{want} K1")
    dev = {label: ms for label, (ms, _) in res.items()}
    for i, (row, *_) in enumerate(per_shape):
        row.update(kernel_us=dev[f"k1 {i}"] * 1e3, plain_us=dev[f"plain {i}"] * 1e3,
                   floor_us=dev[f"floor {i}"] * 1e3, copy_us=dev[f"copy {i}"] * 1e3)
        log("[k1] " + json.dumps(row))
    seq.update(ms=dev["k1 seq"], plain_ms=dev["plain seq"],
               floor_ms=dev["floor seq"], copy_ms=dev["copy seq"])
    log(f"[timing] {name}: K1 x{ABN_SITES} at bucket 8 (floor_ms: an empty "
        f"kernel of each launch's geometry; copy_ms: Tensor.copy_ of each "
        f"input; yardsticks, neither computes K1): {json.dumps(seq)}")
    for b, f in forward.items():
        f.update(device_ms=dev[f"forward {b}"],
                 device_busy=dev[f"forward {b}"] / f["wall_ms"],
                 images_per_s=b / f["wall_ms"] * 1e3)
        log(f"[timing] {name}: served forward, bucket {b}: {json.dumps(f)}")
    check("forward 8" in timer.per_kernel, "torch.profiler recorded no kernel "
          "for the bucket-8 forward")
    breakdown = forward_families(*timer.per_kernel["forward 8"])
    check(breakdown["k1"]["launches"] == ABN_SITES,
          f"bucket-8 forward breakdown: {breakdown['k1']['launches']} K1 "
          f"launches, expected {ABN_SITES}")
    forward[8]["by_family"] = breakdown
    log(f"[timing] {name}: served forward, bucket 8, device ms by kernel "
        f"family: {json.dumps(breakdown)}")
    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    report["k1_shapes"] = [row for row, *_ in per_shape]
    report["k1_forward_sequence"] = seq
    seq_serve = seq
    report["forward"] = forward
    report["profiler_serve"] = timer.record()
    del model, engine, served

    # ---------------------------------------- 7. kernel vs plain (K2-K4) --
    from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
    from ddp_classification_pytorch_tpu_torch.train import checkpoint

    flash_rows, flash_timed = flash_vs_plain(torch, fa, device)

    # -------------------------------------------- 8. the training path --
    trainer, train_cfg, train_rec = train_main_path(
        torch, device, train_cli, checkpoint, TRAIN_ARGV,
        {kind: getattr(fa, attr) for kind, attr, *_ in FLASH_KERNELS},
        {"fwd": VIT_BLOCKS * (TRAIN_STEPS + EVAL_BATCHES),
         "dq": VIT_BLOCKS * TRAIN_STEPS, "dkv": VIT_BLOCKS * TRAIN_STEPS},
        "train")
    report["train"] = train_rec

    # ------------------------------- 9. the training slice, kernel vs plain --
    report["train_slice"] = train_slice(torch, fa, device, train_cfg,
                                        trainer.train_ds)

    # ----------------------------------------------- 10. training timings --
    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    n = train_cfg.data.batch_size
    items = [trainer.train_ds[i] for i in range(n)]
    images = torch.from_numpy(np.stack([im for im, _ in items])).to(device)
    labels = torch.from_numpy(
        np.asarray([lb for _, lb in items], np.int32)).to(device)

    def step():
        return trainer.train_step(trainer.state, images, labels)

    step_wall = host_ms(torch, step)
    with DeviceTimer(torch, lambda: flash_counts(fa)) as timer:
        for i, fns in enumerate(flash_timed):
            for key, fn in fns.items():
                timer.run(f"{key} {i}", fn, reps=FLASH_REPS)
        timer.run("train step", step, reps=STEP_REPS)
    res = timer.results()
    # host time of issuing one launch through each wrapper, at the slice's
    # shape in bf16: 12 in a row with nothing synchronized (the median of 5
    # such rows); the wrappers make 3 (K2), 4 (K3) and 6 (K4) tensor maps
    host_us = {}
    for kind, *_ in FLASH_KERNELS:
        fn, rows = flash_timed[1][f"k_{kind}"], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(VIT_BLOCKS):
                fn()
            rows.append((time.perf_counter() - t0) / VIT_BLOCKS * 1e6)
        torch.cuda.synchronize()
        host_us[kind] = statistics.median(rows)
    log(f"[timing] host µs per wrapper launch (bf16, slice shape): "
        f"{json.dumps(host_us)}")
    for i in range(len(flash_timed)):  # attribution: kernel regions hold
        for j, (kind, _, part, *_) in enumerate(FLASH_KERNELS):  # exactly
            label = f"k_{kind} {i}"                            # their launches
            names = res[label][1]
            if names is None:  # timed with CUDA events: the counters speak
                want = tuple(FLASH_REPS * (x == j) for x in range(3))
                check(timer.launched[label] == want,
                      f"region {label}: launches {timer.launched[label]}, "
                      f"want {want}")
            else:
                check(len(names) == FLASH_REPS
                      and all(part in n for n in names),
                      f"profiler region {label}: {len(names)} kernels")
    for i, row in enumerate(flash_rows):
        row.update({f"{key}_ms": res[f"{key} {i}"][0]
                    for key in flash_timed[i]})
        log("[flash] " + json.dumps(row))
    step_dev = res["train step"][0]
    step_rec = {"batch": n, "wall_ms": step_wall, "device_ms": step_dev,
                "device_busy": step_dev / step_wall,
                "images_per_s": n / step_wall * 1e3,
                "host_us_per_launch": host_us}
    slice_row = flash_rows[1]  # (32, 1024, 12, 64) bf16
    for kind, _, part, *_ in FLASH_KERNELS:
        ms, per_step = timer.kernel_ms("train step", part)
        want = VIT_BLOCKS
        check(per_step == want, f"{per_step} {part} launches per train "
              f"step, expected {want}")
        step_rec[f"{kind}_x12_ms"] = ms
        step_rec[f"{kind}_x12_bound_ms"] = VIT_BLOCKS * slice_row[f"bound_ms_{kind}"]
    top = {}  # the step's device time by kernel name, largest first
    for d, kname in timer.per_kernel["train step"][0]:
        top[kname] = top.get(kname, 0.0) + d / STEP_REPS / 1e3
    step_rec["top_kernels_ms"] = dict(sorted(top.items(),
                                             key=lambda kv: -kv[1])[:12])
    log(f"[timing] {name}: ViT-B/16 train step: {json.dumps(step_rec)}")
    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    report["flash"] = flash_rows
    report["train_step"] = step_rec
    report["profiler_train"] = timer.record()
    report["vit_epoch"] = vit_epoch_walls(torch, trainer)
    del trainer, flash_timed, images, labels, timer, res
    torch.cuda.empty_cache()

    # ------------------------- 11. kernel vs plain (K1s, K1r, K1d) --
    # the ABN shapes of a batch-32 train step: the 36 sites of bucket 8
    # (phase 3's hooks) at 4 times the batch
    wrappers = [getattr(fused_abn, n) for n in ABN_WRAPPERS]

    def abn_counts():
        return tuple(f.launches for f in wrappers)

    train_shapes = [(4 * s[0],) + s[1:] for s in shapes]
    abn_rows, abn_timed, abn_err = abn_train_vs_plain(
        torch, fused_abn, device, train_shapes, tresnet.SLOPE)
    # and at the real-data path's train shapes (new launch geometries):
    # checked with the same tolerances, not timed here (phase 17 times
    # the step)
    report["abn_train_real_data"] = {}
    for px, main_shapes in real_data_shapes.items():
        rows, _, err = abn_train_vs_plain(torch, fused_abn, device,
                                          main_shapes, tresnet.SLOPE,
                                          ragged=False)
        report["abn_train_real_data"][f"{px}px"] = rows
        abn_err = {k: max(v, err[k]) for k, v in abn_err.items()}

    # ------------------------------ 12. the TResNet-M training path --
    # its checkpoint (with the sidecar) is also what phase 27 serves over
    # HTTP: copied into a watch dir of its own before the run's goes
    http_root = tempfile.mkdtemp(prefix="chip_smoke_http_")

    def keep_for_http(ckpt):
        os.makedirs(os.path.join(http_root, "run"))
        for f in (ckpt, checkpoint.checksum_path(ckpt)):
            shutil.copy(f, os.path.join(http_root, "run", os.path.basename(f)))
        return {}

    fused_abn.FusedBNLeakyReLU.layout_copies = 0
    trainer, tres_cfg, tres_rec = train_main_path(
        torch, device, train_cli, checkpoint, TRESNET_TRAIN_ARGV,
        dict(zip(("k1", "k1s", "k1r", "k1d"), wrappers)),
        {"k1": ABN_SITES * (TRAIN_STEPS + EVAL_BATCHES),
         "k1s": ABN_SITES * TRAIN_STEPS, "k1r": ABN_SITES * TRAIN_STEPS,
         "k1d": ABN_SITES * TRAIN_STEPS}, "tresnet-train",
        lambda tr, ckpt: serve_trained_checkpoint(
            torch, fused_abn, device, serve_cli, k1, tr, ckpt,
            np.stack([tr.val_ds[i][0] for i in range(8)])) | keep_for_http(
                ckpt))
    report["tresnet_train"] = tres_rec

    # ----------------- 13. the TResNet-M training slice, kernel vs plain --
    report["tresnet_train_slice"] = tresnet_train_slice(
        torch, fused_abn, device, tres_cfg, trainer.train_ds, wrappers)

    # ------------------------------------ 14. TResNet-M training timings --
    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    n = tres_cfg.data.batch_size
    items = [trainer.train_ds[i] for i in range(n)]
    images = torch.from_numpy(np.stack([im for im, _ in items])).to(device)
    labels = torch.from_numpy(
        np.asarray([lb for _, lb in items], np.int32)).to(device)

    def tstep():
        return trainer.train_step(trainer.state, images, labels)

    # the 36 sites of one step in order, bf16: each kernel and its plain
    # version in sequence, K1 on the batch statistics, and the yardsticks
    gen = torch.Generator(device=device).manual_seed(4)
    sites = []
    for shape in train_shapes:
        t = abn_train_inputs(torch, fused_abn, shape, torch.bfloat16, device,
                             gen, tresnet.SLOPE)
        ds, db = fused_abn.abn_grad_sums_ref(t[1], t[2], t[0], t[5], t[7],
                                             tresnet.SLOPE)
        sites.append(abn_train_closures(torch, fused_abn, t, tresnet.SLOPE,
                                        ds, db) | {
            "k1": lambda t=t: k1(t[0], t[3], t[4], t[5], t[6], 1e-5,
                                 tresnet.SLOPE),
            "p_k1": lambda t=t: fused_abn.fused_bn_leaky_relu_ref(
                t[0], t[3], t[4], t[5], t[6], 1e-5, tresnet.SLOPE)})
    step_wall = host_ms(torch, tstep)
    # host time of one K1s and one K1r wrapper call: the 36 sites in a row
    # with nothing synchronized (the median of 5 such rows), as phase 6
    host_us = {}
    for key in ("k_k1s", "k_k1r"):
        rows_us = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in sites:
                f[key]()
            rows_us.append((time.perf_counter() - t0) / ABN_SITES * 1e6)
        torch.cuda.synchronize()
        host_us[key[2:]] = statistics.median(rows_us)
    with DeviceTimer(torch, abn_counts) as timer:
        for i, (_, fns) in enumerate(abn_timed):
            for key, fn in fns.items():
                timer.run(f"{key} {i}", fn)
        for key in sites[0]:
            timer.run(f"{key} seq", lambda k=key: [f[k]() for f in sites],
                      reps=FLASH_REPS)
    res = timer.results()
    del sites
    # the step in a session of its own, away from the kernels' ≈ 80 regions
    with DeviceTimer(torch, abn_counts) as step_timer:
        step_timer.run("tresnet train step", tstep, reps=STEP_REPS)
    step_dev = step_timer.results()["tresnet train step"][0]
    check(step_timer.launched["tresnet train step"]
          == (ABN_SITES * STEP_REPS,) * 4,
          f"ABN launches over {STEP_REPS} train steps: "
          f"{step_timer.launched['tresnet train step']}, expected "
          f"{ABN_SITES * STEP_REPS} each")
    kinds = {kind: (j, part) for j, (kind, _, part, *_) in
             enumerate(ABN_TRAIN_KERNELS, start=1)}
    for label, (_, names) in res.items():  # attribution: kernel regions
        key = label.split()[0]                # hold exactly their launches
        if key not in ("k_k1s", "k_k1r", "k_k1d", "k1"):
            continue
        j, part = (0, "fused_abn_fwd") if key == "k1" else kinds[key[2:]]
        calls = (FLASH_REPS * ABN_SITES if label.endswith("seq") else REPS)
        if names is None:  # timed with CUDA events: the counters speak
            want = tuple(calls * (x == j) for x in range(4))
            check(timer.launched[label] == want,
                  f"region {label}: launches {timer.launched[label]}, "
                  f"want {want}")
        else:  # one kernel a call, K1s and K1r included
            check(len(names) == calls and all(part in nm for nm in names),
                  f"profiler region {label}: {len(names)} kernels")
    for i, (row, fns) in enumerate(abn_timed):
        row.update({f"{key}_us": res[f"{key} {i}"][0] * 1e3 for key in fns})
        log("[abn-train] " + json.dumps(row))
    seq = {key: res[f"{key} seq"][0] for key in
           ("k1", "p_k1", "k_k1s", "p_k1s", "k_k1r", "p_k1r", "k_k1d", "p_k1d",
            "var_mean", "bn_stats", "bn_bwd_reduce", "bn_bwd")}
    step_rec2 = {"batch": n, "wall_ms": step_wall, "device_ms": step_dev,
                 "device_busy": step_dev / step_wall,
                 "images_per_s": n / step_wall * 1e3,
                 "sequence_ms": seq, "host_us_per_call": host_us}
    bounds = {"k1": abn_bound_ms(train_shapes, 2)}
    for kind, *_ in ABN_TRAIN_KERNELS:
        bounds[kind] = abn_train_bound_ms(kind, train_shapes, 2)
    for kind, part, counted in (("k1", "fused_abn_fwd", "fused_abn_fwd"),
                                *((k, p, c) for k, _, p, c, *_ in
                                  ABN_TRAIN_KERNELS)):
        ms, _ = step_timer.kernel_ms("tresnet train step", part)
        # the wrappers' counters are checked above; the profiler's own
        # count (36 unless it lost a record) rides in the report
        _, seen = step_timer.kernel_ms("tresnet train step", counted)
        _, seen_all = step_timer.kernel_ms("tresnet train step", part)
        # one kernel a wrapper call: a lost record gives fewer, never more
        check(seen_all <= ABN_SITES, f"{seen_all} {part} kernels a train "
              f"step, more than one a call of its {ABN_SITES} sites")
        step_rec2[f"{kind}_x36_ms"] = ms
        step_rec2[f"{kind}_launches_seen_per_step"] = seen
        step_rec2[f"{kind}_x36_bound_ms"], step_rec2[f"{kind}_bound_by"] = \
            bounds[kind]
    breakdown = forward_families(*step_timer.per_kernel["tresnet train step"],
                                 families=TRAIN_FAMILIES)
    step_rec2["by_family"] = breakdown
    log(f"[timing] {name}: TResNet-M train step, batch {n}, bf16 (the ABN "
        f"kernels' x36_ms inside the step; sequence_ms: the 36 sites in a "
        f"row outside it, with the plain versions, batch_norm_stats, "
        f"var_mean, batch_norm_backward_reduce and the F.batch_norm "
        f"backward as yardsticks; host_us_per_call: K1s's and K1r's "
        f"wrappers): {json.dumps(step_rec2)}")
    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    report["abn_train"] = abn_rows
    report["tresnet_train_step"] = step_rec2
    report["profiler_tresnet_train"] = [timer.record(), step_timer.record()]
    del trainer, timer, step_timer, res, images, labels
    torch.cuda.empty_cache()

    # ------------------------------------------- 16-19. real-data phases --
    if not dataplane_ok:
        report["dataplane"]["cli_without_libjpeg"] = cli_refuses_folders(
            train_cli)
    report["real_data"] = real_data_phases(
        torch, device, native, train_cli, serve_cli, checkpoint, fused_abn,
        k1, wrappers, abn_counts, name,
        "imagefolder" if dataplane_ok else "cifar10")

    # ------------------------------------ 20. the ResNet-50 training path --
    # the reference's default model through cli/train.py: no TPU kernel on
    # this path, so every wrapper's count stays 0
    counters = dict(zip(("k1", "k1s", "k1r", "k1d"), wrappers)) | {
        kind: getattr(fa, attr) for kind, attr, *_ in FLASH_KERNELS}
    trainer, r50_cfg, r50_rec = train_main_path(
        torch, device, train_cli, checkpoint, RESNET_TRAIN_ARGV, counters,
        dict.fromkeys(counters, 0), "resnet50-train",
        lambda tr, ckpt: serve_trained_checkpoint(
            torch, fused_abn, device, serve_cli, k1, tr, ckpt,
            np.stack([tr.val_ds[i][0] for i in range(8)]), RESNET_SERVE_ARGV,
            k1_per_forward=0))
    report["resnet50_train"] = r50_rec
    del trainer
    torch.cuda.empty_cache()

    # ------------------------------------- 21. ResNet-50 training timings --
    report["resnet50_train_step"] = resnet_step_timing(torch, device,
                                                       train_cli, card)
    torch.cuda.empty_cache()

    # ----------------------------------- 22. torchrun (NCCL) vs plain run --
    report["ddp"] = ddp_vs_plain(torch, checkpoint)

    # ------------------------- 23-25. the ArcFace, CDR and Nested paths --
    # the reference's other workloads on ResNet-50: no TPU kernel on these
    # paths either (their heads, CDR's mask and the all-K sweep are jnp
    # under XLA in the JAX package), so every count stays 0
    heads_rec = {}
    for workload in ("arcface", "cdr", "nested"):
        heads_rec[workload] = head_main_path(
            torch, device, train_cli, serve_cli, checkpoint, fused_abn, k1,
            counters, workload)
        heads_rec[workload]["step"] = head_step_timing(
            torch, device, train_cli, workload, card)
    report["heads"] = heads_rec

    # --------------------------------------------- 26. the PLC workload --
    # no TPU kernel here either (PLC is numpy on the host, one eval
    # forward and a probe MLP in the JAX package), so every count stays 0
    t0 = time.perf_counter()
    plc_rec = plc_main_path(torch, device, train_cli, serve_cli, checkpoint,
                            fused_abn, k1, counters)
    plc_rec["noise_and_timing"] = plc_noise_and_timing(torch, device,
                                                       train_cli, card)
    plc_rec["phase_s"] = time.perf_counter() - t0
    log(f"[plc] phase 26 took {plc_rec['phase_s']:.1f} s")
    report["plc"] = plc_rec

    # ------------------------------------- 27. the HTTP serve path --
    # phase 12's checkpoint served over HTTP in process (K1 36 a forward,
    # every other count 0), the CLI with --watch --port as a subprocess,
    # then ViT-B/16 served through K2
    t0 = time.perf_counter()
    try:
        http_rec = serve_http_phase(torch, device, serve_cli, checkpoint,
                                    counters, http_root, card, name)
        http_rec["cli"] = serve_cli_http(http_root, card)
    finally:
        shutil.rmtree(http_root, ignore_errors=True)
    vit_serve_rec = vit_serve_leg(torch, device, serve_cli, fa, counters, card)
    http_rec["phase_s"] = time.perf_counter() - t0
    log(f"[serve-http] phase 27 took {http_rec['phase_s']:.1f} s")
    report["serve_http"] = http_rec
    report["vit_serve"] = vit_serve_rec

    # ------------------------------------------- 29. the recovery chain --
    # run here, before the summary line that carries its launch counts
    t0 = time.perf_counter()
    recovery_rec = recovery_in_process(torch, device, train_cli, checkpoint,
                                       counters, card)
    hang_s = max(RECOVERY_T_MIN_S,
                 float(np.ceil(2 * recovery_rec["slowest_silent_s"])))
    log(f"[recovery] hang timeout T = {hang_s:.0f} s (slowest silent "
        f"stretch {recovery_rec['slowest_silent_s']:.3f} s in process; "
        f"{card})")
    gc.collect()  # the drill's processes share the card with this one
    torch.cuda.empty_cache()
    recovery_rec["supervised"] = recovery_supervised(hang_s, card)
    recovery_rec["phase_s"] = time.perf_counter() - t0
    log(f"[recovery] phase 29 took {recovery_rec['phase_s']:.1f} s ({card})")
    report["recovery"] = recovery_rec

    # ------------------------------------ 30. the train→serve scenario --
    gc.collect()  # the scenario's processes share the card with this one
    torch.cuda.empty_cache()
    scen = scenario_phase(card)
    rep = scen["report"]
    log(f"[scenario] phase 30 took {scen['wall_s']:.1f} s ({card}): "
        f"{scen['green']}")
    for pub in rep["adoption_s"]:
        log(f"[scenario] publish epoch {pub['epoch']} at "
            f"{pub['at_s']:.1f} s served after (s) "
            f"{json.dumps(pub['replicas'])} ({card})")
    log(f"[scenario] lowest availability window "
        f"{json.dumps(rep['min_availability'])} ({card})")
    log(f"[scenario] requests p50 {rep['request_ms']['p50']} ms, p99 "
        f"{rep['request_ms']['p99']} ms over {rep['request_ms']['n']} "
        f"answers, {json.dumps(rep['request_ms']['statuses'])} ({card})")
    log(f"[scenario] restarts: trainer rcs {scen['trainer_rcs']}, lost "
        f"hosts {json.dumps(rep['host_lost'])}, replica stops "
        f"{json.dumps([(r['replica'], r['rc']) for r in rep['replica_stops']])}"
        f" ({card})")
    log(f"[scenario] spike to scale_out (s) "
        f"{json.dumps(rep['spike_to_scale_out_s'])} ({card})")
    log(f"[scenario] wave kill {json.dumps(scen['wave_kill'])}; children "
        f"on {json.dumps(scen['devices'])}")
    report["scenario"] = scen

    # ------------------------------------------- 31. this slice's paths --
    gc.collect()
    torch.cuda.empty_cache()
    slice_rec = slice15_phase(torch, device, train_cli, serve_cli, checkpoint,
                              fused_abn, k1, counters, card)
    slice_rec["profile_window"] = prof_rec
    log(f"[slice15] phase 31 took {slice_rec['legs_s'] + prof_rec['phase_s']:.1f}"
        f" s ((d) {prof_rec['phase_s']:.1f} s; {card})")
    report["slice15"] = slice_rec

    # ------------------------------------------ 32. the scaling levers --
    gc.collect()
    torch.cuda.empty_cache()
    levers = slice16_phase(torch, device, train_cli, checkpoint, fused_abn,
                           counters, card)
    log(f"[slice16] phase 32 took {levers['phase_s']:.1f} s ({card})")
    report["slice16"] = levers

    # ------------------------------------------- 33. the model options --
    gc.collect()
    torch.cuda.empty_cache()
    options = slice17_phase(torch, device, train_cli, counters, card)
    log(f"[slice17] phase 33 took {options['phase_s']:.1f} s ({card})")
    report["slice17"] = options

    # ---------------------------------- 34. serving's remaining surface --
    gc.collect()
    torch.cuda.empty_cache()
    serving18 = slice18_phase(torch, device, serve_cli, counters, card)
    log(f"[slice18] phase 34 took {serving18['phase_s']:.1f} s ({card})")
    report["slice18"] = serving18

    # --------------------------------------------- 35. the model axis --
    gc.collect()
    torch.cuda.empty_cache()
    axis_rec = model_axis_phase(torch, device, train_cli, counters, card)
    log(f"[slice19] phase 35 took {axis_rec['phase_s']:.1f} s ({card})")
    report["slice19"] = axis_rec

    # ------------------------------------------------------ 36. GPipe --
    gc.collect()
    torch.cuda.empty_cache()
    pipe_rec = pipeline_phase(torch, device, train_cli, checkpoint, counters,
                              card)
    log(f"[slice20] phase 36 took {pipe_rec['phase_s']:.1f} s ({card})")
    report["slice20"] = pipe_rec

    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    # ------------------------------------------------------ 28. summary --
    # the ResNet-50 path (phase 20) and the ArcFace, CDR, Nested and PLC
    # paths (phases 23-26) launch none of these kernels; the HTTP path
    # (phase 27) launches K1 only, the ViT serve leg K2 only
    def head_launches(kind):
        return {f"{w}_path_launches": r["launches"][kind]
                for w, r in (heads_rec | {"plc": plc_rec}).items()} | {
            "serve_http_path_launches": http_rec["launches"][kind],
            "vit_serve_path_launches": vit_serve_rec["launches"][kind],
            "recovery_path_launches": recovery_rec["launches"][kind]} | {
            f"{leg}_path_launches": slice_rec[leg]["launches"][kind]
            for leg in ("vgg_nested", "tresnet_arcface", "tresnet_nested",
                        "vit_arcface", "debug_nans", "profile_window")} | {
            "grad_accum_path_launches":
                levers["tresnet_accum"]["launches"][kind],
            "vit_remat_step_launches":
                options["vit_remat"]["remat"]["launches"][kind],
            "vit_moe_path_launches": options["moe"]["launches"][kind],
            "serve_graph_path_launches": serving18["launches"][kind],
            "model_axis_path_launches": axis_rec["launches"][kind],
            "pipeline_path_launches": pipe_rec["launches"][kind]}

    log(json.dumps({"kernels": [{
        "name": "fused_bn_leaky_relu",
        "route": "cuda",
        "source": "ddp_classification_pytorch_tpu_torch/ops/csrc/fused_abn.cu",
        "replaces": "ddp_classification_pytorch_tpu/ops/pallas_kernels.py:37",
        "tpu": "ops/pallas_kernels.py::_fused_kernel",
        "checked": True,
        "launches": launches,
        "max_abs_err": max(max_err, abn_err["k1"]),
        "ms": seq_serve["ms"],
        "plain_ms": seq_serve["plain_ms"],
        "bound_ms": seq_serve["bound_ms"],
        "bound_by": seq_serve["bound_by"],
        # no PyTorch call computes BN + LeakyReLU; the two yardsticks (an
        # empty kernel per launch, Tensor.copy_ of each input) compute
        # something else and stand beside it, labelled
        "library_ms": None,
        "yardstick_floor_ms": seq_serve["floor_ms"],
        "yardstick_copy_ms": seq_serve["copy_ms"],
        # its 36 launches on batch statistics inside a batch-32 train step
        "train_step_ms": step_rec2["k1_x36_ms"],
        "train_step_bound_ms": step_rec2["k1_x36_bound_ms"],
        "train_step_launches": tres_rec["launches"]["k1"],
        "resnet50_path_launches": r50_rec["launches"]["k1"],
    } | head_launches("k1")] + [{
        "name": attr,
        "route": "cuda",
        "source": source,
        "replaces": tpu,
        "checked": True,
        "launches": train_rec["launches"][kind],
        "max_abs_err": max(max(r["max_abs_err"][key] for key in
                               (("o", "lse") if kind == "fwd" else
                                ("dq",) if kind == "dq" else ("dk", "dv")))
                           for r in flash_rows),
        "ms": slice_row[f"k_{kind}_ms"],
        "plain_ms": slice_row[f"p_{kind}_ms"],
        "bound_ms": slice_row[f"bound_ms_{kind}"],
        "bound_by": slice_row[f"bound_by_{kind}"],
        # one PyTorch call computing the same function: SDPA's forward for
        # K2; its backward computes dQ, dK and dV together, so K3 and K4
        # alone have none (the SDPA backward stands in the flash rows)
        "library_ms": slice_row["sdpa_fwd_ms"] if kind == "fwd" else None,
        "resnet50_path_launches": r50_rec["launches"][kind],
    } | head_launches(kind) | ({} if kind == "fwd" else {
        # K3 + K4 against the one call that computes dQ, dK and dV together
        "pair_ms": slice_row["k_dq_ms"] + slice_row["k_dkv_ms"],
        "library_pair_ms": slice_row["sdpa_bwd_ms"],
    }) for kind, attr, _, tpu, source in FLASH_KERNELS] + [{
        "name": attr,
        "route": "cuda",
        "source": CSRC + "fused_abn_train.cu",
        "replaces": lines,  # jnp around K1 in training, not a TPU kernel
        "tpu": None,
        "checked": True,
        "launches": tres_rec["launches"][kind],
        "max_abs_err": abn_err[kind],
        # the 36 launches inside one batch-32 train step
        "ms": step_rec2[f"{kind}_x36_ms"],
        "plain_ms": seq[f"p_{kind}"],
        "bound_ms": step_rec2[f"{kind}_x36_bound_ms"],
        "bound_by": step_rec2[f"{kind}_bound_by"],
        "sequence_ms": seq[f"k_{kind}"],
        # the nearest one PyTorch call over the same 36 inputs:
        # torch.batch_norm_stats for K1s (its mean and inv_std, not var);
        # torch.batch_norm_backward_reduce for K1r (its two sums without
        # the LeakyReLU gate: it reads g and x, not y); K1d has none
        "library_ms": {"k1s": seq["bn_stats"],
                       "k1r": seq["bn_bwd_reduce"]}.get(kind),
        "library_call": {"k1s": "torch.batch_norm_stats",
                         "k1r": "torch.batch_norm_backward_reduce"}.get(kind),
        "resnet50_path_launches": r50_rec["launches"][kind],
    } | head_launches(kind) | ({"yardstick_var_mean_ms": seq["var_mean"],
          "host_us_per_call": host_us["k1s"]} if kind == "k1s" else {
        "pair_ms": step_rec2["k1r_x36_ms"] + step_rec2["k1d_x36_ms"],
        "yardstick_bn_backward_ms": seq["bn_bwd"],
    } | ({"host_us_per_call": host_us["k1r"]} if kind == "k1r" else {}))
        for kind, attr, _, _, lines, *_ in ABN_TRAIN_KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
