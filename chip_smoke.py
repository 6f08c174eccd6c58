#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (yolat_tpu_torch) on one GPU.

  python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100. Imports
no jax. Phases, each of which raises on failure (non-zero exit):
  1. device: CUDA present; the card's name and power limit from
     nvidia-smi; TF32 off for matmuls and cuDNN;
  2. build: nvcc builds the kernels from yolat_tpu_torch/csrc; for the
     kernels with a tensor-core route at bf16 (the pool head 2, 3, 11 and
     the message MLPs 1, 4, 5, 6 with kernel 1's probe variants, kernel
     12) the count of warpgroup (HGMMA) and warp
     (HMMA) tensor-core instructions in each one's SASS (`cuobjdump
     -sass`), with ptxas's registers, spills and static shared memory: each
     bf16 kernel must have HGMMA, spill nothing and keep its wgmma pipeline
     unserialised (no C7515), each f32 kernel must have neither; and
     ptxas's registers and spills of every instantiation of the row
     kernels (9, 10, whose bodies 8 and 8b run, and 7b: f32 and bf16,
     16-byte and narrow-row routes), none of which may spill;
  3. kernels: on one packed batch of 4 bench-scale synthetic floorplans
     (2000x1500, 6 rooms, 1-3 symbols per room, seed 7, sampling step 10),
     each kernel against its plain PyTorch version at the shapes the
     serving path gives it, f32 and bf16, with median times; for kernel 1
     also each route's shared memory per CTA and CTAs per SM (CUDA's
     occupancy query) and the largest and mean edges per window;
  4. serve: a seeded random canonical detector (64 channels, 2 blocks,
     17 classes, randomised BN statistics) saved as a reference-format
     .pth and served through `yolat_tpu_torch.cli.infer` on the 8 SVGs
     in fast_bf16 mode; both kernels must launch, one record per SVG;
     kernel-route logits must match the plain route and the module
     forward on the card;
  5. training kernels: on the same batch, the fusion input cat [N, 128]
     of a train-mode forward of the seeded model; kernel 3 against its
     plain version (f32, bf16); the fused pool head's kernel route
     (kernel 3 -> kernel 11) against its plain route for pooled, the
     batch statistics and all five gradients under a fixed random
     cotangent (relative Frobenius error 1e-5 at f32, 5e-4 at bf16), and
     at bf16 both routes against a float64 run of the plain route on the
     same bf16-rounded x and W (the kernel route's error at most
     HEAD_F64_FACTOR = 1.5 times the plain route's + 1e-6, with the
     pooled entries and block maxima the routes part on printed);
     the kernel route against the unfused composition (Linear -> masked
     BN -> ReLU -> segment max, torch autograd) at f32 (1e-5); kernel
     11 twice, bit-identical; paired median times; then the whole bf16
     head, forward and backward, fused against the unfused composition in
     turns, with the profiler's device time per call;
  6. train: 8 bench-scale training SVGs and 2 test SVGs through
     `yolat_tpu_torch.cli.train` (bf16, fused head, augmentation on,
     batch 4, full width) for a few steps; losses finite, kernels 3 and
     11 launched once per step, a checkpoint and an evaluation written;
     the trained weights exported as a reference .pth and served through
     `cli.infer`, one record per SVG;
  7. window kernels: on the bench batch packed with the edge-window plan's
     transpose, kernels 9 and 10, forward and backward, against their
     plain versions at C 5 and C 64 (the gathers exact; the sums within
     |err| <= 1e-5 + 1e-5|ref| at f32 and, where the result is rounded to
     bf16, one ulp, with at most 1e-3 of the elements differing at all,
     beside the reading of a planted fault), each twice, bit-identical;
     paired median times and the library call's time
     (`index_select`, `index_add_`); then each kernel's and each library
     call's profiler device time per call, warm (40 back-to-back calls)
     and L2-flushed (40 calls, each after a 128 MB scratch write that the
     profiler does not count), and the flushed time over the bound;
  8. window conv: the second conv layer (64 -> 64) in the window layout
     against the sparse layout on the same weights and the first layer's
     real activations: eval-mode outputs, train-mode outputs and BN
     statistics, and the gradients of x and of every parameter under a
     fixed random cotangent (relative Frobenius error: forward values
     and statistics 1e-5 at f32 and 1e-4 at bf16; gradients, which a
     flipped ReLU gate moves, 5e-3 and 2e-2); the ReLU gates that differ
     between the layouts are counted, and at f32 the second BN shift's
     gradient must agree to 1e-5 once their cotangents are taken out;
     two planted faults in the window backward must read above the limit;
  9. dense route: kernel 4 against its plain version at both conv shapes,
     f32 and bf16, twice, bit-identical, with times; at bf16 the MLP rows
     it computed (its own count) equal to the used slots; the engine's dense
     route (kernel 4) against its edge-window route (kernel 1) on batches
     of the same files (f32 logits within 1e-4 of their scale);
 10. window train and dense test: a few bf16 steps through
     `cli.train --train_layout window` on the SVGs of phase 6, finite
     losses, with the CLI's own launch counts equal to: kernel 9 and
     kernel 10 forward n_blocks per step and per evaluated batch, kernel
     10 backward n_blocks per step, kernel 9 backward n_blocks - 1 per step
     (the first layer's input needs no gradient); then that checkpoint
     through `cli.test --serve_mode fast --dense_layout true
     --nms_algorithm classfix`, kernel 4 launched n_blocks times per batch.
 11. banded kernels: on the bench batch packed for YOLaT++ (the super-edge
     family, its `sew_` plan, the edge-window plan's transpose) and the
     conv stack's real activations, kernel 5 over the clique family
     (single stage with W_own = Wa - Wb, and once with the second stage),
     over the curve family sorted by dst and by src, and kernel 6 over the
     curve family, f32 and bf16: each against its plain version (max|err|
     <= 1e-5 max|ref| at f32, 5e-4 at bf16, beside the reading of a planted
     fault: own and other weights swapped), each twice, bit-identical;
     kernel 6's own-endpoint sum bit-equal to kernel 5's and its
     other-endpoint sum within 1e-5 max|ref| of kernel 5 over the
     src-sorted plan; the largest and median edge count per thread block;
     paired median times and bounds (no PyTorch call computes either);
 12. pp route: `fast_forward_pp` with open gates against the eval-mode
     module on the card at f32 (per-edge with the curve level fused and in
     two passes, 2e-4 of scale, and factored), the kernel route against the
     plain route at f32 and bf16, bf16 argmax agreement with f32 on valid
     proposals (> 0.97), every gate closed in turn changes the logits, and
     the factored level's f32 prefix mean against its float64 value (8 *
     2^-24 of the largest prefix sum, printed as a share of the largest
     feature; the factored module-to-engine limit is 1e-3 of scale for it);
 13. pp serve: seeded open-gate YOLaT++ checkpoints through
     `cli.infer --arch yolat_pp` (kernels 1, 2, 5 and 6 launch) and
     `cli.infer --profile yolat_pp_fast` (the factored checkpoint: kernel 6
     and no launch of kernel 5) on the 8 SVGs, and `cli.test --arch
     yolat_pp` on the train phase's test split (finite AP table).
 14. banded train kernels: on the bench batch packed for the banded
     YOLaT++ training route (the `sew_` plan with its transpose) and the
     conv stack's real activations [72704, 64], kernels 7, 7b, 8, 8b, f32
     and bf16: the gathers (7, 8b) exact against their plain versions; the
     sums (8, 7b) against the float64 sum of the same terms within the
     a-priori bound of an f32 sum in any order, (k - 1) 2^-24 sum|terms|
     for the most terms k any node adds, plus one rounding of the output
     where it is bf16, beside the readings of two planted faults (own and other
     endpoint swapped, one row dropped); each twice, bit-identical; an
     empty family (E = 0) through all four; the runs per node on both
     sides, and what 4 or 2 nodes a warp add to 7b's chains (a node's
     longer run); paired median times, the library call's time
     (`index_select`, `index_add_`) and the bound; the profiler's warm and
     L2-flushed device times, as in phase 7; then 7b, 8 and 8b at an odd
     width (C = 5, the narrow route) against their plain versions, 7b and 8
     also against the float64 limit, and at C = 64 with every value input a
     view off a 16-byte boundary (the narrow route), bit-identical to the
     aligned inputs' results;
 15. pp train route: the train-mode YOLaT++ module on its banded route
     (kernels 7 and 8 with their backward kernels) against its sparse route
     on the same weights and batch, f32 and bf16: `prim_at_node`,
     `super_edge_mlp`'s batch statistics, and the gradients of a fixed
     random cotangent on `prim_at_node` (relative Frobenius error: values
     and statistics 1e-5 at f32 and 2e-3 at bf16; gradients, which a
     flipped ReLU gate moves and which the sparse route's gather sums in
     bf16 at bf16, 5e-3 and 6e-2), the ReLU gates that differ
     between the routes counted; two planted faults in the banded backward
     must read above the limit;
 16. pp train: `cli.train --arch yolat_pp` at bf16 for a few steps on the
     SVGs of phase 6, with an evaluation and a checkpoint, on the per-edge
     sparse route, with `--pp_banded_super true --fused_head_train true`
     and with `--profile yolat_pp_fast`: losses finite and falling,
     kernels 7, 7b, 8, 8b launched exactly on the banded run (forward once
     per step and per evaluated batch, backward once per step) and kernels
     3 and 11 exactly on the fused run; then `cli.test` restores the
     banded run's checkpoint (fast_bf16: kernels 1, 2, 5, 6) and the
     factored one (the eval-mode module);
 17. edge-window decomposition (kernel 12): on the bench batch of phase 3
     with the probe's seeded inputs (x [N, 64], w1 [132, 64], w2 [64, 64],
     scale 1, shift 0), f32 and bf16, each variant of
     `edge_window_decomp` (full, noband, noonehot) bit-identical to kernel
     1 on the variant's inputs (as they are; the plan with src := dst; x
     filled with 0.001), twice bit-identical, within phase 3's tolerance of
     its plain version, and unlike `full` (noband, noonehot); paired median
     times of `full` at bf16; then
     `yolat_tpu_torch.scripts.ew_kernel_decomp` (the probe: its own copy of
     the bench batch; per variant the profiler's device time per launch
     over 40 calls after 3 unprofiled ones, three rounds, in turns; not its
     source edits, which run only when the probe runs as a program) prints
     its line, on the same N and E, every time finite and kernel 1 not
     launched;
 18. host stage: the host geometry library (`geom/_native.py`, g++ over
     yolat_tpu_torch/csrc/geomcore.cpp at first use, before phase 3; its
     path, build time and compiler version printed here); the 8 SVGs of
     phase 4 loaded cold (graph, proposals, cache write) in two fresh
     copies, once through the library and once on the numpy paths
     (`_native.disabled()`): every integer array of the graph and the
     proposal set equal, every float within rtol 1e-9, atol 1e-8;
     CompactFile, canonical and with the super family, bit-equal between
     the paths; median ms per image of each path, and median CompactFile
     ms per variant and path (warm, the paths in turns); the entries the loads do not reach
     (enumerate_rect_sets, build_rect_proposals, angle_stats,
     compact_sort_align) held to their numpy versions on the largest CC of
     a bench file, so every entry was called; the count of per-call numpy
     cases; `cli.preprocess --workers 2 --hierarchical` over cold copies of
     phase 6's splits with the stats.pkl of `--workers 0` and one .hier
     pickle per file; `cli.infer --preproc_workers 2` on phase 4's SVGs
     and checkpoint with phase 4's records and kernels 1 and 2 launched;
     the host's core count and the card's name and power limit;
 19. CUDA graphs (every serving and train step of phases 4-18 already runs
     as graph replays: `eval/predict.make_serving_fn`,
     `train/loop.make_scan_train_step`): kernel N1 (`nms_fixpoint.cu`,
     both entries) against the plain loop on the inputs predict forms on
     the canonical and YOLaT++ bench batches and on a suppression chain
     (one sweep per candidate), kept sets equal, times and bound; the
     serving graphs against the eager predict on the unpadded batches,
     detections bit-identical per batch and in a short chunk (2 batches
     in a 3-row graph), on the plan, dense, YOLaT++ per-edge and factored
     routes and the eval-mode module (its sparse sums are float atomics:
     within the slice test's tolerance where two eager runs differ), with
     the launches a replay adds, and the `loop` refusal; the
     train graphs (scan 1 and 3) against the eager step over 3 steps on
     seven routes (canonical bf16 fused, unfused with dropout, window,
     dense; YOLaT++ per-edge, banded and factored; augmentation on, the
     schedule decaying at step 2), bit-identical or within the eager
     run's own spread (`GRAPH_TRAIN_TOL`), and the capturable optimizer
     (a device-tensor rate) against the float-rate one within the same
     limits; eager against graph times in turns
     (`cli/profile.serve_graph_arms`, `train_graph_arms`, one line per
     step); `cli.infer --chunk 1` against
     `--chunk 8` on 64 bench SVGs (records byte-identical, SVGs/s in
     turns, graphs captured per run no more than the slot caps + 1),
     `cli.test --serve_mode fast_bf16 --nms_algorithm classfix`, and
     `cli.train --scan_steps 4` against 1 (images/s in turns, one graph
     per run).
 20. data parallel (`parallel/`, `train/loop.make_dp_train_step`): (a) the
     DP step as one rank over NCCL against the eager step (bf16, fused
     head, 3 steps, within the eager run's own spread, phase 19's rule),
     kernels 3 and 11 once per step; then two ranks on the one card over
     gloo with CUDA tensors (NCCL refuses two ranks on one GPU), in
     processes of their own: (b) identical shards against the
     single-device step (SGD, 3 steps, the parameters and running means
     within the single-device run's own spread), distinct shards on the
     kernel route against the plain route under the same DP (the loss and
     the averaged gradients, relative Frobenius, phase 15's limits: 1e-5
     and 5e-3 at f32, 2e-3 and 6e-2 at bf16), kernels 3 and 11 once per
     rank per step; (c) `make_dp_predict_fn` on the bench batch's halves,
     detections bit-identical to `make_serving_fn` on each half; (d)
     `run_training` over the two ranks as two nodes of one rank each
     (`--coordinator localhost:<port>`, a TCPStore, `--process_id`,
     `--n_processes 2`), 4 bf16 fused steps with an evaluation over both
     ranks and rank 0's checkpoint, then the DP
     step's wall, device busy time and idle share per rank (gloo through
     the host: not NCCL scaling).
 21. detection CLIs: a test split of 8 bench-scale SVGs (phase 6's
     writer) through `cli.detect` from phase 6's checkpoint dir, in its
     loop with a recording renderer, in flax, fast and fast_bf16, one image
     per call: fast held to flax per image by the CPU test's rule
     (tests/test_torch_detect.py: paired boxes within rtol 1e-6 / atol
     1e-4, their scores within 1e-5; a detection on one side only must sit
     at the hard-NMS threshold, below a same-class detection that both
     runs kept, at an IoU within 1e-5 of 0.5, or, where the other run kept
     its full 300 (Config.max_det), score no higher than that run's lowest
     within the score limit; at most 2% of the
     detections), under phase 6's checkpoint and under seeded weights that
     keep 100+ detections and several merges per image, fast_bf16's counts
     and largest score difference printed; on the fast
     routes kernels 1, 2 and N1 launched 2, 1 and 1 times per image and one
     graph captured per (slot cap, signature) key, replayed once per image;
     `--merge_nms` draws `merge_nms` of each call's kept proposals bit for
     bit; the warm mean ms per image of each mode; `cli.detect_badcase`
     (TP, FP, FN per drawn image); `cli.export_ckpt` on phase 6's
     checkpoint dir, bit-equal to phase 6's trained.pth; then, where
     matplotlib imports, `cli.detect.main` with one PNG per image, and
     where it does not, a line saying so and `main`'s refusal.
 22. diagrams and charts, written by the port's own writers
     (`data/synthetic.write_diagram_dataset`, `write_chart_dataset`):
     (a) 16 train and 4 test diagrams (1500x1000, 8 symbols, seed 7)
     through `cli.train` at step 5 (canonical, bf16, fused head, `--buckets
     2 --do_mixup 1`, batch 4, 8 steps): losses finite, kernels 3 and 11
     once per step, one graph captured per batch signature met (each
     signature's first step eager, every other step a replay; at most one
     signature per bucket and pad growth), the bytes the live graphs'
     pools hold; kernels 3 and 11 against their plain route on an epoch of
     the trainer's mixup batches (kernel 3 alone and the f32 head at phase
     5's limits, the bf16 head by phase 5's float64 rule);
     `cli.test` in fast_bf16 with classfix NMS (kernels 1, 2, N1 at 2, 1, 1
     per batch) and in fast on the dense table (kernel 4 instead of 1), the
     AP table finite; under seeded weights that keep many proposals
     (`_many_proposal_pth`, the background bias raised by 10), every call
     of kernels 1, 2, 4 and N1 that the predict core makes on `cli.test`'s
     batch, f32 and bf16, recorded at the wrappers and held against its
     plain version on the same inputs (phases 3, 9 and 19's limits);
     `cli.detect`'s loop on the 4 test images in each serve mode and on
     the dense table, under the trained and the seeded weights, fast and
     fast on the dense table within phase 21's rule of flax, the seeded
     weights with 100+ detections and several merges per image;
     `cli.infer`, one record per SVG; the scan step's release of a graph
     (two signatures captured, one released: the reserved memory falls by
     its pool's bytes); (b) 8 train and 4 test charts (1600x1200, seed 7)
     in a directory named `charts` through `cli.train --profile
     yolat_pp_fast` at step 20 (the chart recipe, bf16, 6 steps) and
     `cli.test --serve_mode fast_bf16` (kernels 1, 2, 6 and N1 at 2, 1, 1,
     1 per batch, no launch of 5), with the proposals, edges, super edges
     and pads of a batch, ms per step and the test CLI's wall; under
     seeded YOLaT++ weights that keep many proposals, kernels 1, 2, 6 and
     N1 held to their plain versions on `cli.test`'s batch as in (a), and
     `cli.detect`'s loop on the 4 charts, fast within phase 21's rule of
     flax at the factored route's score limit (1e-3, phase 14's: its f32
     prefix sums round apart between the routes, 2.06e-4 on a chart's
     scores), a one-sided detection also explained by a same-class
     one-sided detection of the other run that overlaps it above the NMS
     IoU within that limit (two near-tied boxes ranked apart), kernel 6
     once per image; the phase's time;
 23. the conv zoo (`nn/conv.py`, `nn/dynamic.py`, `nn/gen_conv.py`): on
     the first train batch of phase 6's floorplans (batch 4, full width:
     64 channels, 2 blocks, the 1024-wide fusion, the 2304 -> 512 -> 256
     -> 17 head, f32, TF32 off), each of the 12 convs besides
     attr_edge_gp2 as a seeded model in train mode, forward and backward
     on the card against the same model and batch on the CPU (the plain
     path): logits within CONV_ZOO_TOL of their scale, the loss, the
     BatchNorm running statistics after the step, the gradients of the
     tensors after the node max pool (the prediction head, the super
     stream) at the relative Frobenius limit, and every gradient's
     relative Frobenius error printed with the share of (proposal,
     channel) pairs of the node max pool that have tied winners (the
     compare-form max gradient gives each the cotangent; the card's and the
     CPU's rounding break ties apart), held below CONV_ZOO_GRAD_TOL for
     the convs without act -> BatchNorm ties; the bf16 fused-head train
     step of gp2, edge, gat, gen and attr_edge_cf as graph replays, timed
     in turns (synchronised host wall, staging included), with each
     graph's pool; then `cli.train --conv
     {edge, gat, gen, attr_edge_cf} --fused_head_train true --dtype
     bfloat16` and `--conv sage --act gelu --norm layer` (f32) for a few
     steps each (losses finite, kernels 3 and 11 once per fused step, one
     capture per signature and replays), `cli.test --serve_mode flax` on
     each checkpoint (N1 once per batch, the AP table finite), and the
     refusals of `cli.test --serve_mode fast --conv edge` and `cli.train
     --fused_head_train true --act gelu`; the phase's time.
 24. the dynamic-graph family (`ops/knn.py`, the kNN blocks of
     `nn/dynamic.py`, `nn/dense_graph.py`): on the first train batch of
     phase 6's floorplans (63488 node rows), node features lifted to 64
     channels by the seeded canonical model's first conv in eval mode,
     k 16, f32: `knn_graph` over the whole batch with the node mask and
     again with the images' ids as segments, each timed (median of 10
     synchronised calls) with its own peak memory (held under 4 GiB),
     its structure (dst order, no unmasked self edge, none across images
     under segments, k real edges per real centre) and 256 seeded rows
     against a float64 brute force (equal up to the a-priori f32 bound
     of a near tie); one image card against CPU (the rows apart, each a
     near tie); `dilated` at dilation 2, strided and stochastic (epsilon
     0.2, 8 seeds: one k-subset of positions shared by every centre,
     reproducible); each sparse block at 64 channels (DynConv edge and
     mr, PlainDynBlock, ResDynBlock, DenseDynBlock, ResGraphBlock and
     DenseGraphBlock on the batch's edges, ResBlockMultiEdge over the
     shape, kNN and dilated kNN families) and the dense mirror on [4,
     n_max, 64] with the per-image mask (DynConv2d edge and mr at
     dilation 1 and 2, ResDynBlock2d, DenseDynBlock2d), seeded, in train
     mode, forward and backward, card against CPU within KNN_BLOCK_TOL
     (the CPU's side on its own kNN lists, computed once from the same
     features; where the card's lists differ, the card's block held on
     the CPU's lists after its own run); no kernel of the port launched;
     the phase's time.
 25. the last modules (`data/toy.py`, `utils/profiling.py`,
     `data/legacy.py`, `data/deepgcn_utils.py`, `get_anchor`,
     `batch_statistics_loop`, `ScalarWriter`): the port's toy batch (4
     images of 3 squares, node rows padded to 512), built here, served
     through the canonical fast_bf16 graph and the YOLaT++ per-edge graph
     (detections bit-identical to the eager predict; logits against the
     eager f32 module, f32 within 1e-4 / 2e-4 of their scale, bf16 within
     5e-2 with the argmax agreeing on over 97%) and trained 4 bf16
     fused-head steps (the first eager, then a graph), kernels 1, 2, 3, 5,
     6, 11 and N1 launched on that path, then every call of 1, 2, 5, 6 and
     N1 in the predict cores and kernels 3 and 11 on the toy batch held to
     their plain versions (phase 22's rules); `timed` against the
     CUDA-event median of the canonical replay of the bench batch and a
     ThroughputMeter over those replays; `trace` in a process of its own
     (`scripts/traced_predict.py`: its trace's kernel records equal to the
     launches counted there); `cost_analysis` of the eval module's predict
     on the CPU and its refusal on the card (N1 launches there); each
     `LegacySVGDataset` graph over phase 22's test diagrams, `get_anchor`
     over the bench floorplans, `batch_statistics_loop` equal to
     `batch_statistics` on phase 21's detections, alone and followed by
     the GT boxes (true positives on every image), at IoU 0.05-0.95,
     `PartNetDataset`'s refusal without h5py, `ScalarWriter`'s sinks; the
     phase's time.
 26. YOLaT++ under --act / --norm, and data parallel beyond gp2, on
     phase 6's floorplans at full width (batch 4; seeded open-gate models,
     their LayerNorms' affine terms drawn too): (a) under `--act gelu
     --norm layer` and `--act leakyrelu --norm batch`, the train-mode
     module on its three routes, card against CPU at f32 (prim_at_node
     and the logits within 1e-4 of their scale, the loss 1e-5; the
     factored route with its prefix mean in float64 on both, its f32
     prefix mean held to phase 12's bound apart), each f32 run's
     gradients against the card's float64 run (relative Frobenius 3e-2
     per tensor, the gates as one vector), the ReLU/LeakyReLU gates the
     devices part on; every call of kernels 7, 7b, 8 and 8b of the banded
     route (f32, and a bf16 forward and backward) against its plain
     version at phase 14's limits; the bf16 banded step as a graph
     replay (CUDA-event ms, device busy, graph pool, kernels 7-8b once a
     replay); `cli.train --arch yolat_pp --act gelu --norm layer
     --pp_banded_super true` (bf16, 4 steps: kernels 7 and 8 at steps +
     evaluated batches, 7b and 8b at steps), `cli.test --serve_mode flax`
     (the AP table; kernels 7, 8 and N1 once a batch), cli.export_ckpt
     and `cli.infer --serve_mode module` on phase 4's SVGs (SVGs/s), and
     `cli.infer --serve_mode fast_bf16` refusing with its flags named;
     (b) tests/test_torch_dp_zoo.py's six cases (gat under leakyrelu, gen,
     attr_edge_cf, edge under --norm layer, YOLaT++ under --act leakyrelu,
     edge with the fused head) at full width in two gloo ranks on the one
     card (`tests/torch_dp_zoo_ranks.zoo_scenarios`, CUDA tensors, batch 2
     a rank, 2 SGD steps): the ranks bit-identical, identical shards
     against the single-device step within phase 19's rule of its own
     spread, the fused head's kernel route (kernels 3 and 11 once a step
     a rank) against its plain route under DP within phase 20's f32
     limits; the phase's time.
Everything it runs comes from yolat_tpu_torch, the synthetic SVG writer
included, and from the rank helpers of tests/torch_dp_zoo_ranks.py
(torch and the port only): it imports neither jax nor the JAX package
yolat_tpu.
The kernels line (a JSON object describing each kernel; launches are
counted over the path that runs it, with the counts set to 0 just before:
phase 4 for the serving kernels, phase 6 for the fused head's, phase 10 for
kernels 9, 10 and 4, phase 13's first `cli.infer` run for kernels 5 and 6,
phase 16's banded run for kernels 7 and 8, phase 17's probe run for
kernel 12, `edge_window_decomp`, phase 19's first `cli.infer --chunk 8`
run for N1's fixpoint entry and its `cli.test` for the classfix entry;
a replay adds the launches its capture recorded; `conv_zoo_launches` on
the rows of kernels 3, 11 and N1 counts phase 23's runs, each CLI run
from 0; `act_norm_launches` on the rows of kernels 7, 7b, 8, 8b and N1
counts phase 26's cli.train, cli.test and cli.infer from 0, and on those
of kernels 3 and 11 one rank's launches in the fused DP case)
comes before the nvidia-smi line; the last line is
{"ok": true, "device": {...}}. Each kernel's bound_ms is the larger of its
bytes (each input read once, each output written once; of a gathered
input, the rows that this run's indices reach) over 3.35 TB/s and
its operations over the H100 SXM data-sheet peak for its type (989 TFLOP/s
on the bf16 tensor cores for the MLP kernels, whose times are taken at
bf16; 67 TFLOP/s in float32 for the gathers' and sums' additions), from
this run's shapes and data; library_ms is one PyTorch call of the same
function where there is one, timed here and used nowhere in the port.
`ms` and `plain_ms` are medians of synchronised spans of one call (each
holds the wrapper's host time); `device_ms` is the median of queued spans,
one CUDA-event pair around 40 back-to-back calls divided by 40, six per
kernel in turns with the plain version's, except for kernels 7-10b
(phases 7 and 14), whose wrappers issue slower than the kernels run: there
`device_ms` is the profiler's L2-flushed device time, `warm_ms` its
back-to-back reading, `queued_ms` the queued span and `library_device_ms`
the library call's L2-flushed profiler time.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_SVGS = 8
BATCH = 4
TRAIN_STEPS = 8
# relative Frobenius limits of the fused head: kernel route vs plain route
# by dtype name, and the f32 kernel route vs the unfused composition
HEAD_TOL = {"f32": 1e-5, "bf16": 5e-4}
UNFUSED_TOL = 1e-5
WINDOW_STEPS = 4
N_BLOCKS = 2
# relative Frobenius limits, window conv layer vs sparse conv layer:
# (forward values and BN statistics, gradients)
CONV_TOL = {"f32": (1e-5, 5e-3), "bf16": (1e-4, 2e-2)}
# max|err| / max|ref| of kernels 5 and 6 against their plain versions
BANDED_TOL = {"f32": 1e-5, "bf16": 5e-4}
PP_TRAIN_STEPS = 6
# relative Frobenius limits, banded YOLaT++ route vs sparse route:
# (prim_at_node and BN statistics, gradients)
PP_ROUTE_TOL = {"f32": (1e-5, 5e-3), "bf16": (2e-3, 6e-2)}
CHUNK = 8          # cli.infer's default --chunk
SERVE_CHUNK = 3    # phase 19's make_serving_fn chunk over the 2 bench batches
GRAPH_SVGS = 64    # phase 19's cli.infer --chunk comparison (16 batches)
GRAPH_TRAIN_SVGS = 16
GRAPH_STEPS = 3
SCAN = 4           # phase 19's cli.train --scan_steps
# phase 19: where two eager train runs differ (float atomics), a graph run
# may differ from the eager one by four times that spread or by these, max
# |loss diff| and max |state diff| after 3 steps (on an H100 80GB HBM3 at
# 700 W the eager spread reached 2.7e-4 and 5.1e-3, the graph 6.7e-4 and
# 5.9e-3);
# where the eager runs are bit-identical, so must the graph run be
GRAPH_TRAIN_TOL = (1e-3, 1e-2)
# the H100 SXM data sheet's peaks: HBM bytes/s, float32 and dense bf16 FLOP/s
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> list:
    """Device times (ms) of `reps` calls of fn, after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def queued_ms(fn, reps: int = 40) -> float:
    """Device ms per call: one CUDA-event pair around `reps` back-to-back
    calls, divided by the count (no synchronisation between the calls, so
    the host queues ahead of the device while it can)."""
    import torch

    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def paired_ms(kernel_fn, plain_fn) -> tuple:
    """(ms, plain ms, device ms): medians of synchronised spans of one call
    (time_ms) of the kernel and the plain version, in turns plain, kernel,
    kernel, plain; then the median of the kernel's queued spans
    (queued_ms), after warm-up, in turns with the plain version's, three
    times plain, kernel, kernel, plain."""
    p = time_ms(plain_fn)
    k = time_ms(kernel_fn)
    k += time_ms(kernel_fn)
    p += time_ms(plain_fn)
    dk = []
    for _ in range(3):
        queued_ms(plain_fn)
        dk += [queued_ms(kernel_fn), queued_ms(kernel_fn)]
        queued_ms(plain_fn)
    return statistics.median(k), statistics.median(p), statistics.median(dk)


# the wrappers' modules, as `profiled_ms` names a function ("module:name")
EWT = "yolat_tpu_torch.ops.edge_window_train:"
BT = "yolat_tpu_torch.ops.banded_train:"


def profiled_ms(specs: dict) -> dict:
    """{key: (warm, flushed)}: the profiler's device ms per call of each of
    `specs` ({key: (function, args)}), over 40 back-to-back calls and over
    40 calls each after a 128 MB L2-flushing write that is not counted, in
    a process of its own (`scripts/profiled_calls.py`: this process's
    profiler drops records once it has run a while)."""
    from yolat_tpu_torch.scripts.profiled_calls import in_child

    return {k: tuple(v) for k, v in in_child(specs).items()}


def bound(nbytes: float, ops: float, peak_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def add_bound(entry: dict, b: dict) -> None:
    """Add one call's bound to a kernel's entry (times are summed over a
    kernel's calls in one step); the larger share names what binds."""
    if b["bound_ms"] > entry.get("_largest", 0.0):
        entry["_largest"], entry["bound_by"] = b["bound_ms"], b["bound_by"]
    entry["bound_ms"] = entry.get("bound_ms", 0.0) + b["bound_ms"]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# the kernels with two routes: bf16 on the tensor cores (the pool head 2, 3,
# 11; the message MLPs 1 with its probe variants 12, 4, 5, 6), f32 on IEEE
# FMA
TC_KERNELS = ("block_max_tc_kernel", "bwd_rows_tc_kernel", "bwd_dw_tc_kernel",
              "edge_window_tc_kernel", "dense_message_tc_kernel",
              "banded_tc_kernel")
F32_KERNELS = ("block_max_kernel", "bwd_rows_kernel", "bwd_dw_kernel",
               "edge_window_kernel", "dense_message_kernel", "banded_kernel")
# the row kernels (9 and 10, forward and backward, whose bodies 8 and 8b
# run, and 7b): no product, so no tensor-core route; every instantiation
# (f32 and bf16, the 16-byte route and the narrow-row route) must spill
# nothing
ROW_KERNELS = ("pair_fwd_kernel", "pair_bwd_kernel", "wsum_fwd_kernel",
               "wsum_bwd_kernel", "gather_bwd_kernel")


def _cuobjdump() -> str:
    cands = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("cuobjdump not found (PATH, /usr/local/cuda, triton)")


def sass_tensor_ops(sass: str) -> dict:
    """{function: {"HGMMA": n, "HMMA": n}} from `cuobjdump -sass` text."""
    import re

    ops, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            ops[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\b", line):
                    ops[fn][op] += 1
    return ops


def ptxas_props(log: str) -> dict:
    """{function: registers, spill stores / loads, static smem} from
    `nvcc -Xptxas -v` output."""
    import re

    props = {}
    for m in re.finditer(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?Used "
            r"(\d+) registers(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?",
            log, re.S):
        props[m.group(1)] = dict(registers=int(m.group(5)),
                                 spill_stores=int(m.group(3)),
                                 spill_loads=int(m.group(4)),
                                 smem=int(m.group(6) or 0))
    return props


def functions_of(name: str, fns) -> list:
    """The mangled functions among `fns` that are kernel `name` (each
    template instantiation; another kernel whose name ends in `name` is
    not)."""
    import re

    return [f for f in fns if re.search(rf"\d{name}(I|E|v|P|$)", f)]


def tensor_core_report() -> dict:
    """Phase 2: the warpgroup (HGMMA) and warp (HMMA) tensor-core
    instructions in the SASS of the kernels with a tensor-core route, with
    ptxas's registers, spills and static shared memory; fails unless every
    bf16 kernel has HGMMA, spills nothing and runs its wgmma pipeline
    unserialised, and no f32 kernel has either instruction. Then ptxas's
    registers and spills of every instantiation of the row kernels
    (ROW_KERNELS); a spill fails."""
    import re

    from yolat_tpu_torch.ops import _build

    so = _build.library_path()
    ops = sass_tensor_ops(subprocess.run(
        [_cuobjdump(), "-sass", so], capture_output=True, text=True,
        check=True, timeout=300).stdout)
    with open(os.path.join(os.path.dirname(so), "ptxas.log")) as f:
        log = f.read()
    props = ptxas_props(log)
    out = {}
    for name in TC_KERNELS + F32_KERNELS:
        fns = functions_of(name, ops)
        check(bool(fns), f"{name} not in the SASS of {so}")
        for f in fns:
            p = props.get(f, {})
            # ptxas's C7515: the wgmma pipeline runs serialised
            serial = bool(re.search(rf"C7515\)[^\n]*{re.escape(f)}", log))
            out[f] = dict(ops[f], serialised=serial, **p)
            print(f"sass {name} ({f}): HGMMA {ops[f]['HGMMA']}, HMMA "
                  f"{ops[f]['HMMA']}; ptxas: {p.get('registers')} registers, "
                  f"{p.get('spill_stores')} / {p.get('spill_loads')} bytes "
                  f"spilled (stores / loads), {p.get('smem')} bytes static "
                  f"smem, wgmma serialised (C7515) {serial}")
            if name in TC_KERNELS:
                check(ops[f]["HGMMA"] > 0, f"{name}: no HGMMA in its SASS")
                check(p.get("spill_stores", 0) + p.get("spill_loads", 0) == 0,
                      f"{name}: ptxas spills registers")
                check(not serial, f"{name}: ptxas serialises its wgmma (C7515)")
            else:
                check(ops[f]["HGMMA"] + ops[f]["HMMA"] == 0,
                      f"{name}: the f32 kernel uses the tensor cores")
    for name in ROW_KERNELS:
        fns = functions_of(name, ops)
        check(bool(fns), f"{name} not in the SASS of {so}")
        for f in fns:
            p = props.get(f, {})
            out[f] = dict(ops[f], **p)
            print(f"ptxas {name} ({f}): {p.get('registers')} registers, "
                  f"{p.get('spill_stores')} / {p.get('spill_loads')} bytes "
                  f"spilled (stores / loads), {p.get('smem')} bytes static "
                  f"smem")
            check(bool(p), f"{name}: no ptxas report for {f}")
            check(p["spill_stores"] + p["spill_loads"] == 0,
                  f"{name}: ptxas spills registers in {f}")
    return out


def kernel_phase(folded, batch, dev_line):
    """Each kernel vs its plain version at the serving shapes; returns
    {kernel name: dict(max_abs_err, ms, plain_ms)} (ms at bf16, summed over
    the kernel's calls in one forward)."""
    import torch

    from yolat_tpu_torch.ops.block_max import (folded_mlp_block_max2,
                                               folded_mlp_block_max2_plain)
    from yolat_tpu_torch.ops.edge_window import (edge_window_message_sum,
                                                 edge_window_message_sum_plain,
                                                 route_info)
    from yolat_tpu_torch.ops.plans import ew_of

    ew = ew_of(batch)
    per_window = torch.diff(ew[3]).float()
    print(f"edge windows: {per_window.numel()} of {ew[4]} nodes, edges per "
          f"window largest {int(per_window.max().item())}, mean "
          f"{per_window.mean().item():.2f}")
    cnt = torch.clamp(batch["dst_count"].float(), min=1.0)[:, None]
    maskf = batch["node_mask"].float()[:, None]
    res = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, device_ms=0.0)
           for k in ("edge_window_message_sum", "folded_mlp_block_max2")}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        f = batch["x"].to(dt)
        feats = []
        for i, c in enumerate(folded["convs"]):
            c = {k: v.to(dt) for k, v in c.items()}  # as fast_forward casts
            args = (f, ew, c["w1"], c["sc1"], c["w2"], c["sc2"])
            info = route_info(f.shape[1], ew[2].shape[1], ew[4], dt)
            print(f"kernel edge_window_message_sum conv{i} {name} route: "
                  f"{info['smem_bytes']} bytes of shared memory per CTA, "
                  f"{info['ctas_per_sm']} CTAs per SM")
            got = edge_window_message_sum(*args)
            want = edge_window_message_sum_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if dt == torch.float32:
                ok = bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
                tol = "|err| <= 1e-4 + 1e-4|ref|"
            else:
                ok = err <= 5e-3 * scale
                tol = "max|err| <= 5e-3 max|ref|"
            ms, pms, dms = paired_ms(lambda: edge_window_message_sum(*args),
                                lambda: edge_window_message_sum_plain(*args))
            print(f"kernel edge_window_message_sum conv{i} {name} x{tuple(f.shape)} "
                  f"E={ew[0].shape[0]} in {ew[3].shape[0] - 1} windows of "
                  f"{ew[4]}: max_abs_err={err:.3e}, max_rel_err="
                  f"{err / scale:.3e} of max|ref|={scale:.3e} ({tol}) "
                  f"{'ok' if ok else 'FAIL'}; "
                  f"kernel {ms:.4f} ms (queued {dms:.4f}), plain {pms:.4f} ms [{dev_line}]")
            check(ok, f"edge_window_message_sum conv{i} {name} disagrees")
            r = res["edge_window_message_sum"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if dt == torch.bfloat16:
                r["ms"] += ms
                r["plain_ms"] += pms
                r["device_ms"] += dms
                n, ci = f.shape
                e, h = ew[0].shape[0], c["w2"].shape[0]
                add_bound(r, bound(
                    2 * (n * ci + (2 * ci + 4) * h + h * h) + e * (8 + 16)
                    + 4 * (ew[3].shape[0] + 4 * h + n * h),
                    e * (2 * (2 * ci + 4) * h + 2 * h * h), PEAK_BF16))
            f = ((got / cnt).to(dt) + f @ c["wr"] + c["br"].reshape(1, -1))
            feats.append(f)
        cat = torch.cat(feats, dim=1)
        w, sc = folded["fusion_block"]
        args = (cat, maskf, w.to(dt), sc.to(dt))
        gh, gx = folded_mlp_block_max2(*args)
        wh, wx = folded_mlp_block_max2_plain(*args)
        torch.cuda.synchronize()
        err = max((gh.float() - wh.float()).abs().max().item(),
                  (gx.float() - wx.float()).abs().max().item())
        rtol = 1e-4 if dt == torch.float32 else 1e-2
        ok = bool(((gh.float() - wh.float()).abs()
                   <= 1e-4 + rtol * wh.float().abs()).all()) and torch.equal(gx, wx)
        ms, pms, dms = paired_ms(lambda: folded_mlp_block_max2(*args),
                            lambda: folded_mlp_block_max2_plain(*args))
        print(f"kernel folded_mlp_block_max2 {name} x{tuple(cat.shape)} -> "
              f"{tuple(gh.shape)}+{tuple(gx.shape)}: max_abs_err={err:.3e} "
              f"(|err| <= 1e-4 + {rtol:g}|ref|, x max exact) "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms (queued {dms:.4f}), plain "
              f"{pms:.4f} ms [{dev_line}]")
        check(ok, f"folded_mlp_block_max2 {name} disagrees")
        r = res["folded_mlp_block_max2"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if dt == torch.bfloat16:
            r["ms"], r["plain_ms"], r["device_ms"] = ms, pms, dms
            n, ci = cat.shape
            h = w.shape[1]
            add_bound(r, bound(
                2 * (n * ci + ci * h + n // 8 * (h + ci)) + 4 * (n + 2 * h),
                2 * n * ci * h, PEAK_BF16))
    return res


def route_phase(model, folded, batch, dev_line):
    """Kernel-route logits vs the plain route and the module forward."""
    import torch

    from yolat_tpu_torch.eval.fast_forward import fast_forward

    with torch.no_grad():
        ref, _ = model(batch)
        k32, _ = fast_forward(folded, batch)
        p32, _ = fast_forward(folded, batch, plain=True)
        k16, _ = fast_forward(folded, batch, bf16=True)
        p16, _ = fast_forward(folded, batch, bf16=True, plain=True)
    torch.cuda.synchronize()
    m = batch["proposal_mask"]
    check(k16.shape == ref.shape and bool(torch.isfinite(k16).all())
          and bool(torch.isfinite(k32).all()), "finite logits of the right shape")
    scale = max(1.0, ref[m].abs().max().item())
    e_mod = (k32 - ref)[m].abs().max().item()
    e_32 = (k32 - p32)[m].abs().max().item()
    e_16 = (k16 - p16)[m].abs().max().item()
    e_16f = (k16 - ref)[m].abs().max().item()
    print(f"route logits {tuple(ref.shape)} (max|ref|={scale:.3e}): "
          f"f32 kernel route vs module forward {e_mod:.3e} (<= 1e-4 scale), "
          f"f32 kernel vs plain route {e_32:.3e} (<= 1e-4 scale), "
          f"bf16 kernel vs plain route {e_16:.3e} (<= 3e-2 scale), "
          f"bf16 kernel route vs f32 module {e_16f:.3e} [{dev_line}]")
    check(e_mod <= 1e-4 * scale, "f32 kernel route disagrees with the module")
    check(e_32 <= 1e-4 * scale, "f32 kernel route disagrees with the plain route")
    check(e_16 <= 3e-2 * scale, "bf16 kernel route disagrees with the plain route")


def serve_phase(root, ckpt, work, dev_line):
    """The CLI on the SVGs; returns the launch counts of its first run."""
    from yolat_tpu_torch.cli import infer
    from yolat_tpu_torch.ops import _build

    out = os.path.join(work, "detections.jsonl")
    argv = ["--input_dir", root, "--pretrained_model", ckpt, "--out", out,
            "--serve_mode", "fast_bf16", "--device", "cuda", "--conf_th", "0.0",
            "--batch_size", str(BATCH)]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    infer.main(argv)
    cold = N_SVGS / (time.perf_counter() - t0)
    counts = dict(_build.launch_counts)
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    check(len(recs) == N_SVGS, f"{len(recs)} records for {N_SVGS} SVGs")
    for r in recs:
        check("error" not in r and r["width"] > 0, f"bad record {r.get('file')}")
        for d in r["detections"]:
            check(len(d["box"]) == 4 and all(map(_finite, d["box"]))
                  and 0.0 <= d["score"] <= 1.0, "bad detection")
    n_det = sum(len(r["detections"]) for r in recs)
    check(counts["edge_window_message_sum"] > 0
          and counts["folded_mlp_block_max2"] > 0, f"kernel launches {counts}")
    t0 = time.perf_counter()
    infer.main(argv)
    warm = N_SVGS / (time.perf_counter() - t0)
    print(f"serve: {N_SVGS} SVGs -> {len(recs)} records, {n_det} detections; "
          f"launches {counts}; "
          f"{cold:.3f} SVGs/s first run, {warm:.3f} SVGs/s second run "
          f"(end to end through the CLI, preprocessing caches warm) [{dev_line}]")
    return counts


def _rel(a, b, ref=None) -> float:
    """||a - b|| / ||ref or b||, in f32 (float64 where b is)."""
    ref = b if ref is None else ref
    wide = str(b.dtype) == "torch.float64"
    a, b, ref = ((t.double() if wide else t.float()) for t in (a, b, ref))
    return ((a - b).norm() / max(ref.norm().item(), 1e-30)).item()


def _head_run(cat, maskf, lin, bn, blk_first, n_prop, cot, dtype, route,
              round_to=None):
    """The fused head on `route`: (pooled, mean, var) and the gradients
    of sum(pooled * cot) wrt x, W, b, gamma, beta. x and W are cast to
    `dtype`, after rounding them to `round_to` if given; at float64 (the
    plain route only) the Dense bias and the BatchNorm terms too."""
    import torch

    from yolat_tpu_torch.ops.fused_pool_train import fused_pool_train

    wide = dtype == torch.float64

    def leaf(t, rounded):
        t = t.detach()
        if rounded and round_to is not None:
            t = t.to(round_to)
        if wide or rounded:
            t = t.to(dtype)
        return t.clone().contiguous().requires_grad_(True)

    leaves = [leaf(cat, True), leaf(lin.weight.t(), True),
              leaf(lin.bias, False), leaf(bn.weight, False),
              leaf(bn.bias, False)]
    x, w, b, g, be = leaves
    pooled, mean, var, _ = fused_pool_train(
        x, maskf, w, b, g, be, blk_first, n_prop, route)
    (pooled.float() * cot).sum().backward()
    torch.cuda.synchronize()
    return ({"pooled": pooled.detach(), "mean": mean, "var": var},
            dict(zip(("dx", "dW", "db", "dgamma", "dbeta"),
                     (t.grad for t in leaves))))


def _unfused_run(cat, mask, lin, bn, batch, n_prop, cot, dtype=None):
    """Linear -> masked train-mode BN -> ReLU -> segment max (torch
    autograd through the port's modules) at f32, or on dtype copies of x
    and the parameters as the bf16 train step runs it."""
    import torch

    from yolat_tpu_torch.nn.layers import MLP
    from yolat_tpu_torch.ops.plans import plan_of
    from yolat_tpu_torch.ops.segment import segment_max

    mlp = MLP([cat.shape[1], lin.weight.shape[0]]).to(cat.device).train()
    x = cat.detach().clone().requires_grad_(True)
    w = lin.weight.detach().t().contiguous().requires_grad_(True)
    b = lin.bias.detach().clone().requires_grad_(True)
    g = bn.weight.detach().clone().requires_grad_(True)
    be = bn.bias.detach().clone().requires_grad_(True)
    dt = dtype or torch.float32
    a = torch.func.functional_call(
        mlp, {"0.weight": w.t().to(dt), "0.bias": b.to(dt), "1.weight": g.to(dt),
              "1.bias": be.to(dt)},
        ((x * mask[:, None].float()).to(dt), mask))
    pooled = segment_max(a, batch["bbox_idx"], n_prop, mask=mask,
                         plan=plan_of(batch))
    (pooled.float() * cot).sum().backward()
    torch.cuda.synchronize()
    return ({"pooled": pooled.detach()},
            dict(zip(("dx", "dW", "db", "dgamma", "dbeta"),
                     (t.grad for t in (x, w, b, g, be)))))


def train_kernel_phase(model, batch, dev_line):
    """Kernels 3 and 11 at the bench batch's training shapes; returns
    {kernel name: dict(max_abs_err, ms, plain_ms)} (ms at bf16; kernel
    11's max_abs_err is the largest gradient error of the f32 head)."""
    import torch

    from yolat_tpu_torch.ops.block_max import (folded_mlp_block_max,
                                               folded_mlp_block_max_plain)
    from yolat_tpu_torch.ops.fused_pool_train import (
        _scale_shift, _stats, fused_pool_train_bwd,
        fused_pool_train_bwd_plain)
    from yolat_tpu_torch.ops.plans import plan_of

    model.train()
    # the features in a fixed order (the sparse layout's scatter_add_ is
    # otherwise atomic): the bf16 head comparison below then sees the same
    # inputs, and the same bf16 winner flips between the routes, every run
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad():
            cat, _ = model.cls_net.features(batch)
    finally:
        torch.use_deterministic_algorithms(det[0], warn_only=det[1])
    lin, bn = model.cls_net.fusion_block[0], model.cls_net.fusion_block[1]
    mask = batch["node_mask"]
    maskf = mask.float()[:, None]
    blk_first = plan_of(batch)[0]
    n_prop = batch["labels"].shape[0]
    h = lin.weight.shape[0]
    cot = torch.randn(n_prop, h, generator=torch.Generator().manual_seed(5)
                      ).to(cat.device)
    res = {"folded_mlp_block_max": dict(max_abs_err=0.0),
           "fused_pool_train_bwd": dict(max_abs_err=0.0)}
    print(f"train kernels: cat {tuple(cat.shape)} -> H {h}, "
          f"{blk_first.shape[0]} blocks, {n_prop} proposals")

    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        x = (cat * maskf).to(dt)
        w = lin.weight.detach().t().contiguous().to(dt)
        mean, var, _, _, _ = _stats(x, maskf, w, lin.bias.detach())
        sc = _scale_shift(mean, var, lin.bias.detach(), bn.weight.detach(),
                          bn.bias.detach())
        got = folded_mlp_block_max(x, maskf, w, sc)
        want = folded_mlp_block_max_plain(x, maskf, w, sc)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rtol = 1e-4 if dt == torch.float32 else 1e-2
        ok = bool(((got.float() - want.float()).abs()
                   <= 1e-4 + rtol * want.float().abs()).all())
        ms, pms, dms = paired_ms(lambda: folded_mlp_block_max(x, maskf, w, sc),
                            lambda: folded_mlp_block_max_plain(x, maskf, w, sc))
        print(f"kernel folded_mlp_block_max {name} x{tuple(x.shape)} -> "
              f"{tuple(got.shape)}: max_abs_err={err:.3e} (|err| <= 1e-4 + "
              f"{rtol:g}|ref|) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms (queued {dms:.4f}), "
              f"plain {pms:.4f} ms [{dev_line}]")
        check(ok, f"folded_mlp_block_max {name} disagrees")
        r = res["folded_mlp_block_max"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if dt == torch.bfloat16:
            r["ms"], r["plain_ms"], r["device_ms"] = ms, pms, dms
            n, ci = x.shape
            add_bound(r, bound(
                2 * (n * ci + ci * h + n // 8 * h) + 4 * (n + 2 * h),
                2 * n * ci * h, PEAK_BF16))
            # kernel 11: x, mask, W, scale/shift, the pooled maxima and
            # their cotangent in; dW, dx and two column sums out, each
            # once; the function needs three products of the forward's
            # size (z = x W to find the winners, dW = x^T s, dx = s W^T)
            add_bound(res["fused_pool_train_bwd"], bound(
                2 * (n * ci + ci * h + n // 8 * h) + 4 * (n + 2 * h)
                + 4 * n // 8 * h + 4 * ci * h + 2 * n * ci + 8 * h,
                3 * 2 * n * ci * h, PEAK_BF16))

        # the whole fused head: kernel route vs plain route
        kv, kg = _head_run(cat, maskf, lin, bn, blk_first, n_prop, cot, dt,
                           "kernel")
        pv, pg = _head_run(cat, maskf, lin, bn, blk_first, n_prop, cot, dt,
                           "plain")
        # f32: sound runs read <= 6.9e-7; bf16: <= 7.2e-5 with one bf16
        # winner flip, while a kernel 11 that keeps s = u*sc0 in f32
        # instead of rounding it to bf16 reads 2.6e-3 (dx), 2.9e-3 (dW)
        tol = HEAD_TOL[name]
        errs = {k: _rel(kv[k], pv[k]) for k in kv}
        errs.update({k: _rel(kg[k], pg[k], pg["dbeta"] if k == "db" else None)
                     for k in kg})
        abs_err = max((kg[k].float() - pg[k].float()).abs().max().item()
                      for k in kg)
        check(all(torch.isfinite(t.float()).all() for t in
                  list(kv.values()) + list(kg.values())), "finite head outputs")
        check(kg["dW"].abs().max().item() > 0, "winners found (dW nonzero)")
        print(f"fused head {name}, kernel route vs plain route, relative "
              f"Frobenius error (db against ||dbeta||; <= {tol:g}): "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; max abs grad err {abs_err:.3e}")
        check(all(v <= tol for v in errs.values()),
              f"fused head {name}: kernel route disagrees with the plain route")
        if dt == torch.bfloat16:
            print(f"fused head bf16 against the float64 plain route (kernel "
                  f"<= {HEAD_F64_FACTOR} x plain + {HEAD_F64_FLOOR:g} in "
                  f"{', '.join(HEAD_F64_KEYS)}):")
            print(_head_vs_f64(cat, maskf, lin, bn, blk_first, n_prop, cot,
                               (got, want), (kv, kg), (pv, pg), errs,
                               "phase 5 fused head"))
        if dt == torch.float32:
            # at bf16 a rounding flip at a bf16 boundary can move a winner
            # between the routes, so the element-wise error of the
            # kernels line is the f32 one
            res["fused_pool_train_bwd"]["max_abs_err"] = abs_err

        # kernel 11 alone: bit-identical runs, paired times
        pooled_b = kv["pooled"][blk_first.long()]
        gp_b = cot[blk_first.long()]
        ppb = folded_mlp_block_max_plain(x, maskf, w, sc)  # plain's own bits
        raw = torch.full((n_prop, h), -1e30, device=x.device).scatter_reduce_(
            0, blk_first.long()[:, None].expand(-1, h), ppb.float(), "amax")
        ppooled_b = torch.where(raw <= -5e29, torch.zeros_like(raw),
                                raw).to(dt)[blk_first.long()]
        a1 = fused_pool_train_bwd(x, maskf, w, sc, pooled_b, gp_b)
        a2 = fused_pool_train_bwd(x, maskf, w, sc, pooled_b, gp_b)
        torch.cuda.synchronize()
        same = all(torch.equal(p, q) for p, q in zip(a1, a2))
        check(same, f"kernel 11 {name}: two runs differ")
        ms, pms, dms = paired_ms(
            lambda: fused_pool_train_bwd(x, maskf, w, sc, pooled_b, gp_b),
            lambda: fused_pool_train_bwd_plain(x, maskf, w, sc, ppooled_b,
                                               gp_b))
        print(f"kernel fused_pool_train_bwd {name}: two runs bit-identical "
              f"{same}; kernel {ms:.4f} ms (queued {dms:.4f}), plain {pms:.4f} ms [{dev_line}]")
        if dt == torch.bfloat16:
            res["fused_pool_train_bwd"].update(ms=ms, plain_ms=pms,
                                               device_ms=dms)

    # the kernel route against the unfused composition, f32
    kv, kg = _head_run(cat, maskf, lin, bn, blk_first, n_prop, cot,
                       torch.float32, "kernel")
    uv, ug = _unfused_run(cat, mask, lin, bn, batch, n_prop, cot)
    errs = {"pooled": _rel(kv["pooled"], uv["pooled"])}
    errs.update({k: _rel(kg[k], ug[k], ug["dbeta"] if k == "db" else None)
                 for k in kg})
    # sound runs read <= 1.6e-6: cuBLAS and torch's BN sum in other orders
    print(f"fused head f32, kernel route vs unfused composition, relative "
          f"Frobenius error (<= {UNFUSED_TOL:g}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(all(v <= UNFUSED_TOL for v in errs.values()),
          "fused head disagrees with the unfused composition")

    # the whole bf16 head, forward and backward: the fused route (kernels
    # 3 and 11) against the unfused composition (cuBLAS and torch autograd)
    # in turns, device time per call from the profiler
    from yolat_tpu_torch.cli.profile import _trace

    arms = {"fused": lambda: _head_run(cat, maskf, lin, bn, blk_first, n_prop,
                                       cot, torch.bfloat16, "kernel"),
            "unfused": lambda: _unfused_run(cat, mask, lin, bn, batch, n_prop,
                                            cot, torch.bfloat16)}
    for fn in arms.values():
        fn()
    reads = {k: [] for k in arms}
    for k in ("fused", "unfused", "unfused", "fused"):
        t = _trace(arms[k], 10)
        check(t["device_busy_ms_per_call"] is not None,
              "the profiler traced the card")
        reads[k].append(t)
    for k, ts in reads.items():
        print(f"bf16 head {k}, forward + backward: device busy "
              + " / ".join(f"{t['device_busy_ms_per_call']:.4f}" for t in ts)
              + " ms per call, profiled wall "
              + " / ".join(f"{t['profiled_wall_ms_per_call']:.4f}" for t in ts)
              + f" ms, {ts[0]['device_kernels_per_call']:.0f} kernels; own "
              f"kernels {ts[-1]['own_kernels_ms_per_call']} [{dev_line}]")
    model.eval()
    return res


def train_phase(work, dev_line):
    """cli.train on bench-scale SVGs (bf16, fused head), then the trained
    weights through cli.infer; returns the train path's launch counts, the
    data root, the checkpoint dir and the trained weights' reference .pth."""
    from yolat_tpu_torch.cli import infer
    from yolat_tpu_torch.cli import train as train_cli
    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.synthetic import write_dataset
    from yolat_tpu_torch.nn.model import build_model
    from yolat_tpu_torch.ops import _build
    from yolat_tpu_torch.train.checkpoint import (CheckpointManager,
                                                  load_train_state,
                                                  save_reference_checkpoint)

    root = os.path.join(work, "train_svgs")
    write_dataset(root, n_train=N_SVGS, n_test=2, seed=11, width=2000.0,
                  height=1500.0, n_rooms=6, symbols_per_room=(1, 3))
    argv = ["--data_dir", root, "--device", "cuda", "--dtype", "bfloat16",
            "--fused_head_train", "true", "--data_aug", "true",
            "--batch_size", str(BATCH), "--n_filters", "64",
            "--max_steps", str(TRAIN_STEPS), "--root_dir",
            os.path.join(work, "log"), "--print_freq", "1"]
    _build.reset_launch_counts()
    res = train_cli.main(argv)
    counts = dict(_build.launch_counts)
    check(res["steps"] == TRAIN_STEPS, f"{res['steps']} train steps")
    check(len(res["losses"]) == TRAIN_STEPS
          and all(v == v and abs(v) != float("inf") for v in res["losses"]),
          f"finite losses {res['losses']}")
    check(counts["folded_mlp_block_max"] == TRAIN_STEPS
          and counts["fused_pool_train_bwd"] == TRAIN_STEPS,
          f"training kernels launched once per step: {counts}")
    for k in ("map_50", "map_all", "top1_acc"):
        check(k in res and res[k] == res[k], f"evaluation result {k}")
    ckdir = os.path.join(res["exp_dir"], "checkpoint")
    check(os.path.exists(os.path.join(ckdir, "ckpt_best.pt")),
          "a best checkpoint was written")
    secs = res["train_seconds"]
    print(f"train: {res['steps']} bf16 steps (fused head, augmentation on, "
          f"batch {BATCH}, 64 channels) in {secs:.3f} s = "
          f"{res['steps'] / secs:.3f} steps/s, {res['images'] / secs:.3f} "
          f"images/s (first steps included); losses "
          f"{[round(v, 4) for v in res['losses']]}; MAP@0.5 "
          f"{res['map_50']:.4f}, top1 {res['top1_acc']:.4f}; launches "
          f"{counts} [{dev_line}]")

    state, epoch, _ = CheckpointManager(ckdir).restore("best")
    model = build_model(Config(n_classes=SESYDDataset(root).n_classes))
    load_train_state(state, model)
    pth = os.path.join(work, "trained.pth")
    save_reference_checkpoint(model, pth, epoch)
    out = os.path.join(work, "trained.jsonl")
    infer.main(["--data_dir", root, "--phase", "train", "--pretrained_model",
                pth, "--out", out, "--device", "cuda", "--conf_th", "0.0",
                "--batch_size", str(BATCH)])
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    check(len(recs) == N_SVGS and all("error" not in r for r in recs),
          f"{len(recs)} records for {N_SVGS} trained-on SVGs")
    print(f"served the trained checkpoint (epoch {epoch}): {len(recs)} "
          f"records, {sum(len(r['detections']) for r in recs)} detections")
    return counts, root, ckdir, pth


def _library_ms(fn) -> float:
    return statistics.median(time_ms(fn) + time_ms(fn))


def window_kernel_phase(model, batch, dev_line):
    """Kernels 9 and 10, forward and backward, against their plain versions
    at the window train step's shapes; returns {kernel name: entry} (ms at
    bf16, summed over the kernel's calls in one step)."""
    import torch

    from yolat_tpu_torch.ops import edge_window_train as ewt
    from yolat_tpu_torch.ops.plans import ew_train_of

    plan = ew_train_of(batch)
    check(plan is not None, "the batch carries the transposed plan")
    src, dst, dptr, sperm, sptr = plan
    srcl, dstl = src.long(), dst.long()
    n, e = batch["x"].shape[0], src.shape[0]
    # the node rows a gather reads: the bound counts these, not all n
    n_pair = int(torch.unique(torch.cat([srcl, dstl])).numel())
    n_dst = int(torch.unique(dstl).numel())
    print(f"window plan: {n} nodes, {n_pair} on an edge, {n_dst} with an "
          f"in-edge (the gathers' bounds read these rows)")
    with torch.no_grad():
        f1, _ = model.cls_net.head.gconv(
            batch["x"], batch["x"], batch["edge"], batch["e_attr"],
            batch["edge_mask"], batch["node_mask"],
            dst_count=batch["dst_count"])
    gen = torch.Generator(device=f1.device).manual_seed(9)
    names = ("ew_pair_features", "ew_pair_features_bwd",
             "ew_window_segment_sum", "ew_window_segment_sum_bwd")
    res = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, device_ms=0.0,
                   queued_ms=0.0, warm_ms=0.0, library_ms=0.0,
                   library_device_ms=0.0) for k in names}
    # calls per step: kernel 9 forward at C 5 and 64, its backward at C 64
    # (the first layer's input needs no gradient); kernel 10 forward and
    # backward at C 64, once per layer
    calls = {"ew_pair_features": {5: 1, 64: 1}, "ew_pair_features_bwd": {64: 1},
             "ew_window_segment_sum": {64: N_BLOCKS},
             "ew_window_segment_sum_bwd": {64: N_BLOCKS}}

    # the profiler's readings, taken after the loop (`profiled_ms`): the
    # kernel's and the library call's (function, args) under one key each
    specs, pending = {}, []

    def note(name, c, dt, err, ok, limit, ms, pms, dms, lms, b, kspec, lspec):
        tag = "f32" if dt == torch.float32 else "bf16"
        print(f"kernel {name} {tag} C={c} N={n} E={e}: max_abs_err={err:.3e} "
              f"({limit}) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms (queued {dms:.4f}), plain "
              f"{pms:.4f} ms, library {lms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{dev_line}]")
        check(ok, f"{name} {tag} C={c} disagrees with its plain version")
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        k = calls[name].get(c, 0) if dt == torch.bfloat16 else 0
        if k:
            r["ms"] += k * ms
            r["plain_ms"] += k * pms
            r["queued_ms"] += k * dms
            r["library_ms"] += k * lms
            for _ in range(k):
                add_bound(r, b)
        key = f"{name} {tag} C={c}"
        specs[key], specs[key + " library"] = kspec, lspec
        pending.append((key, name, k, b))

    for dt in (torch.float32, torch.bfloat16):
        s = 4 if dt == torch.float32 else 2
        for x in (batch["x"].to(dt), f1.to(dt)):
            c = x.shape[1]
            # kernel 9 forward: copies and one rounded difference, exact
            g = ewt.pair_fwd(x, src, dst)
            g2 = ewt.pair_fwd(x, src, dst)
            want = ewt.pair_fwd_plain(x, src, dst)
            torch.cuda.synchronize()
            ok = torch.equal(g, want) and torch.equal(g, g2)
            err = (g.float() - want.float()).abs().max().item()
            kfn = lambda: ewt.pair_fwd(x, src, dst)
            ms, pms, dms = paired_ms(kfn,
                                lambda: ewt.pair_fwd_plain(x, src, dst))
            lfn = lambda: (x.index_select(0, dstl), x.index_select(0, srcl))
            lms = _library_ms(lfn)
            note("ew_pair_features", c, dt, err, ok,
                 "exact, two runs bit-identical", ms, pms, dms, lms,
                 bound(s * (n_pair * c + 2 * e * c) + 8 * e, e * c,
                       PEAK_F32), (EWT + "pair_fwd", (x, src, dst)),
                 ("gather2", (x, dstl, srcl)))

            # kernel 9 backward: sums in the plan's order, rounded to dt
            dg = torch.randn(e, 2 * c, device=x.device, generator=gen).to(dt)
            dx = ewt.pair_bwd(dg, src, dst, dptr, sperm, sptr, n)
            dx2 = ewt.pair_bwd(dg, src, dst, dptr, sperm, sptr, n)
            want = ewt.pair_bwd_plain(dg, src, dst, n)
            # a planted fault for the limit: dg0 - dg1 kept in f32
            acc = torch.zeros(n, c, device=x.device)
            acc.index_add_(0, dstl, dg[:, :c].float() - dg[:, c:].float())
            planted = acc.index_add_(0, srcl, dg[:, c:].float()).to(dt)
            torch.cuda.synchronize()
            diff = (dx.float() - want.float()).abs()
            err = diff.max().item()
            frac = (diff > 0).float().mean().item()
            pfrac = (planted != want).float().mean().item()
            if dt == torch.float32:
                ok = bool((diff <= 1e-5 + 1e-5 * want.abs()).all())
                limit = "|err| <= 1e-5 + 1e-5|ref|"
            else:
                ok = bool((diff <= 1e-5 + 2.0 ** -7 * want.float().abs()
                           ).all()) and frac <= 1e-3
                limit = (f"one bf16 ulp, {frac:.2e} of the elements differ "
                         f"(<= 1e-3; the planted fault reads {pfrac:.2e})")
            ok = ok and torch.equal(dx, dx2)
            kfn = lambda: ewt.pair_bwd(dg, src, dst, dptr, sperm, sptr, n)
            ms, pms, dms = paired_ms(
                kfn, lambda: ewt.pair_bwd_plain(dg, src, dst, n))
            d_xi, d_xj = dg[:, :c].float(), dg[:, c:].float()
            lfn = lambda: torch.zeros(n, c, device=x.device).index_add_(
                0, dstl, d_xi).index_add_(0, srcl, d_xj)
            lms = _library_ms(lfn)
            note("ew_pair_features_bwd", c, dt, err, ok, limit, ms, pms, dms, lms,
                 bound(s * (2 * e * c + n * c) + 4 * (2 * n + 2 + e),
                       3 * e * c, PEAK_F32),
                 (EWT + "pair_bwd", (dg, src, dst, dptr, sperm, sptr, n)),
                 ("index_add2", (n, c, dstl, d_xi, srcl, d_xj)))

        # kernel 10 at C 64 (messages) and C 1 (edge counts)
        for c in (64, 1):
            h = torch.randn(e, c, device=f1.device, generator=gen).to(dt)
            out = ewt.wsum_fwd(h, dst, dptr, n)
            out2 = ewt.wsum_fwd(h, dst, dptr, n)
            want = ewt.wsum_fwd_plain(h, dst, n)
            torch.cuda.synchronize()
            diff = (out - want).abs()
            ok = bool((diff <= 1e-5 + 1e-5 * want.abs()).all()) \
                and torch.equal(out, out2)
            kfn = lambda: ewt.wsum_fwd(h, dst, dptr, n)
            ms, pms, dms = paired_ms(kfn,
                                lambda: ewt.wsum_fwd_plain(h, dst, n))
            hf = h.float()
            lfn = lambda: torch.zeros(n, c, device=h.device).index_add_(
                0, dstl, hf)
            lms = _library_ms(lfn)
            note("ew_window_segment_sum", c, dt, diff.max().item(), ok,
                 "|err| <= 1e-5 + 1e-5|ref|, two runs bit-identical", ms, pms,
                 dms, lms, bound(s * e * c + 4 * (n + 1) + 4 * n * c, e * c,
                            PEAK_F32), (EWT + "wsum_fwd", (h, dst, dptr, n)),
                 ("index_add", (n, c, dstl, hf)))

            g = torch.randn(n, c, device=f1.device, generator=gen)
            dh = ewt.wsum_bwd(g, dst, dt)
            dh2 = ewt.wsum_bwd(g, dst, dt)
            want = ewt.wsum_bwd_plain(g, dst, dt)
            torch.cuda.synchronize()
            ok = torch.equal(dh, want) and torch.equal(dh, dh2)
            err = (dh.float() - want.float()).abs().max().item()
            kfn = lambda: ewt.wsum_bwd(g, dst, dt)
            ms, pms, dms = paired_ms(kfn,
                                lambda: ewt.wsum_bwd_plain(g, dst, dt))
            lfn = lambda: g.index_select(0, dstl)
            lms = _library_ms(lfn)
            note("ew_window_segment_sum_bwd", c, dt, err, ok,
                 "exact, two runs bit-identical", ms, pms, dms, lms,
                 bound(4 * n_dst * c + 4 * e + s * e * c, 0.0, PEAK_F32),
                 (EWT + "wsum_bwd", (g, dst, dt)), ("gather", (g, dstl)))

    times = profiled_ms(specs)
    for key, name, k, b in pending:
        (kw, kf), (lw, lf) = times[key], times[key + " library"]
        print(f"profiler {key}: device ms per call, in a process of its own: "
              f"kernel {kw:.4f} warm, {kf:.4f} L2-flushed "
              f"({kf / b['bound_ms']:.2f}x its bound), library {lw:.4f} "
              f"warm, {lf:.4f} L2-flushed [{dev_line}]")
        r = res[name]
        r["device_ms"] += k * kf
        r["warm_ms"] += k * kw
        r["library_device_ms"] += k * lf
    return res


def window_conv_phase(model, batch, dev_line):
    """The second conv layer in the window layout against the sparse
    layout: the same weights, the first layer's real activations."""
    import copy

    import torch

    from yolat_tpu_torch.nn import conv as conv_mod
    from yolat_tpu_torch.ops import edge_window_train as ewt
    from yolat_tpu_torch.ops.plans import ew_train_of

    with torch.no_grad():
        f1, s1 = model.cls_net.head.gconv(
            batch["x"], batch["x"], batch["edge"], batch["e_attr"],
            batch["edge_mask"], batch["node_mask"],
            dst_count=batch["dst_count"])
    base = model.cls_net.backbone[0].body.gconv
    maskf = batch["node_mask"].float()[:, None]
    args = (batch["edge"], batch["e_attr"], batch["edge_mask"],
            batch["node_mask"])
    plan = ew_train_of(batch)
    window = dict(ew=plan, ew_attr=batch["ew_attr"])
    layouts = {"sparse": {}, "window": window, "no_src_sum": window,
               "sum_bwd_by_src": window}
    # window row e is sparse row order[e]: the real edges, stably by dst
    real = batch["edge_mask"].nonzero()[:, 0]
    order = real[torch.argsort(batch["edge"][real, 1], stable=True)]
    check(torch.equal(batch["edge"][order, 0], plan[0])
          and torch.equal(batch["edge"][order, 1], plan[1]),
          "the plan's rows are the sparse rows in dst order")

    # two planted faults in the window layout's backward, for the limit:
    # kernel 9's backward without its sum over out-edges (moves dx), and
    # kernel 10's backward reading the cotangent at the source node (moves
    # the message MLP's gradients and dx)
    class NoSrcSum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.n = x.shape[0]
            return ewt.pair_fwd(x, plan[0], plan[1])

        @staticmethod
        def backward(ctx, dg):
            c = dg.shape[1] // 2
            dx = torch.zeros(ctx.n, c, device=dg.device)
            dx.index_add_(0, plan[1].long(), (dg[:, :c] - dg[:, c:]).float())
            return dx.to(dg.dtype)

    class SumBwdBySrc(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, n):
            ctx.dtype = h.dtype
            return ewt.wsum_fwd(h, plan[1], plan[2], n)

        @staticmethod
        def backward(ctx, g):
            return ewt.wsum_bwd(g.float(), plan[0], ctx.dtype), None

    faults = {"no_src_sum": ("ew_pair_features",
                             lambda x, ew: NoSrcSum.apply(x)),
              "sum_bwd_by_src": ("ew_window_segment_sum_n",
                                 lambda h, ew, n: SumBwdBySrc.apply(h, n))}
    # a fixed random cotangent on the real nodes. The layouts' forward
    # values differ by summation order in the BN statistics (46102 real rows
    # against 56320 padded ones), which can flip a ReLU gate of the message
    # MLP; one flip moves a gradient sum by a whole cotangent, so the
    # gradients are held looser than the forward. At bf16 the sparse
    # layout also sums its index_select backward and its weight gradients
    # over other rows in another order, with bf16 rounding between. The
    # phase counts the flipped gates, shows what they alone do to one
    # gradient, and reads both planted faults beside the limit.
    cot = torch.randn(2, *f1.shape, generator=torch.Generator().manual_seed(3)
                      ).to(f1.device) * maskf

    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        runs, gates = {}, {}
        for layout, kw in layouts.items():
            conv = copy.deepcopy(base).eval()
            cast = {k: (p.to(dt) if p.dtype == torch.float32 else p)
                    for k, p in conv.named_parameters()}
            e_args = (args[0], args[1].to(dt)) + args[2:]
            kw = {k: (v.to(dt) if k == "ew_attr" else v) for k, v in kw.items()}
            with torch.no_grad():
                ev, _ = torch.func.functional_call(
                    conv, cast, (f1.to(dt), s1.to(dt)) + e_args,
                    dict(dst_count=batch["dst_count"], **kw))
            conv.train()
            gates[layout] = []
            hooks = [conv.nn[i].register_forward_hook(
                lambda m, a, out, g=gates[layout]: g.append(out.detach() > 0))
                for i in (2, 5)]
            x = f1.clone().requires_grad_(True)
            leaves = {k: p.detach().clone().requires_grad_(True)
                      for k, p in conv.named_parameters()}
            if layout in faults:
                attr, fn = faults[layout]
                sound = getattr(conv_mod, attr)
                setattr(conv_mod, attr, fn)
            try:
                out, out_node = torch.func.functional_call(
                    conv, {k: p.to(dt) for k, p in leaves.items()},
                    (x.to(dt), s1.to(dt)) + e_args,
                    dict(dst_count=batch["dst_count"], **kw))
            finally:
                if layout in faults:
                    setattr(conv_mod, attr, sound)
            ((out.float() * cot[0]).sum()
             + (out_node.float() * cot[1]).sum()).backward()
            torch.cuda.synchronize()
            for hk in hooks:
                hk.remove()
            r = {"eval_out": ev, "train_out": out.detach(), "dx": x.grad}
            for i in (1, 4):
                r[f"nn.{i}.running_mean"] = conv.nn[i].running_mean
                r[f"nn.{i}.running_var"] = conv.nn[i].running_var
            r.update({f"d {k}": p.grad for k, p in leaves.items()})
            runs[layout] = r
        zero = {"d nn.0.bias": "d nn.1.bias", "d nn.3.bias": "d nn.4.bias",
                "d mlp_node.0.bias": "d mlp_node.1.bias"}

        def rel_to_sparse(layout):
            return {k: _rel(v, runs["sparse"][k],
                            runs["sparse"].get(zero.get(k)))
                    for k, v in runs[layout].items()}

        errs = rel_to_sparse("window")
        flips = [int((gs[order] != gw).sum())
                 for gs, gw in zip(gates["sparse"], gates["window"])]
        n_gates = gates["window"][0].numel()
        check(all(torch.isfinite(v.float()).all()
                  for v in runs["window"].values()), "finite conv outputs")
        check(runs["window"]["dx"].abs().max().item() > 0, "dx is nonzero")
        tol_fwd, tol_grad = CONV_TOL[name]
        print(f"window conv vs sparse conv {name} (64 -> 64, N="
              f"{f1.shape[0]}), relative Frobenius error (Dense biases "
              f"feeding a BN against the BN shift's gradient; forward and "
              f"statistics <= {tol_fwd:g}, gradients <= {tol_grad:g}): "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; ReLU gates that differ between the layouts: {flips[0]} "
              f"and {flips[1]} of {n_gates} after the message MLP's first "
              f"and second stage [{dev_line}]")
        check(all(v <= (tol_grad if k.startswith("d") else tol_fwd)
                  for k, v in errs.items()),
              f"window conv {name} disagrees with the sparse conv")
        # what the flipped gates alone do to the second BN shift's gradient:
        # a stage-2 gate open in one layout only lets that element's
        # cotangent, cot / count at its dst, through to the sum
        key = "d nn.4.bias"
        c = (cot[0] / batch["dst_count"].float().clamp(min=1.0)[:, None]
             )[plan[1].long()]
        pred = ((gates["window"][1].float() - gates["sparse"][1][order].float())
                * c).sum(0)
        meas = runs["window"][key].float() - runs["sparse"][key].float()
        den = runs["sparse"][key].float().norm()
        rest = ((meas - pred).norm() / den).item()
        print(f"window conv {name}: the {flips[1]} flipped stage-2 gates alone "
              f"move {key} by {(pred.norm() / den).item():.2e} of its norm "
              f"(read {errs[key]:.2e}); without them the layouts differ by "
              f"{rest:.2e}" + (" (<= 1e-5)" if dt == torch.float32 else ""))
        check(dt != torch.float32 or rest <= 1e-5,
              f"window conv {name}: {key} differs by more than the flipped "
              f"gates explain")
        # the planted faults: each must read above the gradient limit in
        # every gradient it reaches
        p_dx = rel_to_sparse("no_src_sum")["dx"]
        p_sum = rel_to_sparse("sum_bwd_by_src")
        reached = {k: v for k, v in p_sum.items()
                   if k == "dx" or (k.startswith("d nn.") and k not in zero)}
        print(f"window conv {name}, planted faults against the gradient "
              f"limit {tol_grad:g}: kernel 9's backward without the sum over "
              f"out-edges reads dx {p_dx:.2e}; kernel 10's backward reading "
              f"the source's cotangent reads "
              + ", ".join(f"{k} {v:.2e}" for k, v in reached.items()))
        check(p_dx > tol_grad and all(v > tol_grad for v in reached.values()),
              f"window conv {name}: a planted fault passes the limit")


def dense_phase(folded, batch, dense_batch, dev_line):
    """Kernel 4 against its plain version at both conv shapes, and the
    engine's dense route against its edge-window route; returns kernel
    4's entry (ms at bf16, summed over both conv layers)."""
    import torch

    from yolat_tpu_torch.eval.fast_forward import fast_forward
    from yolat_tpu_torch.ops.dense_message import (dense_message_work,
                                                   fused_dense_message,
                                                   fused_dense_message_plain)

    nbr = (dense_batch["nbr_idx"], dense_batch["nbr_attr"],
           dense_batch["nbr_mask"])
    n, d = nbr[0].shape
    used = int(nbr[2].sum())
    check(used == int(batch["edge_mask"].sum()),
          "the table holds every real edge")
    r = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, device_ms=0.0,
             library_ms=None)
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        f = dense_batch["x"].to(dt)
        for i, c in enumerate(folded["convs"]):
            args = (f, *nbr, c["w1"], c["sc1"], c["w2"], c["sc2"], c["wr"],
                    c["br"])
            dense_message_work(reset=True)
            got = fused_dense_message(*args)
            if dt == torch.bfloat16:
                rows, tiles = dense_message_work(reset=True)
                print(f"kernel fused_dense_message conv{i} bf16: computed "
                      f"{rows} MLP rows for {used} used slots (of {n * d}), "
                      f"in {tiles} pair tiles of 64 rows")
                check(rows == used, "kernel 4 computes MLP rows for used "
                      "slots only, each once")
            again = fused_dense_message(*args)
            want = fused_dense_message_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if dt == torch.float32:
                ok = bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
                tol = "|err| <= 1e-4 + 1e-4|ref|"
            else:
                ok = err <= 5e-3 * scale
                tol = "max|err| <= 5e-3 max|ref|"
            ok = ok and torch.equal(got, again)
            ms, pms, dms = paired_ms(lambda: fused_dense_message(*args),
                                lambda: fused_dense_message_plain(*args))
            ci, h = f.shape[1], c["w2"].shape[0]
            b = bound((2 if dt == torch.bfloat16 else 4)
                      * (n * ci + (3 * ci + 4) * h + h * h)
                      + n * d * (4 + 16 + 1) + 4 * (5 * h + n * h),
                      n * 4 * ci * h + used * (2 * (ci + 4) * h + 2 * h * h),
                      PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32)
            print(f"kernel fused_dense_message conv{i} {name} x"
                  f"{tuple(f.shape)} D={d}, {used} of {n * d} slots used: "
                  f"max_abs_err={err:.3e} of max|ref|={scale:.3e} ({tol}, "
                  f"two runs bit-identical) {'ok' if ok else 'FAIL'}; kernel "
                  f"{ms:.4f} ms (queued {dms:.4f}), plain {pms:.4f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{dev_line}]")
            check(ok, f"fused_dense_message conv{i} {name} disagrees")
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if dt == torch.bfloat16:
                r["ms"] += ms
                r["plain_ms"] += pms
                r["device_ms"] += dms
                add_bound(r, b)
            f = got.to(dt)

    with torch.no_grad():
        dense32, _ = fast_forward(folded, dense_batch)
        window32, _ = fast_forward(folded, batch)
        dense16, _ = fast_forward(folded, dense_batch, bf16=True)
        plain16, _ = fast_forward(folded, dense_batch, bf16=True, plain=True)
    torch.cuda.synchronize()
    m = batch["proposal_mask"]
    scale = max(1.0, window32[m].abs().max().item())
    e32 = (dense32 - window32)[m].abs().max().item()
    e16 = (dense16 - plain16)[m].abs().max().item()
    print(f"dense route logits {tuple(dense32.shape)} (max|ref|={scale:.3e}): "
          f"f32 dense route vs edge-window route {e32:.3e} (<= 1e-4 scale), "
          f"bf16 kernel vs plain route {e16:.3e} (<= 3e-2 scale) [{dev_line}]")
    check(bool(torch.isfinite(dense32).all() and torch.isfinite(dense16).all()),
          "finite logits on the dense route")
    check(e32 <= 1e-4 * scale, "the dense route disagrees with the edge-window route")
    check(e16 <= 3e-2 * scale, "bf16 dense route disagrees with its plain route")
    return {"fused_dense_message": r}


def window_train_phase(root, work, dev_line):
    """cli.train --train_layout window on the SVGs of the train phase,
    then its checkpoint through cli.test on the dense route with classfix
    NMS; returns the launch counts of kernels 9, 10 and 4."""
    from yolat_tpu_torch.cli import test as test_cli
    from yolat_tpu_torch.cli import train as train_cli
    from yolat_tpu_torch.ops import _build

    _build.reset_launch_counts()
    res = train_cli.main([
        "--data_dir", root, "--device", "cuda", "--dtype", "bfloat16",
        "--train_layout", "window", "--data_aug", "true", "--batch_size",
        str(BATCH), "--n_filters", "64", "--n_blocks", str(N_BLOCKS),
        "--max_steps", str(WINDOW_STEPS), "--root_dir",
        os.path.join(work, "log_window"), "--print_freq", "1"])
    counts = res["launches"]
    check(counts == {k: v for k, v in _build.launch_counts.items()},
          "the CLI's launch counts are the counters' rise")
    steps, evals = res["steps"], res["eval_batches"]
    check(steps == WINDOW_STEPS and evals >= 1, f"{steps} steps, {evals} "
          "evaluated batches")
    check(len(res["losses"]) == steps and all(map(_finite, res["losses"])),
          f"finite losses {res['losses']}")
    want = {"ew_pair_features": N_BLOCKS * (steps + evals),
            "ew_window_segment_sum": N_BLOCKS * (steps + evals),
            "ew_window_segment_sum_bwd": N_BLOCKS * steps,
            "ew_pair_features_bwd": (N_BLOCKS - 1) * steps}
    got = {k: counts[k] for k in want}
    check(got == want, f"window kernels launched {got}, the code implies {want}")
    secs = res["train_seconds"]
    print(f"window train: {steps} bf16 steps (train_layout window, "
          f"augmentation on, batch {BATCH}, 64 channels) in {secs:.3f} s = "
          f"{steps / secs:.3f} steps/s (first steps included), {evals} "
          f"evaluated batches; losses {[round(v, 4) for v in res['losses']]}; "
          f"launches {got} = per step {N_BLOCKS} / {N_BLOCKS - 1} / {N_BLOCKS}"
          f" / {N_BLOCKS} (kernel 9 forward / backward, kernel 10 forward / "
          f"backward) plus {N_BLOCKS} forward launches of each per evaluated "
          f"batch [{dev_line}]")

    _build.reset_launch_counts()
    table = test_cli.main([
        "--data_dir", root, "--phase", "test", "--device", "cuda",
        "--batch_size", str(BATCH), "--n_filters", "64", "--n_blocks",
        str(N_BLOCKS), "--pretrained_model",
        os.path.join(res["exp_dir"], "checkpoint"), "--serve_mode", "fast",
        "--dense_layout", "true", "--nms_algorithm", "classfix"])
    tcounts = table["launches"]
    n_batches = 1  # 2 test SVGs in one batch of BATCH
    check(tcounts["fused_dense_message"] == N_BLOCKS * n_batches
          and tcounts["edge_window_message_sum"] == 0
          and tcounts["folded_mlp_block_max2"] == n_batches,
          f"test CLI launches {tcounts}")
    check(len(table["map_per_th"]) == 10 and _finite(table["map_all"])
          and _finite(table["top1_acc"]), "the test CLI's AP table")
    print(f"dense test: cli.test --serve_mode fast --dense_layout true "
          f"--nms_algorithm classfix on the window-trained checkpoint: "
          f"MAP@0.5 {table['map_50']:.4f}, top1 {table['top1_acc']:.4f}; "
          f"kernel 4 launched {tcounts['fused_dense_message']} times in "
          f"{n_batches} batch, kernel 1 {tcounts['edge_window_message_sum']} "
          f"[{dev_line}]")
    counts = dict(got)
    counts["fused_dense_message"] = tcounts["fused_dense_message"]
    return counts


def _pp_activations(model, batch):
    """The local stream after the conv stack: what the engine hands the
    banded kernels."""
    import torch

    with torch.no_grad():
        f = s = batch["x"]
        for conv in model.convs:
            f, s = conv(f, s, batch["edge"], batch["e_attr"],
                        batch["edge_mask"], batch["node_mask"],
                        dst_count=batch["dst_count"])
    return f


def banded_kernel_phase(model, folded, batch, dev_line):
    """Kernels 5 and 6 against their plain versions at the YOLaT++ serving
    shapes; returns {kernel name: entry} (ms at bf16 of the call the main
    path makes: kernel 5 over the clique family, kernel 6 over the curve
    family)."""
    import torch

    from yolat_tpu_torch.ops import banded_message as bmod
    from yolat_tpu_torch.ops.plans import bm_of

    sew, cwd, cws = (bm_of(batch, p) for p in ("sew_", "cwd_", "cws_"))
    check(None not in (sew, cwd, cws), "the batch carries the banded plans")
    check(sew.n_edges == int(batch["super_mask"].sum())
          and cwd.n_edges == cws.n_edges == int(batch["edge_mask"].sum()),
          "the plans hold the real edges")
    s_f = _pp_activations(model, batch)
    n, c = s_f.shape
    na = batch["e_attr"].shape[1]

    def blocks(bm):
        """(thread blocks, largest and median edge count of one)."""
        nptr = bm.nptr.long()
        cuts = (bm.cnode.long() if bm.cnode is not None else torch.arange(
            0, n + bm.wn, bm.wn, device=nptr.device).clamp(max=n))
        per = (nptr[cuts[1:]] - nptr[cuts[:-1]]).float()
        return per.numel(), int(per.max()), float(per.median())

    for name, bm in (("sew_ (clique family)", sew), ("cwd_ (curve family)", cwd)):
        nb, big, med = blocks(bm)
        deg = (bm.nptr[1:] - bm.nptr[:-1]).max().item()
        print(f"banded plan {name}: {bm.n_edges} edges over {n} nodes in {nb} "
              f"thread blocks, largest {big} edges, median {med:.0f}; largest "
              f"node {deg} edges")

    res = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, device_ms=0.0,
                   library_ms=None)
           for k in ("banded_message_sum", "banded_message_sum_both")}
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        x = s_f.to(dt)
        # as fast_forward_pp forms them: the folded tree in x's type, then
        # the slices and Wa - Wb
        cw, csc = (t.to(dt) for t in folded["curve_mlp"])
        sw, ssc = (t.to(dt) for t in folded["super_edge_mlp"])
        w_attr, w_src, w_dst = cw[:na], cw[na:na + c], cw[na + c:]
        wa, wb, wc = sw[:c], sw[c:2 * c], sw[2 * c:]
        w2, sc2 = (folded["convs"][1][k].to(dt) for k in ("w2", "sc2"))
        cases = (
            ("sew", "banded_message_sum", sew, (wa - wb, wb, wc, ssc), ()),
            ("sew two-stage", "banded_message_sum", sew,
             (wa - wb, wb, wc, ssc), (w2, sc2)),
            ("cwd", "banded_message_sum", cwd, (w_dst, w_src, w_attr, csc), ()),
            ("cws", "banded_message_sum", cws, (w_src, w_dst, w_attr, csc), ()),
            ("cwd both", "banded_message_sum_both", cwd,
             (w_dst, w_src, w_attr, csc), ()))
        kept = {}
        for label, kname, bm, w, second in cases:
            both = kname.endswith("_both")
            kernel = getattr(bmod, kname)
            plain = getattr(bmod, kname + "_plain")

            def cat(out):
                return torch.cat(out, dim=1) if both else out

            got = cat(kernel(x, bm, *w, *second))
            again = cat(kernel(x, bm, *w, *second))
            want = cat(plain(x, bm, *w, *second))
            planted = cat(plain(x, bm, w[1], w[0], *w[2:], *second))
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            limit = BANDED_TOL[tag] * scale
            perr = (planted - want).abs().max().item()
            same = torch.equal(got, again)
            ok = err <= limit and same and bool(torch.isfinite(got).all())
            ms, pms, dms = paired_ms(lambda: kernel(x, bm, *w, *second),
                                lambda: plain(x, bm, *w, *second))
            e = bm.n_edges
            sz = 2 if dt == torch.bfloat16 else 4
            outs = 2 if both else 1
            nbytes = (sz * (n * c + (2 * c + na) * 64 + (64 * 64 if second else 0))
                      + e * (8 + 4 * na) + 4 * (n + 1) + 8 * 64 * (2 if second else 1)
                      + (4 * blocks(bm)[0] if bm.cnode is not None else 0)
                      + (4 * e if bm.perm is not None else 0)
                      + (4 * e + 4 * (n + 1) if both else 0) + outs * 4 * n * 64)
            ops = e * (2 * (2 * c + na) * 64 + (2 * 64 * 64 if second else 0)
                       + outs * 64)
            b = bound(nbytes, ops, PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32)
            print(f"kernel {kname} {label} {tag} x{tuple(x.shape)} E={e}: "
                  f"max_abs_err={err:.3e} of max|ref|={scale:.3e} (limit "
                  f"{limit:.3e} = {BANDED_TOL[tag]:g} max|ref|; own and other "
                  f"weights swapped reads {perr:.3e}; two runs "
                  f"{'bit-identical' if same else 'DIFFER'}) "
                  f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms (queued {dms:.4f}), plain "
                  f"{pms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']}), library none [{dev_line}]")
            check(ok, f"{kname} {label} {tag} disagrees with its plain version")
            check(perr > limit, f"{kname} {label} {tag}: the planted fault "
                  "passes the limit")
            kept[label] = got
            r = res[kname]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if dt == torch.bfloat16 and label in ("sew", "cwd both"):
                r["ms"], r["plain_ms"], r["device_ms"] = ms, pms, dms
                add_bound(r, b)
        own, oth = kept["cwd both"][:, :64], kept["cwd both"][:, 64:]
        own_same = torch.equal(own, kept["cwd"])
        e_oth = (oth - kept["cws"]).abs().max().item()
        lim = 1e-5 * kept["cws"].abs().max().item()
        print(f"kernel 6 against kernel 5 {tag}: own-endpoint sum "
              f"{'bit-equal' if own_same else 'DIFFERS'}; other-endpoint sum "
              f"against kernel 5 over the src-sorted plan max_abs_err="
              f"{e_oth:.3e} (limit {lim:.3e} = 1e-5 max|ref|, bit-equal: "
              f"{torch.equal(oth, kept['cws'])})")
        check(own_same, f"kernel 6's own sum is not kernel 5's ({tag})")
        check(e_oth <= lim, f"kernel 6's other sum disagrees with kernel 5 "
              f"over the transposed plan ({tag})")
    return res


def pp_route_phase(models, batch, dev_line):
    """`fast_forward_pp` on the card against the eval-mode module, the
    plain route and itself with each gate closed; `models` maps
    'per_edge' / 'factored' to (model, folded)."""
    import torch

    from yolat_tpu_torch.config import PP_GATES
    from yolat_tpu_torch.eval.fast_forward import fast_forward_pp
    from yolat_tpu_torch.nn.yolat_pp import prefix_member_mean
    from yolat_tpu_torch.ops.plans import plan_of

    m = batch["proposal_mask"]
    for variant, (model, folded) in models.items():
        with torch.no_grad():
            ref, _ = model(batch)
            runs = {"f32": fast_forward_pp(folded, batch)[0],
                    "f32 plain": fast_forward_pp(folded, batch, plain=True)[0],
                    "bf16": fast_forward_pp(folded, batch, bf16=True)[0],
                    "bf16 plain": fast_forward_pp(folded, batch, bf16=True,
                                                  plain=True)[0]}
            if variant == "per_edge":
                runs["f32 two-pass"] = fast_forward_pp(
                    folded, batch, curve_fused=False)[0]
                runs["bf16 two-pass"] = fast_forward_pp(
                    folded, batch, bf16=True, curve_fused=False)[0]
        torch.cuda.synchronize()
        check(all(v.shape == ref.shape and bool(torch.isfinite(v).all())
                  for v in runs.values()), "finite logits of the right shape")
        scale = max(1.0, ref[m].abs().max().item())

        def gap(a, b):
            return (a - b)[m].abs().max().item()

        e_mod = gap(runs["f32"], ref)
        e_32 = gap(runs["f32"], runs["f32 plain"])
        e_16 = gap(runs["bf16"], runs["bf16 plain"])
        e_16f = gap(runs["bf16"], ref)
        agree = (runs["bf16"].argmax(1)[m] == ref.argmax(1)[m]).float().mean().item()
        # the factored level's f32 prefix sum rounds at the magnitude of its
        # largest partial sum (checked below); the module and the engine feed
        # it inputs that differ in the last bits, so their roundings differ
        mod_tol = 2e-4 if variant == "per_edge" else 1e-3
        line = (f"pp route {variant} logits {tuple(ref.shape)} (max|ref|="
                f"{scale:.3e}): f32 kernel route vs module {e_mod:.3e} (<= "
                f"{mod_tol:g} scale), f32 kernel vs plain route {e_32:.3e} (<= 1e-4 scale), "
                f"bf16 kernel vs plain route {e_16:.3e} (<= 3e-2 scale), bf16 "
                f"vs f32 module {e_16f:.3e} (<= 5e-2 scale), bf16 argmax "
                f"agreement on {int(m.sum())} valid proposals {agree:.4f} "
                f"(> 0.97)")
        check(e_mod <= mod_tol * scale, f"{variant}: f32 route vs module")
        check(e_32 <= 1e-4 * scale, f"{variant}: f32 kernel vs plain route")
        check(e_16 <= 3e-2 * scale, f"{variant}: bf16 kernel vs plain route")
        check(e_16f <= 5e-2 * scale, f"{variant}: bf16 route vs f32 module")
        check(agree > 0.97, f"{variant}: bf16 argmax agreement {agree}")
        if variant == "per_edge":
            e_two = gap(runs["f32 two-pass"], runs["f32"])
            e_two16 = gap(runs["bf16 two-pass"], runs["bf16"])
            line += (f"; two-pass curve route vs fused f32 {e_two:.3e} (<= "
                     f"1e-4 scale), bf16 {e_two16:.3e} (<= 3e-2 scale)")
            check(e_two <= 1e-4 * scale and e_two16 <= 3e-2 * scale,
                  "the two-pass curve route disagrees with the fused one")
        print(line + f" [{dev_line}]")
        moved = {}
        for g in PP_GATES:
            closed = {**folded, "gates": {**folded["gates"],
                                          g: torch.zeros_like(folded["gates"][g])}}
            with torch.no_grad():
                moved[g] = gap(fast_forward_pp(closed, batch)[0], runs["f32"])
        print(f"pp route {variant}: closing a gate moves the f32 logits by "
              + ", ".join(f"{g} {v:.3e}" for g, v in moved.items())
              + f" (each > 1e-3 scale = {1e-3 * scale:.3e})")
        check(all(v > 1e-3 * scale for v in moved.values()),
              f"{variant}: a closed gate leaves the logits unmoved: {moved}")
        if variant == "factored":
            s_f = _pp_activations(model, batch)
            pool = plan_of(batch)
            got, valid = prefix_member_mean(s_f, batch, pool)
            cpu = {k: batch[k].cpu() for k in (
                "sup_member", "sup_rank", "prop_first_row", "bbox_idx")}
            want, _ = prefix_member_mean(s_f.cpu().double(), cpu,
                                         tuple(t.cpu() for t in pool))
            torch.cuda.synchronize()
            err = (got.cpu().double() - want)[valid.cpu()].abs().max().item()
            feat = s_f.abs().max().item()
            rows = torch.where(batch["sup_member"][:, None], s_f,
                               torch.zeros_like(s_f)).double()
            top = rows.cumsum(0).abs().max().item()
            # m is a difference of two f32 prefix sums over its rank >= 1:
            # a few roundings at the magnitude of the largest prefix sum
            limit = 8 * 2.0 ** -24 * top
            print(f"pp factored prefix mean: {int(valid.sum())} valid rows of "
                  f"{s_f.shape[0]}, prefix sums up to {top:.3e}, f32 on the "
                  f"card vs float64 max_abs_err={err:.3e} = {err / feat:.2e} of "
                  f"the largest feature {feat:.3e} (limit {limit:.3e} = 8 * "
                  f"2^-24 of the largest prefix sum) [{dev_line}]")
            check(err <= limit, "the factored prefix mean drifts")


def pp_serve_phase(root, test_root, ckpts, work, dev_line):
    """cli.infer --arch yolat_pp and --profile yolat_pp_fast on the SVGs and
    cli.test --arch yolat_pp on `test_root`; returns the launch counts of
    the per-edge cli.infer run."""
    from yolat_tpu_torch.cli import infer
    from yolat_tpu_torch.cli import test as test_cli
    from yolat_tpu_torch.ops import _build

    served = ("edge_window_message_sum", "folded_mlp_block_max2",
              "banded_message_sum", "banded_message_sum_both")
    main_counts = None
    for variant, flags in (("per_edge", ["--arch", "yolat_pp"]),
                           ("factored", ["--profile", "yolat_pp_fast"])):
        out = os.path.join(work, f"pp_{variant}.jsonl")
        argv = ["--input_dir", root, "--pretrained_model", ckpts[variant],
                "--out", out, "--serve_mode", "fast_bf16", "--device", "cuda",
                "--conf_th", "0.0", "--batch_size", str(BATCH)] + flags
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        shown = infer.main(argv)
        rate = N_SVGS / (time.perf_counter() - t0)
        counts = dict(_build.launch_counts)
        check(shown == counts, "the CLI's launch counts are the counters' rise")
        with open(out) as f:
            recs = [json.loads(line) for line in f]
        check(len(recs) == N_SVGS and all(
            "error" not in r and r["width"] > 0 for r in recs),
            f"{len(recs)} records for {N_SVGS} SVGs")
        for r in recs:
            for d in r["detections"]:
                check(len(d["box"]) == 4 and all(map(_finite, d["box"]))
                      and 0.0 <= d["score"] <= 1.0, "bad detection")
        # one chunk graph of CHUNK predict bodies, its rows past the
        # batches replaying the last one
        n_batches = -(-N_SVGS // BATCH)
        rows = -(-n_batches // CHUNK) * CHUNK
        want = {"edge_window_message_sum": N_BLOCKS * rows,
                "folded_mlp_block_max2": rows,
                "banded_message_sum": rows if variant == "per_edge" else 0,
                "banded_message_sum_both": rows}
        got = {k: counts[k] for k in served}
        check(got == want, f"pp {variant} launches {got}, the code implies {want}")
        print(f"pp serve {variant} (cli.infer {' '.join(flags)}, fast_bf16): "
              f"{N_SVGS} SVGs -> {len(recs)} records, "
              f"{sum(len(r['detections']) for r in recs)} detections; launches "
              f"{got}; {rate:.3f} SVGs/s end to end through the CLI, "
              f"preprocessing caches warm [{dev_line}]")
        if variant == "per_edge":
            main_counts = counts

    _build.reset_launch_counts()
    table = test_cli.main([
        "--data_dir", test_root, "--phase", "test", "--device", "cuda",
        "--batch_size", str(BATCH), "--arch", "yolat_pp", "--pretrained_model",
        ckpts["per_edge"], "--serve_mode", "fast_bf16"])
    tcounts = table["launches"]
    check(all(tcounts[k] > 0 for k in served), f"pp test CLI launches {tcounts}")
    check(len(table["map_per_th"]) == 10 and _finite(table["map_all"])
          and _finite(table["top1_acc"]), "the pp test CLI's AP table")
    print(f"pp test: cli.test --arch yolat_pp --serve_mode fast_bf16: MAP@0.5 "
          f"{table['map_50']:.4f}, top1 {table['top1_acc']:.4f}; launches "
          f"{ {k: tcounts[k] for k in served} } [{dev_line}]")
    return main_counts


def banded_train_kernel_phase(model, batch, dev_line):
    """Kernels 7, 7b, 8, 8b against their plain versions and the float64
    sums at the banded train step's shapes; returns {kernel name: entry}
    (ms at bf16; each runs once per step)."""
    import numpy as np
    import torch

    from yolat_tpu_torch.ops import _build
    from yolat_tpu_torch.ops import banded_train as bt
    from yolat_tpu_torch.ops.banded_message import plan_tensors
    from yolat_tpu_torch.ops.plans import banded_plan, bm_of

    bm = bm_of(batch, "sew_")
    check(bm is not None and bm.tperm is not None,
          "the batch carries the sew_ plan with its transpose")
    own, oth, nptr, tperm, tptr = bm.own, bm.oth, bm.nptr, bm.tperm, bm.tptr
    ownl, othl = own.long(), oth.long()
    s_f = _pp_activations(model, batch)
    n, c = s_f.shape
    e = bm.n_edges
    # the node rows a gather reads: the bound counts these, not all n
    n_pair = int(torch.unique(torch.cat([ownl, othl])).numel())
    n_own = int(torch.unique(ownl).numel())
    print(f"banded train plan: {n} nodes, {n_pair} on a row, {n_own} as its "
          f"own endpoint (the gathers' bounds read these rows)")
    check(e == int(batch["super_mask"].sum()), "the plan holds the real edges")
    dev = s_f.device

    # the runs a node's lanes walk; 7b walks both side by side, so a node's
    # chain is its longer run, and a warp (4 nodes at bf16 C = 64, 8 lanes
    # each; 2 at f32) waits for its longest chain
    runs = [(ptr[1:] - ptr[:-1]).float() for ptr in (nptr, tptr)]
    for side, deg in zip(("own (nptr)", "other (tptr)"), runs):
        print(f"banded train plan, {side} side: {e} rows over {n} nodes, "
              f"{int((deg > 0).sum())} nodes with rows, largest run "
              f"{int(deg.max())}, median of the others' "
              f"{float(deg[deg > 0].median()):.0f}")
    chain = torch.maximum(*runs)
    for per in (4, 2):
        warp = torch.nn.functional.pad(chain, (0, -n % per)).reshape(-1, per)
        ratio = per * float(warp.max(1).values.sum()) / float(chain.sum())
        print(f"banded train plan, 7b at {per} nodes a warp: the warps' "
              f"longest chains add to {ratio:.3f}x the nodes' chains (what "
              f"the warps' imbalance adds), largest chain "
              f"{int(chain.max())} rows")
    # the most terms any node's sums add: its own run plus its other run
    k_max = int(((nptr[1:] - nptr[:-1]) + (tptr[1:] - tptr[:-1])).max())

    names = ("banded_gather", "banded_gather_bwd", "banded_scatter_own",
             "banded_scatter_own_bwd")
    res = {k: dict(max_abs_err=0.0) for k in names}
    gen = torch.Generator(device=dev).manual_seed(14)
    # the profiler's readings, taken after the loop (`profiled_ms`)
    specs, pending = {}, []

    def note(name, dt, err, ok, limit, ms, pms, dms, lms, b, kspec, lspec):
        tag = "f32" if dt == torch.float32 else "bf16"
        print(f"kernel {name} {tag} C={c} N={n} E={e}: max_abs_err={err:.3e} "
              f"({limit}) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms (queued {dms:.4f}), plain "
              f"{pms:.4f} ms, library {lms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{dev_line}]")
        check(ok, f"{name} {tag} disagrees")
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if dt == torch.bfloat16:
            r.update(ms=ms, plain_ms=pms, queued_ms=dms, library_ms=lms)
            add_bound(r, b)
        key = f"{name} {tag} C={c}"
        specs[key], specs[key + " library"] = kspec, lspec
        pending.append((key, name, dt == torch.bfloat16, b))

    def sum_check(got, terms, want_plain, out_bf16):
        """got [n, c] against the float64 sum of `terms` (([E, c], index)
        pairs) -> (max |err| against the plain version, within the limit,
        the limit and the planted faults' readings as text)."""
        want = torch.zeros(got.shape, dtype=torch.float64, device=dev)
        mass = torch.zeros_like(want)
        for t, i in terms:
            want.index_add_(0, i, t.double())
            mass.index_add_(0, i, t.double().abs())
        lim = (k_max - 1) * 2.0 ** -24 * mass + 1e-30
        if out_bf16:
            lim = lim + 2.0 ** -8 * want.abs()
        err64 = (got.double() - want).abs()
        ok = bool((err64 <= lim).all())
        # planted faults: endpoints swapped; the last row dropped
        swapped = torch.zeros_like(want)
        for t, i in terms:
            swapped.index_add_(0, othl if i is ownl else ownl, t.double())
        t0, i0 = terms[0]
        dropped = want.clone().index_add_(0, i0[-1:], -t0[-1:].double())
        faults = [((f - want).abs() / lim).max().item()
                  for f in (swapped, dropped)]
        text = (f"float64 sum of the same terms: largest |err| / limit "
                f"{(err64 / lim).max().item():.3f} (<= 1; limit = "
                f"{k_max - 1} x 2^-24 x sum|terms|"
                f"{' + 2^-8 |ref|' if out_bf16 else ''}; endpoints swapped "
                f"reads {faults[0]:.3g}, one row dropped {faults[1]:.3g}), "
                f"two runs bit-identical")
        check(min(faults) > 1.0, "a planted fault passes the limit")
        return (got.float() - want_plain.float()).abs().max().item(), ok, text

    def shifted(t):
        """t as a view one element into a buffer: its data off a 16-byte
        boundary, so the kernels take their narrow route."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:] = t.reshape(-1)
        v = buf[1:].view(t.shape)
        check(v.data_ptr() % 16 != 0, "the view is off a 16-byte boundary")
        return v

    for dt in (torch.float32, torch.bfloat16):
        s = 4 if dt == torch.float32 else 2
        x = s_f.to(dt)
        # kernel 7: copies, exact
        got = bt.gather_fwd(x, own, oth)
        again = bt.gather_fwd(x, own, oth)
        want = bt.gather_plain(x, own, oth)
        torch.cuda.synchronize()
        ok = all(torch.equal(a, b) and torch.equal(a, w)
                 for a, b, w in zip(got, again, want))
        check(not torch.equal(got[0], got[1]), "own and other rows differ")
        err = max((a.float() - w.float()).abs().max().item()
                  for a, w in zip(got, want))
        kfn = lambda: bt.gather_fwd(x, own, oth)
        ms, pms, dms = paired_ms(kfn, lambda: bt.gather_plain(x, own, oth))
        lfn = lambda: (x.index_select(0, ownl), x.index_select(0, othl))
        lms = _library_ms(lfn)
        note("banded_gather", dt, err, ok, "exact, two runs bit-identical",
             ms, pms, dms, lms,
             bound(s * (n_pair * c + 2 * e * c) + 8 * e, 0.0, PEAK_F32),
             (BT + "gather_fwd", (x, own, oth)), ("gather2", (x, ownl, othl)))

        # kernel 7b: two sums per node, rounded once to dt
        g_own = torch.randn(e, c, device=dev, generator=gen).to(dt)
        g_oth = torch.randn(e, c, device=dev, generator=gen).to(dt)
        args = (g_own, g_oth, own, oth, nptr, tperm, tptr, n)
        dx, dx2 = bt.gather_bwd(*args), bt.gather_bwd(*args)
        want = bt.gather_bwd_plain(g_own, g_oth, own, oth, n)
        torch.cuda.synchronize()
        err, ok, text = sum_check(dx, [(g_own, ownl), (g_oth, othl)], want,
                                  dt == torch.bfloat16)
        off = bt.gather_bwd(shifted(g_own), shifted(g_oth), *args[2:])
        ok = ok and torch.equal(dx, dx2) and torch.equal(off, dx) \
            and dx.dtype == dt
        text += "; inputs off a 16-byte boundary bit-identical"
        kfn = lambda: bt.gather_bwd(*args)
        ms, pms, dms = paired_ms(kfn,
                            lambda: bt.gather_bwd_plain(g_own, g_oth, own,
                                                        oth, n))
        gf_own, gf_oth = g_own.float(), g_oth.float()
        lfn = lambda: torch.zeros(n, c, device=dev).index_add_(
            0, ownl, gf_own).index_add_(0, othl, gf_oth)
        lms = _library_ms(lfn)
        note("banded_gather_bwd", dt, err, ok, text, ms, pms, dms, lms,
             bound(s * (2 * e * c + n * c) + 4 * (2 * (n + 1) + e),
                   2 * e * c, PEAK_F32), (BT + "gather_bwd", args),
             ("index_add2", (n, c, ownl, gf_own, othl, gf_oth)))

        # kernel 8: one sum per node, f32
        rows = torch.randn(e, c, device=dev, generator=gen).to(dt)
        out = bt.scatter_own_fwd(rows, own, nptr, n)
        out2 = bt.scatter_own_fwd(rows, own, nptr, n)
        want = bt.scatter_own_plain(rows, own, n)
        torch.cuda.synchronize()
        err, ok, text = sum_check(out, [(rows, ownl)], want, False)
        off = bt.scatter_own_fwd(shifted(rows), own, nptr, n)
        ok = ok and torch.equal(out, out2) and torch.equal(off, out) \
            and out.dtype == torch.float32
        text += "; inputs off a 16-byte boundary bit-identical"
        kfn = lambda: bt.scatter_own_fwd(rows, own, nptr, n)
        ms, pms, dms = paired_ms(kfn,
                            lambda: bt.scatter_own_plain(rows, own, n))
        rf = rows.float()
        lfn = lambda: torch.zeros(n, c, device=dev).index_add_(0, ownl, rf)
        lms = _library_ms(lfn)
        note("banded_scatter_own", dt, err, ok, text, ms, pms, dms, lms,
             bound(s * e * c + 4 * (n + 1) + 4 * n * c, e * c, PEAK_F32),
             (BT + "scatter_own_fwd", (rows, own, nptr, n)),
             ("index_add", (n, c, ownl, rf)))

        # kernel 8b: a gather of the f32 cotangent, rounded to dt: exact
        g = torch.randn(n, c, device=dev, generator=gen)
        d_rows = bt.scatter_own_bwd(g, own, dt)
        d_rows2 = bt.scatter_own_bwd(g, own, dt)
        want = bt.scatter_own_bwd_plain(g, own, dt)
        torch.cuda.synchronize()
        ok = torch.equal(d_rows, want) and torch.equal(d_rows, d_rows2) \
            and torch.equal(bt.scatter_own_bwd(shifted(g), own, dt), d_rows)
        err = (d_rows.float() - want.float()).abs().max().item()
        kfn = lambda: bt.scatter_own_bwd(g, own, dt)
        ms, pms, dms = paired_ms(kfn,
                            lambda: bt.scatter_own_bwd_plain(g, own, dt))
        lfn = lambda: g.index_select(0, ownl)
        lms = _library_ms(lfn)
        note("banded_scatter_own_bwd", dt, err, ok,
             "exact, two runs bit-identical, an input off a 16-byte "
             "boundary bit-identical", ms, pms, dms, lms,
             bound(4 * n_own * c + 4 * e + s * e * c, 0.0, PEAK_F32),
             (BT + "scatter_own_bwd", (g, own, dt)), ("gather", (g, ownl)))

    times = profiled_ms(specs)
    for key, name, at_bf16, b in pending:
        (kw, kf), (lw, lf) = times[key], times[key + " library"]
        print(f"profiler {key}: device ms per call, in a process of its own: "
              f"kernel {kw:.4f} warm, {kf:.4f} L2-flushed "
              f"({kf / b['bound_ms']:.2f}x its bound), library {lw:.4f} "
              f"warm, {lf:.4f} L2-flushed [{dev_line}]")
        if at_bf16:
            res[name].update(device_ms=kf, warm_ms=kw, library_device_ms=lf)

    # an odd width: the narrow route of 7b, 8 and 8b
    c5 = 5
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        g_own, g_oth, rows = (torch.randn(e, c5, device=dev, generator=gen
                                          ).to(dt) for _ in range(3))
        g = torch.randn(n, c5, device=dev, generator=gen)
        args = (g_own, g_oth, own, oth, nptr, tperm, tptr, n)
        runs = [(bt.gather_bwd(*args), bt.scatter_own_fwd(rows, own, nptr, n),
                 bt.scatter_own_bwd(g, own, dt)) for _ in range(2)]
        dx, out, d_rows = runs[0]
        torch.cuda.synchronize()
        twice = all(torch.equal(a, b) for a, b in zip(*runs))
        for name, got, terms, want, rounded in (
                ("banded_gather_bwd", dx, [(g_own, ownl), (g_oth, othl)],
                 bt.gather_bwd_plain(g_own, g_oth, own, oth, n),
                 dt == torch.bfloat16),
                ("banded_scatter_own", out, [(rows, ownl)],
                 bt.scatter_own_plain(rows, own, n), False)):
            err, ok, text = sum_check(got, terms, want, rounded)
            print(f"kernel {name} {tag} C={c5}: max_abs_err={err:.3e} "
                  f"({text}) {'ok' if ok and twice else 'FAIL'} "
                  f"[{dev_line}]")
            check(ok and twice and got.shape == (n, c5),
                  f"{name} {tag} C={c5} disagrees")
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        ok = torch.equal(d_rows, bt.scatter_own_bwd_plain(g, own, dt))
        print(f"kernel banded_scatter_own_bwd {tag} C={c5}: "
              f"{'exact' if ok else 'FAIL'}, two runs bit-identical {twice} "
              f"[{dev_line}]")
        check(ok and twice, f"banded_scatter_own_bwd {tag} C={c5} disagrees")

    # an empty family: no launch, zero sums, empty gathers
    empty = plan_tensors(banded_plan(
        np.zeros((4, 2), np.int32), np.zeros(4, bool),
        np.zeros((4, 4), np.float32), n, transpose=True), dev)
    before = dict(_build.launch_counts)
    xt = s_f.clone().requires_grad_(True)
    a, b = bt.banded_gather(xt, empty)
    rt = torch.zeros(0, c, device=dev, requires_grad=True)
    total = bt.banded_scatter_own(rt, empty, n)
    (a.sum() + b.sum() + total.sum()).backward()
    torch.cuda.synchronize()
    check(a.shape == b.shape == (0, c) and total.shape == (n, c)
          and not total.any() and not xt.grad.any()
          and rt.grad.shape == (0, c)
          and before == dict(_build.launch_counts),
          "an empty family goes through all four without a launch")
    print("banded train kernels, E = 0: empty gathers, zero sums and "
          "gradients, no launch")
    return res


def _pp_prim_run(model, batch, dt, cot, patch=None):
    """One train-mode forward of a copy of `model` at `dt` up to
    prim_at_node and the backward of (prim * cot).sum(): prim_at_node,
    super_edge_mlp's running statistics, its ReLU gates, the gradients."""
    import copy

    import torch

    from yolat_tpu_torch.nn import yolat_pp as pp_mod
    from yolat_tpu_torch.train.loop import _COMPUTE_KEYS

    m = copy.deepcopy(model).train()
    leaves = {k: p.detach().clone().requires_grad_(True)
              for k, p in m.named_parameters()}
    cast = {k: (p.to(dt) if p.dtype == torch.float32 else p)
            for k, p in leaves.items()}
    b = {k: (v.to(dt) if k in _COMPUTE_KEYS else v) for k, v in batch.items()}
    gates, probes = [], {}
    hook = m.super_edge_mlp[2].register_forward_hook(
        lambda mod, a, out: gates.append(out.detach() > 0))
    sound = {k: getattr(pp_mod, k) for k in (patch or {})}
    for k, fn in (patch or {}).items():
        setattr(pp_mod, k, fn)
    try:
        torch.func.functional_call(m, cast, (b,), {"probes": probes})
    finally:
        for k, fn in sound.items():
            setattr(pp_mod, k, fn)
    hook.remove()
    prim = probes["prim_at_node"]
    (prim.float() * cot).sum().backward()
    torch.cuda.synchronize()
    bn = m.super_edge_mlp[1]
    out = {"prim_at_node": prim.detach(), "running_mean": bn.running_mean,
           "running_var": bn.running_var}
    out.update({f"d {k}": p.grad for k, p in leaves.items()
                if p.grad is not None})
    return out, gates[0]


def pp_train_route_phase(model, batch, dev_line):
    """The train-mode module's banded route against its sparse route."""
    import torch

    from yolat_tpu_torch.ops import banded_train as bt

    sparse = model
    import copy
    banded = copy.deepcopy(model)
    banded.banded_super = True
    maskf = batch["node_mask"].float()[:, None]
    n, c = batch["pos"].shape[0], model.super_edge_mlp[0].weight.shape[0]
    cot = torch.randn(n, c, generator=torch.Generator().manual_seed(15)
                      ).to(maskf.device) * maskf
    real = batch["super_mask"].nonzero()[:, 0]  # plan row r = buffer row real[r]
    check(torch.equal(batch["edge_super"][real, 1], batch["sew_own"])
          and torch.equal(batch["edge_super"][real, 0], batch["sew_oth"]),
          "the plan's rows are the buffer's real rows in order")

    # planted faults in the banded backward: kernel 7's backward without
    # its sum at the other endpoint; kernel 8's backward reading the
    # cotangent at the other endpoint
    class NoOthSum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, bm):
            ctx.bm, ctx.n = bm, x.shape[0]
            return bt.gather_fwd(x, bm.own, bm.oth)

        @staticmethod
        def backward(ctx, g_own, g_oth):
            bm = ctx.bm
            return bt.gather_bwd(g_own, torch.zeros_like(g_oth), bm.own,
                                 bm.oth, bm.nptr, bm.tperm, bm.tptr,
                                 ctx.n), None

    class SumBwdAtOth(torch.autograd.Function):
        @staticmethod
        def forward(ctx, rows, bm, n):
            ctx.bm, ctx.dtype = bm, rows.dtype
            return bt.scatter_own_fwd(rows, bm.own, bm.nptr, n)

        @staticmethod
        def backward(ctx, g):
            return bt.scatter_own_bwd(g.float(), ctx.bm.oth, ctx.dtype), None, None

    # every Dense bias below prim_at_node feeds train-mode BatchNorms only:
    # its gradient is structurally zero, noise on both routes
    dead = {f"d {k}.bias" for k, m in model.named_modules()
            if isinstance(m, torch.nn.Linear)}
    faults = {"no_oth_sum": {"banded_gather": NoOthSum.apply},
              "sum_bwd_at_oth": {"banded_scatter_own": SumBwdAtOth.apply}}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        ref, g_sparse = _pp_prim_run(sparse, batch, dt, cot)
        got, g_banded = _pp_prim_run(banded, batch, dt, cot)

        def rel_to_sparse(run):
            return {k: _rel(v, ref[k]) for k, v in run.items()
                    if k not in dead}

        errs = rel_to_sparse(got)
        flips = int((g_sparse[real] != g_banded).sum())
        check(set(got) == set(ref) and len(got) > 12, "the same gradients")
        check(all(torch.isfinite(v.float()).all() for v in got.values()),
              "finite values on the banded route")
        tol_fwd, tol_grad = PP_ROUTE_TOL[name]
        print(f"pp train route {name}, banded vs sparse (N={n}, "
              f"{real.shape[0]} super edges), relative Frobenius error "
              f"(prim_at_node and statistics <= {tol_fwd:g}, gradients <= "
              f"{tol_grad:g}; the Dense biases, which feed BatchNorms only, "
              f"left out): "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; ReLU gates that differ between the routes: {flips} of "
              f"{g_banded.numel()} [{dev_line}]")
        check(all(v <= (tol_grad if k.startswith("d ") else tol_fwd)
                  for k, v in errs.items()),
              f"pp train route {name}: banded disagrees with sparse")
        check(got["d convs.1.nn.0.weight"].abs().max().item() > 0
              and got["d super_edge_mlp.0.weight"].abs().max().item() > 0,
              "the gradient reaches the conv stack and the level's MLP")
        read = {}
        for fault, patch in faults.items():
            bad, _ = _pp_prim_run(banded, batch, dt, cot, patch)
            e = rel_to_sparse(bad)
            # kernel 7's backward feeds the conv stack below the gather;
            # kernel 8's the level's own MLP and everything below it
            keys = [k for k in e if k.startswith("d convs.1.nn")
                    and k.endswith(".weight")]
            if fault == "sum_bwd_at_oth":
                keys.append("d super_edge_mlp.0.weight")
            read[fault] = {k: e[k] for k in keys}
        print(f"pp train route {name}, planted faults against the gradient "
              f"limit {tol_grad:g}: kernel 7's backward without the sum at "
              f"the other endpoint reads "
              + ", ".join(f"{k} {v:.2e}" for k, v in read["no_oth_sum"].items())
              + "; kernel 8's backward reading the other endpoint's "
              "cotangent reads "
              + ", ".join(f"{k} {v:.2e}" for k, v in
                          read["sum_bwd_at_oth"].items()))
        check(all(v > tol_grad for r in read.values() for v in r.values()),
              f"pp train route {name}: a planted fault passes the limit")


def pp_train_phase(root, work, dev_line):
    """cli.train --arch yolat_pp on its three routes on the SVGs of the
    train phase, then cli.test on two of the checkpoints; returns the
    banded run's launch counts."""
    from yolat_tpu_torch.cli import test as test_cli
    from yolat_tpu_torch.cli import train as train_cli
    from yolat_tpu_torch.ops import _build

    k78 = ("banded_gather", "banded_gather_bwd", "banded_scatter_own",
           "banded_scatter_own_bwd")
    k311 = ("folded_mlp_block_max", "fused_pool_train_bwd")
    runs = (("per_edge", ["--arch", "yolat_pp"]),
            ("banded", ["--arch", "yolat_pp", "--pp_banded_super", "true",
                        "--fused_head_train", "true"]),
            ("factored", ["--profile", "yolat_pp_fast"]))
    main_counts, ckpts = None, {}
    for route, flags in runs:
        _build.reset_launch_counts()
        res = train_cli.main([
            "--data_dir", root, "--device", "cuda", "--dtype", "bfloat16",
            "--data_aug", "false", "--lr", "1e-3", "--batch_size", str(BATCH),
            "--n_filters", "64", "--n_blocks", str(N_BLOCKS), "--max_steps",
            str(PP_TRAIN_STEPS), "--root_dir",
            os.path.join(work, f"log_pp_{route}"), "--print_freq", "1"] + flags)
        counts = dict(_build.launch_counts)
        check(res["launches"] == counts,
              "the CLI's launch counts are the counters' rise")
        steps, evals, losses = res["steps"], res["eval_batches"], res["losses"]
        check(steps == PP_TRAIN_STEPS and evals >= 1,
              f"{steps} steps, {evals} evaluated batches")
        check(len(losses) == steps and all(map(_finite, losses)),
              f"finite losses {losses}")
        check(sum(losses[-2:]) < sum(losses[:2]),
              f"pp train {route}: the loss does not fall: {losses}")
        for k in ("map_50", "map_all", "top1_acc"):
            check(k in res and _finite(res[k]), f"evaluation result {k}")
        banded, fused = route == "banded", "--fused_head_train" in flags
        want = {"banded_gather": (steps + evals) * banded,
                "banded_gather_bwd": steps * banded,
                "banded_scatter_own": (steps + evals) * banded,
                "banded_scatter_own_bwd": steps * banded,
                "folded_mlp_block_max": steps * fused,
                "fused_pool_train_bwd": steps * fused}
        got = {k: counts[k] for k in k78 + k311}
        check(got == want, f"pp train {route} launches {got}, the code "
              f"implies {want}")
        # the last epoch's checkpoint: what the evaluation above scored
        ckdir = os.path.join(res["exp_dir"], "checkpoint")
        last = max(int(f[5:-3]) for f in os.listdir(ckdir)
                   if f.startswith("ckpt_") and f[5:-3].isdigit())
        ckpts[route] = (os.path.join(ckdir, f"ckpt_{last}"), res["map_50"])
        check(os.path.exists(os.path.join(ckdir, "ckpt_best.pt")),
              "a best checkpoint was written")
        secs = res["train_seconds"]
        print(f"pp train {route} (cli.train {' '.join(flags)}, bf16, batch "
              f"{BATCH}, 64 channels): {steps} steps in {secs:.3f} s = "
              f"{steps / secs:.3f} steps/s (first steps included), {evals} "
              f"evaluated batches; losses {[round(v, 4) for v in losses]}; "
              f"MAP@0.5 {res['map_50']:.4f}, top1 {res['top1_acc']:.4f}; "
              f"launches {got} [{dev_line}]")
        if banded:
            main_counts = counts

    served = ("edge_window_message_sum", "folded_mlp_block_max2",
              "banded_message_sum", "banded_message_sum_both")
    for route, extra in (("banded", ["--serve_mode", "fast_bf16"]),
                         ("factored", [])):
        _build.reset_launch_counts()
        table = test_cli.main([
            "--data_dir", root, "--phase", "test", "--device", "cuda",
            "--batch_size", str(BATCH), "--n_filters", "64", "--n_blocks",
            str(N_BLOCKS), "--pretrained_model", ckpts[route][0]]
            + dict(runs)[route][:4 if route == "banded" else 2] + extra)
        check(len(table["map_per_th"]) == 10 and _finite(table["map_all"])
              and _finite(table["top1_acc"]), "the pp test CLI's AP table")
        tc = table["launches"]
        if extra:
            check(all(tc[k] > 0 for k in served), f"pp test launches {tc}")
        else:  # the same module forward as the trainer's evaluation
            check(abs(table["map_50"] - ckpts[route][1]) <= 1e-3,
                  f"cli.test reads MAP@0.5 {table['map_50']}, the trainer's "
                  f"evaluation read {ckpts[route][1]}")
        print(f"pp train, cli.test on the {route} run's last checkpoint "
              f"({' '.join(extra) or 'the eval-mode module'}): MAP@0.5 "
              f"{table['map_50']:.4f} (the trainer's evaluation "
              f"{ckpts[route][1]:.4f}), top1 {table['top1_acc']:.4f}; "
              f"launches { {k: v for k, v in tc.items() if v} } [{dev_line}]")
    return main_counts


def decomp_phase(batch, dev_line):
    """Phase 17: kernel 12's variants against kernel 1 and their plain
    versions, then the probe; returns (its kernels-line entry, its launches
    over the probe's run)."""
    import torch

    from yolat_tpu_torch.ops.edge_window import (VARIANTS, decomp_inputs,
                                                 edge_window_decomp,
                                                 edge_window_decomp_plain,
                                                 edge_window_message_sum)
    from yolat_tpu_torch.ops.plans import ew_of
    from yolat_tpu_torch.scripts import ew_kernel_decomp as probe

    ew = ew_of(batch)
    n, e, nw = batch["pos"].shape[0], ew[0].shape[0], ew[3].shape[0] - 1
    r = {"max_abs_err": 0.0, "library_ms": None}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        x, w1, sc1, w2, sc2 = probe.probe_inputs(n, batch["pos"].device, dt)
        w = (w1, sc1, w2, sc2)
        full = edge_window_decomp(x, ew, *w, "full")
        for v in VARIANTS:
            got = edge_window_decomp(x, ew, *w, v)
            again = edge_window_decomp(x, ew, *w, v)
            k1 = edge_window_message_sum(*decomp_inputs(x, ew, v), *w)
            want = edge_window_decomp_plain(x, ew, *w, v)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if dt == torch.float32:
                ok = bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
                tol = "|err| <= 1e-4 + 1e-4|ref|"
            else:
                ok = err <= 5e-3 * scale
                tol = "max|err| <= 5e-3 max|ref|"
            same_k1, same_run = torch.equal(got, k1), torch.equal(got, again)
            moved = v == "full" or not torch.equal(got, full)
            print(f"kernel edge_window_decomp {v} {name} x{tuple(x.shape)} E={e}"
                  f" in {nw} windows: bit-identical to kernel 1 on its inputs "
                  f"{same_k1}, twice {same_run}, differs from full {moved}; "
                  f"vs plain max_abs_err={err:.3e} of max|ref|={scale:.3e} "
                  f"({tol}) {'ok' if ok else 'FAIL'} [{dev_line}]")
            check(same_k1 and same_run and moved and ok,
                  f"edge_window_decomp {v} {name}")
            r["max_abs_err"] = max(r["max_abs_err"], err)
        if dt == torch.bfloat16:
            r["ms"], r["plain_ms"], r["device_ms"] = paired_ms(
                lambda: edge_window_decomp(x, ew, *w, "full"),
                lambda: edge_window_decomp_plain(x, ew, *w, "full"))
            r.update(bound(*probe.variant_work("full", n, probe.C, e, nw, 2),
                           PEAK_BF16))
            print(f"kernel edge_window_decomp full bf16: kernel {r['ms']:.4f} "
                  f"ms (queued {r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{dev_line}]")

    # the probe reads the profiler: in a process of its own (`profiled_ms`),
    # which prints its launch counts after the probe's line
    child = subprocess.run([sys.executable, "-c", PROBE_CHILD], cwd=REPO,
                           capture_output=True, text=True)
    check(child.returncode == 0, f"the probe failed ({child.returncode}):\n"
          f"{child.stdout[-4000:]}\n{child.stderr[-4000:]}")
    out, counts = (json.loads(line)
                   for line in child.stdout.strip().splitlines()[-2:])
    launches = counts["edge_window_decomp"]
    check(out["N"] == n and out["E"] == e, "the probe ran on the bench batch")
    check(all(_finite(out[f"{v}_us"]) and out[f"{v}_us"] > 0 for v in VARIANTS),
          "the probe's times are finite")
    check(launches > 0 and counts["edge_window_message_sum"] == 0,
          f"the probe ran kernel 12, not kernel 1: {counts}")
    print(f"probe: {launches} launches of edge_window_decomp; full "
          f"{out['full_us']:.2f} us, noband {out['noband_us']:.2f}, noonehot "
          f"{out['noonehot_us']:.2f}; source-row gather "
          f"{out['gather_src_us']:.2f} us, both gathers "
          f"{out['gather_both_us']:.2f} us [{dev_line}]")
    return r, launches


# phase 17's probe run: the variants only (no source edits), then the
# wrappers' launch counts of that process
PROBE_CHILD = ("import json\n"
               "from yolat_tpu_torch.ops import _build\n"
               "from yolat_tpu_torch.scripts import ew_kernel_decomp\n"
               "ew_kernel_decomp.main([])\n"
               "print(json.dumps(dict(_build.launch_counts)))\n")


# phase 18: the tolerance of the JAX package's own native-vs-numpy loads
# (tests/test_native.py: the angle statistics' std is a one-pass variance
# in C++)
HOST_RTOL, HOST_ATOL = 1e-9, 1e-8


def _host_close(got, want, path: str) -> None:
    """Integer arrays equal, floats within HOST_RTOL / HOST_ATOL, the same
    structure."""
    import numpy as np

    if isinstance(want, dict):
        check(set(got) == set(want), f"{path}: keys {sorted(got)}")
        for k in want:
            _host_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{path}: {len(got)} != {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            _host_close(a, b, f"{path}[{i}]")
    else:
        a, b = np.asarray(got), np.asarray(want)
        check(a.shape == b.shape, f"{path}: shape {a.shape} != {b.shape}")
        if np.issubdtype(b.dtype, np.floating):
            check(np.allclose(a, b, rtol=HOST_RTOL, atol=HOST_ATOL),
                  f"{path}: max |diff| {np.abs(a - b).max()}")
        else:
            check(np.array_equal(a, b), f"{path}: integers differ")


def _identical(got, want, path: str) -> None:
    import numpy as np

    if isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{path}: {len(got)} != {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            _identical(a, b, f"{path}[{i}]")
        return
    a, b = np.asarray(got), np.asarray(want)
    check(a.dtype == b.dtype and a.shape == b.shape
          and np.array_equal(a, b), f"{path}: not bit-equal")


def _cold_copy(src: str, dst: str) -> str:
    """The manifests, SVGs and annotations of `src`, without caches."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("*.pkl"))
    return dst


def _largest_cc(graph):
    """Positions, shape edges and super edges of a graph's largest CC,
    CC-local, control nodes dropped (as generate_proposals takes them)."""
    import numpy as np

    ctrl = np.asarray(graph["attr"]["is_control"]).reshape(-1) > 0.5
    o2n = np.cumsum(~ctrl) - 1
    pos = np.asarray(graph["pos"], np.float64)[~ctrl]
    cl = np.unique(o2n[np.asarray(max(graph["cc"], key=len), np.int64)])
    in_cc = np.zeros(len(pos), bool)
    in_cc[cl] = True

    def local(e):
        e = o2n[np.asarray(e, np.int64).reshape(-1, 2)]
        return np.searchsorted(cl, e[in_cc[e[:, 0]] & in_cc[e[:, 1]]])

    return pos[cl], local(graph["edge"]["shape"]), local(graph["edge"]["super"])


def _other_entries(graph, step: int) -> None:
    """The entries the loads do not reach, each against its numpy version
    on the largest CC of one file."""
    import numpy as np

    from yolat_tpu_torch.data.packing import _align_runs
    from yolat_tpu_torch.geom import _native
    from yolat_tpu_torch.geom import proposals as pr
    from yolat_tpu_torch.ops.plans import SUPER_BLOCK

    pos, edges, supers = _largest_cc(graph)
    sets = pr._enumerate_subclusters(pos, step)
    cores = pr._cc_proposal_cores(pos, step, edges, supers)
    check(len(sets) == len(cores) > 0, "windows of the largest CC")
    angles = []
    for ids, erows, _ in cores[:64]:
        if len(erows):
            angles.append((len(ids), np.searchsorted(ids, edges[erows]),
                           pos[ids]))
    got_angles = [pr._angle_stats(*a) for a in angles]
    so = np.argsort(supers[:, 1], kind="stable")
    attr = np.random.default_rng(0).normal(size=(len(supers), 6))
    old2new = np.arange(len(pos), dtype=np.int64) * 2
    csa = _native.compact_sort_align_native(supers, attr, old2new,
                                            SUPER_BLOCK)
    with _native.disabled():
        _identical(sets, pr._enumerate_subclusters(pos, step),
                   "enumerate_rect_sets")
        _identical(cores, pr._cc_proposal_cores(pos, step, edges, supers),
                   "build_rect_proposals")
        want_angles = [pr._angle_stats(*a) for a in angles]
    check(len(angles) > 0, "windows with shape edges")
    _host_close([g or {} for g in got_angles],
                [w or {} for w in want_angles], "angle_stats")
    _identical(csa, _align_runs(
        old2new[supers[so]].astype(np.int32),
        attr[so, :4].astype(np.float32), SUPER_BLOCK), "compact_sort_align")
    print(f"host: the largest CC of one file ({len(pos)} points, "
          f"{len(edges)} shape and {len(supers)} super edges): "
          f"{len(sets)} windows, {len(angles)} angle statistics and "
          f"{len(csa[0])} aligned rows equal between the paths")


def host_phase(root, train_root, ckpt, work, build, dev_line):
    """Phase 18: the host stage through the host library against its numpy
    paths, its times, and the CLIs on its worker pools."""
    from yolat_tpu_torch.cli import infer, preprocess
    from yolat_tpu_torch.data.dataset import CACHE_VERSION, SESYDDataset
    from yolat_tpu_torch.data.packing import CompactFile
    from yolat_tpu_torch.geom import _native
    from yolat_tpu_torch.ops import _build

    print(f"host: {os.cpu_count()} cores; library {_native.library_path()} "
          f"built by {_native.compiler_version()} in {build:.2f} s "
          f"(first use) [{dev_line}]")

    # cold loads, each path on a fresh copy of phase 4's SVGs
    _native.reset_counts()
    loads, ms = {}, {}
    for path_name in ("native", "numpy"):
        copy = _cold_copy(root, os.path.join(work, f"cold_{path_name}"))
        ds = SESYDDataset(copy, "train", bbox_sampling_step=10)
        with (_native.disabled() if path_name == "numpy"
              else contextlib.nullcontext()):
            loads[path_name], ms[path_name] = [], []
            for i in range(len(ds)):
                t0 = time.perf_counter()
                pf, gt, wh = ds.load(i)
                ms[path_name].append((time.perf_counter() - t0) * 1e3)
                loads[path_name].append(
                    (ds._graph(ds.files[i]), pf.to_dict(), list(gt), wh))
    check(len(loads["native"]) == N_SVGS, "the SVGs of phase 4")
    for i, (got, want) in enumerate(zip(loads["native"], loads["numpy"])):
        _host_close(got, want, f"file {i}")
    n_props = [l[1]["labels"].shape[0] for l in loads["native"]]

    # CompactFile, canonical and with the super family: per file one
    # warm-up call of each path, then numpy, native, native, numpy twice
    cf_ms = {}
    ds = SESYDDataset(os.path.join(work, "cold_native"), "train",
                      bbox_sampling_step=10)
    pfs = [ds.load(i)[0] for i in range(N_SVGS)]

    def cf_call(f, sf, path_name):
        with (_native.disabled() if path_name == "numpy"
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            CompactFile(f, n_classes=ds.n_classes, super_family=sf)
            return (time.perf_counter() - t0) * 1e3

    for sf in (False, True):
        t = {"native": [], "numpy": []}
        for f in pfs:
            cf_call(f, sf, "numpy")
            cf_call(f, sf, "native")
            for path_name in ("numpy", "native", "native", "numpy") * 2:
                t[path_name].append(cf_call(f, sf, path_name))
        for path_name, v in t.items():
            cf_ms[(sf, path_name)] = statistics.median(v)
        for f in pfs:
            a = CompactFile(f, n_classes=ds.n_classes, super_family=sf)
            with _native.disabled():
                b = CompactFile(f, n_classes=ds.n_classes, super_family=sf)
            for k in CompactFile.__slots__:
                if k != "_dense":
                    _identical(getattr(a, k), getattr(b, k),
                               f"CompactFile(super_family={sf}).{k}")
    _other_entries(loads["native"][0][0], 10)
    used = dict(_native.native_calls)
    check(all(used[e] > 0 for e in _native.ENTRIES),
          f"every entry of the host library was called: {used}")
    n_numpy = sum(_native.numpy_cases.values())
    print(f"host: {N_SVGS} bench SVGs cold ({sum(n_props)} proposals), "
          f"native against numpy: integers equal, floats within rtol "
          f"{HOST_RTOL} atol {HOST_ATOL}; CompactFile bit-equal; ms per "
          f"image cold {statistics.median(ms['native']):.3f} native, "
          f"{statistics.median(ms['numpy']):.3f} numpy (each file native "
          f"{[round(v, 3) for v in ms['native']]}, numpy "
          f"{[round(v, 3) for v in ms['numpy']]}); CompactFile ms "
          f"{cf_ms[(False, 'native')]:.3f} native, "
          f"{cf_ms[(False, 'numpy')]:.3f} numpy; with the super family "
          f"{cf_ms[(True, 'native')]:.3f} native, "
          f"{cf_ms[(True, 'numpy')]:.3f} numpy; native calls {used}; "
          f"per-call numpy cases {n_numpy} {dict(_native.numpy_cases)} "
          f"[{dev_line}]")

    # the offline CLI over cold copies of phase 6's splits
    pre = {}
    for w in ("2", "0"):
        copy = _cold_copy(train_root, os.path.join(work, f"pre_{w}"))
        t0 = time.perf_counter()
        preprocess.main(["--data_dir", copy, "--bbox_sampling_step", "10",
                         "--workers", w] + (["--hierarchical"] if w == "2"
                                            else []))
        secs = time.perf_counter() - t0
        with open(os.path.join(copy, "stats.pkl"), "rb") as f:
            pre[w] = (f.read(), secs, copy)
    check(pre["2"][0] == pre["0"][0], "stats.pkl of --workers 2 == 0")
    n_files = sum(len(SESYDDataset(pre["2"][2], part).files)
                  for part in ("train", "test"))
    hier = [n for _, _, ns in os.walk(pre["2"][2]) for n in ns
            if n.endswith(f".hier.v{CACHE_VERSION}.pkl")]
    check(len(hier) == n_files, f"{len(hier)} .hier pickles, {n_files} files")
    print(f"host: cli.preprocess over {n_files} files: --workers 2 "
          f"--hierarchical {pre['2'][1]:.3f} s, --workers 0 "
          f"{pre['0'][1]:.3f} s; stats.pkl equal; {len(hier)} .hier pickles")

    # the inference CLI with its pools, against phase 4's records
    with open(os.path.join(work, "detections.jsonl")) as f:
        want = [json.loads(line) for line in f]
    out = os.path.join(work, "detections_workers.jsonl")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    infer.main(["--input_dir", root, "--pretrained_model", ckpt, "--out", out,
                "--serve_mode", "fast_bf16", "--device", "cuda",
                "--conf_th", "0.0", "--batch_size", str(BATCH),
                "--preproc_workers", "2"])
    rate = N_SVGS / (time.perf_counter() - t0)
    counts = dict(_build.launch_counts)
    with open(out) as f:
        got = [json.loads(line) for line in f]
    check(got == want, "cli.infer --preproc_workers 2 gives phase 4's records")
    check(counts["edge_window_message_sum"] > 0
          and counts["folded_mlp_block_max2"] > 0, f"kernel launches {counts}")
    print(f"host: cli.infer --preproc_workers 2: {len(got)} records equal "
          f"to phase 4's, {rate:.3f} SVGs/s (caches warm), launches "
          f"edge_window_message_sum={counts['edge_window_message_sum']}, "
          f"folded_mlp_block_max2={counts['folded_mlp_block_max2']} "
          f"[{dev_line}]")


def _np_equal(a: dict, b: dict) -> bool:
    import numpy as np

    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def _nms_bound(kept, rel, valid, rank=None) -> dict:
    """Kernel N1's bound on these inputs: the bytes it must read to confirm
    the fixed point (each valid row of the relation up to its first
    suppressor, or whole when there is none), the valid flags once and the
    kept flags written once; no arithmetic to speak of."""
    import torch

    if rank is None:  # fixpoint: rel [B, C, C] = sup, valid [B, C]
        hit = rel & kept[:, None, :]
    else:  # classfix: rel [B, M, M] = overb (j, i), valid = cand [B, K, M]
        hit = (rel.transpose(1, 2)[:, None] & kept[:, :, None, :]
               & (rank[:, :, None, :] < rank[:, :, :, None]))
    n = hit.shape[-1]
    first = torch.where(hit.any(-1), hit.float().argmax(-1) + 1,
                        torch.full(hit.shape[:-1], n, device=hit.device))
    nbytes = float((first * valid).sum()) + 2 * valid.numel()
    if rank is not None:
        nbytes += 4 * rank.numel()
    return bound(nbytes, 0.0, PEAK_F32)


def nms_kernel_phase(batch, pbatch, caps, models, dev_line):
    """Kernel N1 against the plain loop: the inputs the fixpoint and the
    classfix NMS of predict form on the bench batches (recorded at the
    wrappers), and a suppression chain that takes one sweep per candidate;
    booleans equal, ms beside the plain loop's."""
    import torch

    from yolat_tpu_torch.eval.predict import make_predict_core
    from yolat_tpu_torch.ops import nms, nms_fixpoint as nf

    seen = {"fix": [], "cls": []}

    def rec_fix(sup, valid):
        seen["fix"].append((sup.clone(), valid.clone()))
        return nf.fixpoint_kept(sup, valid)

    def rec_cls(overb, rank, cand):
        seen["cls"].append((overb.clone(), rank.clone(), cand.clone()))
        return nf.classfix_kept(overb, rank, cand)

    nms.fixpoint_kept, nms.classfix_kept = rec_fix, rec_cls
    try:
        for b, cap, (cfg, folded) in ((batch, caps[0], models["canonical"]),
                                      (pbatch, caps[1], models["per_edge"])):
            for alg in ("fixpoint", "classfix"):
                make_predict_core(cfg.replace(nms_algorithm=alg),
                                  folded=folded, bf16=True,
                                  img_slots=cap)(b)
    finally:
        nms.fixpoint_kept, nms.classfix_kept = (nf.fixpoint_kept,
                                                nf.classfix_kept)
    dev = batch["pos"].device
    c = 1024
    chain = torch.zeros(4, c, c, dtype=torch.bool, device=dev)
    i = torch.arange(1, c, device=dev)
    chain[:, i, i - 1] = True
    seen["fix"].append((chain, torch.ones(4, c, dtype=torch.bool, device=dev)))
    m = 512
    j = torch.arange(m, device=dev)
    near = (j[:, None] - j[None, :]).abs() <= 1
    seen["cls"].append((near.expand(4, m, m).contiguous(),
                        j.to(torch.int32).expand(4, 2, m).contiguous(),
                        torch.ones(4, 2, m, dtype=torch.bool, device=dev)))
    res = {}
    for key, name, kern, plain in (
            ("fix", "nms_fixpoint", nf.fixpoint_kept, nf.fixpoint_kept_plain),
            ("cls", "nms_classfix", nf.classfix_kept,
             nf.classfix_kept_plain)):
        cases = seen[key]
        check(len(cases) == 3, f"{name}: {len(cases)} recorded inputs")
        rows = []
        for n_case, args in enumerate(cases):
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{name} case {n_case}: the kernel's "
                  "kept set is not the plain loop's")
            rows.append(int(want.sum()))
        # the first bench batch's inputs set the row's numbers
        args = cases[0]
        ms, plain_ms, device_ms = paired_ms(lambda: kern(*args),
                                            lambda: plain(*args))
        kept = plain(*args)
        b = (_nms_bound(kept, args[0], args[1]) if key == "fix"
             else _nms_bound(kept, args[0], args[2], args[1]))
        chain_ms = statistics.median(time_ms(lambda: kern(*cases[-1])))
        chain_plain = statistics.median(time_ms(lambda: plain(*cases[-1]),
                                                reps=3))
        res[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                     "device_ms": device_ms, "library_ms": None, **b}
        print(f"nms kernel {name}: kept sets equal to the plain loop's on "
              f"the canonical and YOLaT++ bench batches and a "
              f"{cases[-1][1].shape[-1]}-long suppression chain (kept "
              f"{rows}); bench batch {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
              f"queued {device_ms:.4f}, bound {b['bound_ms']:.6f} "
              f"({b['bound_by']}); chain {chain_ms:.4f} ms vs plain "
              f"{chain_plain:.4f} [{dev_line}]")
    return res


def graph_serve_checks(batches, pbatches, dbatches, models, module,
                       dev_line):
    """make_serving_fn's CUDA graphs against the eager predict on the
    unpadded batches: per batch and in a short chunk (2 batches in a
    3-row graph, the last row replayed), detections bit-identical, on the
    canonical plan route, the dense route and YOLaT++ per-edge and
    factored, fast_bf16, and the eval-mode module (`module`: its cfg and
    model; `cli.infer --serve_mode module`); the launches counted per
    replay. The module's sparse sums are float atomics: where its eager
    runs differ, the module route is held to a tolerance."""
    import numpy as np

    from yolat_tpu_torch.data.packing import to_device
    from yolat_tpu_torch.eval.predict import (img_slot_cap, make_predict_core,
                                              make_serving_fn)
    from yolat_tpu_torch.ops import _build
    from yolat_tpu_torch.ops.plans import pad_plans

    dev = "cuda"
    for route, bs, cfg, fkw in (
            ("plan", batches, models["canonical"][0],
             dict(folded=models["canonical"][1], bf16=True)),
            ("dense", dbatches, models["canonical"][0],
             dict(folded=models["canonical"][1], bf16=True)),
            ("pp_per_edge", pbatches, models["per_edge"][0],
             dict(folded=models["per_edge"][1], bf16=True)),
            ("pp_factored", pbatches, models["factored"][0],
             dict(folded=models["factored"][1], bf16=True)),
            ("module", batches, module[0], dict(model=module[1]))):
        cap = max(img_slot_cap(b) for b in bs)
        kw = dict(img_slots=cap, detections_only=True, **fkw)
        predict = make_predict_core(cfg, **kw)

        def eager_run():
            return [{k: v.cpu().numpy() for k, v in
                     predict(to_device(b, dev)).items()} for b in bs]

        eager = eager_run()
        # the module's sparse sums are index_add_'s float atomics: where two
        # eager runs differ, graph against eager is held to the slice
        # test's tolerance (the same detections and classes, boxes rtol
        # 1e-6, scores 1e-5) instead of bit for bit
        again = eager_run()
        exact = all(_np_equal(a, e) for a, e in zip(again, eager))

        def same(got, want):
            if exact:
                return _np_equal(got, want)
            return (np.array_equal(got["valid"], want["valid"])
                    and np.array_equal(got["classes"], want["classes"])
                    and np.allclose(got["boxes"], want["boxes"], rtol=1e-6,
                                    atol=1e-4)
                    and np.allclose(got["scores"], want["scores"], rtol=1e-5,
                                    atol=1e-5))

        staged = [pad_plans(b) for b in bs]
        one = make_serving_fn(cfg, staged[0], device=dev, **kw)
        check(one.route == route, f"route {one.route}, want {route}")
        _build.reset_launch_counts()
        got = [one(b).numpy() for b in staged]
        per_batch = dict(_build.launch_counts)
        check(all(same(g, e) for g, e in zip(got, eager)),
              f"{route}: graph detections differ from the eager ones "
              f"(eager bit-identical to itself: {exact}; max |score diff| "
              f"{max(float(np.abs(g['scores'] - e['scores']).max()) for g, e in zip(got, eager))})")
        chunked = make_serving_fn(cfg, staged[0], chunk=SERVE_CHUNK,
                                  device=dev, **kw)
        _build.reset_launch_counts()
        fetched, n_real = chunked(staged)
        det = fetched.numpy()
        per_chunk = dict(_build.launch_counts)
        check(n_real == len(bs), f"n_real {n_real}")
        for r in range(SERVE_CHUNK):
            want = eager[min(r, len(bs) - 1)]  # rows past n_real replay the last
            check(same({k: v[r] for k, v in det.items()}, want),
                  f"{route}: chunk row {r} differs from the eager detections")
        shown = {k: v for k, v in per_batch.items() if v}
        check(shown and all(per_chunk[k] == v // len(bs) * SERVE_CHUNK
                            for k, v in shown.items()),
              f"{route}: launches per batch {shown}, per chunk {per_chunk}")
        try:
            make_serving_fn(cfg.replace(nms_algorithm="loop"), staged[0],
                            device=dev, **kw)
            check(False, "the graph route accepted nms_algorithm loop")
        except ValueError as e:
            check("--nms_algorithm" in str(e), f"loop refusal: {e}")
        print(f"graph serve {route}: detections "
              f"{'bit-identical to' if exact else 'within tolerance of'} the "
              f"eager predict (itself bit-identical run to run: {exact}) "
              f"per batch ({len(bs)}) and in a {SERVE_CHUNK}-row "
              f"chunk of {len(bs)}; kept keys {len(one.kept_batch_keys)}, "
              f"{one.route}; launches per batch replay "
              f"{ {k: v // len(bs) for k, v in shown.items()} } [{dev_line}]")


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def graph_train_checks(route_batches, dev_line):
    """The train step as CUDA graphs (make_scan_train_step, scan 1 and 3)
    against the eager step, 3 steps from one init with one generator seed,
    on each route; and the eager step against itself (its own spread)."""
    import torch

    from yolat_tpu_torch.cli.profile import open_gates
    from yolat_tpu_torch.config import PP_ARCHS
    from yolat_tpu_torch.data.packing import to_device
    from yolat_tpu_torch.ops.plans import pad_plans
    from yolat_tpu_torch.train.loop import (make_scan_train_step,
                                            make_train_step)
    from yolat_tpu_torch.train.optim import make_optimizer, make_scheduler
    from yolat_tpu_torch.train.trainer import init_model

    out = {}
    for route, (cfg, bs) in route_batches.items():
        seq = [pad_plans(bs[i % len(bs)]) for i in range(GRAPH_STEPS)]
        runs = {}
        for arm in ("eager", "eager_again", "eager_float_lr", "graph_1",
                    "graph_3"):
            model = init_model(cfg, "cuda")
            if cfg.arch in PP_ARCHS:
                open_gates(model)
            if arm == "eager_float_lr":  # as the CPU route builds it
                opt = {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW,
                       "radam": torch.optim.RAdam}[cfg.optimizer](
                    model.parameters(), lr=cfg.lr,
                    weight_decay=cfg.weight_decay)
            else:  # capturable, the rate a device tensor
                opt = make_optimizer(cfg.optimizer, model.parameters(),
                                     cfg.lr, cfg.weight_decay)
            sched = make_scheduler(opt, cfg.lr, 1, 0.5, 2)
            gen = torch.Generator(device="cuda").manual_seed(5)
            if arm.startswith("eager"):
                step = make_train_step(cfg, model, opt, sched)
                losses = [float(step(to_device(b, "cuda"), gen)["loss"])
                          for b in seq]
            else:
                k = int(arm[-1])
                run = make_scan_train_step(cfg, model, opt, sched, k)
                losses = []
                for c0 in range(0, len(seq), k):
                    losses += run(seq[c0:c0 + k], gen)["loss"].tolist()
            runs[arm] = (losses, _state(model))

        def diff(a, b):
            la = max(abs(x - y) for x, y in zip(runs[a][0], runs[b][0]))
            pa = max(float((runs[a][1][k].float() - runs[b][1][k].float())
                           .abs().max()) for k in runs[a][1]
                     if runs[a][1][k].numel())
            same = runs[a][0] == runs[b][0] and all(
                torch.equal(runs[a][1][k], runs[b][1][k]) for k in runs[a][1])
            return la, pa, same

        d = {arm: diff("eager", arm) for arm in (
            "eager_again", "eager_float_lr", "graph_1", "graph_3")}
        check(all(map(_finite, runs["graph_1"][0] + runs["graph_3"][0])),
              f"{route}: finite graph losses")
        # the graph runs the eager step's kernels in its order; what can
        # differ is the order of float atomics (index_add_'s backward, the
        # scatter-reduce of the pool head), which differs between two eager
        # runs as well: the graph must be as close to the eager run as the
        # eager run is to itself (GRAPH_TRAIN_TOL)
        spread_l, spread_p, eager_same = d["eager_again"]
        la, pa, _ = d["eager_float_lr"]  # capturable against the float rate
        check(la <= max(4 * spread_l, GRAPH_TRAIN_TOL[0])
              and pa <= max(4 * spread_p, GRAPH_TRAIN_TOL[1]),
              f"{route}: the capturable optimizer moves the losses {la} and "
              f"the parameters {pa} from the float-rate one")
        for arm in ("graph_1", "graph_3"):
            la, pa, same = d[arm]
            check(same or (not eager_same
                           and la <= max(4 * spread_l, GRAPH_TRAIN_TOL[0])
                           and pa <= max(4 * spread_p, GRAPH_TRAIN_TOL[1])),
                  f"{route} {arm}: losses {la}, parameters {pa} from the "
                  f"eager run (eager against itself {spread_l}, {spread_p})")
        out[route] = d
        print(f"graph train {route}: {GRAPH_STEPS} steps, max |loss diff| / "
              f"max |state diff| from the eager run (bit-identical): "
              + ", ".join(f"{a} {v[0]:.3g} / {v[1]:.3g} ({v[2]})"
                          for a, v in d.items())
              + f"; losses {[round(v, 5) for v in runs['eager'][0]]} "
              f"[{dev_line}]")
    return out


def graph_times(batch_np, pbatch_np, route_batches, models, res, dev_line):
    """Eager against graph, in turns, from cli/profile: fast_bf16 predict
    (canonical, YOLaT++ per-edge and factored) and the train step per
    route, wall, device busy, kernels per call, idle share."""
    from yolat_tpu_torch.cli import profile
    from yolat_tpu_torch.cli.profile import open_gates
    from yolat_tpu_torch.config import PP_ARCHS

    for name, nb, (cfg, folded) in (
            ("serve_canonical", batch_np, models["canonical"]),
            ("serve_pp_per_edge", pbatch_np, models["per_edge"]),
            ("serve_pp_factored", pbatch_np, models["factored"])):
        profile.serve_graph_arms(cfg, nb, "cuda", 20, res, name,
                                 folded=folded, bf16=True)
    for route, (cfg, bs) in route_batches.items():
        profile.train_graph_arms(
            cfg, bs[0], "cuda", 20, res, f"train_{route}",
            prepare=open_gates if cfg.arch in PP_ARCHS else None)
    names = ["serve_canonical", "serve_pp_per_edge", "serve_pp_factored"] + [
        f"train_{r}" for r in route_batches]
    for name in names:
        first = "predict_eager" if name.startswith("serve") else "step_eager"
        e, g = res[f"{name}_eager_trace"], res[f"{name}_graph_trace"]
        print(f"graph times {name}: eager {res[f'{name}_{first}_ms']:.3f} ms "
              f"wall, busy {e['device_busy_ms_per_call']}, "
              f"{e['device_kernels_per_call']:.0f} kernels, idle "
              f"{res[f'{name}_eager_idle_share_estimate']}; graph "
              f"{res[f'{name}_replay_graph_ms']:.3f} ms wall, busy "
              f"{g['device_busy_ms_per_call']}, "
              f"{g['device_kernels_per_call']:.0f} kernels, "
              f"{res[f'{name}_graph_launches_per_replay']} own-kernel "
              f"launches per replay, idle "
              f"{res[f'{name}_graph_idle_share_estimate']}"
              + (f"; from the numpy batch: eager {res[f'{name}_serve_eager_ms']:.3f}"
                 f", graph {res[f'{name}_serve_graph_ms']:.3f} ms"
                 if name.startswith("serve") else "") + f" [{dev_line}]")


def graph_cli_phase(work, ckpt, train_ckpt_root, dev_line):
    """cli.infer --chunk 1 against --chunk 8 on GRAPH_SVGS bench SVGs
    (records byte-identical, SVGs/s in turns 1, 8, 8, 1, graphs captured
    per run), cli.test fast_bf16 with classfix NMS, cli.train --scan_steps
    SCAN against 1 (images/s in turns, graphs); returns the launch counts
    of the first --chunk 8 run (kernel N1's fixpoint row) and of cli.test
    (its classfix row)."""
    from yolat_tpu_torch.cli import infer
    from yolat_tpu_torch.cli import test as test_cli
    from yolat_tpu_torch.cli import train as train_cli
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import PackedLoader
    from yolat_tpu_torch.data.synthetic import write_dataset
    from yolat_tpu_torch.eval.predict import img_slot_cap
    from yolat_tpu_torch.ops import _build

    root = os.path.join(work, "svgs64")
    write_dataset(root, n_train=GRAPH_SVGS, n_test=0, seed=13, width=2000.0,
                  height=1500.0, n_rooms=6, symbols_per_room=(1, 3))
    caps = {img_slot_cap(b) for b in PackedLoader(
        SESYDDataset(root, "train", bbox_sampling_step=10), batch_size=BATCH,
        cache_files=False)}
    outs, rates, graphs = {}, {1: [], CHUNK: []}, {}
    counts = None
    for n_run, chunk in enumerate((CHUNK, 1, CHUNK, CHUNK, 1)):
        out = os.path.join(work, f"chunk{chunk}_{n_run}.jsonl")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        infer.main(["--input_dir", root, "--pretrained_model", ckpt, "--out",
                    out, "--serve_mode", "fast_bf16", "--device", "cuda",
                    "--conf_th", "0.0", "--batch_size", str(BATCH),
                    "--chunk", str(chunk)])
        rate = GRAPH_SVGS / (time.perf_counter() - t0)
        graphs[chunk] = dict(_build.graph_counts)
        if n_run == 0:  # the run that warmed the caches, not timed
            counts = dict(_build.launch_counts)
        else:
            rates[chunk].append(rate)
        with open(out, "rb") as f:
            outs.setdefault(chunk, f.read())
        with open(out, "rb") as f:
            check(f.read() == outs[chunk], "records differ between runs")
        check(graphs[chunk]["captured"] <= len(caps) + 1,
              f"--chunk {chunk}: {graphs[chunk]} graphs for caps {caps}")
    check(outs[1] == outs[CHUNK], f"--chunk {CHUNK} and --chunk 1 records "
          "differ")
    check(counts["nms_fixpoint"] > 0, f"N1 launches {counts}")
    print(f"graph cli.infer: {GRAPH_SVGS} SVGs, records byte-identical at "
          f"--chunk 1 and {CHUNK}; SVGs/s --chunk 1 {rates[1]}, --chunk "
          f"{CHUNK} {rates[CHUNK]} (caches warm, in turns); graphs "
          f"{graphs} for slot caps {sorted(caps)} [{dev_line}]")

    _build.reset_launch_counts()
    table = test_cli.main([
        "--data_dir", train_ckpt_root, "--phase", "test", "--device", "cuda",
        "--batch_size", str(BATCH), "--pretrained_model", ckpt,
        "--serve_mode", "fast_bf16", "--nms_algorithm", "classfix"])
    tcounts = table["launches"]
    check(tcounts["nms_classfix"] > 0 and _finite(table["map_all"]),
          f"cli.test classfix launches {tcounts}")
    print(f"graph cli.test fast_bf16 classfix: MAP@0.5 {table['map_50']:.4f}, "
          f"launches { {k: v for k, v in tcounts.items() if v} }, graphs "
          f"{dict(_build.graph_counts)} [{dev_line}]")

    troot = os.path.join(work, "train16")
    write_dataset(troot, n_train=GRAPH_TRAIN_SVGS, n_test=2, seed=17,
                  width=2000.0, height=1500.0, n_rooms=6,
                  symbols_per_room=(1, 3))
    trates = {1: [], SCAN: []}
    for n_run, scan in enumerate((1, SCAN, SCAN, 1)):
        res = train_cli.main([
            "--data_dir", troot, "--device", "cuda", "--dtype", "bfloat16",
            "--fused_head_train", "true", "--batch_size", str(BATCH),
            "--max_steps", str(2 * GRAPH_TRAIN_SVGS // BATCH),
            "--scan_steps", str(scan), "--root_dir",
            os.path.join(work, f"log_scan{n_run}"), "--print_freq", "4"])
        check(res["steps"] == 2 * GRAPH_TRAIN_SVGS // BATCH
              and all(map(_finite, res["losses"])), f"scan {scan}: {res['steps']}"
              " steps")
        check(res["graphs"]["captured"] == 1 and res["graphs"]["replayed"]
              == res["steps"] - 1, f"scan {scan}: graphs {res['graphs']}")
        trates[scan].append(res["images"] / res["train_seconds"])
    print(f"graph cli.train: {2 * GRAPH_TRAIN_SVGS // BATCH} bf16 fused steps "
          f"of batch {BATCH}, images/s --scan_steps 1 {trates[1]}, "
          f"--scan_steps {SCAN} {trates[SCAN]} (first step and capture "
          f"included; in turns); one graph per run, replayed per step "
          f"[{dev_line}]")
    return counts, tcounts


def _dp_diff(a, b) -> tuple:
    """(max |loss diff|, max |state diff|, bit-identical) of two runs,
    each ([losses], state dict)."""
    import torch

    la = max(abs(x - y) for x, y in zip(a[0], b[0]))
    pa = max(float((a[1][k].float() - b[1][k].float()).abs().max())
             for k in a[1] if a[1][k].numel())
    same = a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    return la, pa, same


def _within_spread(d, spread) -> bool:
    """Phase 19's rule: bit-identical, or (where two eager runs differ) as
    close as four times their spread or GRAPH_TRAIN_TOL."""
    return d[2] or (not spread[2]
                    and d[0] <= max(4 * spread[0], GRAPH_TRAIN_TOL[0])
                    and d[1] <= max(4 * spread[1], GRAPH_TRAIN_TOL[1]))


def dp_nccl_phase(route_batches, work, dev_line):
    """Phase 20 (a): the DP step (`train/loop.make_dp_train_step`) as one
    rank over NCCL against the eager step, bf16 with the fused head, 3
    steps from one init with one generator seed, within the eager run's
    own spread."""
    import torch

    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.packing import to_device
    from yolat_tpu_torch.ops import _build
    from yolat_tpu_torch.ops.plans import pad_plans
    from yolat_tpu_torch.parallel.distributed import (initialize_from_config,
                                                      shutdown)
    from yolat_tpu_torch.train.loop import make_dp_train_step, make_train_step
    from yolat_tpu_torch.train.optim import make_optimizer, make_scheduler
    from yolat_tpu_torch.train.trainer import init_model

    cfg, bs = route_batches["bf16_fused"]
    seq = [pad_plans(bs[i % len(bs)]) for i in range(GRAPH_STEPS)]
    ranks = initialize_from_config(Config(n_devices=1), 0, "cuda:0",
                                   store_path=os.path.join(work, "nccl_store"),
                                   timeout_s=300)
    try:
        check(ranks.backend == "nccl", f"backend {ranks.backend}")
        runs, counts = {}, {}
        for arm in ("eager", "eager_again", "dp"):
            model = init_model(cfg, "cuda")
            opt = make_optimizer(cfg.optimizer, model.parameters(), cfg.lr,
                                 cfg.weight_decay)
            sched = make_scheduler(opt, cfg.lr, 1, 0.5, 2)
            gen = torch.Generator(device="cuda").manual_seed(5)
            step = (make_dp_train_step(cfg, model, opt, sched, ranks.group)
                    if arm == "dp" else make_train_step(cfg, model, opt,
                                                        sched))
            _build.reset_launch_counts()
            losses = [float(step(to_device(b, "cuda"), gen)["loss"])
                      for b in seq]
            counts[arm] = (_build.launch_counts["folded_mlp_block_max"],
                           _build.launch_counts["fused_pool_train_bwd"])
            runs[arm] = (losses, _state(model))
    finally:
        shutdown(ranks)
    spread = _dp_diff(runs["eager"], runs["eager_again"])
    d = _dp_diff(runs["eager"], runs["dp"])
    check(all(map(_finite, runs["dp"][0])), "finite DP losses")
    check(counts["dp"] == (GRAPH_STEPS, GRAPH_STEPS),
          f"kernels 3 and 11 once per DP step: {counts}")
    check(_within_spread(d, spread),
          f"DP step over one NCCL rank: losses {d[0]}, state {d[1]} from "
          f"the eager step (eager against itself {spread[0]}, {spread[1]})")
    print(f"dp nccl: one rank over NCCL, {GRAPH_STEPS} bf16 fused steps: max "
          f"|loss diff| / max |state diff| from the eager step {d[0]:.3g} / "
          f"{d[1]:.3g} (bit-identical {d[2]}), eager against itself "
          f"{spread[0]:.3g} / {spread[1]:.3g}; kernels 3, 11 launches "
          f"{counts['dp']} [{dev_line}]")


# phase 20 (b): relative Frobenius limits of the DP step's kernel route
# against its plain route (the fused head's kernels 3 and 11 against their
# plain versions), (loss, averaged gradients), phase 15's by dtype
DP_ROUTE_TOL = {"f32": (1e-5, 5e-3), "bf16": (2e-3, 6e-2)}
DP_WORLD = 2
DP_TRAIN_STEPS = 4


def _dp_rank(local_rank, store_path, bench_root, train_root, work, port,
             device="cuda"):
    """Phase 20 (b)-(d) in one of two ranks over gloo on the one card
    (CUDA tensors; `device` 'cpu' rehearses it on the CPU): (b) and (c) as
    two local ranks of one node (a FileStore), (d) as two nodes of one
    rank each (`--coordinator localhost:port`, `--process_id`,
    `--n_processes 2`: a TCPStore). Returns what the parent checks and
    prints."""
    import functools

    import torch

    from yolat_tpu_torch.cli import profile
    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import PackedLoader, stack_shards
    from yolat_tpu_torch.data.packing import to_device
    from yolat_tpu_torch.eval.fast_forward import fold_params
    from yolat_tpu_torch.eval.predict import make_dp_predict_fn
    from yolat_tpu_torch.nn import layers
    from yolat_tpu_torch.nn.model import seeded_model
    from yolat_tpu_torch.ops import _build
    from yolat_tpu_torch.ops import fused_pool_train as fpt
    from yolat_tpu_torch.ops.plans import pad_plans
    from yolat_tpu_torch.parallel.distributed import (initialize_from_config,
                                                      shutdown)
    from yolat_tpu_torch.train.loop import make_dp_train_step, make_train_step
    from yolat_tpu_torch.train.trainer import init_model, run_training

    dev = torch.device(device, 0)  # both ranks on the one card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ranks = initialize_from_config(Config(n_devices=DP_WORLD), local_rank,
                                   dev, store_path=store_path,
                                   backend="gloo", timeout_s=300)
    out: dict = {"backend": ranks.backend}
    try:
        tds = SESYDDataset(train_root, "train", bbox_sampling_step=10)
        windows = {r: [pad_plans(b) for b in PackedLoader(
            tds, batch_size=BATCH, n_devices=DP_WORLD, rank=r, prefetch=0)]
            for r in range(DP_WORLD)}
        out["train_images"] = [int(w[0]["n_images"])
                               for w in windows.values()]

        def run(cfg, batches, dp, route="kernel"):
            """SGD steps from cfg.seed's init with the generator seed 5:
            ([losses], state, kernel 3 and 11 launches)."""
            model = init_model(cfg, dev)
            opt = torch.optim.SGD(model.parameters(), lr=1e-2)
            step = (make_dp_train_step(cfg, model, opt, group=ranks.group)
                    if dp else make_train_step(cfg, model, opt))
            gen = torch.Generator(device=dev).manual_seed(5)
            if route == "plain":
                layers.fused_pool_train = functools.partial(
                    fpt.fused_pool_train, route="plain")
            _build.reset_launch_counts()
            try:
                losses = [float(step(to_device(b, dev), gen)["loss"])
                          for b in batches]
            finally:
                layers.fused_pool_train = fpt.fused_pool_train
            return (losses, _state(model),
                    (_build.launch_counts["folded_mlp_block_max"],
                     _build.launch_counts["fused_pool_train_bwd"]))

        # (b) identical shards (rank 0's window on both ranks) against the
        # single-device step, bf16 fused; its own spread from two eager runs
        bf16 = Config(n_classes=tds.n_classes, dtype="bfloat16",
                      fused_head_train=True)
        seq = [windows[0][0]] * GRAPH_STEPS
        ident = run(bf16, seq, dp=True)
        out["identical_launches"] = ident[2]
        if ranks.rank == 0:
            # the running variances take the unbiased correction of the
            # global count (2n / (2n - 1), not n / (n - 1)): not compared
            def params(r):
                return r[0], {k: v for k, v in r[1].items()
                              if not k.endswith("running_var")}
            single = params(run(bf16, seq, dp=False))
            again = params(run(bf16, seq, dp=False))
            out["identical"] = (_dp_diff(single, params(ident)),
                                _dp_diff(single, again))
        # (b) distinct shards: the kernel route against the plain route
        # under the same DP, one SGD step: the loss and the averaged
        # gradients (the update over lr)
        out["routes"] = {}
        for name, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
            cfg = bf16.replace(dtype=dtype)
            start = _state(init_model(cfg, dev))
            got = {route: run(cfg, windows[ranks.rank][:1], True, route)
                   for route in ("kernel", "plain")}
            grads = {route: torch.cat([
                (start[k].float() - v[1][k].float()).reshape(-1) / 1e-2
                for k in start if not k.endswith(
                    ("running_mean", "running_var", "num_batches_tracked"))])
                for route, v in got.items()}
            out["routes"][name] = (
                abs(got["kernel"][0][0] - got["plain"][0][0])
                / abs(got["plain"][0][0]),
                float((grads["kernel"] - grads["plain"]).norm()
                      / grads["plain"].norm()),
                got["kernel"][2], got["plain"][2])

        # (c) DP predict: the bench batch's halves, one per rank
        bds = SESYDDataset(bench_root, "train", bbox_sampling_step=10)
        halves = [pad_plans(next(iter(PackedLoader(
            bds, batch_size=BATCH // 2, n_devices=DP_WORLD, rank=r,
            prefetch=0)))) for r in range(DP_WORLD)]
        scfg = Config(n_classes=bds.n_classes)
        folded = fold_params(seeded_model(scfg).to(dev), dev)
        fn = make_dp_predict_fn(scfg, stack_shards(halves), ranks.rank,
                                device=dev, folded=folded, bf16=True)
        out["predict"] = fn(stack_shards(halves)).numpy()
        out["predict_images"] = [int(h["n_images"]) for h in halves]
    finally:
        shutdown(ranks)

    # (d) as two nodes: process `local_rank` of 2, one rank each
    node = Config(n_devices=DP_WORLD, n_processes=DP_WORLD,
                  process_id=local_rank, coordinator=f"localhost:{port}")
    ranks = initialize_from_config(node, 0, dev, backend="gloo",
                                   timeout_s=300)
    out["nodes"] = (ranks.rank, ranks.node, ranks.n_nodes, ranks.local_world)
    try:
        # the DP trainer: run_training, 4 bf16 fused steps (batch 4 a rank,
        # one step an epoch over the 8 train SVGs: a node takes every
        # second step of the global schedule, one window a step), then the
        # DP step's wall and device busy time on a batch already on the
        # card
        tcfg = node.replace(data_dir=train_root, dtype="bfloat16",
                            fused_head_train=True, batch_size=BATCH,
                            total_epochs=DP_TRAIN_STEPS,
                            eval_start=DP_TRAIN_STEPS + 1, print_freq=1,
                            root_dir=os.path.join(work, "log_dp"))
        _build.reset_launch_counts()
        model, res = run_training(tcfg, dev, max_steps=DP_TRAIN_STEPS,
                                  ranks=ranks)
        out["trainer"] = {k: res[k] for k in (
            "steps", "images", "train_seconds", "losses", "map_50",
            "exp_dir")}
        out["trainer_launches"] = (
            _build.launch_counts["folded_mlp_block_max"],
            _build.launch_counts["fused_pool_train_bwd"])
        opt = torch.optim.SGD(model.parameters(), lr=1e-4)
        step = make_dp_train_step(tcfg.replace(n_classes=tds.n_classes),
                                  model, opt, group=ranks.group)
        gen = torch.Generator(device=dev).manual_seed(5)
        batch = to_device(windows[ranks.rank][0], dev)
        for _ in range(3):
            step(batch, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step(batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 10
        trace = profile._trace(lambda: step(batch, gen), 10)
        busy = trace["device_busy_ms_per_call"]
        out["step_times"] = (wall, busy, trace["device_kernels_per_call"],
                             None if busy is None else 1.0 - busy / wall)
        return out
    finally:
        shutdown(ranks)


def dp_gloo_phase(bench_root, train_root, work, dev_line):
    """Phase 20 (b)-(d): two ranks on the one card over gloo (CUDA
    tensors; NCCL refuses two ranks on one GPU), in processes of their own
    (`parallel/launch.spawn_ranks`)."""
    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import PackedLoader
    from yolat_tpu_torch.eval.fast_forward import fold_params
    from yolat_tpu_torch.eval.predict import make_serving_fn
    from yolat_tpu_torch.nn.model import seeded_model
    from yolat_tpu_torch.ops.plans import pad_plans
    from yolat_tpu_torch.parallel.launch import spawn_ranks

    import socket

    with socket.socket() as sock:  # a free port on this machine
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    outs = spawn_ranks(_dp_rank, DP_WORLD,
                       (bench_root, train_root, work, port),
                       join_timeout_s=600)
    secs = time.perf_counter() - t0
    check(all(o["backend"] == "gloo" for o in outs), "gloo ranks")
    check([o["nodes"] for o in outs] == [(r, r, DP_WORLD, 1)
                                         for r in range(DP_WORLD)],
          f"two nodes of one rank: {[o['nodes'] for o in outs]}")
    # (b)
    check(outs[0]["train_images"] == [BATCH, BATCH],
          f"distinct shards of {BATCH} images: {outs[0]['train_images']}")
    d, spread = outs[0]["identical"]
    check(_within_spread(d, spread),
          f"identical shards on {DP_WORLD} ranks: losses {d[0]}, state "
          f"{d[1]} from the single-device step (it against itself "
          f"{spread[0]}, {spread[1]})")
    for o in outs:
        check(o["identical_launches"] == (GRAPH_STEPS, GRAPH_STEPS),
              f"kernels 3 and 11 once per rank per step: "
              f"{o['identical_launches']}")
        for name, (loss_err, grad_err, kl, pl) in o["routes"].items():
            tol = DP_ROUTE_TOL[name]
            check(loss_err <= tol[0] and grad_err <= tol[1],
                  f"DP {name}: kernel route against plain route, loss "
                  f"{loss_err}, gradients {grad_err} (limits {tol})")
            check(kl == (1, 1) and pl == (0, 0),
                  f"DP {name}: launches kernel route {kl}, plain {pl}")
    print(f"dp gloo: {DP_WORLD} ranks on one card (gloo, CUDA tensors), "
          f"bf16 fused: identical shards against the single-device step "
          f"over {GRAPH_STEPS} SGD steps {d[0]:.3g} / {d[1]:.3g} (loss / "
          f"state; bit-identical {d[2]}), single against itself "
          f"{spread[0]:.3g} / {spread[1]:.3g}; distinct shards, kernel route "
          f"against plain route (loss, gradients rel. Frobenius) "
          + ", ".join(f"{n} {v[0]:.3g} {v[1]:.3g}"
                      for n, v in outs[0]["routes"].items())
          + f", rank 1 "
          + ", ".join(f"{n} {v[0]:.3g} {v[1]:.3g}"
                      for n, v in outs[1]["routes"].items())
          + f"; kernels 3, 11 per rank per step {outs[0]['identical_launches']}"
          f" / {GRAPH_STEPS} [{dev_line}]")
    # (c)
    bds = SESYDDataset(bench_root, "train", bbox_sampling_step=10)
    scfg = Config(n_classes=bds.n_classes)
    folded = fold_params(seeded_model(scfg).to("cuda"), "cuda")
    for r, o in enumerate(outs):
        half = pad_plans(next(iter(PackedLoader(
            bds, batch_size=BATCH // 2, n_devices=DP_WORLD, rank=r,
            prefetch=0))))
        want = make_serving_fn(scfg, half, device="cuda", folded=folded,
                               bf16=True)(half).numpy()
        check(o["predict_images"] == [BATCH // 2] * DP_WORLD
              and set(o["predict"]) == set(want)
              and all(_np_equal({k: o["predict"][k]}, {k: want[k]})
                      for k in want),
              f"rank {r}: DP predict detections bit-identical to "
              "make_serving_fn on its half")
    n_det = [int(o["predict"]["valid"].sum()) for o in outs]
    print(f"dp predict: the bench batch's halves ({BATCH // 2} images a rank)"
          f", detections bit-identical to single-device make_serving_fn; "
          f"valid detections per rank {n_det} [{dev_line}]")
    # (d)
    for r, o in enumerate(outs):
        t = o["trainer"]
        check(t["steps"] == DP_TRAIN_STEPS and all(map(_finite, t["losses"]))
              and _finite(t["map_50"]),
              f"rank {r}: DP trainer {t['steps']} steps, losses "
              f"{t['losses']}")
        check(o["trainer_launches"] == (DP_TRAIN_STEPS, DP_TRAIN_STEPS),
              f"rank {r}: trainer kernel 3, 11 launches "
              f"{o['trainer_launches']}")
    check(outs[0]["trainer"]["losses"] == outs[1]["trainer"]["losses"],
          "the ranks log the same averaged losses")
    check(os.path.exists(os.path.join(outs[0]["trainer"]["exp_dir"],
                                      "checkpoint", "ckpt_best.pt")),
          "rank 0 wrote the checkpoint")
    for r, o in enumerate(outs):
        t, (wall, busy, kern, idle) = o["trainer"], o["step_times"]
        print(f"dp trainer rank {r}: run_training {t['steps']} bf16 fused "
              f"steps of batch {BATCH} on {DP_WORLD} gloo ranks sharing one "
              f"card, as {DP_WORLD} nodes of one rank (--coordinator "
              f"localhost:port): "
              f"{t['train_seconds'] * 1e3 / t['steps']:.3f} ms wall "
              f"per step (first step included), losses "
              f"{[round(v, 4) for v in t['losses']]}; the DP step on a batch "
              f"on the card: {wall:.3f} ms wall, {busy} ms device busy in "
              f"{kern:.0f} kernels, idle share {idle} (gloo through the "
              f"host, not NCCL scaling) [{dev_line}]")
    print(f"dp phase: {secs:.1f} s for the two ranks [{dev_line}]")


# phase 21: the detection CLIs (cli.detect, cli.detect_badcase,
# cli.export_ckpt) on a test split of DETECT_SVGS bench-scale SVGs written
# by phase 6's writer, served from phase 6's checkpoint dir (one proposal
# per image survives its 8 steps: the root) and from seeded weights that
# keep many (DETECT_MANY_MIN detections per image at least)
DETECT_SVGS = 8
DETECT_MODES = ("flax", "fast", "fast_bf16")
DETECT_MANY_MIN = 100
NMS_IOU = 0.5  # Config.nms_iou
MAX_DET = 300  # Config.max_det: the detections NMS keeps per image


def _iou64(a, b) -> float:
    a = [float(v) for v in a]
    b = [float(v) for v in b]
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union > 0 else 0.0


def _pair_detections(got: dict, want: dict) -> tuple:
    """Pair one image's detections of two runs by class and box (rtol
    1e-6, atol 1e-4, tests/test_torch_detect.py's limits) -> (pairs,
    unpaired of got, unpaired of want)."""
    import numpy as np

    left = list(range(len(want["boxes"])))
    pairs, alone = [], []
    for i, box in enumerate(got["boxes"]):
        j = next((j for j in left if got["classes"][i] == want["classes"][j]
                  and np.allclose(box, want["boxes"][j], rtol=1e-6,
                                  atol=1e-4)), None)
        if j is None:
            alone.append(i)
        else:
            left.remove(j)
            pairs.append((i, j))
    return pairs, alone, left


def _match_detections(got: dict, want: dict, what: str,
                      tol: float = 1e-5, swaps: bool = False) -> int:
    """The CPU test's rule (tests/test_torch_detect.py match_detections):
    paired scores within rtol/atol `tol` (1e-5); a detection on one side
    only must be a pair at the hard-NMS threshold (a same-class detection
    kept by both, ranked above it, at an IoU within 1e-5 of it) or, where
    the other side's list is full (MAX_DET, Config.max_det), a near tie at
    its end (a score no higher than the other side's lowest within the
    score limit); at most 2% of the detections. With `swaps` (the factored
    YOLaT++ route, whose scores carry noise near `tol`) it may also be one
    of two near-tied overlapping boxes that the two sides ranked apart: a
    same-class detection on the other side only at an IoU above NMS_IOU
    with a score within the limit. Returns how many were left on one
    side."""
    import numpy as np

    pairs, ua, ub = _pair_detections(got, want)
    for i, j in pairs:
        check(abs(got["scores"][i] - want["scores"][j])
              <= tol + tol * abs(want["scores"][j]),
              f"{what}: scores {got['scores'][i]} vs {want['scores'][j]}")
    for rec, other, mine, both in ((got, want, ua, [i for i, _ in pairs]),
                                   (want, got, ub, [j for _, j in pairs])):
        low = min(map(float, other["scores"]), default=0.0)
        for k in mine:
            score = float(rec["scores"][k])
            at_cap = (len(other["scores"]) >= MAX_DET
                      and score <= low + tol + tol * abs(low))
            swapped = swaps and any(
                other["classes"][q] == rec["classes"][k]
                and _iou64(other["boxes"][q], rec["boxes"][k]) > NMS_IOU
                and abs(float(other["scores"][q]) - score)
                <= tol + tol * abs(score)
                for q in (ub if other is want else ua))
            check(at_cap or swapped or any(
                rec["classes"][p] == rec["classes"][k]
                and rec["scores"][p] > rec["scores"][k]
                and abs(_iou64(rec["boxes"][p], rec["boxes"][k])
                        - NMS_IOU) <= 1e-5 for p in both),
                f"{what}: detection {k} (score {score}) on one side only, "
                f"not at the NMS threshold nor at the end of a full list "
                f"(the other side: {len(other['scores'])} detections, lowest "
                f"score {low}), box {np.asarray(rec['boxes'][k]).tolist()}")
    n = len(ua) + len(ub)
    check(n <= 0.02 * max(len(got["boxes"]), len(want["boxes"]), 1),
          f"{what}: {n} detections on one side only")
    return n


def _detect_recorder(store: list):
    import numpy as np

    def render(svg_path, width, height, boxes, scores, classes, class_names,
               out_path, score_th=0.75):
        store.append({"file": svg_path, "out": out_path,
                      "w": float(width), "h": float(height),
                      "boxes": np.asarray(boxes), "scores": np.asarray(scores),
                      "classes": np.asarray(classes), "score_th": score_th})
    return render


def _many_proposal_pth(root: str, path: str, cfg=None,
                       raise_bg: float = 5.0) -> str:
    """Seeded weights of cfg's arch (the canonical detector by default) at
    width 64 (randomised BatchNorm terms, `seeded_model`) with the
    background logit's bias raised by `raise_bg`, as
    tests/test_torch_detect.py makes its weights: the roots fall to
    background, so their children are kept and hard NMS and merge_nms
    select among hundreds of overlapping proposals per image (a diagram's
    roots lead the background logit by 5.4 to 6.9 under these weights, so
    diagrams raise it by 10)."""
    import torch

    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.nn.model import seeded_model
    from yolat_tpu_torch.train.checkpoint import save_reference_checkpoint

    cfg = (cfg or Config()).replace(
        n_classes=SESYDDataset(root, "test").n_classes, n_filters=64)
    model = seeded_model(cfg, seed=21)
    with torch.no_grad():
        model.prediction_cls[-1][0].bias[-1] += raise_bg
    save_reference_checkpoint(model, path)
    return path


def _detect_argv(root: str, pretrained: str) -> list:
    return ["--data_dir", root, "--pretrained_model", pretrained,
            "--n_filters", "64", "--conf_th", "0.0", "--device", "cuda"]


def _detect_weights(work, root, weights, pretrained, dev_line,
                    n=DETECT_SVGS, extra=(), label="phase 21", many_min=0,
                    dense=False, pp=False, tol=1e-5) -> dict:
    """cli.detect under `pretrained` in each serve mode and fast
    `--merge_nms` (and fast `--dense_layout true` under `dense`), through
    its loop with a recording renderer, on the n test images of `root`
    (`extra`: more flags): fast (and dense) held to flax by
    `_match_detections` at `tol`, fast_bf16 reported, kernels 1 (4 on the
    dense table) / 2 / N1 at 2 / 1 / 1 launches per image in the fast
    modes and, for YOLaT++ (`pp`), kernel 6 once and kernel 5 never, a
    graph per (slot cap, signature), the merged boxes merge_nms of each
    call's kept proposals bit for bit; with `many_min`, that many flax
    detections per image at least and several merges on every image.
    Returns {mode: (records, result)}."""
    import numpy as np

    from yolat_tpu_torch.cli import detect
    from yolat_tpu_torch.eval.merge_nms import merge_nms
    from yolat_tpu_torch.ops import _build

    argv = _detect_argv(root, pretrained) + list(extra)
    modes = DETECT_MODES + ("merge",) + (("dense",) if dense else ())
    runs = {}
    for mode in modes:
        flags = {"merge": ["--serve_mode", "fast", "--merge_nms"],
                 "dense": ["--serve_mode", "fast", "--dense_layout", "true"]
                 }.get(mode, ["--serve_mode", mode])
        rec: list = []
        _build.reset_launch_counts()
        res = detect.detect(argv + flags + [
            "--out_dir", os.path.join(work, f"detect_{weights}_{mode}")],
            render=_detect_recorder(rec))
        check(len(rec) == len(res["images"]) == n,
              f"{weights} {mode}: {len(rec)} images drawn")
        for r in rec:
            check(r["boxes"].shape[1:] == (4,) and np.isfinite(r["boxes"]).all()
                  and np.isfinite(r["scores"]).all() and r["w"] > 0
                  and r["out"].endswith(".png"),
                  f"{weights} {mode}: a bad record")
        if mode != "flax":
            want = {"edge_window_message_sum": 2 * n,
                    "folded_mlp_block_max2": n, "nms_fixpoint": n}
            if mode == "dense":
                want.update(edge_window_message_sum=0,
                            fused_dense_message=2 * n)
            if pp:
                want.update(banded_message_sum_both=n, banded_message_sum=0)
            got = {k: res["launches"][k] for k in want}
            check(got == want, f"{weights} {mode}: launches {got}, "
                  f"want {want}")
            check(res["graphs"]["captured"] == res["serving_fns"] and
                  res["graphs"]["replayed"] == n,
                  f"{weights} {mode}: graphs {res['graphs']} for "
                  f"{res['serving_fns']} (slot cap, signature) keys")
        runs[mode] = (rec, res)

    flax, fast, bf16 = (runs[m][0] for m in DETECT_MODES)
    check(all(len(r["boxes"]) > 0 for r in flax),
          f"{weights} flax: an image without detections")
    flips = [_match_detections(f, w, f"{weights} fast vs flax, image {i}",
                               tol, swaps=pp)
             for i, (f, w) in enumerate(zip(fast, flax))]
    fast_err = max((abs(float(f["scores"][p]) - float(w["scores"][q]))
                    for f, w in zip(fast, flax)
                    for p, q in _pair_detections(f, w)[0]), default=0.0)
    dense_flips = [_match_detections(
        f, w, f"{weights} fast dense table vs flax, image {i}")
        for i, (f, w) in enumerate(zip(runs["dense"][0], flax))
    ] if dense else []
    bf16_rows = []
    for b, w in zip(bf16, flax):
        pairs, _, _ = _pair_detections(b, w)
        err = max((abs(float(b["scores"][p]) - float(w["scores"][q]))
                   for p, q in pairs), default=0.0)
        bf16_rows.append((len(b["boxes"]), len(w["boxes"]), len(pairs),
                          err))
    merges = []
    for r, img in zip(runs["merge"][0], runs["merge"][1]["images"]):
        out = img["outputs"]
        kept = out["kept"]
        m = merge_nms(out["prop_boxes"][kept], out["prop_obj"][kept],
                      out["prop_cls"][kept], conf_thres=0.0, nms_thres=0.4)
        check(np.array_equal(r["boxes"], m["boxes"])
              and np.array_equal(r["scores"], m["obj_conf"] * m["cls_conf"])
              and np.array_equal(r["classes"], m["classes"])
              and r["score_th"] == 0.0, f"{weights} --merge_nms: not "
              "merge_nms of the call's kept proposals")
        merges.append((int(kept.sum()), len(m["boxes"])))
    if many_min:
        check(all(len(r["boxes"]) >= many_min for r in flax),
              f"{weights}: flax detections per image "
              f"{[len(r['boxes']) for r in flax]}, want {many_min}+")
        check(all(m >= 2 and k - m >= 3 for k, m in merges),
              f"{weights}: (kept, merged) per image {merges}, want several "
              "merges on every image")
    print(f"{label} cli.detect, {weights} weights: " + "; ".join(
        f"{m}: {sum(len(r['boxes']) for r in runs[m][0])} detections on "
        f"{n} images, ms per image: warm mean "
        f"{1e3 * statistics.fmean(runs[m][1]['times_s'][1:]):.3f} (calls 2 "
        f"onward, as the CLI prints it), steady mean "
        f"{_steady_ms(runs[m][1]):.3f} (the calls that made no serving "
        f"fn), launches "
        f"{ {k: v for k, v in runs[m][1]['launches'].items() if v} }, graphs "
        f"{runs[m][1]['graphs']} over {runs[m][1]['serving_fns']} (slot cap, "
        f"signature) keys" for m in modes)
        + f" [{dev_line}]")
    print(f"{label} {weights} fast vs flax: every image within phase 21's "
          f"rule (boxes rtol 1e-6 / atol 1e-4, scores {tol:g}); "
          f"detections per image {[len(r['boxes']) for r in flax]}, on one "
          f"side only (each at the NMS threshold or the end of a full list"
          f"{' or a near-tied swap' if pp else ''}) {flips}, max |score "
          f"diff| of the pairs {fast_err:.3e}"
          + (f"; fast on the dense table vs flax (scores 1e-5): on one side "
             f"only {dense_flips}" if dense else ""))
    print(f"{label} {weights} fast_bf16 vs flax per image (bf16 count, "
          f"flax count, paired, max |score diff| of the pairs): {bf16_rows}")
    print(f"{label} {weights} --merge_nms: merge_nms of each call's kept "
          f"proposals, bit for bit; (kept, merged) per image {merges}")
    return runs


def _steady_ms(res: dict) -> float:
    steady = [t for t, s in zip(res["times_s"], res["set_up"]) if not s]
    return 1e3 * statistics.fmean(steady) if steady else float("nan")


def detect_phase(work, ckpt_dir, trained_pth, dev_line):
    """Phase 21: cli.detect (`_detect_weights`) under phase 6's checkpoint
    dir and under seeded weights that keep many proposals,
    cli.detect_badcase under both, cli.export_ckpt against phase 6's .pth,
    and cli.detect.main where matplotlib imports (one PNG per image) or its
    refusal where it does not. Returns (the test split's root, the flax
    records of the seeded weights that keep many detections)."""
    import torch

    from yolat_tpu_torch.cli import detect, detect_badcase, export_ckpt
    from yolat_tpu_torch.data.synthetic import write_dataset

    t_start = time.perf_counter()
    root = os.path.join(work, "detect_svgs")
    write_dataset(root, n_train=0, n_test=DETECT_SVGS, seed=19, width=2000.0,
                  height=1500.0, n_rooms=6, symbols_per_room=(1, 3))
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
        print("phase 21: overlays not drawn: matplotlib is not installed on "
              "this machine (cli.detect.main and cli.detect_badcase.main "
              "refuse; the detections are checked through the loop)")
    many = _many_proposal_pth(root, os.path.join(work, "detect_many.pth"))
    weights = {"phase6": ckpt_dir, "many": many}
    fast = _detect_weights(work, root, "phase6", ckpt_dir, dev_line)["fast"][0]
    many_runs = _detect_weights(work, root, "many", many, dev_line,
                                many_min=DETECT_MANY_MIN)

    # bad cases: the module route, TP / FP / FN per drawn image
    for name, pretrained in weights.items():
        bad: list = []
        res = detect_badcase.badcase(_detect_argv(root, pretrained) + [
            "--out_dir", os.path.join(work, f"badcase_{name}")],
            render=lambda *a: bad.append(a))
        check(len(bad) == res["n_bad"] <= DETECT_SVGS,
              f"badcase {name}: {res['n_bad']}")
        kinds = [(sum(k == "tp" for _, k in a[3]),
                  sum(k == "fp" for _, k in a[3]), len(a[4])) for a in bad]
        print(f"phase 21 cli.detect_badcase, {name} weights: {res['n_bad']} "
              f"of {DETECT_SVGS} images drawn, (TP, FP, FN) per drawn image "
              f"{kinds}")

    # export: phase 6's checkpoint dir to a reference .pth
    out = os.path.join(work, "exported.pth")
    export_ckpt.main(["--pretrained_model", ckpt_dir, "--n_filters", "64",
                      "--out", out])
    got = torch.load(out, weights_only=True)
    want = torch.load(trained_pth, weights_only=True)
    check(got["epoch"] == want["epoch"]
          and list(got["state_dict"]) == list(want["state_dict"])
          and all(torch.equal(got["state_dict"][k], v)
                  for k, v in want["state_dict"].items()),
          "the exported .pth is not phase 6's trained.pth")
    print(f"phase 21 cli.export_ckpt: {len(want['state_dict'])} tensors "
          f"bit-equal to phase 6's trained.pth (epoch {got['epoch']})")

    # the CLI itself: PNGs where matplotlib imports, its refusal elsewhere
    png_dir = os.path.join(work, "detect_png")
    argv = _detect_argv(root, ckpt_dir)
    if have_mpl:
        detect.main(argv + ["--serve_mode", "fast", "--out_dir", png_dir])
        want_png = sorted(os.path.basename(r["out"]) for r in fast)
        check(sorted(os.listdir(png_dir)) == want_png
              and all(os.path.getsize(os.path.join(png_dir, p)) > 0
                      for p in want_png), "cli.detect.main: one PNG per image")
        print(f"phase 21 cli.detect.main: {len(want_png)} PNGs")
    else:
        try:
            detect.main(argv + ["--serve_mode", "fast", "--out_dir", png_dir])
            check(False, "cli.detect.main ran without matplotlib")
        except RuntimeError as e:
            check("matplotlib" in str(e) and not os.path.exists(png_dir),
                  f"cli.detect.main's refusal: {e}")
        print("phase 21 cli.detect.main refused before the first image: "
              "matplotlib is absent")
    print(f"phase 21: {time.perf_counter() - t_start:.1f} s")
    return root, many_runs["flax"][0]


# phase 22: the repo's other two datasets, written by the port's own
# writers: diagrams (the bench's diagram shape, bench.py:232-241: 1500x1000,
# 8 symbols, seed 7) trained with --buckets 2 --do_mixup 1 and served, and
# charts (1600x1200, seed 7) trained and served with YOLaT++'s chart recipe
DIAGRAM_TRAIN, DIAGRAM_TEST, DIAGRAM_STEP, DIAGRAM_STEPS = 16, 4, 5, 8
DIAGRAM_BUCKETS = 2
DIAGRAM_MANY_MIN = 100  # flax detections per diagram under seeded weights
CHART_MANY_MIN = 100    # and per chart
CHART_TRAIN, CHART_TEST, CHART_STEP, CHART_STEPS = 8, 4, 20, 6


def _graph_line(res: dict) -> str:
    g = res["graphs"]
    return (f"graphs captured {g['captured']}, replayed {g['replayed']}, "
            f"freed {res['graphs_released']}; {res['signatures']} batch "
            f"signatures, {res['pad_growths']} pad growths; bytes in the "
            f"live graphs' pools {res['graph_bytes']}")


def _check_graphs(res: dict, buckets: int, what: str) -> None:
    """One capture per signature met (its first step eager), a replay for
    every other step, at most one signature per bucket and pad growth."""
    g = res["graphs"]
    check(g["captured"] == res["signatures"]
          and g["replayed"] == res["steps"] - res["signatures"]
          and res["signatures"] <= buckets + res["pad_growths"],
          f"{what}: {_graph_line(res)}")


def _release_check(root, dev_line) -> None:
    """`make_scan_train_step`'s release on the card: two signatures of the
    diagram split captured (the loader's pads, then twice them), the first
    released; after `empty_cache` the reserved memory falls by at least
    the bytes its graph's pool held."""
    import torch

    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import PackedLoader
    from yolat_tpu_torch.data.packing import PadSizes
    from yolat_tpu_torch.ops.plans import pad_plans
    from yolat_tpu_torch.train.loop import make_scan_train_step
    from yolat_tpu_torch.train.optim import make_optimizer
    from yolat_tpu_torch.train.trainer import init_model

    ds = SESYDDataset(root, "train", bbox_sampling_step=DIAGRAM_STEP)
    cfg = Config(n_classes=ds.n_classes, dtype="bfloat16",
                 fused_head_train=True)
    small = PackedLoader(ds, batch_size=BATCH, prefetch=0, edge_window=False)
    p = small.pad
    large = PackedLoader(ds, batch_size=BATCH, prefetch=0, edge_window=False,
                         pad=PadSizes(2 * p.n_nodes, 2 * p.n_edges,
                                      2 * p.n_proposals, p.n_gt, BATCH))
    model = init_model(cfg, "cuda")
    run = make_scan_train_step(cfg, model, make_optimizer(
        cfg.optimizer, model.parameters(), cfg.lr), None, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    held = []
    for loader in (small, large):
        run([pad_plans(next(iter(loader)))], gen)
        run([pad_plans(next(iter(loader)))], gen)  # a replay
        held.append(run.stats()["graph_bytes"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    check(run.release(next(iter(run.captured))), "release: no first graph")
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    first, second = held[0], held[1] - held[0]
    left = run.stats()
    check(left == {"graphs": 1, "graph_bytes": second}
          and before - after >= first > 0,
          f"release: reserved {before} -> {after}, the graph's pool {first}, "
          f"left {left}")
    print(f"phase 22 release: two diagram signatures captured (pools "
          f"{first} and {second} bytes), the first released: reserved "
          f"{before} -> {after} bytes after empty_cache [{dev_line}]")


def _served_kernels(cfg, folded, batch, label, want, dev_line) -> dict:
    """Every call of kernels 1, 2, 4, 5, 6 and N1 that the predict core
    makes on `batch` in f32 and in bf16, recorded at the wrappers and held
    against its plain version on the same inputs by the limits of phases
    3, 9, 14 and 19: kernels 1 and 4 |err| <= 1e-4 + 1e-4|ref| in f32 and
    max|err| <= 5e-3 max|ref| in bf16; kernel 2 |err| <= 1e-4 + rtol|ref|
    (rtol 1e-4, 1e-2) with the x max exact; kernels 5 and 6 max|err| <=
    BANDED_TOL max|ref|; N1 the plain loop's kept set. `want` names the
    kernels the route must call; returns {kernel: (calls, max_abs_err)}."""
    import torch

    from yolat_tpu_torch.eval import fast_forward as ff
    from yolat_tpu_torch.eval.predict import make_predict_core
    from yolat_tpu_torch.ops import nms, nms_fixpoint as nf

    def message(got, want, bf):
        err = (got.float() - want.float()).abs()
        if bf:
            return err.max().item() <= 5e-3 * want.float().abs().max().item()
        return bool((err <= 1e-4 + 1e-4 * want.float().abs()).all())

    def block_max(got, want, bf):
        ref = want[0].float()
        return (bool(((got[0].float() - ref).abs()
                      <= 1e-4 + (1e-2 if bf else 1e-4) * ref.abs()).all())
                and torch.equal(got[1], want[1]))

    def banded(got, want, bf):
        got, want = (torch.cat(t, 1) if isinstance(t, tuple) else t
                     for t in (got, want))
        return ((got.float() - want.float()).abs().max().item()
                <= BANDED_TOL["bf16" if bf else "f32"]
                * want.float().abs().max().item())

    def exact(got, want, bf):
        return torch.equal(got, want)

    cases = {"edge_window_message_sum": (ff, message),
             "fused_dense_message": (ff, message),
             "folded_mlp_block_max2": (ff, block_max),
             "banded_message_sum": (ff, banded),
             "banded_message_sum_both": (ff, banded),
             "nms_fixpoint": (nms, exact), "nms_classfix": (nms, exact)}
    names = {"nms_fixpoint": "fixpoint_kept", "nms_classfix": "classfix_kept"}
    seen: dict = {}

    def recorder(name, kernel, plain, same):
        def rec(*a, **kw):
            got, want = kernel(*a, **kw), plain(*a, **kw)
            bf = a[0].dtype == torch.bfloat16
            outs = [t for t in (got if isinstance(got, tuple) else (got,))
                    if t.is_floating_point()]
            refs = [t for t in (want if isinstance(want, tuple) else (want,))
                    if t.is_floating_point()]
            err = max(((g.float() - r.float()).abs().max().item()
                       for g, r in zip(outs, refs)), default=0.0)
            check(same(got, want, bf) and all(
                bool(torch.isfinite(t).all()) for t in outs),
                f"{label}: {name} {'bf16' if bf else 'f32'} call "
                f"{seen.get(name, (0,))[0] + 1} disagrees with its plain "
                f"version (max_abs_err {err:.3e})")
            calls, worst = seen.get(name, (0, 0.0))
            seen[name] = (calls + 1, max(worst, err))
            return got
        return rec

    saved = {}
    for name, (mod, same) in cases.items():
        attr = names.get(name, name)
        kernel = getattr(mod, attr)
        plain = (getattr(nf, attr + "_plain") if mod is nms
                 else getattr(ff, name + "_plain"))
        saved[(mod, attr)] = kernel
        setattr(mod, attr, recorder(name, kernel, plain, same))
    try:
        for bf in (False, True):
            make_predict_core(cfg, folded=folded, bf16=bf)(batch)
        torch.cuda.synchronize()
    finally:
        for (mod, attr), kernel in saved.items():
            setattr(mod, attr, kernel)
    check(set(seen) == set(want), f"{label}: kernels called {sorted(seen)}, "
          f"want {sorted(want)}")
    print(f"{label}: " + ", ".join(
        f"{k} {c} calls (max_abs_err {e:.3e})" for k, (c, e) in seen.items())
        + " against their plain versions on the same inputs, each within "
        f"its limit [{dev_line}]")
    return seen


def _head_apart(bm_k, bm_p, pooled_k, pooled_p, blk_first, n_prop) -> dict:
    """Where the two bf16 routes of the fused head part, from kernel 3's
    and its plain version's block maxima [N/8, H] and each route's pooled
    [P, H]: pooled entries of other values; block maxima that round to
    another bf16 value (real blocks); pooled entries whose winning blocks
    (block max equal to the pooled value and above 0) differ."""
    import torch

    first = blk_first.long()
    real = bm_p.float() > -5e29
    win_k = (bm_k == pooled_k[first]) & (bm_k.float() > 0)
    win_p = (bm_p == pooled_p[first]) & (bm_p.float() > 0)
    flip = torch.zeros(n_prop, bm_k.shape[1], device=bm_k.device)
    flip.scatter_reduce_(0, first[:, None].expand(-1, bm_k.shape[1]),
                         (win_k != win_p).float(), "amax")
    return {"pooled": int((pooled_k != pooled_p).sum()),
            "rounded": int(((bm_k != bm_p) & real).sum()),
            "winner": int(flip.sum()), "entries": pooled_k.numel()}


# the bf16 head's rule: against the float64 plain route on the same
# bf16-rounded x and W, the kernel route's relative Frobenius error of
# each of these is at most HEAD_F64_FACTOR times the bf16 plain route's
# (+ HEAD_F64_FLOOR, where both routes share the code: mean and var)
HEAD_F64_KEYS = ("pooled", "mean", "var", "dW", "db", "dgamma", "dbeta")
HEAD_F64_FACTOR, HEAD_F64_FLOOR = 1.5, 1e-6


def _head_vs_f64(cat, maskf, lin, bn, blk_first, n_prop, cot, bm, kernel,
                 plain, errs, label) -> str:
    """Holds the bf16 head's kernel route to the float64 rule (HEAD_F64_*)
    and returns the line that says how far each bf16 route stands from
    float64 (dx too, not held), how far apart the routes are (`errs`) and
    where they part (`_head_apart`; bm = kernel 3's and its plain
    version's block maxima). kernel, plain: each route's ({pooled, mean,
    var}, {gradients})."""
    import torch

    rv, rg = _head_run(cat, maskf, lin, bn, blk_first, n_prop, cot,
                       torch.float64, "plain", round_to=torch.bfloat16)
    ref = {**rv, **rg}
    routes = ({**kernel[0], **kernel[1]}, {**plain[0], **plain[1]})
    e_k, e_p = {}, {}
    for k in HEAD_F64_KEYS + ("dx",):
        norm = ref["dbeta"] if k == "db" else None
        e_k[k] = _rel(routes[0][k], ref[k], norm)
        e_p[k] = _rel(routes[1][k], ref[k], norm)
    apart = _head_apart(*bm, kernel[0]["pooled"], plain[0]["pooled"],
                        blk_first, n_prop)
    bad = [k for k in HEAD_F64_KEYS
           if e_k[k] > HEAD_F64_FACTOR * e_p[k] + HEAD_F64_FLOOR]
    line = (f"  {(cat.shape[0], n_prop)}: vs float64, kernel / plain: "
            + ", ".join(f"{k} {e_k[k]:.3e} / {e_p[k]:.3e}" for k in e_k)
            + "; kernel vs plain: "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f"; apart {apart}")
    check(not bad, f"{label} bf16: kernel route farther from float64 than "
          f"{HEAD_F64_FACTOR} x the plain route in {bad}: {line}")
    return line


def _head_routes(cfg, batches, label, dev_line) -> None:
    """The fused training head on each of `batches` (on the card), seeded
    weights: kernel 3 alone against its plain version element-wise, f32
    and bf16 (phase 5's rule, |err| <= 1e-4 + rtol|ref|, rtol 1e-4 and
    1e-2); the whole head (kernels 3 and 11) against its plain route in
    f32 within HEAD_TOL (pooled, mean, var and the gradients, relative
    Frobenius). At bf16 the two routes accumulate in other orders, so an
    entry can round to another bf16 value or another winner, and on the
    mixup diagram batches the kernel route read 5.06e-4 (dbeta) from the
    plain route, over phase 5's 5e-4. So the bf16 route is held to the
    float64 plain route on the same bf16-rounded x and W (the exact
    function both bf16 routes approximate): for each of HEAD_F64_KEYS
    the kernel route's relative Frobenius error is at most
    HEAD_F64_FACTOR (1.5) times the bf16 plain route's, + HEAD_F64_FLOOR
    (1e-6). Printed per batch: both routes' errors against float64 (dx
    too, not held), the kernel route's against the plain route, and
    where the routes part (`_head_apart`)."""
    import torch

    from yolat_tpu_torch.nn.model import seeded_model
    from yolat_tpu_torch.ops.block_max import (folded_mlp_block_max,
                                               folded_mlp_block_max_plain)
    from yolat_tpu_torch.ops.fused_pool_train import _scale_shift, _stats
    from yolat_tpu_torch.ops.plans import plan_of

    model = seeded_model(cfg, seed=5).to("cuda").train()
    worst = {"k3 f32": 0.0, "k3 bf16": 0.0, "f32": 0.0, "bf16": 0.0}
    shapes, lines = [], []
    for batch in batches:
        with torch.no_grad():
            cat, _ = model.cls_net.features(batch)
        lin, bn = model.cls_net.fusion_block[0], model.cls_net.fusion_block[1]
        mask = batch["node_mask"]
        maskf = mask.float()[:, None]
        blk_first = plan_of(batch)[0]
        n_prop = batch["labels"].shape[0]
        shapes.append((cat.shape[0], n_prop))
        cot = torch.randn(n_prop, lin.weight.shape[0],
                          generator=torch.Generator().manual_seed(5)
                          ).to(cat.device)
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = (cat * maskf).to(dt)
            w = lin.weight.detach().t().contiguous().to(dt)
            mean, var, _, _, _ = _stats(x, maskf, w, lin.bias.detach())
            sc = _scale_shift(mean, var, lin.bias.detach(),
                              bn.weight.detach(), bn.bias.detach())
            got = folded_mlp_block_max(x, maskf, w, sc)
            want = folded_mlp_block_max_plain(x, maskf, w, sc)
            err = (got.float() - want.float()).abs()
            rtol = 1e-4 if dt == torch.float32 else 1e-2
            check(bool((err <= 1e-4 + rtol * want.float().abs()).all()),
                  f"{label}: kernel 3 {tag} (nodes, proposals) {shapes[-1]} "
                  f"disagrees with its plain version: max_abs_err "
                  f"{err.max().item():.3e}")
            worst[f"k3 {tag}"] = max(worst[f"k3 {tag}"], err.max().item())
            kv, kg = _head_run(cat, maskf, lin, bn, blk_first, n_prop, cot,
                               dt, "kernel")
            pv, pg = _head_run(cat, maskf, lin, bn, blk_first, n_prop, cot,
                               dt, "plain")
            errs = {k: _rel(kv[k], pv[k]) for k in kv}
            errs.update({k: _rel(kg[k], pg[k],
                                 pg["dbeta"] if k == "db" else None)
                         for k in kg})
            check(all(bool(torch.isfinite(t.float()).all()) for t in
                      list(kv.values()) + list(kg.values()))
                  and kg["dW"].abs().max().item() > 0,
                  f"{label} {tag}: non-finite head outputs or no winners")
            worst[tag] = max(worst[tag], max(errs.values()))
            if dt == torch.float32:
                check(all(v <= HEAD_TOL[tag] for v in errs.values()),
                      f"{label} f32 (nodes, proposals) {shapes[-1]}: kernel "
                      f"route vs plain route {errs}")
                continue
            lines.append(_head_vs_f64(cat, maskf, lin, bn, blk_first,
                                      n_prop, cot, (got, want), (kv, kg),
                                      (pv, pg), errs, label))
    print(f"{label}: (nodes, proposal slots) per batch {shapes}; kernel 3 "
          f"alone against its plain version, max_abs_err f32 "
          f"{worst['k3 f32']:.3e}, bf16 {worst['k3 bf16']:.3e} (|err| <= "
          f"1e-4 + rtol|ref|, rtol 1e-4 / 1e-2); the head's kernel route "
          f"against its plain route, largest relative Frobenius error of "
          f"pooled, mean, var and the gradients: f32 {worst['f32']:.2e} "
          f"(<= {HEAD_TOL['f32']:g}), bf16 {worst['bf16']:.2e}; bf16 held "
          f"to the float64 plain route (kernel <= {HEAD_F64_FACTOR} x plain "
          f"+ {HEAD_F64_FLOOR:g} in {', '.join(HEAD_F64_KEYS)}) "
          f"[{dev_line}]")
    for line in lines:
        print(line)


def _served_phase(cfg, root, pth, step, label, dev_line) -> None:
    """`_served_kernels` on the first test batch of `root` as cli.test
    packs it (batch BATCH), under the weights in `pth`: the edge-window
    route with fixpoint NMS and, for the canonical detector (diagrams),
    with classfix NMS and on the dense table. (Charts serve on fixpoint
    NMS: classfix's plain loop would hold a [4, 6, 7.4k, 7.4k] table,
    78.5 GiB, at their batch.)"""
    from yolat_tpu_torch.cli.test import serving_loader
    from yolat_tpu_torch.config import PP_ARCHS
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.packing import finalize_batch, to_device
    from yolat_tpu_torch.eval.fast_forward import fold_params_for
    from yolat_tpu_torch.nn.model import build_model
    from yolat_tpu_torch.train.checkpoint import state_from_pth

    ds = SESYDDataset(root, "test", bbox_sampling_step=step)
    cfg = cfg.replace(n_classes=ds.n_classes)
    model = build_model(cfg)
    state_from_pth(model, pth)
    folded = fold_params_for(cfg, model.eval().to("cuda"), "cuda")
    pp = cfg.arch in PP_ARCHS
    conv = ({"edge_window_message_sum", "banded_message_sum_both"} if pp
            else {"edge_window_message_sum"})
    runs = [(cfg, conv | {"nms_fixpoint"})]
    if not pp:
        runs += [(cfg.replace(nms_algorithm="classfix"),
                  conv | {"nms_classfix"}),
                 (cfg.replace(dense_layout=True),
                  {"fused_dense_message", "nms_fixpoint"})]
    for c, want in runs:
        b = next(iter(serving_loader(c, ds, BATCH, "fast", prefetch=0)))
        _served_kernels(c, folded, finalize_batch(to_device(b, "cuda")),
                        f"{label} served kernels ({c.nms_algorithm}, "
                        f"{'dense table' if c.dense_layout else 'edge window'}"
                        f", {int(b['proposal_mask'].sum())} proposals in "
                        f"{b['labels'].shape[0]} slots, {b['pos'].shape[0]} "
                        f"node rows)", want | {"folded_mlp_block_max2"},
                        dev_line)


def diagram_phase(work, dev_line) -> None:
    """Phase 22 (a): diagrams through cli.train (canonical, bf16, fused
    head, --buckets 2 --do_mixup 1), with kernels 3 and 11 held to their
    plain route on the mixup batches; cli.test (fast_bf16 with classfix
    NMS; fast on the dense table); kernels 1, 2, 4 and N1 held to their
    plain versions on the test batch under seeded weights that keep many
    proposals; cli.detect's loop (fast on the edge windows and on the
    dense table within phase 21's per-image rule of flax, under the trained
    weights and the seeded ones) and cli.infer."""
    import torch

    from yolat_tpu_torch.cli import export_ckpt, infer
    from yolat_tpu_torch.cli import test as test_cli
    from yolat_tpu_torch.cli import train as train_cli
    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import PackedLoader, train_plans_for
    from yolat_tpu_torch.data.packing import finalize_batch, to_device
    from yolat_tpu_torch.data.synthetic import write_diagram_dataset
    from yolat_tpu_torch.ops import _build

    t_start = time.perf_counter()
    root = os.path.join(work, "diagrams")
    write_diagram_dataset(root, n_train=DIAGRAM_TRAIN, n_test=DIAGRAM_TEST,
                          seed=7)
    step = ["--bbox_sampling_step", str(DIAGRAM_STEP)]
    _build.reset_launch_counts()
    reserved = torch.cuda.memory_reserved()
    res = train_cli.main([
        "--data_dir", root, "--device", "cuda", "--dtype", "bfloat16",
        "--fused_head_train", "true", "--buckets", str(DIAGRAM_BUCKETS),
        "--do_mixup", "1", "--batch_size", str(BATCH), "--n_filters", "64",
        "--max_steps", str(DIAGRAM_STEPS), "--root_dir",
        os.path.join(work, "log_diagrams"), "--print_freq", "4"] + step)
    counts = res["launches"]
    check(res["steps"] == DIAGRAM_STEPS and len(res["losses"]) == DIAGRAM_STEPS
          and all(map(_finite, res["losses"])),
          f"diagrams: {res['steps']} steps, losses {res['losses']}")
    check(counts["folded_mlp_block_max"] == DIAGRAM_STEPS
          and counts["fused_pool_train_bwd"] == DIAGRAM_STEPS,
          f"diagrams: kernels 3 and 11 once per step: {counts}")
    _check_graphs(res, DIAGRAM_BUCKETS, "diagrams")
    secs = res["train_seconds"]
    print(f"phase 22 diagrams cli.train: {res['steps']} bf16 fused steps of "
          f"batch {BATCH} at step {DIAGRAM_STEP}, --buckets "
          f"{DIAGRAM_BUCKETS} --do_mixup 1: {1e3 * secs / res['steps']:.3f} "
          f"ms per step (first step and capture of each signature "
          f"included); losses {[round(v, 4) for v in res['losses']]}; "
          f"MAP@0.5 {res['map_50']:.4f}; kernels 3 / 11 "
          f"{counts['folded_mlp_block_max']} / "
          f"{counts['fused_pool_train_bwd']}; {_graph_line(res)}; memory "
          f"reserved {reserved} -> {torch.cuda.memory_reserved()} bytes "
          f"[{dev_line}]")

    # kernels 3 and 11 on the mixup training shapes: an epoch of the
    # trainer's loader (mixup, two buckets, grown pads)
    n_classes = SESYDDataset(root).n_classes
    cfg = Config(n_classes=n_classes, n_filters=64, dtype="bfloat16",
                 fused_head_train=True)
    mixed = PackedLoader(
        SESYDDataset(root, "train", bbox_sampling_step=DIAGRAM_STEP,
                     do_mixup=True, seed=0),
        batch_size=BATCH, shuffle=True, seed=0, buckets=DIAGRAM_BUCKETS,
        edge_window=False, prefetch=0, **train_plans_for(cfg))
    _head_routes(cfg, [finalize_batch(to_device(b, "cuda")) for b in mixed],
                 "phase 22 diagrams mixup batches, fused head kernel route "
                 "vs plain route", dev_line)

    ckdir = os.path.join(res["exp_dir"], "checkpoint")
    n_batches = -(-DIAGRAM_TEST // BATCH)
    for name, flags, want in (
            ("fast_bf16 classfix",
             ["--serve_mode", "fast_bf16", "--nms_algorithm", "classfix"],
             {"edge_window_message_sum": 2 * n_batches,
              "folded_mlp_block_max2": n_batches,
              "nms_classfix": n_batches, "fused_dense_message": 0}),
            ("fast dense table", ["--serve_mode", "fast", "--dense_layout",
                                  "true"],
             {"fused_dense_message": 2 * n_batches,
              "folded_mlp_block_max2": n_batches,
              "nms_fixpoint": n_batches, "edge_window_message_sum": 0})):
        t0 = time.perf_counter()
        table = test_cli.main([
            "--data_dir", root, "--phase", "test", "--device", "cuda",
            "--batch_size", str(BATCH), "--n_filters", "64",
            "--pretrained_model", ckdir] + step + flags)
        wall = time.perf_counter() - t0
        got = {k: table["launches"][k] for k in want}
        check(got == want, f"diagrams cli.test {name}: launches {got}, "
              f"want {want}")
        check(len(table["map_per_th"]) == 10
              and all(map(_finite, table["map_per_th"]))
              and _finite(table["top1_acc"]),
              f"diagrams cli.test {name}: AP table {table['map_per_th']}")
        print(f"phase 22 diagrams cli.test {name}: MAP@0.5 "
              f"{table['map_50']:.4f}, MAP@all {table['map_all']:.4f}, top1 "
              f"{table['top1_acc']:.4f}; launches {got}; {1e3 * wall:.1f} ms "
              f"for the CLI's {n_batches} batch (restore, load, pack, serve)")

    # the serving kernels on the test batch under weights that keep many
    # proposals; per image: fast within phase 21's rule of flax, the
    # kernels per image, under the trained and the seeded weights
    many = _many_proposal_pth(root, os.path.join(work, "diagram_many.pth"),
                              raise_bg=10.0)
    _served_phase(cfg.replace(dtype="float32", fused_head_train=False),
                  root, many, DIAGRAM_STEP, "phase 22 diagrams", dev_line)
    _detect_weights(work, root, "diagram", ckdir, dev_line, n=DIAGRAM_TEST,
                    extra=step, label="phase 22", dense=True)
    _detect_weights(work, root, "diagram many", many, dev_line,
                    n=DIAGRAM_TEST, extra=step, label="phase 22",
                    many_min=DIAGRAM_MANY_MIN, dense=True)

    pth = os.path.join(work, "diagram_trained.pth")
    export_ckpt.main(["--pretrained_model", ckdir, "--n_filters", "64",
                      "--n_classes", str(SESYDDataset(root).n_classes),
                      "--out", pth])
    out = os.path.join(work, "diagrams.jsonl")
    infer.main(["--data_dir", root, "--phase", "test", "--pretrained_model",
                pth, "--out", out, "--device", "cuda", "--conf_th", "0.0",
                "--batch_size", str(BATCH), "--n_filters", "64"] + step)
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    check(len(recs) == DIAGRAM_TEST and all("error" not in r for r in recs),
          f"diagrams cli.infer: {len(recs)} records for {DIAGRAM_TEST} SVGs")
    _release_check(root, dev_line)
    print(f"phase 22 diagrams cli.infer: {len(recs)} records, "
          f"{sum(len(r['detections']) for r in recs)} detections; diagrams "
          f"{time.perf_counter() - t_start:.1f} s")


def chart_phase(work, dev_line) -> None:
    """Phase 22 (b): charts through cli.train (YOLaT++ --profile
    yolat_pp_fast at step 20: the chart recipe) and cli.test fast_bf16
    (kernels 1, 2, 6 and N1 at their counts per batch; no launch of 5),
    with the batch's proposals, edges, super edges and pads; under seeded
    YOLaT++ weights that keep many proposals, kernels 1, 2, 6 and N1 held
    to their plain versions on cli.test's batch, and cli.detect's loop
    (fast within phase 21's rule of flax at the factored route's score
    limit, 1e-3, with near-tied overlapping boxes allowed to swap)."""
    from yolat_tpu_torch.cli import test as test_cli
    from yolat_tpu_torch.cli import train as train_cli
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import (PackedLoader, extra_plans_for,
                                             train_plans_for)
    from yolat_tpu_torch.data.synthetic import write_chart_dataset
    from yolat_tpu_torch.ops import _build

    t_start = time.perf_counter()
    root = os.path.join(work, "charts")
    write_chart_dataset(root, n_train=CHART_TRAIN, n_test=CHART_TEST, seed=7)
    flags = ["--profile", "yolat_pp_fast", "--bbox_sampling_step",
             str(CHART_STEP), "--n_filters", "64", "--batch_size", str(BATCH)]
    argv = ["--data_dir", root, "--device", "cuda", "--dtype", "bfloat16",
            "--max_steps", str(CHART_STEPS), "--root_dir",
            os.path.join(work, "log_charts"), "--print_freq", "3"] + flags
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(argv),
                                     argv)
    check(cfg.arch == "yolat_pp" and cfg.pp_factored_prim
          and cfg.pos_class_weight == 16.0 and cfg.iou_aware_loss
          and cfg.iou_aware_mode == "rel", f"the chart recipe: {cfg}")
    _build.reset_launch_counts()
    res = train_cli.main(argv)
    check(res["steps"] == CHART_STEPS and all(map(_finite, res["losses"])),
          f"charts: {res['steps']} steps, losses {res['losses']}")
    _check_graphs(res, 1, "charts")
    secs = res["train_seconds"]
    print(f"phase 22 charts cli.train (YOLaT++ factored, chart recipe, "
          f"bf16): {res['steps']} steps of batch {BATCH} at step "
          f"{CHART_STEP}: {1e3 * secs / res['steps']:.3f} ms per step "
          f"(first step and capture included); losses "
          f"{[round(v, 4) for v in res['losses']]}; MAP@0.5 "
          f"{res['map_50']:.4f}; launches "
          f"{ {k: v for k, v in res['launches'].items() if v} }; "
          f"{_graph_line(res)} [{dev_line}]")

    ckdir = os.path.join(res["exp_dir"], "checkpoint")
    t0 = time.perf_counter()
    table = test_cli.main(["--data_dir", root, "--phase", "test", "--device",
                           "cuda", "--pretrained_model", ckdir,
                           "--serve_mode", "fast_bf16"] + flags)
    wall = time.perf_counter() - t0
    n_batches = -(-CHART_TEST // BATCH)
    want = {"edge_window_message_sum": 2 * n_batches,
            "folded_mlp_block_max2": n_batches,
            "banded_message_sum_both": n_batches, "nms_fixpoint": n_batches,
            "banded_message_sum": 0}
    got = table["launches"]
    check({k: got[k] for k in want} == want
          and all(map(_finite, table["map_per_th"])),
          f"charts cli.test: launches {got}, want {want}, AP "
          f"{table['map_per_th']}")
    print(f"phase 22 charts cli.test fast_bf16: MAP@0.5 {table['map_50']:.4f}, "
          f"top1 {table['top1_acc']:.4f}; launches "
          f"{ {k: v for k, v in got.items() if v} }; {1e3 * wall:.1f} ms for "
          f"the CLI's {n_batches} batch (restore, load, pack, serve)")

    pp_cfg = cfg.replace(n_classes=SESYDDataset(root, "test").n_classes)
    for split, opts in (("train", train_plans_for(pp_cfg)),
                        ("test", extra_plans_for(pp_cfg))):
        loader = PackedLoader(SESYDDataset(root, split,
                                           bbox_sampling_step=CHART_STEP),
                              batch_size=BATCH, prefetch=0, **opts)
        b = next(iter(loader))
        p = loader.pad
        print(f"phase 22 charts {split} batch: {int(b['proposal_mask'].sum())} "
              f"proposals in {b['labels'].shape[0]} slots, "
              f"{int(b['edge_mask'].sum())} edges in {b['edge'].shape[0]} "
              f"rows, {int(b['super_mask'].sum())} super edges in "
              f"{b['edge_super'].shape[0]} rows; pad nodes {p.n_nodes}, "
              f"edges {p.n_edges}, proposals {p.n_proposals}, super "
              f"{p.n_super}, gt {p.n_gt}")

    # seeded weights that keep many proposals: the serving kernels on
    # cli.test's batch against their plain versions, and per image fast
    # against flax. The factored level's f32 prefix sums round apart
    # between the routes, the more the larger the image: a chart's scores
    # read 2.06e-4 apart, above tests/test_torch_pp_slice.py's 1e-4 at its
    # small sizes, so the limit is phase 14's for this route (its logits
    # within 1e-3 of their scale; a score's scale is 1)
    many = _many_proposal_pth(root, os.path.join(work, "chart_many.pth"),
                              cfg)
    _served_phase(cfg, root, many, CHART_STEP, "phase 22 charts", dev_line)
    _detect_weights(work, root, "chart many", many, dev_line, n=CHART_TEST,
                    extra=flags, label="phase 22", many_min=CHART_MANY_MIN,
                    pp=True, tol=1e-3)
    print(f"phase 22 charts: {time.perf_counter() - t_start:.1f} s")


def _finite(v) -> bool:
    return v == v and abs(v) != float("inf")


# phase 23: the conv zoo on phase 6's floorplans
ZOO_CONVS = ("attr_edge", "multilayer_edge", "attr_edge_gp", "attr_edge_cf",
             "edge", "mr", "gcn", "gin", "sage", "rsage", "gat", "gen")
ZOO_TIE_PRONE = ("gcn", "gat")  # act -> BatchNorm: tied max-pool winners
ZOO_STEPS = 4
ZOO_TRAINED = ("edge", "gat", "gen", "attr_edge_cf")  # bf16, fused head
ZOO_TIMED = 10  # replays timed per conv, in turns
# card against CPU, f32: logits (of their scale), the loss, the running
# statistics (relative): the same math summed in other orders, through
# train-mode BatchNorm (read <= 8.1e-6, 1.2e-7, 1.0e-6); the gradients
# after the node max pool (relative Frobenius), where a ReLU gate of the
# head that rounds apart moves a whole row's cotangent (read 2e-6 without
# one, up to 1.76e-3 with)
CONV_ZOO_TOL = {"logits": 1e-4, "loss": 1e-5, "stats": 1e-4, "head": 1e-2}
# every gradient of a conv without act -> BatchNorm ties: relative
# Frobenius (a pool winner or ReLU gate that rounds apart moves a few
# entries; read <= 7.5e-3, GIN's eps, a sum that cancels); gcn and gat
# read up to 0.244 and 0.061 with 42% and 21% of the pool's pairs tied
CONV_ZOO_GRAD_TOL = 5e-2


def _zoo_run(model, batch):
    """Train-mode forward and backward of the detection loss: (logits,
    loss, {name: grad}, {name: running statistic}, tied share)."""
    import torch

    from yolat_tpu_torch.nn.model import detection_loss
    from yolat_tpu_torch.ops.segment import segment_max

    model.train()
    model.zero_grad()
    logits = model(batch)[0]
    loss = detection_loss(logits, batch["labels"],
                          batch["proposal_mask"])["loss"]
    loss.backward()
    grads = {n: p.grad.detach().cpu().double()
             for n, p in model.named_parameters()}
    stats = {n: b.detach().cpu().double() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    with torch.no_grad():
        cat, _ = model.cls_net.features(batch)
        n_prop, idx = batch["labels"].shape[0], batch["bbox_idx"].long()
        mx = segment_max(cat, idx, n_prop, mask=batch["node_mask"])
        hit = (cat == mx.index_select(0, idx)) & batch["node_mask"][:, None]
        wins = torch.zeros_like(mx).index_add_(0, idx, hit.to(mx.dtype))
        pm = batch["proposal_mask"]
        tied = float(((wins[pm] > 1) & (mx[pm] != 0)).float().mean())
    return (logits.detach().cpu().double(), loss.item(), grads, stats,
            tied)


def _zoo_card_cpu(root, dev_line) -> None:
    """Phase 23 (a): each conv's seeded full-width model in train mode on
    the card against the CPU's plain path, on the first train batch."""
    import copy

    import torch

    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import PackedLoader, train_plans_for
    from yolat_tpu_torch.data.packing import to_device
    from yolat_tpu_torch.nn.model import seeded_model
    from yolat_tpu_torch.train.loop import prepare_batch

    ds = SESYDDataset(root, "train", bbox_sampling_step=10)
    cfg = Config(n_classes=ds.n_classes, data_aug=False)
    b = next(iter(PackedLoader(ds, batch_size=BATCH, prefetch=0,
                               **train_plans_for(cfg))))
    cpu_b = prepare_batch(cfg, to_device(b, "cpu"))
    dev_b = prepare_batch(cfg, to_device(b, "cuda"))
    rel = lambda a, r: float((a - r).norm() / max(float(r.norm()), 1e-30))  # noqa: E731
    rows = []
    for conv in ZOO_CONVS:
        model = seeded_model(cfg.replace(conv=conv), seed=23)
        t0 = time.perf_counter()
        got = _zoo_run(copy.deepcopy(model).to("cuda"), dev_b)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = _zoo_run(model, cpu_b)
        t_cpu = time.perf_counter() - t0
        pm = cpu_b["proposal_mask"]
        lg = (got[0][pm] - want[0][pm]).abs().max().item() / max(
            want[0][pm].abs().max().item(), 1e-30)
        ls = abs(got[1] - want[1]) / abs(want[1])
        st = max(rel(got[3][k], v) for k, v in want[3].items())
        # a Dense bias feeding a BatchNorm has a structurally zero
        # gradient (noise below 1e-4): held absolutely
        g_err = {k: rel(got[2][k], v) for k, v in want[2].items()
                 if float(v.abs().max()) >= 1e-4}
        noise = max(float((got[2][k] - v).abs().max())
                    for k, v in want[2].items() if k not in g_err)
        head = max(e for k, e in g_err.items()
                   if k.startswith(("prediction_cls", "cls_net.fusion_block_super")))
        worst = max(g_err, key=g_err.get)
        finite = all(bool(torch.isfinite(g).all()) for g in got[2].values())
        check(finite and lg <= CONV_ZOO_TOL["logits"]
              and ls <= CONV_ZOO_TOL["loss"] and st <= CONV_ZOO_TOL["stats"]
              and head <= CONV_ZOO_TOL["head"] and noise <= 1e-4,
              f"phase 23 {conv}: card against CPU: logits {lg:.2e}, loss "
              f"{ls:.2e}, running statistics {st:.2e}, head gradients "
              f"{head:.2e}, noise-level gradients {noise:.2e} (limits "
              f"{CONV_ZOO_TOL}, 1e-4), finite {finite}")
        if conv not in ZOO_TIE_PRONE:
            check(g_err[worst] <= CONV_ZOO_GRAD_TOL,
                  f"phase 23 {conv}: gradient {worst} {g_err[worst]:.2e} "
                  f"(limit {CONV_ZOO_GRAD_TOL}; tied pool pairs "
                  f"{got[4]:.2%} on the card, {want[4]:.2%} on the CPU)")
        rows.append((conv, lg, ls, st, head, worst, g_err[worst],
                     statistics.median(g_err.values()), got[4], want[4],
                     t_card, t_cpu))
        print(f"phase 23 {conv}: card against CPU, logits {lg:.2e}, loss "
              f"{ls:.2e}, running statistics {st:.2e}, head gradients "
              f"{head:.2e}, noise-level gradients {noise:.2e}, gradients "
              f"median {rows[-1][7]:.2e}, largest "
              f"{g_err[worst]:.2e} ({worst}); tied max-pool pairs card "
              f"{got[4]:.2%} CPU {want[4]:.2%}; forward + backward "
              f"{1e3 * t_card:.1f} ms card (first call), {1e3 * t_cpu:.1f} "
              f"ms CPU")
    print(f"phase 23 card against CPU: {len(rows)} convs on a batch of "
          f"{BATCH} ({cpu_b['pos'].shape[0]} node rows, "
          f"{cpu_b['edge'].shape[0]} edge rows, {int(pm.sum())} proposals), "
          f"limits {CONV_ZOO_TOL}, other gradients {CONV_ZOO_GRAD_TOL} "
          f"except {ZOO_TIE_PRONE} (printed) [{dev_line}]")


def _zoo_step_times(root, dev_line) -> None:
    """Phase 23 (b): the bf16 fused-head train step of gp2 and of the four
    trained convs as graph replays (`make_scan_train_step`, scan 1) on
    phase 6's two train batches: the first step eager and captured, two
    replays unclocked, then ZOO_TIMED replays in turns across the convs,
    each synchronised (host wall, the batch's staging included), with the
    bytes each graph's pool holds."""
    import torch

    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import PackedLoader, train_plans_for
    from yolat_tpu_torch.ops.plans import pad_plans
    from yolat_tpu_torch.train.loop import make_scan_train_step
    from yolat_tpu_torch.train.optim import make_optimizer
    from yolat_tpu_torch.train.trainer import init_model

    ds = SESYDDataset(root, "train", bbox_sampling_step=10)
    runs, times = {}, {}
    for conv in ("attr_edge_gp2",) + ZOO_TRAINED:
        cfg = Config(n_classes=ds.n_classes, dtype="bfloat16",
                     fused_head_train=True, conv=conv)
        batches = [pad_plans(b) for b in PackedLoader(
            ds, batch_size=BATCH, prefetch=0, edge_window=False,
            **train_plans_for(cfg))]
        model = init_model(cfg, "cuda")
        run = make_scan_train_step(cfg, model, make_optimizer(
            cfg.optimizer, model.parameters(), cfg.lr), None, 1)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for b in batches + batches[:1]:
            run([b], gen)
        runs[conv], times[conv] = (run, batches, gen), []
    for i in range(ZOO_TIMED):
        for conv, (run, batches, gen) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = run([batches[i % len(batches)]], gen)["loss"]
            torch.cuda.synchronize()
            times[conv].append(1e3 * (time.perf_counter() - t0))
            check(_finite(float(loss[0])), f"phase 23 {conv}: loss {loss}")
    for conv, (run, _, _) in runs.items():
        t = sorted(times[conv])
        print(f"phase 23 train step {conv} (bf16, fused head, batch {BATCH}, "
              f"graph replay incl. staging): median {statistics.median(t):.3f}"
              f" ms, range {t[0]:.3f}-{t[-1]:.3f} over {len(t)}; graph pool "
              f"{run.stats()['graph_bytes']} bytes [{dev_line}]")
    del runs
    torch.cuda.empty_cache()


def conv_zoo_phase(root, work, dev_line) -> dict:
    """Phase 23: the conv zoo on phase 6's floorplans (`root`): card
    against CPU per conv, then training and serving through the CLIs and
    two refusals; returns the phase's launches of kernels 3, 11 and N1."""
    from yolat_tpu_torch.cli import test as test_cli
    from yolat_tpu_torch.cli import train as train_cli
    from yolat_tpu_torch.ops import _build

    t_start = time.perf_counter()
    _zoo_card_cpu(root, dev_line)
    _zoo_step_times(root, dev_line)
    runs = [(["--conv", c, "--fused_head_train", "true", "--dtype",
              "bfloat16"], True) for c in ZOO_TRAINED]
    runs.append((["--conv", "sage", "--act", "gelu", "--norm", "layer"],
                 False))
    total = {"folded_mlp_block_max": 0, "fused_pool_train_bwd": 0,
             "nms_fixpoint": 0}
    base = ["--data_dir", root, "--device", "cuda", "--batch_size",
            str(BATCH), "--n_filters", "64"]
    for flags, fused in runs:
        name = " ".join(flags)
        _build.reset_launch_counts()
        res = train_cli.main(base + flags + [
            "--max_steps", str(ZOO_STEPS), "--print_freq", "2",
            "--root_dir", os.path.join(work, "log_zoo")])
        c = res["launches"]
        check(res["steps"] == ZOO_STEPS and all(map(_finite, res["losses"])),
              f"phase 23 cli.train {name}: {res['steps']} steps, losses "
              f"{res['losses']}")
        want = ZOO_STEPS if fused else 0
        check(c["folded_mlp_block_max"] == want
              and c["fused_pool_train_bwd"] == want,
              f"phase 23 cli.train {name}: kernels 3 and 11 {want} times: {c}")
        check(c["nms_fixpoint"] > 0,
              f"phase 23 cli.train {name}: the evaluation ran no N1: {c}")
        _check_graphs(res, 1, f"phase 23 cli.train {name}")
        for k in total:
            total[k] += c[k]
        secs = res["train_seconds"]
        print(f"phase 23 cli.train {name}: {res['steps']} steps of batch "
              f"{BATCH}, {1e3 * secs / res['steps']:.3f} ms per step (first "
              f"step and capture included); losses "
              f"{[round(v, 4) for v in res['losses']]}; kernels 3 / 11 per "
              f"step {c['folded_mlp_block_max'] / res['steps']:g} / "
              f"{c['fused_pool_train_bwd'] / res['steps']:g}, N1 "
              f"{c['nms_fixpoint']} in the evaluation; {_graph_line(res)} "
              f"[{dev_line}]")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        table = test_cli.main(base + [f for f in flags if f not in (
            "--fused_head_train", "true", "--dtype", "bfloat16")] + [
            "--phase", "test", "--serve_mode", "flax", "--pretrained_model",
            os.path.join(res["exp_dir"], "checkpoint")])
        wall = time.perf_counter() - t0
        n1 = table["launches"]["nms_fixpoint"]
        check(n1 > 0 and len(table["map_per_th"]) == 10
              and all(map(_finite, table["map_per_th"]))
              and _finite(table["top1_acc"]),
              f"phase 23 cli.test {name}: N1 {n1}, AP {table['map_per_th']}")
        total["nms_fixpoint"] += n1
        print(f"phase 23 cli.test --serve_mode flax {name}: MAP@0.5 "
              f"{table['map_50']:.4f}, MAP@all {table['map_all']:.4f}, top1 "
              f"{table['top1_acc']:.4f}, AP per threshold "
              f"{[round(v, 4) for v in table['map_per_th']]}; N1 launches "
              f"{n1}; {1e3 * wall:.1f} ms (restore, load, pack, serve)")
    refused = []
    for argv, what in (
            (base + ["--phase", "test", "--serve_mode", "fast", "--conv",
                     "edge", "--pretrained_model", "unused"],
             test_cli.main),
            (base + ["--fused_head_train", "true", "--act", "gelu",
                     "--max_steps", "1", "--root_dir",
                     os.path.join(work, "log_zoo_refused")], train_cli.main)):
        try:
            what(argv)
            check(False, f"phase 23: {argv} ran")
        except ValueError as e:
            refused.append(str(e).split(":")[0])
    print(f"phase 23 refusals: {refused}; kernels 3 / 11 / N1 launched "
          f"{total['folded_mlp_block_max']} / {total['fused_pool_train_bwd']}"
          f" / {total['nms_fixpoint']} over the phase; phase 23: "
          f"{time.perf_counter() - t_start:.1f} s")
    return total


# phase 24: the dynamic-graph family (ops/knn, the kNN blocks of
# nn/dynamic, nn/dense_graph) on phase 6's floorplans
KNN_K = 16       # Config.k
KNN_REPS = 10    # synchronised spans per timed knn_graph
KNN_ROWS = 256   # rows held to a float64 brute force
KNN_PEAK_BYTES = 4 << 30  # a call's own peak, above what it found
KNN_EPSILON = 0.2
# card against CPU, f32, phase 23's rules: outputs of their scale, running
# statistics relative, gradients by relative Frobenius; a structurally
# zero gradient (a Linear bias feeding a train-mode BatchNorm: its f32
# noise over 1M edge rows read 0.64 relative, 4e-3 absolute) is held
# absolutely at "noise" of the block's largest gradient
KNN_BLOCK_TOL = {"out": 1e-4, "stats": 1e-4, "grad": 1e-2, "noise": 1e-4}
KNN_DRAWS = 8  # seeds of the stochastic dilated draw


def _near_tie_tol(x2, x2max, c: int):
    """A priori bound on the f32 error of the difference of two scores of
    one row: each score 2 x_i.x_j - |x_i|^2 - |x_j|^2 is within
    (C + 2) u (2 |x_i||x_j| + |x_i|^2 + |x_j|^2) of its value, u = 2^-24."""
    return 4 * (c + 2) * 2.0 ** -24 * (x2 + x2max)


def _knn_structure(ei, em, k, mask, seg, what) -> None:
    """dst = repeat(arange(N), k); no unmasked self edge; under segments
    no unmasked edge across images; every real centre keeps k real edges
    (every image has more than k real nodes)."""
    import torch

    src, dst = ei.long()
    n = mask.shape[0]
    check(torch.equal(dst, torch.arange(n, device=dst.device)
                      .repeat_interleave(k)), f"{what}: dst order")
    check(not bool((em & (src == dst)).any()),
          f"{what}: an unmasked self edge")
    if seg is not None:
        check(not bool((em & (seg[src] != seg[dst])).any()),
              f"{what}: an unmasked edge across images")
    check(bool(em.reshape(n, k)[mask].all()),
          f"{what}: a real centre with fewer than {k} real edges")


def _dist64(x64, x2, rows, cols):
    """float64 squared distances of `rows` to `cols` ([M] shared or
    [len(rows), k] per row)."""
    if cols.dim() == 1:
        return (x2[rows, None] + x2[None, cols]
                - 2 * x64[rows] @ x64[cols].t())
    return ((x64[cols] - x64[rows, None, :]) ** 2).sum(-1)


def _knn_brute(x64, ei, k, mask, seg, what) -> str:
    """On KNN_ROWS seeded real rows: the float64 distances of the picked
    neighbours, sorted, equal the row's k smallest float64 distances
    within the a-priori bound of a near tie."""
    import torch

    n, c = x64.shape
    x2 = (x64 * x64).sum(1)
    mask = mask.cpu()
    real = torch.nonzero(mask)[:, 0]
    gen = torch.Generator().manual_seed(24)
    rows = real[torch.randperm(len(real), generator=gen)[:KNN_ROWS]]
    d = _dist64(x64, x2, rows, torch.arange(n))
    d[:, ~mask] = float("inf")
    d[torch.arange(len(rows)), rows] = float("inf")
    if seg is not None:
        s = seg.cpu()
        d[s[rows][:, None] != s[None, :]] = float("inf")
    true = d.topk(k, largest=False).values.sort(dim=1).values
    src = ei[0].long().cpu().reshape(n, k)[rows]
    picked = d.gather(1, src).sort(dim=1).values
    gap = (picked - true).abs().max(dim=1).values
    tol = _near_tie_tol(x2[rows], float(x2.max()), c)
    worst = float((gap / tol).max())
    check(bool((gap <= tol).all()),
          f"{what}: brute force on {len(rows)} rows: a pick off by "
          f"{worst:.3g} of the near-tie bound")
    return (f"brute force on {len(rows)} rows: {int((gap > 0).sum())} rows "
            f"with a near tie picked apart, largest gap "
            f"{float(gap.max()):.3g} ({worst:.3g} of the bound)")


def _rows_apart(x64, sa, sb, what) -> tuple:
    """Neighbour lists [N, k] of one x from the card and the CPU: the
    rows that differ, each explained by a near tie (the sorted float64
    distances of both lists within the a-priori bound). -> (rows apart,
    largest gap, largest gap over its bound)."""
    import torch

    c = x64.shape[1]
    sa, sb = sa.long().cpu(), sb.long().cpu()
    rows = torch.nonzero((sa != sb).any(dim=1))[:, 0]
    if len(rows) == 0:
        return 0, 0.0, 0.0
    x2 = (x64 * x64).sum(1)
    da = _dist64(x64, x2, rows, sa[rows]).sort(dim=1).values
    db = _dist64(x64, x2, rows, sb[rows]).sort(dim=1).values
    gap = (da - db).abs().max(dim=1).values
    ratio = float((gap / _near_tie_tol(x2[rows], float(x2.max()), c)).max())
    check(ratio <= 1.0, f"{what}: {len(rows)} rows apart, one by {ratio:.3g} "
          "of the near-tie bound")
    return len(rows), float(gap.max()), ratio


@contextlib.contextmanager
def _given_lists(module, name: str, lists):
    """While a block runs, `module.name` (knn_graph or dense_knn) returns
    the lists computed before for its k, on the caller's device; None:
    no change."""
    if lists is None:
        yield
        return
    orig = getattr(module, name)

    def given(x, k, *args, **kwargs):
        out = lists[k]
        if isinstance(out, tuple):
            return tuple(t.to(x.device) for t in out)
        return out.to(x.device)

    setattr(module, name, given)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _block_run(block, x, args):
    """Train-mode forward and backward of sum(out * cot), cot seeded: (out,
    {name: grad} with 'x', {name: running statistic}, ms), the tensors
    copied to the CPU as float64."""
    import torch

    block.train()
    t0 = time.perf_counter()
    xt = x.clone().requires_grad_(True)
    out = block(xt, *args)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(25))
    (out * cot.to(out.device)).sum().backward()
    if x.is_cuda:
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().cpu().double() for n, p in block.named_parameters()}
    grads["x"] = xt.grad.detach().cpu().double()
    stats = {n: b.detach().cpu().double() for n, b in block.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return out.detach().cpu().double(), grads, stats, ms


def _hold_block(label, make, x, args, knn, what) -> None:
    """One seeded block in train mode on the card and on the CPU, the same
    weights and inputs. `args(device)` gives the block's other arguments;
    `knn` = (module, name, the CPU's lists, k, the card's lists equal):
    the CPU run takes its own lists (computed before from the same x), and
    where the card's lists differ the card's block is held on the CPU's
    lists after its own run."""
    import copy

    import torch

    torch.manual_seed(24)
    block = make()
    fresh = copy.deepcopy(block)
    module, name, cpu_lists, k, equal = knn or (None, None, None, 0, True)
    with _given_lists(module, name, cpu_lists):
        want = _block_run(block, x.cpu(), args("cpu"))
    got = _block_run(copy.deepcopy(fresh).to("cuda"), x, args("cuda"))
    held = ""
    if not equal:
        with _given_lists(module, name, cpu_lists):
            got = _block_run(copy.deepcopy(fresh).to("cuda"), x,
                             args("cuda"))[:3] + got[3:]
        held = f"; held on the CPU's k={k} lists (the card's differ)"
    rel = lambda a, r: float((a - r).norm() / max(float(r.norm()), 1e-30))  # noqa: E731
    out = float((got[0] - want[0]).abs().max() / want[0].abs().max())
    st = max((rel(got[2][n], v) for n, v in want[2].items()), default=0.0)
    scale = max(float(v.abs().max()) for v in want[1].values())
    floor = KNN_BLOCK_TOL["noise"] * scale
    g_err = {n: rel(got[1][n], v) for n, v in want[1].items()
             if float(v.abs().max()) >= floor}
    noise = max((float((got[1][n] - v).abs().max()) / scale
                 for n, v in want[1].items() if n not in g_err), default=0.0)
    worst = max(g_err, key=g_err.get)
    finite = all(bool(torch.isfinite(g).all()) for g in got[1].values())
    check(finite and out <= KNN_BLOCK_TOL["out"]
          and st <= KNN_BLOCK_TOL["stats"] and noise <= KNN_BLOCK_TOL["noise"]
          and g_err[worst] <= KNN_BLOCK_TOL["grad"],
          f"{what} {label}: card against CPU: output {out:.2e}, running "
          f"statistics {st:.2e}, gradient {worst} {g_err[worst]:.2e}, "
          f"noise-level gradients {noise:.2e} of {scale:.3g} (limits "
          f"{KNN_BLOCK_TOL}), finite {finite}{held}")
    print(f"{what} {label}: card against CPU, output {out:.2e} of scale, "
          f"running statistics {st:.2e}, gradients median "
          f"{statistics.median(g_err.values()):.2e}, largest "
          f"{g_err[worst]:.2e} ({worst}), noise-level {noise:.2e} of the "
          f"largest ({scale:.3g}); forward "
          f"+ backward {got[3]:.1f} ms card (first call), {want[3]:.1f} ms "
          f"CPU{held}")


def _prefix(ei, em, n, k):
    """The first k of each centre's neighbours of a knn_graph result."""
    kk = ei.shape[1] // n
    return (ei.reshape(2, n, kk)[:, :, :k].reshape(2, -1),
            em.reshape(n, kk)[:, :k].reshape(-1))


def knn_phase(root, dev_line) -> None:
    """Phase 24: on the first train batch of phase 6's floorplans (`root`),
    node features lifted to 64 channels by the seeded canonical model's
    first conv (eval mode): knn_graph over the whole batch timed and
    checked, one image card against CPU, dilated, each sparse block and
    the dense mirror in train mode card against CPU; no kernel launches."""
    import torch

    from yolat_tpu_torch.cli.profile import _trace
    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import PackedLoader, train_plans_for
    from yolat_tpu_torch.data.packing import to_device
    from yolat_tpu_torch.nn import dense_graph, dynamic
    from yolat_tpu_torch.nn.model import seeded_model
    from yolat_tpu_torch.ops import _build
    from yolat_tpu_torch.ops.knn import dilated, knn_graph
    from yolat_tpu_torch.train.loop import prepare_batch

    t_start = time.perf_counter()
    what = "phase 24"
    _build.reset_launch_counts()
    ds = SESYDDataset(root, "train", bbox_sampling_step=10)
    cfg = Config(n_classes=ds.n_classes, data_aug=False)
    b = prepare_batch(cfg, to_device(next(iter(PackedLoader(
        ds, batch_size=BATCH, prefetch=0, **train_plans_for(cfg)))), "cuda"))
    model = seeded_model(cfg).to("cuda").eval()
    with torch.no_grad():
        x = model.cls_net.head.gconv(
            b["x"], b["x"], b["edge"], b["e_attr"], b["edge_mask"],
            b["node_mask"], dst_count=b.get("dst_count"))[0].contiguous()
    mask = b["node_mask"]
    seg = b["image_id"].index_select(0, b["bbox_idx"].long())
    n, c = x.shape
    x_cpu, mask_cpu, seg_cpu = x.cpu(), mask.cpu(), seg.cpu()
    x64 = x_cpu.double()
    print(f"{what} data: {n} node rows ({int(mask.sum())} real), {c} "
          f"channels from the canonical model's first conv, k {KNN_K}, "
          f"{int(b['edge_mask'].sum())} shape edges [{dev_line}]")

    # knn_graph over the whole batch: time, peak, structure, brute force
    for label, s in (("node mask", None), ("node mask + image ids", seg)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ei, em = knn_graph(x, KNN_K, mask=mask, segment_ids=s)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = time_ms(lambda: knn_graph(x, KNN_K, mask=mask, segment_ids=s),
                     reps=KNN_REPS)
        check(peak < KNN_PEAK_BYTES,
              f"{what} knn_graph ({label}): peak {peak / 2**30:.2f} GiB")
        _knn_structure(ei, em, KNN_K, mask, s, f"{what} knn_graph ({label})")
        brute = _knn_brute(x64, ei, KNN_K, mask, s,
                           f"{what} knn_graph ({label})")
        if s is None:  # where the call's device time goes
            tr = _trace(lambda: knn_graph(x, KNN_K, mask=mask), 1)
            check(tr["device_busy_ms_per_call"] is not None,
                  f"{what}: the profiler saw no device time")
            top = "; ".join(f"{k.split('(')[0][:70]} {v:.2f}" for k, v in
                            tr["top_kernels_ms_per_call"][:8])
            print(f"{what} knn_graph (node mask) profiled: "
                  f"{tr['device_busy_ms_per_call']:.2f} ms device time in "
                  f"{tr['device_kernels_per_call']:.0f} kernels; top ms: "
                  f"{top}")
        print(f"{what} knn_graph ({label}): N {n}, k {KNN_K}, "
              f"{statistics.median(ms):.3f} ms median of {KNN_REPS} "
              f"synchronised calls ({min(ms):.3f}-{max(ms):.3f}), peak "
              f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB "
              f"held before (limit {KNN_PEAK_BYTES / 2**30:.0f}); structure "
              f"held; {brute} [{dev_line}]")

    # one image, card against CPU
    n0 = int(torch.nonzero(seg_cpu == 1)[0, 0])
    a = knn_graph(x[:n0], KNN_K, mask=mask[:n0])
    t0 = time.perf_counter()
    bb = knn_graph(x_cpu[:n0], KNN_K, mask=mask_cpu[:n0])
    t_cpu = time.perf_counter() - t0
    apart, gap, ratio = _rows_apart(
        x64[:n0], a[0][0].reshape(n0, KNN_K), bb[0][0].reshape(n0, KNN_K),
        f"{what} one image")
    same = (a[0].cpu() == bb[0]).all(dim=0).reshape(n0, KNN_K).all(dim=1)
    check(torch.equal(a[1].cpu().reshape(n0, KNN_K)[same],
                      bb[1].reshape(n0, KNN_K)[same]),
          f"{what} one image: edge masks apart on equal rows")
    print(f"{what} knn_graph one image ({n0} rows) card against CPU: "
          f"{apart} rows apart, each a near tie (largest gap {gap:.3g}, "
          f"{ratio:.3g} of the bound); CPU {t_cpu:.2f} s")

    # the lists the blocks take: the CPU's (k 16 is the first 16 of k 32)
    ei32, em32 = knn_graph(x, 2 * KNN_K, mask=mask)
    card = {KNN_K: knn_graph(x, KNN_K, mask=mask), 2 * KNN_K: (ei32, em32)}
    check(all(torch.equal(u, v) for u, v in zip(
        _prefix(ei32, em32, n, KNN_K), card[KNN_K])),
        f"{what}: the card's k {KNN_K} lists are the first {KNN_K} of k "
        f"{2 * KNN_K}")
    t0 = time.perf_counter()
    cpu32 = knn_graph(x_cpu, 2 * KNN_K, mask=mask_cpu)
    t_cpu = time.perf_counter() - t0
    cpu = {KNN_K: _prefix(*cpu32, n, KNN_K), 2 * KNN_K: cpu32}
    equal = {}
    for k, (ei_k, _) in cpu.items():
        apart, gap, ratio = _rows_apart(
            x64, card[k][0][0].reshape(n, k), ei_k[0].reshape(n, k),
            f"{what} batch k {k}")
        equal[k] = apart == 0
        print(f"{what} knn_graph batch k {k} card against CPU: {apart} rows "
              f"apart, each a near tie (largest gap {gap:.3g}, {ratio:.3g} "
              f"of the bound)")
    print(f"{what}: the CPU's knn_graph of the batch at k {2 * KNN_K}: "
          f"{t_cpu:.1f} s")

    # dilated at dilation 2 over image-segmented lists: strided, stochastic
    ei_s, em_s = knn_graph(x, 2 * KNN_K, mask=mask, segment_ids=seg)
    st_ei, st_em = dilated(ei_s, em_s, KNN_K, 2)
    check(all(torch.equal(u, v) for u, v in zip(
        (st_ei, st_em), (ei_s.reshape(2, n, -1)[:, :, ::2].reshape(2, -1),
                         em_s.reshape(n, -1)[:, ::2].reshape(-1)))),
        f"{what} dilated strided: every second neighbour")
    _knn_structure(st_ei, st_em, KNN_K, mask, seg, f"{what} dilated strided")
    branches = []
    for seed in range(24, 24 + KNN_DRAWS):
        draws = [dilated(ei_s, em_s, KNN_K, 2, stochastic=True,
                         epsilon=KNN_EPSILON,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(seed)) for _ in range(2)]
        check(all(torch.equal(u, v) for u, v in zip(*draws)),
              f"{what} dilated stochastic: one seed, one draw")
        r_ei, r_em = draws[0]
        _knn_structure(r_ei, r_em, KNN_K, mask, seg,
                       f"{what} dilated stochastic")
        # the positions kept in each real centre's 32 (distinct) candidates
        cand = ei_s[0].reshape(n, -1).cpu()[mask_cpu]
        kept = r_ei[0].reshape(n, KNN_K).cpu()[mask_cpu]
        hit = cand[:, None, :] == kept[:, :, None]
        pos = hit.float().argmax(dim=2)
        check(bool(hit.any(dim=2).all()) and bool((pos == pos[0]).all())
              and len(set(pos[0].tolist())) == KNN_K,
              f"{what} dilated stochastic: one k-subset of positions for "
              "every centre")
        branches.append(pos[0].tolist() != list(range(0, 2 * KNN_K, 2)))
    print(f"{what} dilated at dilation 2 (image ids): strided every second; "
          f"stochastic (epsilon {KNN_EPSILON}) over {KNN_DRAWS} seeds took "
          f"the random branch {sum(branches)} times, each a k-subset of "
          f"positions shared by all {len(pos)} real centres, reproducible "
          f"from its seed; structure held")

    # the sparse blocks at 64 channels on the batch
    dyn = lambda k: (dynamic, "knn_graph", cpu, k, equal[k])  # noqa: E731

    def on(dev, *ts):
        return tuple(t.to(dev) if torch.is_tensor(t) else t for t in ts)

    fam16 = cpu[KNN_K]
    fam_d2 = dilated(*cpu32, KNN_K, 2)

    def families(dev):
        zero = lambda e: torch.zeros(e.shape[1], 4)  # noqa: E731
        return ([b["edge"].to(dev), fam16[0].t().to(dev),
                 fam_d2[0].t().to(dev)],
                [b["e_attr"].to(dev), zero(fam16[0]).to(dev),
                 zero(fam_d2[0]).to(dev)],
                [b["edge_mask"].to(dev), fam16[1].to(dev),
                 fam_d2[1].to(dev)], mask.to(dev))

    graph_args = lambda dev: on(dev, b["edge"], b["e_attr"],  # noqa: E731
                                b["edge_mask"], mask)
    dyn_args = lambda dev: (mask.to(dev),)  # noqa: E731
    blocks = (
        ("DynConv edge", lambda: dynamic.DynConv(
            c, c, KNN_K, 1, "edge", norm="batch"), dyn_args, dyn(KNN_K)),
        ("DynConv mr", lambda: dynamic.DynConv(
            c, c, KNN_K, 1, "mr", norm="batch"), dyn_args, dyn(KNN_K)),
        ("PlainDynBlock edge d2", lambda: dynamic.PlainDynBlock(
            c, KNN_K, 2, "edge", norm="batch"), dyn_args, dyn(2 * KNN_K)),
        ("ResDynBlock mr", lambda: dynamic.ResDynBlock(
            c, KNN_K, 1, "mr", norm="batch"), dyn_args, dyn(KNN_K)),
        ("DenseDynBlock edge", lambda: dynamic.DenseDynBlock(
            c, c, KNN_K, 1, "edge", norm="batch"), dyn_args, dyn(KNN_K)),
        ("ResGraphBlock attr_edge", lambda: dynamic.ResGraphBlock(
            c, "attr_edge", norm="batch"), graph_args, None),
        ("DenseGraphBlock edge", lambda: dynamic.DenseGraphBlock(
            c, c, "edge", norm="batch"), graph_args, None),
        ("ResBlockMultiEdge edge (shape, kNN, kNN d2; the CPU's kNN lists)",
         lambda: dynamic.ResBlockMultiEdge(c, "edge", 3, norm="batch"),
         families, None))
    for label, make, args, knn in blocks:
        _hold_block(label, make, x, args, knn, what)

    # the dense mirror: [4, n_max, 64] with the per-image mask
    starts = [0] + [int(torch.nonzero(seg_cpu == i)[0, 0])
                    for i in range(1, BATCH)]
    ends = starts[1:] + [int(torch.nonzero(mask_cpu)[-1, 0]) + 1]
    n_max = max(e - s for s, e in zip(starts, ends))
    xd = torch.zeros(BATCH, n_max, c, device="cuda")
    md = torch.zeros(BATCH, n_max, dtype=torch.bool, device="cuda")
    for i, (s, e) in enumerate(zip(starts, ends)):
        check(bool((seg_cpu[s:e][mask_cpu[s:e]] == i).all()),
              f"{what}: image {i}'s rows are contiguous")
        xd[i, :e - s], md[i, :e - s] = x[s:e], mask[s:e]
    idx32 = dense_graph.dense_knn(xd, 2 * KNN_K, mask=md)
    dcard = {KNN_K: dense_graph.dense_knn(xd, KNN_K, mask=md),
             2 * KNN_K: idx32}
    check(torch.equal(idx32[:, :, :KNN_K], dcard[KNN_K]),
          f"{what}: dense_knn's k {KNN_K} is the first {KNN_K} of k "
          f"{2 * KNN_K}")
    t0 = time.perf_counter()
    cidx32 = dense_graph.dense_knn(xd.cpu(), 2 * KNN_K, mask=md.cpu())
    t_cpu = time.perf_counter() - t0
    dcpu = {KNN_K: cidx32[:, :, :KNN_K].contiguous(), 2 * KNN_K: cidx32}
    dequal = {}
    xd64 = xd.cpu().double()
    for k, idx in dcpu.items():
        apart = 0
        for i in range(BATCH):
            r, gap, ratio = _rows_apart(xd64[i], dcard[k][i], idx[i],
                                        f"{what} dense image {i} k {k}")
            apart += r
        dequal[k] = apart == 0
        print(f"{what} dense_knn [{BATCH}, {n_max}] k {k} card against CPU: "
              f"{apart} rows apart, each a near tie")
    print(f"{what}: the CPU's dense_knn at k {2 * KNN_K}: {t_cpu:.1f} s")
    dn = lambda k: (dense_graph, "dense_knn", dcpu, k, dequal[k])  # noqa: E731
    dense_args = lambda dev: (md.to(dev),)  # noqa: E731
    dense = (
        ("DynConv2d edge d1", lambda: dense_graph.DynConv2d(
            c, c, KNN_K, 1, "edge"), dn(KNN_K)),
        ("DynConv2d edge d2", lambda: dense_graph.DynConv2d(
            c, c, KNN_K, 2, "edge"), dn(2 * KNN_K)),
        ("DynConv2d mr d1", lambda: dense_graph.DynConv2d(
            c, c, KNN_K, 1, "mr"), dn(KNN_K)),
        ("DynConv2d mr d2", lambda: dense_graph.DynConv2d(
            c, c, KNN_K, 2, "mr"), dn(2 * KNN_K)),
        ("ResDynBlock2d edge", lambda: dense_graph.ResDynBlock2d(
            c, KNN_K, 1, "edge"), dn(KNN_K)),
        ("DenseDynBlock2d mr d2", lambda: dense_graph.DenseDynBlock2d(
            c, c, KNN_K, 2, "mr"), dn(2 * KNN_K)))
    for label, make, knn in dense:
        _hold_block(label, make, xd, dense_args, knn, what)

    launched = {k: v for k, v in _build.launch_counts.items() if v}
    check(not launched, f"{what} launched a kernel of the port: {launched}")
    print(f"{what}: no kernel of the port launched; {time.perf_counter() - t_start:.1f} s")


# phase 25: the last modules of the port: its toy batch (data/toy.py)
# served and trained on the kernels, the profiling tools
# (utils/profiling.py), and the host modules (data/legacy.py,
# data/deepgcn_utils.py, get_anchor, batch_statistics_loop, ScalarWriter)
TOY_STEPS = 4   # bf16 fused train steps on the toy batch: 1 eager, 3 graph
TOY_REPS = 20   # replays timed per reading
# the kernels on the toy batch's path, with N1: 1, 2, 3, 5, 6 (YOLaT++'s
# per-edge serving sums its curve level with it), 11
TOY_KERNELS = ("edge_window_message_sum", "folded_mlp_block_max2",
               "folded_mlp_block_max", "banded_message_sum",
               "banded_message_sum_both", "fused_pool_train_bwd",
               "nms_fixpoint")


def _toy_serve(label, cfg, model, folded, engine, batch_np, mod_tol,
               dev_line) -> float:
    """The toy batch through `make_serving_fn` (a CUDA graph, fast_bf16)
    against the eager predict core, bit for bit (phase 19's rule for the
    folded routes), and the engine's logits against the eager f32 module:
    f32 within `mod_tol` of the logits' scale, bf16 within 5e-2 of it with
    the argmax agreeing on over 97% of the real proposals (phase 13's
    rules); returns the replay's median CUDA-event time (ms)."""
    import numpy as np
    import torch

    from yolat_tpu_torch.data.packing import finalize_batch, to_device
    from yolat_tpu_torch.eval.predict import (img_slot_cap, make_predict_core,
                                              make_serving_fn)
    from yolat_tpu_torch.ops.plans import pad_plans

    staged = pad_plans(batch_np)
    kw = dict(folded=folded, bf16=True, img_slots=img_slot_cap(batch_np),
              detections_only=True)
    fn = make_serving_fn(cfg, staged, device="cuda", **kw)
    got = fn(staged).numpy()
    eager = {k: v.cpu().numpy() for k, v in make_predict_core(cfg, **kw)(
        to_device(batch_np, "cuda")).items()}
    check(_np_equal(got, eager), f"{label}: the serving graph's detections "
          "differ from the eager predict's")
    check(int(got["valid"].sum()) > 0
          and all(np.isfinite(got[k]).all() for k in ("boxes", "scores")),
          f"{label}: no finite detections")
    tb = finalize_batch(to_device(batch_np, "cuda"))
    with torch.no_grad():
        ref, _ = model(tb)
        k32, _ = engine(folded, tb)
        k16, _ = engine(folded, tb, bf16=True)
    m = tb["proposal_mask"]
    scale = max(1.0, ref[m].abs().max().item())
    e32 = (k32 - ref)[m].abs().max().item()
    e16 = (k16 - ref)[m].abs().max().item()
    agree = (k16.argmax(1)[m] == ref.argmax(1)[m]).float().mean().item()
    replay = fn.captured[0].replay
    ms = statistics.median(time_ms(replay, TOY_REPS))
    print(f"{label}: graph detections bit-identical to the eager predict "
          f"({int(got['valid'].sum())} kept); logits {tuple(ref.shape)} "
          f"(max|ref|={scale:.3e}) f32 route vs f32 module {e32:.3e} (<= "
          f"{mod_tol:g} scale), bf16 route vs f32 module {e16:.3e} (<= 5e-2 "
          f"scale), bf16 argmax agreement on {int(m.sum())} real proposals "
          f"{agree:.4f} (> 0.97); replay {ms:.4f} ms (median of {TOY_REPS} "
          f"CUDA-event spans) [{dev_line}]")
    check(bool(torch.isfinite(k16).all()) and bool(torch.isfinite(k32).all()),
          f"{label}: non-finite logits")
    check(e32 <= mod_tol * scale, f"{label}: f32 route vs the module")
    check(e16 <= 5e-2 * scale, f"{label}: bf16 route vs the f32 module")
    check(agree > 0.97, f"{label}: bf16 argmax agreement {agree}")
    return ms


def _toy_train(batch_np, dev_line) -> dict:
    """TOY_STEPS bf16 fused-head train steps on the toy batch through
    `make_scan_train_step` (the first eager, then a capture and replays):
    finite losses, kernels 3 and 11 launched; the replays' synchronised
    wall times."""
    import math

    import torch

    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.ops.plans import pad_plans
    from yolat_tpu_torch.train.loop import make_scan_train_step
    from yolat_tpu_torch.train.optim import make_optimizer
    from yolat_tpu_torch.train.trainer import init_model

    cfg = Config(n_classes=17, dtype="bfloat16", fused_head_train=True)
    model = init_model(cfg, "cuda")
    run = make_scan_train_step(cfg, model, make_optimizer(
        cfg.optimizer, model.parameters(), cfg.lr), None, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    staged = pad_plans(batch_np)
    losses, times = [], []
    for _ in range(TOY_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run([staged], gen)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(out["loss"][0]))
    check(all(math.isfinite(v) for v in losses), f"toy train losses {losses}")
    print(f"phase 25 toy train: {TOY_STEPS} bf16 fused-head steps, losses "
          f"{[round(v, 6) for v in losses]}, ms per step (synchronised wall, "
          f"staging included) {[round(t, 3) for t in times]} (the first "
          f"eager, the second the capture) [{dev_line}]")
    return {"model": model, "cfg": cfg, "step_ms": times[2:]}


def _toy_trace(work, dev_line) -> dict:
    """`scripts/traced_predict.py` in a process of its own: one eager
    canonical predict of the toy batch under `utils.profiling.trace`, the
    written trace's kernel records equal to the launches counted there."""
    out = os.path.join(work, "toy_trace")
    r = subprocess.run([sys.executable, "-m",
                        "yolat_tpu_torch.scripts.traced_predict", "--out",
                        out, "--device", "cuda"], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"traced_predict failed ({r.returncode}):\n"
          f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    want = {"edge_window_message_sum", "folded_mlp_block_max2",
            "nms_fixpoint"}
    check(set(res["launches"]) == want
          and res["records"] == res["launches"],
          f"trace records {res['records']}, launches {res['launches']}")
    print(f"phase 25 trace: {os.path.basename(res['trace'])} holds "
          f"{res['records']} kernel records for the launches "
          f"{res['launches']} of one eager canonical bf16 predict of the "
          f"toy batch (in a process of its own), and {res['cpu_ops']} CPU "
          f"ops [{dev_line}]")
    return res


def _host_modules(work, floor_root, detect, dev_line) -> None:
    """The ported host modules where they run on the card's machine: each
    LegacySVGDataset graph over phase 22's diagrams, get_anchor over the
    bench floorplans, batch_statistics_loop against batch_statistics on
    phase 21's detections, PartNetDataset's refusal, ScalarWriter's sink."""
    import importlib.util

    import numpy as np

    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.deepgcn_utils import PartNetDataset
    from yolat_tpu_torch.data.legacy import LegacySVGDataset
    from yolat_tpu_torch.eval.metrics import (batch_statistics,
                                              batch_statistics_loop)
    from yolat_tpu_torch.geom.svg_io import read_ground_truth_boxes
    from yolat_tpu_torch.utils.experiment import ScalarWriter

    diagrams = os.path.join(work, "diagrams")
    for graph in ("bezier", "shape", "bezier_edge_attr"):
        t0 = time.perf_counter()
        ds = LegacySVGDataset(diagrams, "test", graph=graph)
        items = [ds[i] for i in range(len(ds))]
        n = sum(len(it["pos"]) for it in items)
        e = sum(len(it["edge"]) for it in items)
        covered = sum(int((it["gt_obj"] >= 0).sum()) for it in items)
        check(len(items) > 0 and n > 0 and all(
            len(it["x"]) == len(it["pos"]) == len(it["gt_cls"])
            and np.isfinite(it["x"]).all() for it in items),
            f"legacy {graph}: bad items")
        print(f"phase 25 legacy {graph}: {len(items)} diagrams, {n} nodes, "
              f"{e} edges, {covered} nodes inside a GT box "
              f"({time.perf_counter() - t0:.2f} s)")
    floors = SESYDDataset(floor_root, "train")
    anchors = floors.get_anchor()
    check(anchors and all(v["count"] > 0 and len(v["median"]) == 2
                          for v in anchors.values()), f"anchors {anchors}")
    print(f"phase 25 get_anchor: {len(anchors)} classes over the "
          f"{len(floors)} bench floorplans, GT boxes per class "
          f"{ {k: v['count'] for k, v in sorted(anchors.items())} }")
    root, records = detect
    ds = SESYDDataset(root, "test")
    # the evaluator's thresholds 0.5:0.05:0.95 and lower ones; on each
    # image the seeded weights' detections, then those followed by the GT
    # boxes themselves (each GT's own box matches it at every threshold,
    # unless a detection before it took that GT)
    ths = np.round(np.arange(0.05, 0.951, 0.05), 2)
    n_tp = {"seeded": 0, "with GT": 0}
    n_det = 0
    for r in records:
        gt, lab = read_ground_truth_boxes(
            r["file"].replace(".svg", ".xml"), r["w"], r["h"], ds.class_dict)
        gt = np.asarray(gt) * np.array([r["w"], r["h"], r["w"], r["h"]])
        lab = np.asarray(lab)
        cases = {"seeded": (r["boxes"], r["scores"], r["classes"]),
                 "with GT": (np.concatenate([r["boxes"], gt]),
                             np.concatenate([r["scores"],
                                             np.full(len(gt), -1.0)]),
                             np.concatenate([r["classes"], lab]))}
        for name, det in cases.items():
            for th in ths:
                args = det + (gt, lab, float(th))
                want = batch_statistics(*args)[0]
                got = batch_statistics_loop(*args)[0]
                check(np.array_equal(got, want), "batch_statistics_loop "
                      f"differs from batch_statistics on {r['file']} "
                      f"({name}) at {th:.2f}")
                n_tp[name] += int(got.sum())
        n_det += len(r["boxes"])
    check(n_tp["with GT"] >= len(ths) * sum(
        1 for r in records), f"true positives {n_tp}")
    print(f"phase 25 batch_statistics_loop: equal to batch_statistics on "
          f"phase 21's {len(records)} images ({n_det} detections of the "
          f"seeded weights, alone and followed by the GT boxes), at IoU "
          f"0.05-0.95; true positives summed over the thresholds {n_tp}")
    if importlib.util.find_spec("h5py") is None:
        refusal = ""
        try:
            PartNetDataset(work)
            check(False, "PartNetDataset built without h5py")
        except ImportError as err:
            refusal = str(err)
        check("h5py" in refusal, f"PartNetDataset's refusal: {refusal}")
        print(f"phase 25 PartNetDataset: refused, h5py is absent "
              f"({refusal})")
    else:
        try:
            PartNetDataset(work)
            check(False, "PartNetDataset read a missing folder")
        except FileNotFoundError:
            pass
        print("phase 25 PartNetDataset: h5py present; a missing folder "
              "raises FileNotFoundError")
    log = os.path.join(work, "toy_scalars")
    os.makedirs(log, exist_ok=True)
    w = ScalarWriter(log)
    for step in range(1, 4):
        w.add_scalar("loss", 0.5 * step, step)
    w.close()
    with open(os.path.join(log, "scalars.jsonl")) as f:
        check([json.loads(line)["value"] for line in f] == [0.5, 1.0, 1.5],
              "scalars.jsonl")
    events = [p for p in os.listdir(log) if p.startswith("events.out")]
    n_rec = 0
    for p in events:  # TFRecords: length (8 bytes), its crc, data, crc
        with open(os.path.join(log, p), "rb") as f:
            data = f.read()
        i = 0
        while i < len(data):
            i += 16 + int.from_bytes(data[i:i + 8], "little")
            n_rec += 1
    check(len(events) == int(w.tensorboard)
          and (not w.tensorboard or n_rec == 4),
          f"event files {events}, {n_rec} records")
    print(f"phase 25 ScalarWriter: sinks JSON lines"
          + (f" and a TensorBoard event file ({n_rec} records: the file's "
             f"version and 3 scalars)" if w.tensorboard else
             " alone (torch.utils.tensorboard does not import here)"))


def toy_phase(work, floor_root, bench_np, detect, dev_line) -> None:
    """Phase 25: the port's toy batch (4 images, nodes padded to 512)
    served through the canonical fast_bf16 graph and the YOLaT++ per-edge
    graph (`_toy_serve`) and trained (`_toy_train`), with kernels 1, 2, 3,
    5, 6, 11 and N1 launched on that path and then held to their plain
    versions (`_served_kernels`, `_head_routes`); the profiling tools
    (`timed` against the CUDA-event median of the canonical replay of the
    bench batch, a ThroughputMeter over those replays, `trace` in a child
    process, `cost_analysis` on the CPU and its refusal on the card); the
    host modules (`_host_modules`). The models are seeded as in phases 3
    and 11 (the canonical detector from seed 0, YOLaT++ per-edge from seed
    1), full width, eval mode."""
    import torch

    from yolat_tpu_torch.data.packing import finalize_batch, to_device
    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.eval.fast_forward import (fast_forward,
                                                   fast_forward_pp,
                                                   fold_params,
                                                   fold_params_pp)
    from yolat_tpu_torch.eval.predict import (img_slot_cap, make_predict_core,
                                              make_serving_fn)
    from yolat_tpu_torch.nn.model import seeded_model
    from yolat_tpu_torch.ops import _build
    from yolat_tpu_torch.ops.plans import pad_plans
    from yolat_tpu_torch.data.toy import toy_batch
    from yolat_tpu_torch.utils.profiling import (ThroughputMeter,
                                                 cost_analysis, timed)

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    toy_np, pad = toy_batch()
    print(f"phase 25 toy batch: {pad.n_images} images, N={pad.n_nodes} node "
          f"rows ({int(toy_np['node_mask'].sum())} real), E={pad.n_edges}, "
          f"S={pad.n_super}, P={pad.n_proposals} "
          f"({int(toy_np['proposal_mask'].sum())} real proposals), built on "
          f"this machine by data/toy.py in "
          f"{time.perf_counter() - t0:.3f} s")
    cfg = Config(n_classes=17)
    model = seeded_model(cfg).to("cuda")
    folded = fold_params(model, "cuda")
    pp_cfg = Config(arch="yolat_pp", n_classes=17)
    pp_model = seeded_model(pp_cfg, seed=1).to("cuda")
    pp_folded = fold_params_pp(pp_model, "cuda")

    # the main path: serve (graph and eager) and train; launches counted
    _build.reset_launch_counts()
    serve = _toy_serve("phase 25 toy serve canonical", cfg, model, folded,
                       fast_forward, toy_np, 1e-4, dev_line)
    pp_serve = _toy_serve("phase 25 toy serve YOLaT++ per-edge", pp_cfg,
                          pp_model, pp_folded, fast_forward_pp, toy_np, 2e-4,
                          dev_line)
    train = _toy_train(toy_np, dev_line)
    torch.cuda.synchronize()
    counts = {k: _build.launch_counts[k] for k in TOY_KERNELS}
    check(all(v > 0 for v in counts.values()),
          f"phase 25: kernels 1, 2, 3, 5, 6, 11 and N1 launched: {counts}")
    print(f"phase 25 launches on the toy batch's path: {counts}")

    # each kernel held to its plain version on the toy batch's inputs
    tb = finalize_batch(to_device(toy_np, "cuda"))
    _served_kernels(cfg, folded, tb, "phase 25 toy canonical kernels",
                    {"edge_window_message_sum", "folded_mlp_block_max2",
                     "nms_fixpoint"}, dev_line)
    _served_kernels(pp_cfg, pp_folded, tb, "phase 25 toy YOLaT++ kernels",
                    {"edge_window_message_sum", "folded_mlp_block_max2",
                     "banded_message_sum", "banded_message_sum_both",
                     "nms_fixpoint"}, dev_line)
    _head_routes(train["cfg"], [tb], "phase 25 toy fused head", dev_line)

    # the profiling tools: timed against the event median of the canonical
    # replay of the bench batch, and a ThroughputMeter over the replays
    staged = pad_plans(bench_np)
    fn = make_serving_fn(cfg, staged, device="cuda", folded=folded,
                         bf16=True, img_slots=img_slot_cap(bench_np),
                         detections_only=True)
    fn(staged).numpy()
    replay = fn.captured[0].replay
    n_img = int(bench_np["n_images"])
    mean_s = timed(replay, iters=TOY_REPS, warmup=3)
    event = statistics.median(time_ms(replay, TOY_REPS))
    meter = ThroughputMeter()
    for _ in range(TOY_REPS):
        replay()
        meter.update(n_img)
    torch.cuda.synchronize()
    rate = meter.rate
    check(0 < mean_s < 10 and 0 < event < 1e4 and rate > 0,
          f"timed {mean_s} s, event median {event} ms, {rate} images/s")
    print(f"phase 25 timed: canonical fast_bf16 replay of the bench batch "
          f"({n_img} images) {1e3 * mean_s:.4f} ms mean per call "
          f"({TOY_REPS} queued, one drain), CUDA-event median "
          f"{event:.4f} ms ({TOY_REPS} spans, each waited for); "
          f"ThroughputMeter {rate:.1f} images/s over {TOY_REPS} replays "
          f"[{dev_line}]")

    _toy_trace(work, dev_line)

    # cost_analysis: the eval module's predict on the CPU, refused on the
    # card (kernel N1 launches there)
    cpu_model = seeded_model(cfg)
    cpu_predict = make_predict_core(cfg, model=cpu_model)
    t0 = time.perf_counter()
    cost = cost_analysis(cpu_predict, to_device(toy_np, "cpu"))
    cpu_s = time.perf_counter() - t0
    check(cost["flops"] > 0 and cost["bytes_accessed"] is None,
          f"cost_analysis {cost}")
    refusal = ""
    try:
        cost_analysis(make_predict_core(cfg, model=model.eval()),
                      to_device(toy_np, "cuda"))
        check(False, "cost_analysis counted a call that launched kernels")
    except RuntimeError as err:
        refusal = str(err)
    check("nms_fixpoint" in refusal, f"cost_analysis refusal: {refusal}")
    print(f"phase 25 cost_analysis: the eval module's predict of the toy "
          f"batch on the CPU {cost['flops']} flops (matmul family; "
          f"{ {k: v for k, v in cost['raw'].items()} }; {cpu_s:.2f} s); on "
          f"the card refused: {refusal.split(', whose')[0]}")

    _host_modules(work, floor_root, detect, dev_line)
    print(f"phase 25: toy serve replay canonical {serve:.4f} ms, "
          f"YOLaT++ per-edge {pp_serve:.4f} ms, toy train step "
          f"{statistics.median(train['step_ms']):.3f} ms (median of the "
          f"replays); {time.perf_counter() - t_start:.1f} s [{dev_line}]")


# phase 26: YOLaT++ under --act / --norm at full width on phase 6's
# floorplans; the conv zoo and YOLaT++ under data parallel, two gloo ranks
# on the one card
PP_ACT_NORMS = (("gelu", "layer"), ("leakyrelu", "batch"))
PP_ACT_ROUTES = {"per_edge": {}, "banded": {"pp_banded_super": True},
                 "factored": {"pp_factored_prim": True}}
# card against CPU at f32 (the factored route's prefix mean in float64 on
# both, its f32 rounding held to phase 12's bound apart): prim_at_node and
# the logits of their scale, the loss as phase 23; the gradients of each
# f32 run,
# card and CPU, against the card's float64 run (the per-edge route's for
# the banded route: the same function) by tests/torch_pp_train_common.py's
# rule, relative Frobenius 3e-2 per tensor and the gates as one vector; a
# gradient below 1e-4 on both sides (a Dense bias feeding a BatchNorm)
# absolutely at 1e-4
PP_ACT_TOL = {"prim": 1e-4, "logits": 1e-4, "loss": 1e-5, "grad": 3e-2,
              "noise": 1e-4}
PP_ACT_STEPS = 4   # cli.train --act gelu --norm layer bf16 steps
PP_ACT_TIMED = 10  # bf16 replays timed per act and norm
# phase 26 (b): tests/test_torch_dp_zoo.py's cases at full width, batch 2
# a rank (4 a step), SGD lr 1e-2, f32
DP_ZOO_CASES = {
    "gat": dict(conv="gat", act="leakyrelu"),
    "gen": dict(conv="gen"),
    "attr_edge_cf": dict(conv="attr_edge_cf"),
    "edge_layer": dict(conv="edge", norm="layer"),
    "pp_leakyrelu": dict(arch="yolat_pp", act="leakyrelu", norm="batch"),
    "edge_fused": dict(conv="edge", fused_head_train=True),
}
DP_ZOO_STEPS = 2
K78 = ("banded_gather", "banded_gather_bwd", "banded_scatter_own",
       "banded_scatter_own_bwd")


def _pp_act_run(model, batch):
    """Train-mode forward and backward of the detection loss: (prim_at_node,
    logits, loss, {name: grad}, {activation: input > 0} of every ReLU and
    LeakyReLU), tensors on the CPU in float64 (the gates bool)."""
    import torch

    from yolat_tpu_torch.nn.layers import LeakyReLU
    from yolat_tpu_torch.nn.model import detection_loss

    gates, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.ReLU, LeakyReLU)):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: gates.__setitem__(
                    name, (inp[0] > 0).cpu())))
    model.train()
    model.zero_grad()
    probes = {}
    try:
        logits = model(batch, probes=probes)[0]
    finally:
        for h in hooks:
            h.remove()
    loss = detection_loss(logits, batch["labels"],
                          batch["proposal_mask"])["loss"]
    loss.backward()
    grads = {n: p.grad.detach().cpu().double()
             for n, p in model.named_parameters()}
    return (probes["prim_at_node"].detach().cpu().double(),
            logits.detach().cpu().double(), loss.item(), grads, gates)


@contextlib.contextmanager
def _banded_calls():
    """Records (name, args, output) of every call of kernels 7, 7b, 8 and
    8b's wrappers (`ops/banded_train`'s module functions, which the
    autograd functions call) while open."""
    from yolat_tpu_torch.ops import banded_train as bt

    names = ("gather_fwd", "gather_bwd", "scatter_own_fwd", "scatter_own_bwd")
    orig = {n: getattr(bt, n) for n in names}
    calls = []

    def wrap(n):
        def fn(*args):
            out = orig[n](*args)
            calls.append((n, args, out))
            return out
        return fn

    for n in names:
        setattr(bt, n, wrap(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(bt, n, orig[n])


def _hold_banded_calls(calls, label) -> str:
    """Each recorded call of kernels 7-8b against its plain version at
    phase 14's limits: 7 and 8b exact; 7b and 8 against the float64 sum of
    the same terms within (k - 1) 2^-24 sum|terms| (+ 2^-8 |ref| for a
    bf16 output), k the most terms a node's sum adds."""
    import torch

    from yolat_tpu_torch.ops import banded_train as bt

    worst, seen = {}, set()
    for name, args, out in calls:
        seen.add(name)
        if name in ("gather_fwd", "scatter_own_bwd"):
            want = (bt.gather_plain(*args) if name == "gather_fwd"
                    else bt.scatter_own_bwd_plain(*args))
            pairs = list(zip(out, want)) if name == "gather_fwd" else [
                (out, want)]
            ratio = 0.0 if all(torch.equal(g, w) for g, w in pairs) else (
                float("inf"))
        else:
            if name == "gather_bwd":
                g_own, g_oth, own, oth, nptr, tperm, tptr, n = args
                terms = [(g_own, own.long()), (g_oth, oth.long())]
                k = int(((nptr[1:] - nptr[:-1]) + (tptr[1:] - tptr[:-1]))
                        .max())
            else:
                rows, own, nptr, n = args
                e = int(nptr[-1])
                terms = [(rows[:e], own[:e].long())]
                k = int((nptr[1:] - nptr[:-1]).max())
            want = torch.zeros(out.shape, dtype=torch.float64,
                               device=out.device)
            mass = torch.zeros_like(want)
            for t, i in terms:
                want.index_add_(0, i, t.double())
                mass.index_add_(0, i, t.double().abs())
            lim = (k - 1) * 2.0 ** -24 * mass + 1e-30
            if out.dtype == torch.bfloat16:
                lim = lim + 2.0 ** -8 * want.abs()
            ratio = ((out.double() - want).abs() / lim).max().item()
        worst[name] = max(worst.get(name, 0.0), ratio)
    check(seen == {"gather_fwd", "gather_bwd", "scatter_own_fwd",
                   "scatter_own_bwd"} and all(v <= 1.0 for v in worst.values()),
          f"{label}: kernels 7-8b against their plain versions, largest "
          f"|err| / limit {worst} over {len(calls)} calls")
    return (f"{len(calls)} calls of kernels 7-8b, largest |err| / limit "
            + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))


@contextlib.contextmanager
def _prefix_f64(seen: list):
    """While open, YOLaT++'s factored level takes its prefix mean in
    float64 (`nn/yolat_pp.prefix_member_mean` on a float64 copy of its
    input, the result in the input's type); `seen` gets each call's
    (s_f, batch, pool)."""
    from yolat_tpu_torch.nn import yolat_pp

    orig = yolat_pp.prefix_member_mean

    def wide(s_f, batch, pool):
        seen.append((s_f.detach(), batch, pool))
        m, valid = orig(s_f.double(), batch, pool)
        return m.to(s_f.dtype), valid

    yolat_pp.prefix_member_mean = wide
    try:
        yield
    finally:
        yolat_pp.prefix_member_mean = orig


def _prefix_drift(s_f, batch, pool, label) -> str:
    """Phase 12's check of the factored level's f32 prefix mean against its
    float64 value, on the train step's own input: within 8 * 2^-24 of the
    largest prefix sum."""
    import torch

    from yolat_tpu_torch.nn.yolat_pp import prefix_member_mean

    got, valid = prefix_member_mean(s_f, batch, pool)
    want, _ = prefix_member_mean(s_f.double(), batch, pool)
    err = (got.double() - want)[valid].abs().max().item()
    rows = torch.where(batch["sup_member"][:, None], s_f,
                       torch.zeros_like(s_f)).double()
    top = rows.cumsum(0).abs().max().item()
    limit = 8 * 2.0 ** -24 * top
    feat = s_f.abs().max().item()
    check(err <= limit, f"{label}: the f32 prefix mean drifts, {err:.3e} "
          f"(limit {limit:.3e})")
    return (f"f32 prefix mean against float64 {err:.3e} = {err / feat:.2e} "
            f"of the largest feature (limit {limit:.3e} = 8 * 2^-24 of the "
            f"largest prefix sum {top:.3e})")


def _pp_act_grads(got, ref, label) -> tuple:
    """tests/torch_pp_train_common.py's float64 rule: -> (largest relative
    Frobenius error of a tensor, its name, the gates' as one vector)."""
    import torch

    from yolat_tpu_torch.config import PP_GATES

    errs = {}
    for k, v in ref.items():
        g = got[k]
        if float(v.abs().max()) < 1e-4 and float(g.abs().max()) < 1e-4:
            check(float((g - v).abs().max()) <= PP_ACT_TOL["noise"],
                  f"{label}: noise-level gradient {k}")
            continue
        if k not in PP_GATES:
            errs[k] = float((g - v).norm() / v.norm())
    gv = torch.stack([got[k].reshape(()) for k in PP_GATES])
    rv = torch.stack([ref[k].reshape(()) for k in PP_GATES])
    gate = float((gv - rv).norm() / rv.norm())
    worst = max(errs, key=errs.get)
    check(errs[worst] <= PP_ACT_TOL["grad"] and gate <= PP_ACT_TOL["grad"],
          f"{label}: gradients against float64, {worst} {errs[worst]:.3e}, "
          f"gates {gate:.3e} (limit {PP_ACT_TOL['grad']})")
    return errs[worst], worst, gate


def _pp_act_card_cpu(cfg, batch_np, dev_line) -> None:
    """Phase 26 (a): the train-mode module under cfg's act and norm on its
    three routes, card against CPU at f32 and each f32 run against the
    card's float64 run; kernels 7-8b's calls of the banded route (f32, and
    a bf16 forward and backward) held to their plain versions."""
    import copy

    import torch

    from yolat_tpu_torch.data.packing import to_device
    from yolat_tpu_torch.nn.model import build_model, seeded_model
    from yolat_tpu_torch.train.loop import forward_loss, prepare_batch

    fb = {d: prepare_batch(cfg, to_device(batch_np, d))
          for d in ("cpu", "cuda")}
    fb64 = {k: (v.double() if torch.is_tensor(v) and v.dtype == torch.float32
                else v) for k, v in fb["cuda"].items()}
    base = {"per_edge": seeded_model(cfg, 26),
            "factored": seeded_model(cfg.replace(pp_factored_prim=True),
                                      26)}
    refs = {}
    for route, kw in PP_ACT_ROUTES.items():
        rcfg = cfg.replace(**kw)
        src = base["factored" if route == "factored" else "per_edge"]
        model = build_model(rcfg)
        model.load_state_dict(src.state_dict())
        if route != "banded":  # banded: the per-edge route's function
            refs[route] = _pp_act_run(copy.deepcopy(model).to("cuda")
                                      .double(), fb64)
        ref = refs["factored" if route == "factored" else "per_edge"]
        # the factored level's f32 prefix sums round at the size of the
        # running sum, in another order on each device (3.41e-3 of
        # prim_at_node's scale apart at this batch): the two devices compare
        # with that prefix mean in float64, and its f32 rounding is held to
        # its own bound (`_prefix_drift`)
        seen = []
        wide = (_prefix_f64(seen) if route == "factored"
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with _banded_calls() as calls, wide:
            got = _pp_act_run(copy.deepcopy(model).to("cuda"), fb["cuda"])
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        with (_prefix_f64([]) if route == "factored"
              else contextlib.nullcontext()):
            want = _pp_act_run(model, fb["cpu"])
        t_cpu = time.perf_counter() - t0
        pm = fb["cpu"]["proposal_mask"]
        prim = ((got[0] - want[0]).abs().max()
                / max(float(want[0].abs().max()), 1e-30)).item()
        lg = ((got[1][pm] - want[1][pm]).abs().max()
              / max(float(want[1][pm].abs().max()), 1e-30)).item()
        ls = abs(got[2] - want[2]) / abs(want[2])
        ptol = PP_ACT_TOL["prim"]
        flips = sum(int((got[4][k] != v).sum()) for k, v in want[4].items())
        gated = sum(v.numel() for v in want[4].values())
        label = f"phase 26 {cfg.act}/{cfg.norm} {route}"
        check(prim <= ptol and lg <= PP_ACT_TOL["logits"]
              and ls <= PP_ACT_TOL["loss"],
              f"{label}: card against CPU, prim_at_node {prim:.2e} (<= "
              f"{ptol}), logits {lg:.2e}, loss {ls:.2e}")
        g_card = _pp_act_grads(got[3], ref[3], f"{label} card f32")
        g_cpu = _pp_act_grads(want[3], ref[3], f"{label} CPU f32")
        text = ""
        if route == "factored":
            text = "; " + _prefix_drift(*seen[0], label)
        if route == "banded":
            text = "; " + _hold_banded_calls(calls, label + " f32")
            bcfg = rcfg.replace(dtype="bfloat16")
            m16 = copy.deepcopy(model).to("cuda")
            with _banded_calls() as calls16:
                forward_loss(bcfg, m16, fb["cuda"])["loss"].backward()
            text += "; bf16 " + _hold_banded_calls(calls16, label + " bf16")
        else:
            check(not calls, f"{label}: kernels 7-8b ran off the banded "
                  "route")
        print(f"{label}: card against CPU, prim_at_node {prim:.2e}, logits "
              f"{lg:.2e}, loss {ls:.2e}; gradients against the card's "
              f"float64 run, card {g_card[0]:.2e} ({g_card[1]}), gates "
              f"{g_card[2]:.2e}, CPU {g_cpu[0]:.2e} ({g_cpu[1]}), gates "
              f"{g_cpu[2]:.2e}; ReLU/LeakyReLU gates apart card against CPU "
              f"{flips} of {gated}{text}; forward + backward "
              f"{1e3 * t_card:.1f} ms card (first call), {1e3 * t_cpu:.1f} "
              f"ms CPU [{dev_line}]")


def _pp_act_replays(cfg, batches, dev_line) -> dict:
    """Phase 26 (a): the bf16 banded train step under cfg's act and norm as
    a graph replay (`make_scan_train_step`, scan 1, a seeded open-gate
    model): the first step eager and captured, one replay unclocked, then
    PP_ACT_TIMED replays, each one CUDA-event span (staging included);
    device busy from the profiler; the graph's pool; kernels 7-8b
    launches per replay."""
    import torch

    from yolat_tpu_torch.cli.profile import _trace
    from yolat_tpu_torch.nn.model import seeded_model
    from yolat_tpu_torch.ops import _build
    from yolat_tpu_torch.train.loop import make_scan_train_step
    from yolat_tpu_torch.train.optim import make_optimizer

    bcfg = cfg.replace(dtype="bfloat16", pp_banded_super=True)
    model = seeded_model(bcfg, 26).to("cuda")
    run = make_scan_train_step(bcfg, model, make_optimizer(
        bcfg.optimizer, model.parameters(), bcfg.lr), None, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b in batches + batches[:1]:
        run([b], gen)
    _build.reset_launch_counts()
    times, losses = [], []
    for i in range(PP_ACT_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run([batches[i % len(batches)]], gen)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(out["loss"][0]))
    per = {k: _build.launch_counts[k] / PP_ACT_TIMED for k in K78}
    busy = _trace(lambda: run([batches[0]], gen), 5)
    st = run.stats()
    label = f"phase 26 {cfg.act}/{cfg.norm} bf16 banded step"
    check(st["graphs"] >= 1 and all(v == 1 for v in per.values())
          and all(map(_finite, losses)),
          f"{label}: graphs {st}, kernels 7-8b per replay {per}, losses "
          f"{losses}")
    print(f"{label} (batch {BATCH}, 64 channels, graph replay): median "
          f"{statistics.median(times):.3f} ms, range {min(times):.3f}-"
          f"{max(times):.3f} over {len(times)} CUDA-event spans (staging "
          f"included); device busy {busy['device_busy_ms_per_call']} ms in "
          f"{busy['device_kernels_per_call']:.0f} kernels; graph pool "
          f"{st['graph_bytes']} bytes; kernels 7-8b per replay {per}; "
          f"losses {[round(v, 4) for v in losses]} [{dev_line}]")
    del run, model
    torch.cuda.empty_cache()
    return per


def _pp_act_clis(root, train_root, work, n_classes, dev_line) -> dict:
    """Phase 26 (a): cli.train --arch yolat_pp --act gelu --norm layer
    --pp_banded_super true (bf16), cli.test --serve_mode flax, cli.export_ckpt
    and cli.infer --serve_mode module on phase 4's SVGs; cli.infer
    --serve_mode fast_bf16 refuses with its flags named. Returns the
    launches over the three runs."""
    from yolat_tpu_torch.cli import export_ckpt, infer
    from yolat_tpu_torch.cli import test as test_cli
    from yolat_tpu_torch.cli import train as train_cli
    from yolat_tpu_torch.ops import _build

    flags = ["--arch", "yolat_pp", "--act", "gelu", "--norm", "layer",
             "--pp_banded_super", "true"]
    base = ["--data_dir", train_root, "--device", "cuda", "--batch_size",
            str(BATCH), "--n_filters", "64"]
    _build.reset_launch_counts()
    res = train_cli.main(base + flags + [
        "--dtype", "bfloat16", "--max_steps", str(PP_ACT_STEPS),
        "--print_freq", "2", "--root_dir", os.path.join(work, "log_pp_act")])
    c = res["launches"]
    steps, evals = res["steps"], res["eval_batches"]
    want = {"banded_gather": steps + evals, "banded_gather_bwd": steps,
            "banded_scatter_own": steps + evals,
            "banded_scatter_own_bwd": steps, "folded_mlp_block_max": 0,
            "fused_pool_train_bwd": 0}
    got = {k: c[k] for k in want}
    check(steps == PP_ACT_STEPS and all(map(_finite, res["losses"]))
          and got == want and c["nms_fixpoint"] > 0,
          f"phase 26 cli.train {' '.join(flags)}: {steps} steps, losses "
          f"{res['losses']}, launches {got} (the code implies {want}), N1 "
          f"{c['nms_fixpoint']}")
    _check_graphs(res, 1, "phase 26 cli.train")
    print(f"phase 26 cli.train {' '.join(flags)} (bf16, batch {BATCH}, 64 "
          f"channels): {steps} steps, "
          f"{1e3 * res['train_seconds'] / steps:.3f} ms per step (first "
          f"step and capture included), {evals} evaluated batches; losses "
          f"{[round(v, 4) for v in res['losses']]}; MAP@0.5 "
          f"{res['map_50']:.4f}; launches {got}, N1 {c['nms_fixpoint']}; "
          f"{_graph_line(res)} [{dev_line}]")
    ckdir = os.path.join(res["exp_dir"], "checkpoint")
    table = test_cli.main(base + flags + [
        "--phase", "test", "--serve_mode", "flax", "--pretrained_model",
        ckdir])
    tc = {k: table["launches"][k] for k in K78 + ("nms_fixpoint",)}
    check(len(table["map_per_th"]) == 10
          and all(map(_finite, table["map_per_th"]))
          and tc["banded_gather"] == tc["banded_scatter_own"] == tc[
              "nms_fixpoint"] > 0
          and tc["banded_gather_bwd"] == tc["banded_scatter_own_bwd"] == 0,
          f"phase 26 cli.test --serve_mode flax: AP {table['map_per_th']}, "
          f"launches {tc}")
    print(f"phase 26 cli.test --serve_mode flax {' '.join(flags)}: MAP@0.5 "
          f"{table['map_50']:.4f}, MAP@all {table['map_all']:.4f}, top1 "
          f"{table['top1_acc']:.4f}; launches {tc}")
    pth = os.path.join(work, "pp_act.pth")
    export_ckpt.main(["--pretrained_model", ckdir, "--n_filters", "64",
                      "--n_classes", str(n_classes), "--out", pth] + flags)
    out = os.path.join(work, "pp_act.jsonl")
    serve = ["--input_dir", root, "--pretrained_model", pth, "--out", out,
             "--device", "cuda", "--conf_th", "0.0", "--batch_size",
             str(BATCH), "--n_filters", "64"] + flags[:6]
    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        infer.main(serve + ["--serve_mode", "module"])
        rates.append(N_SVGS / (time.perf_counter() - t0))
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    check(len(recs) == N_SVGS and all("error" not in r for r in recs),
          f"phase 26 cli.infer --serve_mode module: {len(recs)} records")
    refused = ""
    try:
        infer.main(serve + ["--serve_mode", "fast_bf16"])
    except ValueError as e:
        refused = str(e)
    check("--act gelu --norm layer" in refused,
          f"phase 26 cli.infer --serve_mode fast_bf16 refused: {refused!r}")
    counts = dict(_build.launch_counts)
    print(f"phase 26 cli.infer --serve_mode module {' '.join(flags[:6])}: "
          f"{len(recs)} records, "
          f"{sum(len(r['detections']) for r in recs)} detections, "
          f"{rates[0]:.3f} SVGs/s first run, {rates[1]:.3f} second; "
          f"fast_bf16 refused: {refused.split(':')[0]}; launches over "
          f"train, test and infer { {k: counts[k] for k in K78 + ('nms_fixpoint',)} } "
          f"[{dev_line}]")
    return counts


def _torch_run(run) -> tuple:
    """A rank's ([losses], numpy state, ...) as `_dp_diff` takes it, the
    running variances left out (the unbiased correction of the global
    count)."""
    import torch

    return run[0], {k: torch.from_numpy(v) for k, v in run[1].items()
                    if not k.endswith("running_var")}


def _dp_zoo_card(train_root, n_classes, dev_line) -> dict:
    """Phase 26 (b): tests/test_torch_dp_zoo.py's cases at full width in two
    gloo ranks on the one card (`tests/torch_dp_zoo_ranks.zoo_scenarios`,
    CUDA tensors): the ranks hold one state; identical shards against the
    single-device step within phase 19's rule of its own spread; the fused
    head's kernel route against its plain route under DP (phase 20's f32
    limits on the loss and, per tensor, the 2-step update). Returns the
    fused case's per-rank launches of kernels 3 and 11."""
    import numpy as np

    from yolat_tpu_torch.nn.model import seeded_model
    from yolat_tpu_torch.parallel.launch import spawn_ranks

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_dp_zoo_ranks

    cases, states = {}, {}
    for name, kw in DP_ZOO_CASES.items():
        cases[name] = dict(n_classes=n_classes, width=64, lr=1e-2, model=kw,
                           steps=DP_ZOO_STEPS, plain=name == "edge_fused")
        model = seeded_model(torch_dp_zoo_ranks.case_config(cases[name]),
                              26)
        states[name] = {k: v.numpy().copy()
                        for k, v in model.state_dict().items()}
        del model
    t0 = time.perf_counter()
    outs = spawn_ranks(torch_dp_zoo_ranks.zoo_scenarios, DP_WORLD,
                       (train_root, DP_WORLD, cases, states, "cuda", 10,
                        BATCH // 2, False, True), join_timeout_s=600)
    secs = time.perf_counter() - t0
    check([o["n_images"] for o in outs] == [[BATCH // 2] * DP_ZOO_STEPS]
          * DP_WORLD, f"phase 26 dp: images per rank per step "
          f"{[o['n_images'] for o in outs]}")
    launches = None
    for name in DP_ZOO_CASES:
        r0, r1 = outs[0][name], outs[1][name]
        one = _dp_diff(_torch_run(r0["dp"]), _torch_run(r1["dp"]))
        d = _dp_diff(_torch_run(r0["identical"]), _torch_run(r0["single"]))
        spread = _dp_diff(_torch_run(r0["single_again"]),
                          _torch_run(r0["single"]))
        losses = r0["dp"][0]
        check(one[2]
              and all(map(_finite, losses)) and _within_spread(d, spread),
              f"phase 26 dp {name}: ranks apart {one}, identical shards "
              f"against the single-device step {d}, its spread {spread}, "
              f"losses {losses}")
        text = ""
        if name == "edge_fused":
            start = states[name]
            kern, plain = r0["dp"], r0["dp_plain"]
            loss_err = max(abs(x - y) / abs(y)
                           for x, y in zip(kern[0], plain[0]))
            upd = {}
            for k, v in plain[1].items():
                if k.endswith(("running_mean", "running_var",
                               "num_batches_tracked")):
                    continue
                du, dp = kern[1][k] - start[k], v - start[k]
                if np.abs(du).max() < 2e-6 and np.abs(dp).max() < 2e-6:
                    check(np.abs(du - dp).max() <= 2e-6,
                          f"phase 26 dp {name}: noise-level update {k}")
                    continue
                upd[k] = float(np.linalg.norm(du - dp) / np.linalg.norm(dp))
            worst = max(upd, key=upd.get)
            tol = DP_ROUTE_TOL["f32"]
            launches = kern[2]
            check(loss_err <= tol[0] and upd[worst] <= tol[1]
                  and kern[2] == (DP_ZOO_STEPS, DP_ZOO_STEPS)
                  and plain[2] == (0, 0),
                  f"phase 26 dp {name}: kernel route against plain route, "
                  f"loss {loss_err:.2e}, update {worst} {upd[worst]:.2e} "
                  f"(limits {tol}); kernels 3, 11 {kern[2]}, plain "
                  f"{plain[2]}")
            text = (f"; kernel route against plain route under DP: loss "
                    f"{loss_err:.2e}, largest update {upd[worst]:.2e} "
                    f"({worst}); kernels 3, 11 per rank {kern[2]} over "
                    f"{DP_ZOO_STEPS} steps, plain {plain[2]}")
        print(f"phase 26 dp {name} ({DP_ZOO_CASES[name]}): losses "
              f"{[round(v, 5) for v in losses]}; ranks bit-identical "
              f"{one[2]}; identical shards against the single-device step "
              f"{d[0]:.3g} / {d[1]:.3g} (bit-identical {d[2]}), single "
              f"against itself {spread[0]:.3g} / {spread[1]:.3g}; "
              f"{r0['seconds']:.1f} s on rank 0{text} [{dev_line}]")
    print(f"phase 26 dp: {len(DP_ZOO_CASES)} cases on {DP_WORLD} gloo ranks "
          f"sharing one card, batch {BATCH // 2} a rank, {DP_ZOO_STEPS} SGD "
          f"steps, f32, 64 channels; {secs:.1f} s for the ranks")
    return {"folded_mlp_block_max": launches[0],
            "fused_pool_train_bwd": launches[1]}


def pp_act_norm_phase(root, train_root, work, dev_line) -> dict:
    """Phase 26: YOLaT++ under --act gelu --norm layer and --act leakyrelu
    --norm batch at full width on phase 6's floorplans (batch 4): card
    against CPU on the three routes, kernels 7-8b held per call, the bf16
    step as a replay, the CLIs; then the conv zoo and YOLaT++ under data
    parallel. Returns each kernel's launches on the phase's paths."""
    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import PackedLoader, train_plans_for
    from yolat_tpu_torch.ops.plans import pad_plans

    t_start = time.perf_counter()
    ds = SESYDDataset(train_root, "train", bbox_sampling_step=10)
    for act, norm in PP_ACT_NORMS:
        cfg = Config(arch="yolat_pp", n_classes=ds.n_classes, act=act,
                     norm=norm, data_aug=False)
        batches = [pad_plans(b) for b in PackedLoader(
            ds, batch_size=BATCH, prefetch=0, edge_window=False,
            **train_plans_for(cfg.replace(pp_banded_super=True)))]
        _pp_act_card_cpu(cfg, batches[0], dev_line)
        _pp_act_replays(cfg, batches, dev_line)
    clis = _pp_act_clis(root, train_root, work, ds.n_classes, dev_line)
    counts = {k: clis[k] for k in K78 + ("nms_fixpoint",)}
    counts.update(_dp_zoo_card(train_root, ds.n_classes, dev_line))
    print(f"phase 26: {time.perf_counter() - t_start:.1f} s")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from yolat_tpu_torch.cli.profile import write_bench_svgs
    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import (PackedLoader, extra_plans_for,
                                             train_plans_for)
    from yolat_tpu_torch.data.packing import (CompactFile,
                                              add_dense_neighbors,
                                              finalize_batch, pack_files,
                                              to_device)
    from yolat_tpu_torch.eval.fast_forward import fold_params, fold_params_pp
    from yolat_tpu_torch.nn.model import seeded_model
    from yolat_tpu_torch.ops import _build
    from yolat_tpu_torch.ops.plans import ew_of
    from yolat_tpu_torch.train.checkpoint import save_reference_checkpoint

    # 1. device
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    dev_line = f"nvidia-smi: {smi}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {kind}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(dev_line)
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {_build.library_path()} in {time.perf_counter() - t0:.2f} s")
    tensor_core_report()
    # the host geometry library (g++ at first use; phase 18 reports it)
    from yolat_tpu_torch.geom import _native
    t0 = time.perf_counter()
    _native.load_library()
    host_build = time.perf_counter() - t0

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as work:
        root = os.path.join(work, "svgs")
        t0 = time.perf_counter()
        write_bench_svgs(root, N_SVGS)
        ds = SESYDDataset(root, "train", bbox_sampling_step=10)
        loader = PackedLoader(ds, batch_size=BATCH)
        batches = list(loader)
        check(all(ew_of(b) is not None for b in batches),
              "every packed batch carries an edge-window plan")
        print(f"data: {N_SVGS} SVGs -> {len(batches)} batches, N="
              f"{batches[0]['pos'].shape[0]} nodes, E={batches[0]['edge'].shape[0]} "
              f"edges, P={batches[0]['labels'].shape[0]} proposals per batch "
              f"({time.perf_counter() - t0:.1f} s host preprocessing)")

        cfg = Config(n_classes=ds.n_classes)
        model = seeded_model(cfg).to(dev)
        folded = fold_params(model, dev)
        batch = finalize_batch(to_device(batches[0], dev))

        # 3. kernels
        res = kernel_phase(folded, batch, dev_line)
        route_phase(model, folded, batch, dev_line)

        # 4. serve
        ckpt = os.path.join(work, "model.pth")
        torch.save({"state_dict": {k: v.cpu() for k, v in
                                   model.state_dict().items()}, "epoch": 0}, ckpt)
        counts = serve_phase(root, ckpt, work, dev_line)

        # 5. training kernels
        res.update(train_kernel_phase(model, batch, dev_line))

        # 6. train
        train_counts, train_root, train_ckpt, trained_pth = train_phase(
            work, dev_line)
        counts.update({k: train_counts[k] for k in (
            "folded_mlp_block_max", "fused_pool_train_bwd")})

        # 7-9. the window and dense layouts on the bench batch
        loads = [ds.load(i) for i in range(BATCH)]
        files = [CompactFile(f, n_classes=ds.n_classes) for f, _, _ in loads]
        packed = (files, [g for _, g, _ in loads], [w for _, _, w in loads],
                  loader.pad)
        wbatch = finalize_batch(to_device(
            pack_files(*packed, ew_transpose=True), dev))
        check(all(torch.equal(wbatch[k], batch[k]) for k in ("pos", "edge")),
              "the same bench batch")
        dbatch = finalize_batch(to_device(add_dense_neighbors(
            pack_files(*packed, edge_window=False)), dev))
        res.update(window_kernel_phase(model, wbatch, dev_line))
        window_conv_phase(model, wbatch, dev_line)
        res.update(dense_phase(folded, batch, dbatch, dev_line))

        # 10. window train, dense test
        counts.update(window_train_phase(train_root, work, dev_line))

        # 11-13. YOLaT++ serving: the bench files packed with the super-edge
        # family and the banded plans, seeded open-gate models
        pp_cfg = Config(arch="yolat_pp", n_classes=ds.n_classes)
        t0 = time.perf_counter()
        pp_np = next(iter(PackedLoader(ds, batch_size=BATCH, prefetch=0,
                                       **extra_plans_for(pp_cfg))))
        pbatch = finalize_batch(to_device(pp_np, dev))
        check(all(torch.equal(pbatch[k], batch[k]) for k in ("pos", "edge")),
              "the same bench batch")
        print(f"pp data: N={pbatch['pos'].shape[0]} nodes, "
              f"{int(pbatch['edge_mask'].sum())} shape edges, "
              f"{int(pbatch['super_mask'].sum())} super edges in "
              f"{pbatch['edge_super'].shape[0]} rows, P="
              f"{pbatch['labels'].shape[0]} proposals "
              f"({time.perf_counter() - t0:.1f} s load and pack)")
        models, ckpts = {}, {}
        for variant, factored in (("per_edge", False), ("factored", True)):
            vcfg = pp_cfg.replace(pp_factored_prim=factored)
            pmodel = seeded_model(vcfg, seed=1).to(dev)
            models[variant] = (pmodel, fold_params_pp(pmodel, dev))
            ckpts[variant] = os.path.join(work, f"pp_{variant}.pth")
            save_reference_checkpoint(pmodel, ckpts[variant])
        res.update(banded_kernel_phase(*models["per_edge"], pbatch, dev_line))
        pp_route_phase(models, pbatch, dev_line)
        pp_counts = pp_serve_phase(root, train_root, ckpts, work, dev_line)
        counts.update({k: pp_counts[k] for k in (
            "banded_message_sum", "banded_message_sum_both")})

        # 14-16. YOLaT++ training: the bench files packed as the trainer's
        # loader packs them for the banded route
        tbatch = finalize_batch(to_device(next(iter(PackedLoader(
            ds, batch_size=BATCH, prefetch=0,
            **train_plans_for(pp_cfg.replace(pp_banded_super=True))))), dev))
        check(all(torch.equal(tbatch[k], pbatch[k])
                  for k in ("pos", "edge_super", "sew_own")),
              "the same bench batch")
        res.update(banded_train_kernel_phase(models["per_edge"][0], tbatch,
                                             dev_line))
        pp_train_route_phase(models["per_edge"][0], tbatch, dev_line)
        tcounts = pp_train_phase(train_root, work, dev_line)
        counts.update({k: tcounts[k] for k in (
            "banded_gather", "banded_gather_bwd", "banded_scatter_own",
            "banded_scatter_own_bwd")})

        # 17. the edge-window decomposition probe (kernel 12)
        res["edge_window_decomp"], counts["edge_window_decomp"] = \
            decomp_phase(batch, dev_line)

        # 18. the host stage: the host library against the numpy paths,
        # the preprocessing pools
        host_phase(root, train_root, ckpt, work, host_build, dev_line)

        # 19. CUDA graphs: kernel N1 against the plain loop, the serving
        # and train graphs against the eager steps, eager against graph
        # times, the CLIs' --chunk and --scan_steps
        from yolat_tpu_torch.eval.predict import img_slot_cap
        gmodels = {"canonical": (cfg, folded),
                   "per_edge": (pp_cfg, models["per_edge"][1]),
                   "factored": (pp_cfg.replace(pp_factored_prim=True),
                                models["factored"][1])}
        res.update(nms_kernel_phase(
            batch, pbatch, (img_slot_cap(batches[0]), img_slot_cap(pp_np)),
            gmodels, dev_line))
        pp_batches = list(PackedLoader(ds, batch_size=BATCH, prefetch=0,
                                       **extra_plans_for(pp_cfg)))
        dense_batches = list(PackedLoader(ds, batch_size=BATCH, prefetch=0,
                                          edge_window=False, dense=True))
        graph_serve_checks(batches, pp_batches, dense_batches, gmodels,
                           (cfg, model.eval()), dev_line)
        tds = SESYDDataset(train_root, "train", bbox_sampling_step=10)
        routes = {
            "bf16_fused": Config(dtype="bfloat16", fused_head_train=True),
            "bf16_unfused_dropout": Config(dtype="bfloat16", dropout=0.1),
            "window": Config(dtype="bfloat16", train_layout="window"),
            "dense": Config(dtype="bfloat16", train_layout="dense"),
            "pp_per_edge": pp_cfg.replace(dtype="bfloat16"),
            "pp_banded": pp_cfg.replace(dtype="bfloat16",
                                        pp_banded_super=True),
            "pp_factored": pp_cfg.replace(dtype="bfloat16",
                                          pp_factored_prim=True)}
        route_batches = {}
        for route, rcfg in routes.items():
            rcfg = rcfg.replace(n_classes=tds.n_classes)
            window = rcfg.train_layout == "window"
            route_batches[route] = (rcfg, list(PackedLoader(
                tds, batch_size=BATCH, prefetch=0, edge_window=window,
                ew_transpose=window, dense=rcfg.train_layout == "dense",
                **train_plans_for(rcfg))))
        graph_train_checks(route_batches, dev_line)
        gres: dict = {}
        graph_times(batches[0], pp_np, route_batches, gmodels, gres, dev_line)
        fix_counts, cls_counts = graph_cli_phase(work, ckpt, train_root,
                                                 dev_line)
        counts["nms_fixpoint"] = fix_counts["nms_fixpoint"]
        counts["nms_classfix"] = cls_counts["nms_classfix"]

        # 20. data parallel: one rank over NCCL against the eager step;
        # two ranks on the one card over gloo: the DP step, DP predict and
        # the DP trainer
        t0 = time.perf_counter()
        dp_nccl_phase(route_batches, work, dev_line)
        dp_gloo_phase(root, train_root, work, dev_line)
        print(f"phase 20: {time.perf_counter() - t0:.1f} s")

        # 21. the detection CLIs: cli.detect in each serve mode,
        # cli.detect_badcase, cli.export_ckpt
        detected = detect_phase(work, train_ckpt, trained_pth, dev_line)

        # 22. diagrams and charts, written by the port's own writers:
        # trained and served through the CLIs
        t0 = time.perf_counter()
        diagram_phase(work, dev_line)
        chart_phase(work, dev_line)
        print(f"phase 22: {time.perf_counter() - t0:.1f} s")

        # 23. the conv zoo: card against CPU per conv, trained and served
        # through the CLIs
        zoo = conv_zoo_phase(train_root, work, dev_line)
        check(all(v > 0 for v in zoo.values()),
              f"phase 23 launched kernels 3, 11 and N1: {zoo}")

        # 24. the dynamic-graph family: knn_graph over the bench batch,
        # dilated, the kNN blocks and the dense mirror, card against CPU
        knn_phase(train_root, dev_line)

        # 25. the last modules: the port's toy batch served and trained on
        # the kernels, the profiling tools, the host modules
        toy_phase(work, root, batches[0], detected, dev_line)

        # 26. YOLaT++ under --act / --norm, card against CPU, the kernels
        # of its banded route, its bf16 step, its CLIs; the conv zoo and
        # YOLaT++ under data parallel, two gloo ranks on the one card
        act_norm = pp_act_norm_phase(root, train_root, work, dev_line)

    # the kernels line
    sources = {"edge_window_message_sum": (
                   "yolat_tpu_torch/csrc/edge_window.cu",
                   "yolat_tpu/ops/edge_window.py:185"),
               "folded_mlp_block_max2": (
                   "yolat_tpu_torch/csrc/block_max.cu",
                   "yolat_tpu/ops/pallas_kernels.py:274"),
               "folded_mlp_block_max": (
                   "yolat_tpu_torch/csrc/block_max.cu",
                   "yolat_tpu/ops/pallas_kernels.py:213"),
               "fused_pool_train_bwd": (
                   "yolat_tpu_torch/csrc/fused_pool_train.cu",
                   "yolat_tpu/ops/fused_pool_train.py:198"),
               "fused_dense_message": (
                   "yolat_tpu_torch/csrc/dense_message.cu",
                   "yolat_tpu/ops/pallas_kernels.py:82"),
               "ew_pair_features": (
                   "yolat_tpu_torch/csrc/edge_window_train.cu",
                   "yolat_tpu/ops/edge_window_train.py:127"),
               "ew_pair_features_bwd": (
                   "yolat_tpu_torch/csrc/edge_window_train.cu",
                   "yolat_tpu/ops/edge_window_train.py:153"),
               "ew_window_segment_sum": (
                   "yolat_tpu_torch/csrc/edge_window_train.cu",
                   "yolat_tpu/ops/edge_window_train.py:245"),
               "ew_window_segment_sum_bwd": (
                   "yolat_tpu_torch/csrc/edge_window_train.cu",
                   "yolat_tpu/ops/edge_window_train.py:270"),
               "banded_message_sum": (
                   "yolat_tpu_torch/csrc/banded_message.cu",
                   "yolat_tpu/ops/banded_message.py:262"),
               "banded_message_sum_both": (
                   "yolat_tpu_torch/csrc/banded_message.cu",
                   "yolat_tpu/ops/banded_message.py:417"),
               "banded_gather": (
                   "yolat_tpu_torch/csrc/banded_train.cu",
                   "yolat_tpu/ops/banded_train.py:143"),
               "banded_gather_bwd": (
                   "yolat_tpu_torch/csrc/banded_train.cu",
                   "yolat_tpu/ops/banded_train.py:294"),
               "banded_scatter_own": (
                   "yolat_tpu_torch/csrc/edge_window_train.cu",
                   "yolat_tpu/ops/banded_train.py:257"),
               "banded_scatter_own_bwd": (
                   "yolat_tpu_torch/csrc/edge_window_train.cu",
                   "yolat_tpu/ops/banded_train.py:319"),
               "edge_window_decomp": (
                   "yolat_tpu_torch/csrc/edge_window.cu",
                   "scripts/ew_kernel_decomp.py:105"),
               # N1: no TPU kernel; XLA's lax.while_loop on the TPU
               "nms_fixpoint": (
                   "yolat_tpu_torch/csrc/nms_fixpoint.cu",
                   "yolat_tpu/ops/nms.py:211"),
               "nms_classfix": (
                   "yolat_tpu_torch/csrc/nms_fixpoint.cu",
                   "yolat_tpu/ops/nms.py:297")}
    check(all(counts[k] > 0 for k in sources),
          f"every kernel was launched on its path: {counts}")
    kernels = [{"name": k, "route": "cuda", "source": sources[k][0],
                "replaces": sources[k][1], "launches": counts[k],
                "max_abs_err": res[k]["max_abs_err"], "ms": res[k]["ms"],
                "device_ms": res[k]["device_ms"],
                # rows 7-10b: the profiler's L2-flushed time (their queued
                # span is queued_ms); the others: the queued span
                "device_ms_by": ("profiler_flushed" if "queued_ms" in res[k]
                                 else "queued_span"),
                "plain_ms": res[k]["plain_ms"],
                "bound_ms": res[k]["bound_ms"], "bound_by": res[k]["bound_by"],
                "library_ms": res[k].get("library_ms"),
                **{x: res[k][x] for x in ("queued_ms", "warm_ms",
                                          "library_device_ms")
                   if x in res[k]},
                **({"conv_zoo_launches": zoo[k]} if k in zoo else {}),
                **({"act_norm_launches": act_norm[k]} if k in act_norm
                   else {})}
               for k in sources]
    print(json.dumps({"kernels": kernels}))
    print(dev_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
