#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (sam2unet_torch): inference at
hiera_l @ 352 and hiera_s @ 960 (the test CLI's defaults), training at
hiera_l @ 352 and at hiera_s @ 960 (the train CLI's defaults), the SAM2
image and video predictors at sam2_hiera_s @ 1024 (the defaults of
build_sam2_image_predictor and build_sam2_video_predictor), and at
sam2_hiera_t the points of the JAX package's hardware scripts: the video
predictor at 512 px under the "pallas" attention backend
(scripts/smoke_video.py) and the automatic mask generator at 1024 px
(scripts/bench_amg.py); the train CLI whole at its defaults; export and
deploy at the fork's defaults; the JAX package's checkpoints and
tooling there (Orbax directories, the FLOP audit, the profiler); the
train CLI across ranks (data parallelism with SyncBN, a resume from the
JAX package's train state layout); the multi-device dry run
(tensor and sequence parallelism) on four ranks of the one card; and the
JAX package's kernel entry points that no model calls (K15, K16, K2's
other modes, the masked whole-grid K6 / K7) at full width; and the backward
modes of K7 and K12 that a trainable trunk and an eval-mode gradient reach
(K7's weight-gradient mode, K13a / K13b); and every head dim the JAX
attention kernels take (the window family at its kernel tests' head dim 12,
K10 / K11 / K14 at 12, 128, 264, K11 at the video memory attention's 256,
K11's bf16 passes on the Hopper kernels at head dims 56-256);
and every width its MLP, LN-matmul and window kernels take (widths that are
not a multiple of 8, LN rows past 2048).

    python3 chip_smoke.py            # every phase, as the acceptance run does
    python3 chip_smoke.py --phases build,kernels --batch 2 --batch960 2 \
        --batch_train 2 --batch_train960 2
    python3 chip_smoke.py --phases build,profile   # device time by kernel
    python3 chip_smoke.py --paths s960train        # one path
    python3 chip_smoke.py --paths s1024sam2        # the SAM2 predictor
    python3 chip_smoke.py --paths s1024video       # the video predictor
    python3 chip_smoke.py --paths t512video,t1024amg   # hiera_t: video, AMG
    python3 chip_smoke.py --paths s960cli          # the train CLI whole
    python3 chip_smoke.py --paths s960deploy       # export and deploy
    python3 chip_smoke.py --paths s960interop      # checkpoints and tooling
    python3 chip_smoke.py --paths s960dp           # data parallelism
    python3 chip_smoke.py --paths s352mc           # dryrun_multichip(4)
    python3 chip_smoke.py --paths opsapi           # the kernel entry points
    python3 chip_smoke.py --paths bwdmodes         # K7 weight-grad, K13
    python3 chip_smoke.py --paths headdims         # any head dim
    python3 chip_smoke.py --paths widths           # any width

Phases, one line each, for each path of --paths (l352, s960, then the
training paths l352train and s960train, listed after these):
  1. the card (nvidia-smi name and power limit); build the CUDA kernels
     from csrc/ with nvcc (one process per source, all at once) and print
     the build time; the Hopper kernels' registers, spills and shared
     memory (K11's dq and dk/dv passes, K10 / K14's forward, K1 / K2's GEMM
     and adapter in csrc/mlp_sm90.cu), failing on a spill, on ptxas
     serializing their wgmma, or on ptxas injecting a warpgroup.arrive
     (C7519) into csrc/mlp_sm90.cu's or csrc/block_bwd_sm90.cu's kernels;
     K3's shared-memory plan at each main-path width, K7's query-side
     and dk/dv blocks and K5 / K9's small-window pass by window, mode and
     head-dim instance (csrc/block_bwd_sm90.cu).
  2. every kernel of the path against its plain PyTorch version on the
     card at the path's main-path shapes: at 352 K1 tail, K1 adapter, K4,
     K6 n_pad=0, K6 n_pad>0, K6 global S=484, K8; at 960 K1 tail, K1
     adapter, K4, K8, K10 (o and lse) and K12. bf16 at every shape (timed
     at one representative shape each, with the bound from the call's
     bytes and operations, and SDPA's time beside K10 and K14), and fp32
     once at a batch of at most 2. TF32 is off. Each bf16 K10 / K14 call
     runs the route its row names: csrc/flash_attention_fwd_sm90.cu (the
     Hopper forward) or, past its head dims and views, csrc/attention_any.cu;
     each bf16 K1 / K2 call at widths that are multiples of 8 runs
     csrc/mlp_sm90.cu (every path; GELU on K1's output only in its adapter
     kernel, hidden 32), its timed rows beside the mma.sync route
     they replaced (csrc/fused_mlp.cu, csrc/fused_mlp_bwd.cu; the time in
     parentheses) and, on a line before, their products in cuBLAS
     (torch.nn.functional.linear / torch.matmul, called by this script
     only). s960train's phase also calls csrc/mlp_sm90.cu's entry points at
     200 rows and every main-path width into outputs longer than M that
     hold a sentinel: no row past M may change. Each bf16 K3 call (C % 8
     == 0 up to 1408, hidden 32) and each bf16 dx-only unmasked K7 call (c
     and head dim multiples of 8, head dim up to 128) runs
     csrc/block_bwd_sm90.cu, its timed rows beside the route it replaced
     (csrc/fused_mlp_bwd.cu, csrc/fused_attention_block_bwd.cu; the time
     in parentheses); so does each bf16 K5 and K9 call on windows of 4 or
     8 at such widths and head dims, every l352train and s960train shape
     of theirs timed beside the route before (csrc/fused_attention_block_bwd.cu,
     csrc/fused_transition_bwd.cu). On l352train and s960train each of
     these K3 / K5 / K7 / K9 rows prints a `[device]` line, its device time
     by kernel and its launches a call; a row whose profile reads part of
     its calls' kernels is profiled again, and fails after four.
  3. the main path: the test CLI (sam2unet_torch.cli.test_cli.main) on a
     synthetic 4-image dataset with a seeded random SAM2UNet checkpoint of
     the path's trunk, --size 352 --model_cfg sam2_hiera_l, or the CLI's
     defaults (--size 960 --model_cfg sam2_hiera_s), --bf16 --batch_size 4;
     PNG checks; launch counts per forward (counters set to 0 just before
     the run and read just after); the same batch under force_plain() on
     the card.
  4. forward throughput, bf16, CUDA events after warm-up: hiera_l@352 at
     --batch (32), hiera_s@960 at --batch960 (16, the fork's batch at 960).
The training paths, l352train (hiera_l@352) and s960train (hiera_s@960),
bf16 over fp32 master parameters, the trunk frozen:
  2. every backward kernel (K2, K3, K5, K7, K9, and at 960 the forward of
     the valid groups, K6 at head dim 96 with and without the pad key, and
     K11: the delta pass, the dq pass, the dk/dv pass and the three
     together, on strided views of one (rows, 3c) buffer at (16, 3600, 4,
     96), on a pair of ragged lengths, and at every width of the Hopper
     kernels' instances (head dims 56-256, S 1000 against 1337, strided
     views), against `plain_flash_attention_bwd`, with the backward of
     SDPA as the library's time; their build reports each instance's
     registers, spills and shared memory) against autograd through its plain
     version on the card at the training step's shapes at --batch_train /
     --batch_train960 (16), bf16 (K9 also on a case of exact ties; K9's
     max-pool routing may send a near-tie elsewhere than the plain
     version's recomputed forward does, so up to 1e-3 of its tokens may
     differ in bf16, each within 0.1 of max |plain|) and fp32 once (K9's
     at the full batch, on an input without near-ties); timed with the
     bound counting the recomputed forward.
  3. the main path: the train CLI (sam2unet_torch.cli.train_cli.main) on a
     synthetic set of 16 train and 4 test images from the seeded random
     checkpoint, --size 352 --model_cfg sam2_hiera_l --bf16 --batch_size 8
     --epoch 2, or for s960train the CLI's defaults (hiera_s, 960, batch
     16) with --bf16 --epoch 2 --save_train_state and then --resume from
     the saved state with --epoch 3 (epochs 0-2 again from the saved step,
     the first rate the schedule's there, as the JAX CLI resumes): finite
     losses that fall, every trainable parameter moved, every frozen
     one bit-identical, the epoch reports in log.txt, a checkpoint that the
     test CLI loads strictly and runs; launches per train step of every
     wrapper (counters set to 0 just before, read just after); then one
     step's loss and trainable gradients, kernels against plain versions
     on the same parameters and batch (batch 4, at 960 batch 2;
     --step_seeds): in fp32
     every leaf to correlation 0.9999 and 1e-2 of max |plain|; in bf16 the
     loss to 1e-2 and each leaf's gradient about as close to the fp32 one
     as the plain bf16 version's of the same leaf (rounding alone
     decorrelates the deepest leaves, plain and kernels alike). At 960 also
     --remat's block checkpointing against the model without it: the same
     loss and the same trainable gradients (under deterministic algorithms,
     where two identical steps agree), and its launch counts.
  4. train-step throughput, bf16, batch --batch_train / --batch_train960,
     CUDA events over 5 steps after 2 warm-up steps, and peak memory; at
     960 also with --remat. A batch that does not fit the card's memory is
     reported with its size and halved.
The SAM2 predictor path, s1024sam2 (sam2_hiera_s @ 1024 through
build_sam2_image_predictor, bf16, seeded random weights):
  2. its kernels at the predictor's shapes (one image a set_image): K1 on
     the block tails, K4, K8, K10 on the 4096-token global blocks and on the
     mask decoder's 16 tokens x 4096 keys at head dim 16, K12 on 64x64 w14
     and 32x32 w7; and K14 at every shape its paths give it under the
     "pallas" attention backend (this trunk's and SAM2-UNet's stage 3->4
     transitions, the decoder's 8-token attentions), timed at SAM2-UNet's
     960 transition beside SDPA.
  3. set_image on a seeded 720x960 image, predict with one point, a box,
     points and a box, 9 points (16 tokens: the decoder's K10), multimask
     on and off, a mask input, set_image_batch + predict_batch over 2
     images: shapes, ious in [0, 1], masks not empty, the launches of each
     call against the table in PATHS; the embedding and low-res logits
     against force_plain(); then under set_attention_impl("pallas"): K14's
     launches per set_image and per predict, the same outputs against the
     default backend, and SAM2-UNet's hiera_s@960 forward (batch 16) with
     K14 at its stage 3->4 transition against the default backend.
  4. set_image ms (host clock) and its forward alone, steady-state
     one-point predict ms (device and host postprocess), peak memory.
The SAM2 video path, s1024video (sam2_hiera_s @ 1024 through
build_sam2_video_predictor, bf16, the predictor's weights above with the
object-score head's last bias at +10 so that tracked objects stay present):
  2. the image encoder's kernels at one frame (K10 at head dim 96 only)
     and K10 at head dim 256 at (2, 4096, 1, 256), the memory attention's
     self-attention at two objects, timed beside SDPA.
  3. 12 seeded 480x640 frames of noise with two moving discs: init_state,
     a point on each disc, a mask on the second, propagate_in_video
     forward and then in reverse from the last frame; the launches of each
     call and each yielded frame (a tracked frame: set_image's and K10 at
     head dim 256 x4; the prompts and the prompted frame none); the masks'
     shapes and values; the video-res logits of every step against the
     same flow under force_plain() and on the host-gathered bank.
  4. add_new_points ms (host clock), steady-state ms per tracked frame
     (CUDA events, masks to the host), frames/s, peak memory, and one call
     of the memory attention's masked cross-attention (the einsum form).
The video path t512video (sam2_hiera_t @ 512 through
build_sam2_video_predictor with SAM2Config(image_size=512), bf16, the same
weights' recipe, the object-score bias at +10), as s1024video on six
seeded 240x320 frames (scripts/smoke_video.py's discs and prompts; reverse
from frame 3, then a drain of packed masks), with these differences:
  2. the encoder's kernels at one frame (K1, K4, K8, K6 on the valid
     groups; the 1024-token global blocks launch nothing), K14 at head dim
     256 at (2, 1024, 1, 256), the memory attention's self-attention under
     "pallas", timed beside SDPA, and K14 at the decoder's 7-token shapes
     and the 32x32 w14 transition.
  3. the flow under set_attention_impl("pallas"): launches of each call
     (K14 +1 per image, 7 per decode, 4 at head dim 256 per tracked
     frame); the packed drain equal to the forward pass's masks; kernels
     vs plain, device bank vs host bank, and "pallas" vs the default
     backend (its launches: no K14) on the video-res logits.
  4. ms per tracked frame under "pallas" and under the default backend.
The AMG path t1024amg (sam2_hiera_t @ 1024 through build_sam2, bf16,
seeded weights; SAM2AutomaticMaskGenerator with 16 points per side, the
iou and stability filters at 0, on bench_amg.py's 480x640 image):
  2. the encoder's kernels at one image (K1, K4, K8, K10, K12).
  3. generate: launches (one set_image; the decodes none), the records;
     each point batch's _predict_amg: the device postprocess against the
     host one on the same logits (masks equal but within 1e-4 of the
     threshold), and kernels vs plain (ious and low-res logits to the
     limits above, masks and stability scores within their logits' gap).
  4. generate wall time (host clock), first call and steady, peak memory.
The train CLI path s960cli (its defaults: sam2_hiera_s, 960, batch 16;
--bf16, seeded random checkpoint; 240 synthetic training JPEGs, so one
epoch is 15 steps, and 16 eval images):
  3. which loader decodes the JPEGs (the native libjpeg one where it
     builds, else PIL, and why); train_cli --epoch 1 --full_eval
     --profile_dir: its epoch img/s, the host evaluation's mIoU and time,
     the launches (s960train's per step, s960's per eval forward; the
     shapes are held by those paths' entries); the trace of steps 10-14:
     its five most expensive kernels by device time (a hand-written
     kernel's device kernels under its C entry point's name), and K1, K2,
     K3, K7, K10 and K11 must each show device time on their Hopper entry
     points, none on the bf16 entry points those replaced; the device
     evaluation of
     the checkpoint; the test CLI on it and the eval CLI on its PNGs; the
     loader A/B: the run again, native, PIL, native, PIL, epoch img/s.
The export and deploy path s960deploy (the export CLI's and the deploy
CLI's defaults: sam2_hiera_s, 960; a seeded random checkpoint, its head
bias at logit(0.1); 16 synthetic images of mixed aspect ratio with masks):
  2. the kernels of the fp32 forward at batch 1 (the deployed dtype, whose
     route differs from bf16's: K12's gate refuses 60x60 w14 at 4-byte
     items, so stage 3 runs on the window groups): K1, K4, K8, K6, K10 and
     K12, in bf16 (timed) and in fp32 at every shape.
  3. export_cli --device cuda: the .pt2 program, traced under force_plain,
     verified against the native forward with the kernels (max diff,
     export seconds); deploy_cli over the 16 images with their masks
     (average process_time, images/s, the evaluation); the segmenter's
     run() called once directly, no process_time of 0 (its zero-mask
     fallback), and the program's logits and masks against the native
     module's with the kernels through the same pre and post process (the
     masks to DEPLOY_MASK_SHARE of the pixels); the ONNX leg: the export
     at 960, the export, its check (one forward of the ONNX runtime) and
     the 16 images at 352 px (onnxruntime where installed, else the numpy
     runner; the line says which); the fold-BN A/B of the native forward at 960 with
     the kernels, ms and the max gap; launches = s960's per forward x the
     native forwards (the artifacts launch none).
The checkpoint and tooling path s960interop (hiera_s, 960; a seeded random
checkpoint; its launches are s960's per forward and s960train's per step,
at shapes those paths' entries hold):
  3. the checkpoint through state_dict_to_jax and save_variables into an
     Orbax directory and back through load_any_checkpoint, every tensor
     bit for bit (bytes on disk, write and read seconds); the test CLI at
     its defaults (--bf16 --batch_size 4) over 16 synthetic images from
     the directory and from the .pth, byte-identical PNGs (images/s); the
     FLOP audit at hiera_s@960 and hiera_l@352, both modes (its seconds,
     and the achieved TFLOP/s of this run's l352, s960 and s960train
     throughput); utils/profile_model.py --mode infer and --mode train at
     batch 16, 3 steps each: the top 10 kernels, and each entry point's
     calls in the trace = s960's per forward or s960train's per step x 3;
     the launches of the whole path against the same tables.
The data-parallel path s960dp (the train CLI's defaults: hiera_s, 960,
global batch 16; bf16, the seeded random checkpoint; each rank a process
started by torch.distributed.run on the one card):
  3. (a) one process: step 1's gradients and BatchNorm statistics in fp32
     (the reference), then 2 bf16 train steps; 2 ranks over gloo (NCCL
     refuses two ranks on one device; the line says which backend ran),
     8 rows each, SyncBN, the same 2 steps: each step's global loss, step
     1's gradient of every trainable leaf against one process's (1 - corr
     and max relative gap; both runs' gaps to fp32, 1 - corr, max relative
     gap and the norm's gap, within s960train's bf16 bounds), the BatchNorm statistics' max gap, the ranks' launches
     (s960train's per step each), step ms against one process's and the
     all-reduces' share of a timed extra step; (b) train_cli under
     torch.distributed.run on 2 ranks, --bf16 --epoch 1 --save_train_state
     --shard_map over 32 synthetic images (2 steps) and 4 eval images:
     every write under the save path from rank 0 (an audit hook), the
     JAX-layout train state restored with the moments bit-equal to the
     saved optimizer's, then --resume from it with --epoch 2: its first
     rate the schedule's at the saved step. (A step (c), world 1 over
     NCCL, is cut for the script's time limit: ROADMAP.md, Card budget.)
The multi-device path s352mc (the port's dryrun_multichip(4) with
DRYRUN_FULL=1: four ranks on the one card over gloo, meshes (4, 1) and
(2, 2), fp32; and entry()):
  2. every kernel of the dry run's phases at their shapes per rank (tiny
     at 2 rows, hiera_s@352 and hiera_l@256 at 1 row; the train phases'
     forward and backward kernels, the SP forward's window groups) and of
     entry()'s bf16 forward, bf16 and fp32 at every shape.
  3. entry() on the card (bf16, its three heads' shapes, finite); the five
     phases, each rank's records (counters set to 0 just before each
     phase, read just after; every kernel of the path must launch), each
     phase's wall time beside the card; against one process on the card
     with the same parameters and batch: the tiny TP step's and the two
     hiera_s@352 steps' loss, trainable gradients, parameters after AdamW
     and BatchNorm statistics at the CPU tests' one-step tolerances, a
     rank's bytes of the split leaves and their moments half of theirs
     whole, the SP forward's three heads against the dense forward (fp32,
     2e-5 of the max) with 3 ring calls a rank; then 4 ranks again (this
     script's own workers): ring_sdpa's gradient at (1, 484, 4, 96) over
     the model axis against dense autograd, and the SP forward in bf16
     against the dense fp32 forward within twice the dense bf16 forward's
     own gap plus 0.01 (the bound it measures and prints).
The kernel entry point path opsapi (the JAX package's functions and module
options that no model calls, seeded random weights, bf16):
  2. K15 and K16 on the rows of every block width of hiera_l@352 (batch
     --batch) and hiera_s@960 (half of it), both ways of add_bias; K1 and
     K2 in the frozen `fused_mlp`'s modes (LN without the residual, the
     residual without LN, neither) at hiera_s@960's stage 3 and 4 tails;
     the masked K6 and K7 on hiera_l@352's 22x22 w16 and 11x11 w8 grids;
     bf16 at every shape, fp32 once (below the fp32 weight gate).
  3. the functions and modules as a user calls them: fused_ln_matmul and
     fused_ln_qkv at those shapes, MultiScaleAttention(x, ln_w, ln_b) of a
     hiera_l@352 stage-3 block, MLP(fused=True) and fused_mlp with frozen
     weights and x requiring a gradient, the masked fused_window_block
     forward and backward with grid_window_mask's mask, and fp32 at batch
     2 on both sides of the weight gate; the launches of the run against
     PATHS' table (the fp32 calls past the gate none); then K16 against
     K15's column blocks bit for bit, the fused-LN attention against the
     call on LN(x), outputs and dx against the plain versions, the masked
     blocks against the valid-group route (window_partition_valid + K6
     with n_pad).
The backward-mode path bwdmodes (seeded random weights):
  2. K7's weight-gradient mode (dx and all six weight gradients) at
     hiera_l@352 stage 3's pad-free group (16, 256, 576) 8 heads,
     hiera_s@960 stage 3's 56x56 group (256, 196, 384) and the 256-token
     global blocks of SAM2's hiera_s trunk at 256 px (4, 256, 384), each
     again in fp32 at a batch of 2; K13b at (16, 60, 60, 384) w14 and (1,
     64, 64, 384) w14, K13a at (16, 30, 30, 768) w7 and (1, 32, 32, 768)
     w7, and in fp32 at (2, 30, 30, 768) w7; every gradient against
     autograd through the plain version, each call's launch the JAX
     package's kernel (`dispatch.variants`), every bf16 shape timed.
  3. (b) `Hiera(hiera_l, use_adapters=False)` at 352 in training, batch 4:
     the gradient of a fixed scalar of the four outputs (their mean
     squared distances to seeded targets) with respect to every
     parameter, kernels against force_plain(), bf16 and fp32, held
     as s960train holds a step; launches per step (K7's weight-gradient
     mode 32: stage 3's windowed blocks, one pad-free 16x16 group each);
     (c) `SAM2UNet` (hiera_s) at 960 in eval mode, batch 2: the structure
     loss's gradient with respect to the trainable set through the frozen
     trunk, the same way; launches per backward (K13b 7 on the 60x60 w14
     blocks, K13a 1 on the 30x30 w7 block, beside K5, K9, K11, K2, K3).
The head-dim path headdims (seeded random weights; the kernels of
csrc/attention_any*.cu, which take every head dim the JAX kernels take, and
in bf16 at d % 8 == 0 up to 256 K10 / K14 on csrc/flash_attention_fwd_sm90.cu
and K11's passes on csrc/flash_attention_bwd_sm90.cu):
  2. each window-family mode at the JAX kernel tests' head dim 12 (c 24
     over 2 heads, the transition 24 -> 48 over 4): K4 and K5 on 16x16
     w8, K12 and K13 on 30x30 w8, K6 with and without the pad key, K7,
     the masked K6 / K7 on 12x12 w8, K7's weight-gradient mode, K8 and K9;
     K10 (o and lse) and K11 under autograd (`flash_attention`: K10, then
     the delta, dq and dk/dv passes) at (2, 320, 2, d) for d 12, 128,
     264, K11 at the video memory attention's (2, 4096, 1, 256) and at
     (2, 1000 against 1337 keys, 2, d) for d 56-256 (the Hopper kernels'
     instances: d padded to 64, 96, 128, 256); K14 over
     49 -> 196 tokens at those d; each against its plain version in bf16
     and fp32, each call's launches the JAX route's. Timed (every bf16
     shape): K6 and K7 at 32 x 256 x 576 over 48, 4, 2 heads; K10 and the
     whole K11 at (4, 3600, ., .) with c 384 as 32 x 12, 3 x 128, 1 x 384;
     K14 at (400, 49 -> 196) with c 768 as 64 x 12, 6 x 128, 2 x 384; K11
     at (2, 4096, 1, 256); SDPA (its backward for K11) beside them.
  3. one bf16 call of each of those shapes (`headdims_main_phase`), the
     counters at 0 just before and read just after: the run's launches by
     shape against the launches each shape names.
The width path widths (seeded random weights; the LN and GEMM passes of
csrc/gemm_any.cu, which take every width the JAX kernels take):
  2. K1 in its JAX modes, K2 and K3 at C 12, 13, 20 and 2056, `fused_mlp`
     under autograd (K1, then K2 or K3); K15 / K16 at the JAX test's 80 x
     12 -> 36, K15 at 13 -> 20 and 2060 -> 24, K16 under autograd; K6 / K7
     in every mode at c 26, 20 and 2064 on (2 windows, 16 tokens); K4 / K5
     and K12 / K13 at c 26; K8 / K9 at 20 -> 40, 2056 -> 48 and 20 -> 27;
     each against its plain version in bf16 and fp32, each call's
     launches the JAX route's. Timed (every bf16 shape): K1 at 15488 x 572
     and 576 (hidden 4c) and 4096 x 2056 (hidden 8224), K15 / K16 at 572
     -> 1716 and 576 -> 1728, K2 / K3 at 7744 x 572 and 576, K6 / K7 at 32
     x 256 x 580 and 576 over 4 heads, K8 at (32, 88, 88, 148) -> 296 and
     144 -> 288 over 2 heads (and over 4).
  3. one bf16 call of each of those shapes (`widths_main_phase`) and its
     launches by shape; torch.profiler over one ragged call of each
     family (gemm_any's kernels present) and one hiera_l@352 forward at
     batch 1 (none present).
The throughput phase of l352, l352train and s960train also times the step
with the persistent window groups and per block (SAM2UNET_DISABLE_GROUPED),
alternating, for the record.
`--phases profile` gives the device time by kernel of one forward, train
step, set_image, predict, tracked frame or generate, and its idle share
(1 - the union of the device kernels' intervals over their span: the
entry points' GPU user annotations are not kernels); the s960 and
s1024video profiles fail unless K10 ran on the Hopper forward and none of
its CUDA-core entry points ran, and t512video's K14 rows profile one call
at each held shape and fail the same way for K14; the s960 and s960train
profiles fail unless K1 (and at s960train K2) launched only
csrc/mlp_sm90.cu's kernels (no `gemm_bf16_kernel` or
`gemm_bf16_bwd_kernel` inside its entry point), the l352train and
s960train profiles unless K3, K5, K7 and K9 launched only
csrc/block_bwd_sm90.cu's (its own, the GEMM of csrc/gemm_sm90.cuh, K11's
dk/dv pass, K9's unpool, the LN passes; no mma.sync GEMM or attention
pass, and no call of their CUDA-core entry points); s960train's and the
l352 forward's print the device time by entry point.
`--phases mlp_ab` times the path's train step (l352train) or tracked frame
(t512video) with K1's and K2's bf16 calls on the mma.sync route they took
before csrc/mlp_sm90.cu and on csrc/mlp_sm90.cu, old, new, new, old.
Then a JSON line of per-kernel numbers, the card line, and last the result
line. Any failed phase exits non-zero before the result line. Without a
CUDA device, or without the sam2unet_torch package beside this script, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
BF16_REL_TOL = 2e-2         # max|kernel - plain| / max|plain| in bf16
FP32_REL_TOL = 1e-4         # the same in fp32 (TF32 off)
# K9 in bf16: its two 2x2 max-pools route each pooled gradient to one
# position, and where the kernel's and the plain version's recomputed
# forwards round a near-tie differently, that channel's gradient lands on
# another token of the cell. Measured at the two train shapes (batch 16):
# up to 9.7e-5 of the tokens past the bf16 tolerance, at most 0.044 of
# max |plain|. Allowed: 1e-3 of the tokens, each within 0.1 of max |plain|.
# fp32 rounding makes such near-ties too, at the full batch: K9's fp32
# comparison runs there on an input redrawn until no 2x2 cell has one
# (`_without_near_ties`), and allows no token past the tolerance.
K9_BF16_TOKEN_SHARE = 1e-3
K9_BF16_OUTLIER_REL = 0.1
# the test CLI's logits, kernels vs plain versions, same bf16 weights; one
# train step's trainable gradients in fp32 likewise; the train step's bf16
# loss
MAIN_CORR_MIN = 0.99
MAIN_REL_TOL = 0.1
STEP_LOSS_RTOL = 1e-2
# one bf16 train step, each trainable leaf: its gap 1 - corr(kernels,
# fp32) <= STEP_GAP_RATIO * the plain bf16 version's gap of the same leaf +
# STEP_GAP_MARGIN, and the mean gap over the leaves <= STEP_GAP_MEAN_RATIO *
# the plain's. Set from six batches (seeds 2-7; PERF.md, PR 3): the worst
# leaf exceeded 2x the plain's gap by 0.0051 (a 32-element adapter bias,
# kernels 0.0142 vs plain 0.0046), the mean ratio was 0.90-1.14.
STEP_GAP_RATIO = 2.0
STEP_GAP_MARGIN = 1e-2
STEP_GAP_MEAN_RATIO = 1.25
# s960deploy: the .pt2 program's masks (the plain versions, fp32) against
# the native module's with the kernels (fp32, TF32 off) through the same pre
# and post process; only pixels within the fp32 gap of the 0.1 threshold
# may differ: at most this share of an image's pixels
DEPLOY_MASK_SHARE = 1e-3
# ... with the random checkpoint's head bias at logit(0.1), so that the
# deploy threshold cuts the random model's probabilities into both values
DEPLOY_HEAD_BIAS = -2.197
# the folded forward against the unfolded one, fp32: the neck's and
# decoder's convolutions round once more; max gap over max |unfolded|
FOLD_REL_TOL = 1e-4
# s352mc: the dry run's steps against one process on the card (both fp32,
# the same kernels, the sums in other orders): tests/test_torch_train_cpu.py's
# one-step tolerances; a leaf's gradient scale is at least MC_NOISE_FLOOR of
# the largest leaf's (BatchNorm biases whose shift the next BatchNorm removes
# carry rounding noise only, tests/test_torch_sharding_cpu.py). The SP
# forward against the dense one: fp32 to SP_FP32_TOL of the max; in bf16,
# its gap to the dense fp32 forward within STEP_GAP_RATIO x the dense bf16
# forward's + STEP_GAP_MARGIN. The ring's gradient to SP_FP32_TOL.
MC_LOSS_RTOL, MC_GRAD_TOL, MC_GRAD_CORR, MC_NOISE_FLOOR = 1e-5, 2e-2, 0.9999, 1e-6
SP_FP32_TOL = 2e-5
# the operating points: trunk, input size, per-forward launches of each
# kernel wrapper (a wrapper not listed must not launch)
PATHS = {
    # hiera_l@352: stage 3 (22x22 w16) and stage 4's last three blocks
    # (11x11 w8) run on the persistent window groups, four each, so K1 162
    # tails and 162 adapters per forward (tests/test_torch_grouped_cpu.py
    # holds these against the JAX package's dispatch)
    "l352": dict(label="hiera_l@352", cfg="sam2_hiera_l", size=352,
                 grouping_ab=True, per_forward={"fused_mlp": 324, "fused_window_block_strips": 7,
                              "fused_window_block": 143,
                              "fused_transition_block": 2}),
    "s960": dict(label="hiera_s@960", cfg="sam2_hiera_s", size=960,
                 per_forward={"fused_mlp": 32, "fused_window_block_strips": 2,
                              "fused_transition_block": 2,
                              "fused_window_block_strips_rem": 8,
                              "flash_attention": 3}),
    # per train step: the forward's launches and the backward kernels'
    "l352train": dict(label="hiera_l@352 train", cfg="sam2_hiera_l", size=352,
                      train=True, eval_path="l352", cli_batch=8, step_batch=4,
                      grouping_ab=True,
                      per_step={"fused_mlp": 324,
                                "fused_window_block_strips": 7,
                                "fused_window_block": 143,
                                "fused_transition_block": 2,
                                "adapter_bwd": 162, "mlp_bwd_dx": 162,
                                "window_block_strips_bwd": 7,
                                "window_block_bwd": 38, "transition_bwd": 2}),
    # the train CLI's defaults. Per step, from the routes under train
    # (tests/test_torch_model_960_cpu.py): K4 at blocks 0 and 2, the 240x240
    # transition unfused, K8 at block 3, stage 3's ten blocks after it and
    # block 15 on the persistent window groups (four each): eight windowed
    # blocks (K6: 32, one n_pad = 0 group per block for K7: 8), three long
    # blocks over the concatenated tokens (K10 in the forward and again in
    # the backward's recompute: 6; K11: 3, counted as its delta, dq and
    # dk/dv passes), 49 tails and 49 adapters (4 + 1 dense blocks, 11 x 4
    # groups). With --remat every trunk block's forward runs twice.
    "s960train": dict(label="hiera_s@960 train", cfg="sam2_hiera_s", size=960,
                      train=True, eval_path="s960", cli_batch=16, step_batch=2,
                      remat=True, resume=True, grouping_ab=True,
                      per_step={"fused_mlp": 98, "fused_window_block_strips": 2,
                                "fused_window_block": 32,
                                "fused_transition_block": 1,
                                "flash_attention": 6,
                                "adapter_bwd": 49, "mlp_bwd_dx": 49,
                                "window_block_strips_bwd": 2,
                                "window_block_bwd": 8, "transition_bwd": 1,
                                "flash_attention_bwd_delta": 3,
                                "flash_attention_bwd_dq": 3,
                                "flash_attention_bwd_dkv": 3},
                      per_step_remat={"fused_mlp": 196,
                                      "fused_window_block_strips": 4,
                                      "fused_window_block": 64,
                                      "fused_transition_block": 2,
                                      "flash_attention": 9}),
    # the SAM2 image predictor at build_sam2's default config. Per
    # set_image, from the routes (tests/test_torch_sam2_cpu.py): K1 on the 16
    # block tails (no adapters), K4 at blocks 0 and 2, K8 at blocks 1 and 3,
    # K12 on the 8 remainder-grid blocks of stages 3-4, K10 in the three
    # 4096-token global blocks; the stage 3->4 transition is plain. A
    # prompt of up to 10 tokens' predict launches nothing (the decoder's
    # attentions take the einsum form); one of 16 (9 points) runs its three
    # token->image attentions on K10. Under the "pallas" backend K14 adds 1
    # per set_image (the transition) and 4 per 8-token predict (2 token
    # self-attentions, 2 image->token attentions). set_image embeds one
    # image, so its kernels are held and profiled at batch 1.
    "s1024sam2": dict(label="sam2_hiera_s@1024 predictor", cfg="sam2_hiera_s",
                      size=1024, sam2=True, batch=1,
                      per_set_image={"fused_mlp": 16,
                                     "fused_window_block_strips": 2,
                                     "fused_transition_block": 2,
                                     "fused_window_block_strips_rem": 8,
                                     "flash_attention": 3},
                      per_predict_16={"flash_attention": 3},
                      pallas_set_image={"full_attention": 1},
                      pallas_predict_8={"full_attention": 4}),
    # the SAM2 video predictor at build_sam2_video_predictor's defaults
    # (binarised prompted masks, holes of up to 8 pixels filled, the
    # device-resident bank), two objects. Each frame's features: the
    # s1024sam2 set_image launches; each tracked frame adds the memory
    # attention's four self-attentions, K10 at head dim 256 over 4096
    # tokens (its cross-attention carries a key mask: the einsum form); a
    # prompted frame runs no memory attention, and prompts of one point
    # (8 decoder tokens) launch nothing.
    "s1024video": dict(label="sam2_hiera_s@1024 video", cfg="sam2_hiera_s",
                       size=1024, video=True, batch=1, objects=2,
                       frames=12, hw=(480, 640),
                       points=((160.0, 240.0), (480.0, 120.0)),
                       mask=(60, 180, 420, 540), reverse_from=11,
                       per_image={"fused_mlp": 16,
                                  "fused_window_block_strips": 2,
                                  "fused_transition_block": 2,
                                  "fused_window_block_strips_rem": 8,
                                  "flash_attention": 3},
                       per_frame_d256=4),
    # sam2_hiera_t at 512 px through build_sam2_video_predictor with
    # SAM2Config(image_size=512), the flow of the JAX package's
    # scripts/smoke_video.py at its defaults: six 240x320 frames (upscaled
    # to the input), two objects, a point each and a mask on the second,
    # forward, reverse from the middle frame, one drain of packed masks.
    # Per image (tests/test_torch_sam2_cpu.py, routes at 512): K4 2, K8 2,
    # K6 16 and K1 33 (stage 3's six blocks after the transition and block
    # 11 on the persistent window groups of the 32x32 w14 and 16x16 w7
    # grids, four each, five dense tails); the three 1024-token global
    # blocks the plain form over the concatenated tokens (no K10), and under
    # the default backend nothing else launches. The path runs under
    # set_attention_impl("pallas"), where every unmasked attention over at
    # most 1024 keys is K14 (tests/test_torch_video512_cpu.py): +1 per
    # image (the 32x32 w14 transition), 7 per decode of 7 tokens (a prompt;
    # a tracked frame's), and per tracked frame the memory attention's 4
    # self-attentions at head dim 256 over 1024 tokens.
    "t512video": dict(label="sam2_hiera_t@512 video", cfg="sam2_hiera_t",
                      size=512, video=True, batch=1, objects=2, frames=6,
                      hw=(240, 320), points=((80.0, 120.0), (240.0, 60.0)),
                      mask=(25, 95, 205, 275), reverse_from=3, drain=True,
                      per_image={"fused_mlp": 33,
                                 "fused_window_block_strips": 2,
                                 "fused_transition_block": 2,
                                 "fused_window_block": 16},
                      per_frame_d256=4, profile_k14=True,
                      pallas_image={"full_attention": 1},
                      pallas_decode={"full_attention": 7}),
    # the automatic mask generator at the JAX package's
    # scripts/bench_amg.py point: sam2_hiera_t at 1024 px (build_sam2's
    # default size), 16 points per side on a 480x640 image, the iou and
    # stability filters at 0, the default backend. One set_image per
    # generate (no crop layers): K1 12, K4 2, K8 2, K12 4, K10 3 (the
    # 4096-token global blocks; tests/test_torch_sam2_cpu.py, routes at
    # 1024); its four decodes of 64 points (7 tokens) launch nothing.
    "t1024amg": dict(label="sam2_hiera_t@1024 AMG", cfg="sam2_hiera_t",
                     size=1024, amg=True, batch=1, hw=(480, 640),
                     points_per_side=16,
                     per_set_image={"fused_mlp": 12,
                                    "fused_window_block_strips": 2,
                                    "fused_transition_block": 2,
                                    "fused_window_block_strips_rem": 4,
                                    "flash_attention": 3}),
    # the train CLI whole, as a user runs it at its defaults (hiera_s, 960,
    # batch 16): --bf16 --epoch 1 --full_eval --profile_dir on 240
    # synthetic training JPEGs (15 steps, so the trace window of steps
    # 10-14 fills) and 16 eval images. Its launches are s960train's per
    # step and s960's per eval forward, its shapes those paths' (whose
    # entries hold them). Then the test CLI on its checkpoint and the eval
    # CLI on the PNGs.
    "s960cli": dict(label="hiera_s@960 train CLI", cfg="sam2_hiera_s",
                    size=960, cli=True, batch=16, train_images=240,
                    eval_images=16, held_by=("s960train", "s960")),
    # export and deploy at the fork's defaults (hiera_s, 960): the export
    # CLI's .pt2 and the deploy CLI over 16 images, then the ONNX leg (its
    # 16 images at 352 px, full width: the numpy runner's 960 forward is
    # too slow for 16 of them inside this script's limit), the fold-BN A/B.
    # The artifacts run the plain versions; the native forwards at batch 1
    # (the .pt2's check, the masks' check, the A/B) launch s960's per
    # forward each, at shapes this path's own entries hold (batch 1).
    # Per fp32 forward at batch 1 (the route: kernel_specs), K1 44 tails
    # and 46 adapters (`fused_mlp` 46 + 46: 4 dense blocks, 10 grouped
    # blocks x 4 groups, the plain transition, block 15; the tails of
    # blocks 14 and 15, width 768, take the plain form past the fp32
    # weight gate, as the JAX package's `_f32_weights_overflow` sends them
    # to XLA; tests/test_torch_export_cpu.py), K4 2, K8 2, K6 28 (7
    # windowed grouped blocks x 4 groups), K10 3, K12 1.
    "s960deploy": dict(label="hiera_s@960 deploy", cfg="sam2_hiera_s",
                       size=960, deploy=True, batch=1, images=16,
                       onnx_size=352, fp32=True,
                       per_forward={"fused_mlp": 90,
                                    "fused_window_block_strips": 2,
                                    "fused_transition_block": 2,
                                    "fused_window_block": 28,
                                    "flash_attention": 3,
                                    "fused_window_block_strips_rem": 1}),
    # the JAX package's checkpoints and tooling at the fork's defaults
    # (hiera_s, 960): a seeded random checkpoint through an Orbax directory
    # (state_dict_to_jax, save_variables, load_any_checkpoint) bit for bit;
    # the test CLI (--bf16 --batch_size 4) over 16 images from the directory
    # and from the .pth, the same PNGs; the FLOP audit at hiera_s@960 and
    # hiera_l@352; utils/profile_model.py, --mode infer and train at batch
    # 16, 3 steps each after a warm-up, its entry-point calls in the trace
    # against s960's per forward and s960train's per step. Launches: s960's
    # per forward x (8 test CLI forwards + 4 profiled infer steps) +
    # s960train's per step x 4, at the shapes those paths' entries hold.
    "s960interop": dict(label="hiera_s@960 interop", cfg="sam2_hiera_s",
                        size=960, interop=True, batch=16, images=16,
                        cli_batch=4, steps=3, held_by=("s960train", "s960"),
                        audits=(("sam2_hiera_s", 960), ("sam2_hiera_l", 352))),
    # data parallelism at the train CLI's defaults (hiera_s, 960, global
    # batch 16) on the one card: (a) 2 bf16 train steps in one process,
    # then on 2 ranks over gloo (8 rows each, SyncBN; NCCL refuses two ranks
    # on one device), (b) the train CLI under torch.distributed.run on 2
    # ranks, --epoch 1 --save_train_state --shard_map over 32 images (2
    # steps) and 4 eval images, then --resume from its JAX-layout train
    # state with --epoch 2. Every rank launches s960train's per step (and s960's
    # per eval forward) at shapes that path's entries hold.
    "s960dp": dict(label="hiera_s@960 data parallel", cfg="sam2_hiera_s",
                   size=960, dp=True, batch=16, ranks=2, steps=2, seed=2,
                   train_images=32, eval_images=4, held_by=("s960train",)),
    # the port's dryrun_multichip(4) (sam2unet_torch/parallel/dryrun.py,
    # the JAX package's __graft_entry__.py::dryrun_multichip) with every
    # phase, four ranks on the one card over gloo, fp32: tiny dp x tp at 64
    # px (2 rows a rank, mesh (2, 2)), hiera_s@352 dp and shard_map, and
    # hiera_l@256 shard_map (1 row a rank, mesh (4, 1)), hiera_s@352's SP
    # forward (1 row a data index, its global blocks' attention over the
    # model axis, the window blocks per block); and entry(), hiera_s@352 in
    # bf16 at batch 1. Every kernel of those routes runs (K1-K9; K12's gate
    # refuses 22x22 w14 and 11x11 w7, K10 sees no sequence past 1024). In
    # fp32 the block tails at width 768 (hiera_s stage 4) and 1152
    # (hiera_l@256 stage 4) take the plain form past the fp32 weight gate,
    # forward and backward, as in the JAX package: per rank a hiera_s@352
    # step launches K1 93 (44 tails, 49 adapters) and K2 44, a hiera_l@256
    # step K1 92 and K2 44, the SP forward K1 30
    # (tests/test_torch_ops_api_cpu.py derives them).
    "s352mc": dict(label="dryrun_multichip(4)", cfg="sam2_hiera_s", size=352,
                   multichip=True, batch=1, ranks=4, fp32=True),
    # the JAX package's kernel entry points that no model calls, at full
    # width: K15 `fused_ln_matmul` and K16 `fused_ln_qkv` on the rows of
    # every block width of hiera_l@352 (batch --batch) and hiera_s@960
    # (half of it), `MultiScaleAttention(x, ln_w, ln_b)` of a hiera_l@352
    # stage-3 block (K15); `MLP(fused=True)` and `fused_mlp` with frozen
    # weights in each mode at hiera_s@960's stage 3 and 4 tails (K1, K2
    # without LN, without the residual, without both); the masked
    # whole-grid K6 and K7 on hiera_l@352's stage 3 and 4 grids with
    # `grid_window_mask`; then fp32 at batch 2 on both sides of the fp32
    # weight gate. Per run (`opsapi_main_phase`): K15 16 + 1 + 1 fp32, K16
    # 16, K1 6 + 1 fp32, K2 2 in each of the three modes + 1 fp32, K6
    # masked 2, K7 masked 2.
    "opsapi": dict(label="kernel entry points", opsapi=True,
                   per_run={"fused_ln_matmul": 18, "fused_ln_qkv": 16,
                            "fused_mlp": 7, "mlp_bwd_dx": 7,
                            "fused_window_block": 2, "window_block_bwd": 2}),
}
PATHS["bwdmodes"] = dict(
    # K7's weight-gradient mode and K13a / K13b, reached through the
    # modules as the JAX package reaches its kernels (`bwdmodes_main_phase`
    # derives the counts). (b) a hiera_l@352 train step of the trunk
    # without adapters (nothing frozen; bf16): K1 on the 162 block tails of
    # the window groups and dense blocks (their backward the plain
    # recompute: trainable weights), K4 7 forward (its backward the plain
    # recompute), the transitions plain (a trainable transition leaves K8,
    # hiera.py:318-327 there), K6 143 as l352's forward, and K7's
    # weight-gradient mode 32: stage 3's 32 windowed blocks, each one
    # pad-free 16x16 group (S 256, c 576: 16 c^2 = 5.3 MB <= 8 MiB, live
    # 2.85 MB <= 4 MiB); stage 4's 8x8 groups (c 1152: 16 c^2 = 21.2 MB)
    # and the 484-token global blocks (live 6.95 MB) take the plain
    # recompute, and no frozen block runs K7's dx-only mode. (c) one
    # eval-mode forward and backward of SAM2UNet at hiera_s@960 (the
    # trainable set: adapters, neck, decoder): s960's forward, then K13b 7
    # (blocks 4-6, 8, 9, 11, 12: 60x60 w14, whose strip passes the TPU's
    # 13 MiB) and K13a 1 (block 15, 30x30 w7), K5 2 (blocks 0, 2), K9 1
    # (block 3; block 1's 240x240 transition fails the backward gate), the
    # three long blocks' K10 again and K11, K2 on the 16 frozen tails and
    # K3 on the 16 adapters.
    label="bwdmodes", bwdmodes=True, batch=16, fp32_listed=True,
    time_each=True, trunk_cfg="sam2_hiera_l", trunk_size=352,
    trunk_batch=4, model_cfg="sam2_hiera_s", model_size=960, model_batch=2,
    per_step={"fused_mlp": 162, "fused_window_block_strips": 7,
              "fused_window_block": 143, "window_block_bwd": 32},
    per_backward={"fused_mlp": 32, "fused_window_block_strips": 2,
                  "fused_transition_block": 2,
                  "fused_window_block_strips_rem": 8, "flash_attention": 6,
                  "mlp_bwd_dx": 16, "adapter_bwd": 16,
                  "window_block_strips_bwd": 2, "transition_bwd": 1,
                  "window_block_strips_rem_bwd": 8,
                  "flash_attention_bwd_delta": 3,
                  "flash_attention_bwd_dq": 3,
                  "flash_attention_bwd_dkv": 3})
PATHS["headdims"] = dict(
    # every head dim the JAX attention kernels take, through the functions
    # the JAX package ships and its tests call: its kernel tests'
    # window-family geometries at head dim 12 (c 24 over 2 heads; the
    # transition 24 -> 48 over 4), `flash_attention` under autograd at the
    # video memory attention's (2, 4096, 1, 256) and at head dims 12, 128
    # and 264, `full_attention` over 49 -> 196 tokens (K14) at those d; the
    # main phase runs the kernel phase's shapes once (`headdims_main_phase`)
    label="head dims", headdims=True, batch=1, fp32_listed=True,
    time_each=True)
PATHS["widths"] = dict(
    # every width the JAX MLP, LN-matmul and window kernels take, through the
    # functions the JAX package ships and its tests call: K1 / K2 / K3 / K15
    # / K16 and the window, strip, remainder and transition blocks at widths
    # that are not a multiple of 8 and LN rows past 2048 (csrc/gemm_any.cu;
    # `widths_kernel_specs`); the main phase runs the kernel phase's shapes
    # once (`widths_main_phase`), then shows the gemm_any kernels in a
    # profile of one ragged call of each family and none in one of
    # hiera_l@352's forward
    label="widths", widths=True, batch=1, fp32_listed=True, time_each=True)
BATCH_FLAG = {"l352": "batch", "opsapi": "batch", "s960": "batch960",
              "l352train": "batch_train",
              "s960train": "batch_train960"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------- cases


def make_case(kind: str, dtype, gen, **g):
    """(kernel call, operations, bytes, library call or None) for one kernel
    at one shape. Weights ~ lecun-normal, biases and LN params small noise
    around the identity, activations ~ N(0, 1). Bytes count each input read
    once and each output written once; operations count the work this
    call's data needs."""
    import torch
    import torch.nn.functional as F

    from sam2unet_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_delta,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        full_attention,
    )
    from sam2unet_torch.ops.fused_attention_block import (
        fused_window_block,
        fused_window_block_strips,
        fused_window_block_strips_rem,
        window_block_bwd,
        window_block_strips_bwd,
        window_block_strips_rem_bwd,
    )
    from sam2unet_torch.ops.fused_mlp import (
        adapter_bwd,
        fused_ln_matmul,
        fused_ln_qkv,
        fused_mlp,
        mlp_bwd_dx,
    )
    from sam2unet_torch.ops.fused_transition import (
        fused_transition_block,
        transition_bwd,
    )
    from sam2unet_torch.ops.windowing import grid_window_mask

    def rnd(*shape, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen, device=DEV) * scale + shift
        return t.to(dtype).contiguous()

    def lin(o, i):
        return rnd(o, i, scale=1.0 / math.sqrt(i)), rnd(o, scale=0.1)

    if kind in ("mlp_tail", "mlp_adapter"):
        # the tail: LN and the residual unless g says otherwise (the frozen
        # `fused_mlp`'s other modes); the hidden width 4c or 32 unless given
        m, c = g["tokens"], g["c"]
        hd = g.get("hidden", 4 * c if kind == "mlp_tail" else 32)
        ln, res = g.get("ln", True), g.get("residual", True)
        x = rnd(m, c)
        w1, b1 = lin(hd, c)
        w2, b2 = lin(c, hd)
        if kind == "mlp_tail":
            kw = dict(ln_w=rnd(c, scale=0.1, shift=1.0),
                      ln_b=rnd(c, scale=0.1)) if ln else {}
            call = lambda: fused_mlp(x, w1, b1, w2, b2, residual=res, **kw)
        else:
            call = lambda: fused_mlp(x, w1, b1, w2, b2, residual=True,
                                     gelu_out=True)
        flops = 4 * m * c * hd
        nbytes = 2 * m * c + 2 * c * hd + hd + c + 2 * c * (kind == "mlp_tail"
                                                             and ln)
        return call, flops, nbytes * x.element_size(), None

    if kind in ("ln_matmul", "ln_qkv"):
        # K15 / K16 on a (tokens, c) row block, W the (3c, c) QKV weight
        # unless its rows `n` are given
        m, c, add_bias = g["tokens"], g["c"], g["add_bias"]
        n = g.get("n", 3 * c)
        x = rnd(m, c)
        w, b = lin(n, c)
        lw, lb = rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1)
        fn = fused_ln_qkv if kind == "ln_qkv" else fused_ln_matmul
        call = lambda: fn(x, w, b, lw, lb, add_bias)
        nel = m * c + n * c + n * add_bias + 2 * c + m * n
        return call, 2 * m * c * n, nel * x.element_size(), None

    if kind == "mlp_grad":
        # `fused_mlp` under autograd as the JAX tests differentiate it: the
        # frozen tail or MLP with x trainable (K1, then K2), the adapter
        # with every weight trainable (K1, then K3); dx and the weights'
        # gradients, with the output
        m, c, hd, mode = g["tokens"], g["c"], g["hidden"], g["mode"]
        x, gy = rnd(m, c), rnd(m, c)
        w1, b1 = lin(hd, c)
        w2, b2 = lin(c, hd)
        kw = {"ln tail": dict(residual=True, ln_w=rnd(c, scale=0.1, shift=1.0),
                              ln_b=rnd(c, scale=0.1)),
              "adapter": dict(residual=True, gelu_out=True),
              "no ln, no residual": {}}[mode]

        def call():
            leaves = [t.detach().requires_grad_(i == 0 or mode == "adapter")
                      for i, t in enumerate((x, w1, b1, w2, b2))]
            y = fused_mlp(*leaves, **kw)
            wrt = [t for t in leaves if t.requires_grad]
            return (y.detach(), *torch.autograd.grad(y, wrt, gy))
        # the forward's two products, then K2's three or K3's six; x, gy and
        # the weights read, y and dx (and K3's fp32 weight gradients) written
        es, adapter = x.element_size(), mode == "adapter"
        flops = (16 if adapter else 10) * m * c * hd
        nbytes = (4 * m * c + 2 * c * hd + hd + c) * es + adapter * 4 * (
            2 * c * hd + hd + c)
        return call, flops, nbytes, None

    if kind == "ln_qkv_grad":
        # `fused_ln_qkv` under autograd with x and W trainable, as the JAX
        # test differentiates it: K16, then the plain recompute's backward
        m, c, n = g["tokens"], g["c"], g["n"]
        x, w_b = rnd(m, c), lin(n, c)
        lw, lb = rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1)
        gq = [rnd(m, n // 3) for _ in range(3)]

        def call():
            xx, ww = (t.detach().requires_grad_(True) for t in (x, w_b[0]))
            q, k, v = fused_ln_qkv(xx, ww, w_b[1], lw, lb)
            grads = torch.autograd.grad((q, k, v), (xx, ww), gq)
            return (q.detach(), k.detach(), v.detach(), *grads)
        return call, 6 * m * c * n, (3 * m * c + 2 * m * n + 2 * n * c) * x.element_size(), None

    if kind == "window_grad":
        # `fused_window_block` under autograd with frozen weights: K6, then
        # K7's dx-only backward
        nw, s_, c, nh = g["windows"], g["S"], g["c"], g["heads"]
        lw, lb = rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1)
        wq, bq = lin(3 * c, c)
        wp, bp = lin(c, c)
        x, gy = rnd(nw, s_, c), rnd(nw, s_, c)

        def call():
            xx = x.detach().requires_grad_(True)
            y = fused_window_block(xx, wq, bq, lw, lb, wp, bp, num_heads=nh)
            return (y.detach(), *torch.autograd.grad(y, xx, gy))
        m, pairs = nw * s_, nw * s_ * s_
        flops = 3 * (2 * m * c * 3 * c + 4 * pairs * c + 2 * m * c * c)
        return call, flops, (4 * m * c + 4 * c * c) * x.element_size(), None

    if kind in ("window_masked", "window_masked_bwd"):
        # the masked whole-grid mode: one row per image of grid x grid
        # tokens, the mask and log-multiplicity of `grid_window_mask`; the
        # operations count the whole S x S of scores the mask spans
        b, hh, win, c, nh = (g[k] for k in ("batch", "grid", "window", "c",
                                            "heads"))
        s = hh * hh
        mask, lm = (torch.from_numpy(a).to(DEV)
                    for a in grid_window_mask(hh, hh, win))
        lw, lb = rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1)
        wq, bq = lin(3 * c, c)
        wp, bp = lin(c, c)
        x = rnd(b, s, c)
        kw = dict(num_heads=nh, attn_mask=mask, pad_logmult=lm)
        m, pairs = b * s, b * s * s
        if kind == "window_masked":
            call = lambda: fused_window_block(x, wq, bq, lw, lb, wp, bp, **kw)
            flops = 2 * m * c * 3 * c + 4 * pairs * c + 2 * m * c * c
            nel = 2 * m * c + 4 * c * c + 6 * c
        else:
            gy = rnd(b, s, c)
            call = lambda: window_block_bwd(x, gy, wq, bq, lw, lb, wp, bp, **kw)
            flops = (2 * 2 * m * c * 3 * c + 4 * pairs * c + 2 * m * c * c
                     + 8 * pairs * c)
            nel = 3 * m * c + 4 * c * c + 5 * c
        return call, flops, nel * x.element_size() + 4 * (s * s + s), None

    if kind == "window_wgrad":
        # K7's weight-gradient mode: dx and the six weight gradients (fp32)
        # of pad-free window rows; the operations add the two
        # weight-gradient products to the dx-only backward's
        nw, s_, c, nh = g["windows"], g["S"], g["c"], g["heads"]
        lw, lb = rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1)
        wq, bq = lin(3 * c, c)
        wp, bp = lin(c, c)
        x, gy = rnd(nw, s_, c), rnd(nw, s_, c)
        call = lambda: window_block_bwd(x, gy, wq, bq, lw, lb, wp, bp,
                                        num_heads=nh, weight_grads=True)
        m, pairs = nw * s_, nw * s_ * s_
        flops = (2 * 2 * m * c * 3 * c + 4 * pairs * c + 2 * m * c * c
                 + 8 * pairs * c + 2 * m * c * 4 * c)
        nel = 3 * m * c + 4 * c * c + 5 * c
        return call, flops, nel * x.element_size() + 4 * (4 * c * c + 6 * c), None

    if kind == "strips_rem_bwd":
        # K13: dx of K12 on (B, H, W, c), any grid; the pairs count each
        # window's tokens inside the grid and an edge window's pad key
        b, win, c, nh = g["batch"], g["window"], g["c"], g["heads"]
        hh, wd = (g["grid"], g["grid"]) if isinstance(g["grid"], int) else g["grid"]
        res = g.get("residual", True)
        lw, lb = rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1)
        wq, bq = lin(3 * c, c)
        wp, bp = lin(c, c)
        x, gy = rnd(b, hh, wd, c), rnd(b, hh, wd, c)
        call = lambda: window_block_strips_rem_bwd(
            x, gy, wq, bq, lw, lb, wp, bp, num_heads=nh, window=win,
            residual=res)
        m = b * hh * wd
        vhs = [min(win, hh - i) for i in range(0, hh, win)]
        vws = [min(win, wd - i) for i in range(0, wd, win)]
        pairs = b * sum(vh * vw * (vh * vw + (vh * vw < win * win))
                        for vh in vhs for vw in vws)
        flops = (2 * 2 * m * c * 3 * c + 4 * pairs * c + 2 * m * c * c
                 + 8 * pairs * c)
        nel = 3 * m * c + 4 * c * c + 5 * c
        return call, flops, nel * x.element_size(), None

    if kind in ("flash", "full"):
        # q/k/v as the long-form blocks pass them: slices of the QKV output;
        # with Sk, as the mask decoder passes them: q of one length, k and v
        # slices of one buffer of another. K10 also returns the lse; K14
        # (`full`) takes at most 1024 keys.
        b, sq, nh, d = g["batch"], g["S"], g["heads"], g["d"]
        sk = g.get("Sk", sq)
        if sk == sq:
            qkv = rnd(b, sq, 3, nh, d)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, kv = rnd(b, sq, nh, d), rnd(b, sk, 2, nh, d)
            k, v = kv[:, :, 0], kv[:, :, 1]
        if kind == "flash":
            call = lambda: flash_attention(q, k, v, return_lse=True)
        else:
            call = lambda: full_attention(q, k, v)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        flops = 4 * b * nh * sq * sk * d
        nbytes = (2 * sq + 2 * sk) * b * nh * d * q.element_size()
        if kind == "flash":
            nbytes += 4 * b * nh * sq
        return call, flops, nbytes, library

    if kind == "flash_grad":
        # `flash_attention` under autograd, as a user differentiates it: K10
        # (o and lse), then K11's delta, dq and dk/dv passes; q/k/v the
        # channel blocks of one QKV buffer, the gradient its dqkv; with Sk
        # given, q a leaf of one length and k, v the channel blocks of a
        # KV buffer of another
        b, sq, nh, d = g["batch"], g["S"], g["heads"], g["d"]
        sk = g.get("Sk", sq)
        dout = rnd(b, sq, nh, d)
        if sk == sq:
            leaves = (rnd(b, sq, 3, nh, d).requires_grad_(True),)
            qkv = lambda ls: (ls[0][:, :, 0], ls[0][:, :, 1], ls[0][:, :, 2])
        else:
            leaves = (rnd(b, sq, nh, d).requires_grad_(True),
                      rnd(b, sk, 2, nh, d).requires_grad_(True))
            qkv = lambda ls: (ls[0], ls[1][:, :, 0], ls[1][:, :, 1])

        def call():
            o = flash_attention(*qkv(leaves))
            return (o.detach(), *torch.autograd.grad(o, leaves, dout))

        def library():
            # SDPA's forward and backward on the same buffers
            ls = [t.detach().requires_grad_(True) for t in leaves]
            out = F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in qkv(ls)))
            return torch.autograd.grad(out, ls, dout.transpose(1, 2))
        es, pairs = dout.element_size(), b * nh * sq * sk
        nq, nk = b * sq * nh * d, b * sk * nh * d
        # K10 (4 pairs d) and K11 (14 pairs d); q, k, v, dO read, o, lse,
        # dq, dk, dv written
        return (call, 18 * pairs * d, (4 * nq + 5 * nk) * es
                + 4 * b * nh * sq * 2, library)

    if kind.startswith("flash_bwd"):
        # K11 over K10's interface. With one length, q/k/v are the channel
        # blocks of a (B*S, 3c) QKV buffer and dq/dk/dv land in those of a
        # dqkv buffer, as the long block's backward passes them; with Sk
        # given, separate tensors of two lengths, or with `strided` q the
        # first block of a (B, Sq, 2, heads, d) buffer, k and v those of a
        # (B, Sk, 2, heads, d) one and dq/dk/dv those of one dqkv buffer.
        # o and lse come from K10.
        b, sq, nh, d = g["batch"], g["S"], g["heads"], g["d"]
        sk = g.get("Sk", sq)
        if sk != sq and g.get("strided"):
            q, kv = rnd(b, sq, 2, nh, d)[:, :, 0], rnd(b, sk, 2, nh, d)
            k, v = kv[:, :, 0], kv[:, :, 1]
            dqkv = torch.empty(b, max(sq, sk), 3, nh, d, dtype=dtype,
                               device=DEV)
            outs = (dqkv[:, :sq, 0], dqkv[:, :sk, 1], dqkv[:, :sk, 2])
        elif sk == sq:
            qkv = rnd(b, sq, 3, nh, d)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            dqkv = torch.empty_like(qkv)
            outs = (dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2])
        else:
            q, k, v = rnd(b, sq, nh, d), rnd(b, sk, nh, d), rnd(b, sk, nh, d)
            outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        dout = rnd(b, sq, nh, d)
        o, lse = flash_attention(q, k, v, return_lse=True)
        delta = flash_attention_bwd_delta(o, dout)
        scale = 1.0 / math.sqrt(d)
        es, pairs = q.element_size(), b * nh * sq * sk
        nq, nk, rows = b * sq * nh * d, b * sk * nh * d, 4 * b * nh * sq
        if kind == "flash_bwd_delta":
            call = lambda: flash_attention_bwd_delta(o, dout)
            library = lambda: torch.einsum("bqhd,bqhd->bhq", dout, o)
            return call, 2 * nq, 2 * nq * es + rows, library
        if kind == "flash_bwd_dq":      # scores, dP, dQ
            call = lambda: flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                                  scale, out=outs[0])
            flops, nbytes = 6 * pairs * d, (3 * nq + 2 * nk) * es + 2 * rows
        elif kind == "flash_bwd_dkv":   # scores, dV, dP, dK
            call = lambda: flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                                   scale, out=outs[1:])
            flops, nbytes = 8 * pairs * d, (2 * nq + 4 * nk) * es + 2 * rows
        else:                           # the delta pass and both passes
            call = lambda: flash_attention_bwd(q, k, v, o, lse, dout, out=outs)
            flops, nbytes = 14 * pairs * d, (4 * nq + 4 * nk) * es + rows
        graph = []

        def library():
            # the backward of SDPA (dq, dk and dv together) at this shape
            if not graph:
                leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v)]
                graph.append((F.scaled_dot_product_attention(*leaves), leaves))
            out, leaves = graph[0]
            return torch.autograd.grad(out, leaves, dout.transpose(1, 2),
                                       retain_graph=True)
        return call, flops, nbytes, library

    if kind in ("strips", "strips_rem", "window", "transition"):
        c, nh = g["c"], g["heads"]
        cin = g.get("cin", c)
        cout = c
        lw, lb = rnd(cin, scale=0.1, shift=1.0), rnd(cin, scale=0.1)
        wq, bq = lin(3 * cout, cin)
        wp, bp = lin(cout, cout)
        if kind in ("strips", "strips_rem"):
            b, hh, win = g["batch"], g["grid"], g["window"]
            x = rnd(b, hh, hh, c)
            fn = (fused_window_block_strips if kind == "strips"
                  else fused_window_block_strips_rem)
            call = lambda: fn(x, wq, bq, lw, lb, wp, bp, num_heads=nh,
                              window=win)
            m, mq = b * hh * hh, b * hh * hh
            # query-key pairs: each window's tokens inside the grid, plus
            # the pad key of an edge window
            edges = [min(win, hh - i) for i in range(0, hh, win)]
            pairs = b * sum(vh * vw * (vh * vw + (vh * vw < win * win))
                            for vh in edges for vw in edges)
        elif kind == "window":
            nw, s, n_pad = g["windows"], g["S"], g.get("n_pad", 0)
            x = rnd(nw, s, c)
            call = lambda: fused_window_block(x, wq, bq, lw, lb, wp, bp,
                                              num_heads=nh, n_pad=n_pad)
            m, mq, pairs = nw * s, nw * s, nw * s * (s + (n_pad > 0))
        else:
            b, hh, win = g["batch"], g["grid"], g["window"]
            x = rnd(b, hh, hh, cin)
            ws, bs = lin(cout, cin)
            call = lambda: fused_transition_block(x, wq, bq, lw, lb, wp, bp,
                                                  ws, bs, num_heads=nh,
                                                  window=win)
            m, mq = b * hh * hh, b * hh * hh // 4
            pairs = mq * win * win
        # QKV (+ shortcut) products at full resolution, attention and proj
        # per query
        flops = 2 * m * cin * 3 * cout + 4 * pairs * cout + 2 * mq * cout * cout
        nel = m * cin + mq * cout + 3 * cout * cin + cout * cout + 4 * cout + 2 * cin
        if kind == "transition":
            flops += 2 * m * cin * cout
            nel += cout * cin + cout
        return call, flops, nel * x.element_size(), None

    # backward kernels: dx (and K3's fp32 weight gradients) for a cotangent
    # gy; operations count the recomputed forward the kernel needs
    if kind in ("mlp_tail_bwd", "mlp_adapter_bwd"):
        m, c = g["tokens"], g["c"]
        hd = g.get("hidden", 4 * c if kind == "mlp_tail_bwd" else 32)
        x, gy = rnd(m, c), rnd(m, c)
        w1, b1 = lin(hd, c)
        w2, b2 = lin(c, hd)
        es = x.element_size()
        if kind == "mlp_tail_bwd":
            # LN and the residual unless g says otherwise (K2's other modes)
            ln, res = g.get("ln", True), g.get("residual", True)
            kw = dict(ln_w=rnd(c, scale=0.1, shift=1.0),
                      ln_b=rnd(c, scale=0.1)) if ln else {}
            call = lambda: mlp_bwd_dx(x, gy, w1, b1, w2, b2, residual=res, **kw)
            return (call, 6 * m * c * hd,
                    (3 * m * c + 2 * c * hd + hd + 2 * c * ln) * es, None)
        call = lambda: adapter_bwd(x, gy, w1, b1, w2, b2)
        return (call, 12 * m * c * hd,
                (3 * m * c + 2 * c * hd + hd + c) * es + (2 * c * hd + hd + c) * 4,
                None)

    if kind in ("strips_bwd", "window_bwd", "transition_bwd"):
        c, nh = g["c"], g["heads"]
        cin = g.get("cin", c)
        lw, lb = rnd(cin, scale=0.1, shift=1.0), rnd(cin, scale=0.1)
        wq, bq = lin(3 * c, cin)
        wp, bp = lin(c, c)
        if kind == "strips_bwd":
            b, hh, win = g["batch"], g["grid"], g["window"]
            x, gy = rnd(b, hh, hh, c), rnd(b, hh, hh, c)
            call = lambda: window_block_strips_bwd(x, gy, wq, bq, lw, lb, wp, bp,
                                                   num_heads=nh, window=win)
            m = mq = b * hh * hh
            pairs = m * win * win
        elif kind == "window_bwd":
            nw, s_ = g["windows"], g["S"]
            x, gy = rnd(nw, s_, c), rnd(nw, s_, c)
            call = lambda: window_block_bwd(x, gy, wq, bq, lw, lb, wp, bp,
                                            num_heads=nh)
            m = mq = nw * s_
            pairs = m * s_
        else:
            b, hh, win = g["batch"], g["grid"], g["window"]
            if g.get("ties"):
                # every 2x2 cell of four equal tokens: exact ties in the
                # projected q and the shortcut, in both versions
                x = rnd(b, hh // 2, hh // 2, cin)
                x = x.repeat_interleave(2, 1).repeat_interleave(2, 2).contiguous()
            else:
                x = rnd(b, hh, hh, cin)
            gy = rnd(b, hh // 2, hh // 2, c)
            ws, bs = lin(c, cin)
            if g.get("no_near_ties"):
                x = _without_near_ties(x, rnd, lw, lb, wq[:c], bq[:c], ws, bs)
            call = lambda: transition_bwd(x, gy, wq, bq, lw, lb, wp, bp, ws, bs,
                                          num_heads=nh, window=win)
            m, mq = b * hh * hh, b * hh * hh // 4
            pairs = mq * win * win
        # forward again (QKV [+ shortcut], attention), then dO = gy Wp, the
        # attention backward (dV, dP, dQ, dK) and dLN = dqkv W_qkv [+ dshort]
        extra = cin * c if kind == "transition_bwd" else 0
        flops = (2 * 2 * m * (cin * 3 * c + extra) + 4 * pairs * c
                 + 2 * mq * c * c + 8 * pairs * c)
        nel = 2 * m * cin + mq * c + 4 * c * cin + c * c + 4 * c + 2 * cin
        return call, flops, nel * x.element_size(), None
    raise ValueError(kind)


def _without_near_ties(x, rnd, ln_w, ln_b, w_q, b_q, w_short, b_short,
                       gap: float = 1e-4):
    """x (B, H, W, cin) with the tokens of every 2x2 cell where the
    projected q or the shortcut has a near-tie (its two largest values
    within `gap` in some channel) drawn anew, until no cell has one. There
    the kernel's and the plain version's recomputed forwards, which differ
    by rounding, may route a max-pool's gradient to different tokens; fp32
    rounding moves these projections by ~1e-6."""
    import torch

    from sam2unet_torch.nn.layers import layer_norm_plain, linear_f32

    b, hh, wd, cin = x.shape
    for _ in range(20):
        xn = layer_norm_plain(x, ln_w, ln_b)
        proj = torch.cat([linear_f32(xn, w_q, b_q),
                          linear_f32(xn, w_short, b_short)], -1)
        cells = proj.reshape(b, hh // 2, 2, wd // 2, 2, -1).permute(
            0, 1, 3, 5, 2, 4).reshape(b, hh // 2, wd // 2, -1, 4)
        top = cells.topk(2, dim=-1).values
        near = ((top[..., 0] - top[..., 1]) < gap).any(-1)
        if not near.any():
            return x
        near = near.repeat_interleave(2, 1).repeat_interleave(2, 2)[..., None]
        x = torch.where(near, rnd(b, hh, wd, cin), x).contiguous()
        del xn, proj, cells, top
    fail("K9 fp32 input: near-ties remain after 20 redraws")


def group_rows(b: int, grid: int, window: int) -> list[int]:
    """The row counts (windows x tokens) of the persistent window groups of
    a (b, grid, grid) remainder grid: full windows, an edge row or column
    of windows (the two hold as many rows), the corner."""
    n, r = divmod(grid, window)
    return [b * n * n * window * window, b * n * window * r, b * r * r]


def kernel_specs(path: str, b: int) -> list[tuple]:
    """(name, kind, replaces, source, counted launches (wrapper, variant),
    main-path shapes, index of the timed shape) of each kernel of a path."""
    if "held_by" in PATHS[path]:
        return []   # its kernels are held at the paths of `held_by`
    fab = "sam2unet_tpu/ops/pallas/fused_attention_block.py"
    src_ab = "sam2unet_torch/csrc/fused_attention_block.cu"
    src_ab_bwd = "sam2unet_torch/csrc/fused_attention_block_bwd.cu"
    src_mlp_bwd = "sam2unet_torch/csrc/fused_mlp_bwd.cu"
    # K1 and K2 in bf16 at the main paths' widths run csrc/mlp_sm90.cu; a
    # path whose main path runs in fp32 names their CUDA-core sources
    fp32 = PATHS[path].get("fp32")
    src_k2 = src_mlp_bwd if fp32 else SM90_MLP_SOURCE
    mlp = ("sam2unet_tpu/ops/pallas/fused_mlp.py:135",
           "sam2unet_torch/csrc/fused_mlp.cu" if fp32 else SM90_MLP_SOURCE)
    tra = ("sam2unet_tpu/ops/pallas/fused_transition.py:256",
           "sam2unet_torch/csrc/fused_transition.cu")

    def k6_held(shapes):
        """(select, shapes) of a K6 entry: the launches of exactly these
        shapes' variants, so that a shape the main path gives K6 and no
        entry holds against the plain version is found (`main`)."""
        held = {f"S={g['S']},n_pad={g.get('n_pad', 0)}" for g in shapes}
        return lambda w, v: w == "fused_window_block" and v in held, shapes

    def k7_held(shapes):
        held = {f"S={g['S']}" for g in shapes}
        return lambda w, v: w == "window_block_bwd" and v in held, shapes

    if PATHS[path].get("multichip"):
        return multichip_kernel_specs(k6_held, k7_held, mlp, tra, fab, src_ab,
                                      src_ab_bwd, src_k2, src_mlp_bwd)
    if PATHS[path].get("opsapi"):
        return opsapi_kernel_specs(b, mlp, fab, src_k2)
    if PATHS[path].get("bwdmodes"):
        return bwdmodes_kernel_specs(b, fab)
    if PATHS[path].get("headdims"):
        return headdims_kernel_specs(fab)
    if PATHS[path].get("widths"):
        return widths_kernel_specs(fab)
    if PATHS[path].get("train"):
        fa = "sam2unet_tpu/ops/pallas/flash_attention.py"
        src_k11 = "sam2unet_torch/csrc/flash_attention_bwd.cu"
        src_k11_sm90 = "sam2unet_torch/csrc/flash_attention_bwd_sm90.cu"
        if path == "l352train":
            grids, cs = (88, 44, 22, 11), (144, 288, 576, 1152)
            windows = (16, 8)
            k5 = [dict(batch=b, grid=88, c=144, heads=2, window=8),
                  dict(batch=b, grid=44, c=288, heads=4, window=4)]
            # the 16-window groups of stages 3 and 4; the 484-token global
            # blocks are timed as an entry of their own
            k7 = [dict(windows=b, S=256, c=576, heads=8),
                  dict(windows=b, S=64, c=1152, heads=16)]
            k7_global = [dict(windows=b, S=484, c=576, heads=8)]
            tra_shapes = [dict(batch=b, grid=88, cin=144, c=288, heads=4, window=8),
                          dict(batch=b, grid=44, cin=288, c=576, heads=8, window=4)]
        else:
            grids, cs = (240, 120, 60, 30), (96, 192, 384, 768)
            windows = (14, 7)
            k5 = [dict(batch=b, grid=240, c=96, heads=1, window=8),
                  dict(batch=b, grid=120, c=192, heads=2, window=4)]
            # the n_pad = 0 groups: 4x4 windows of 14x14 on 60x60, of 7x7 on
            # 30x30, head dim 96
            k7 = [dict(windows=16 * b, S=196, c=384, heads=4),
                  dict(windows=16 * b, S=49, c=768, heads=8)]
            k7_global = []   # the 3600-token global blocks take K11
            # the forward of the valid groups under train (K12 is eval only):
            # on 60x60 16 windows of 14x14, 4 + 4 of 14x4 / 4x14 and one of
            # 4x4 per image, on 30x30 the same of 7x7, 7x2 / 2x7 and 2x2
            k6_full = [dict(windows=16 * b, S=196, c=384, heads=4),
                       dict(windows=16 * b, S=49, c=768, heads=8)]
            k6_pad = [dict(windows=4 * b, S=56, c=384, heads=4, n_pad=140),
                      dict(windows=b, S=16, c=384, heads=4, n_pad=180),
                      dict(windows=4 * b, S=14, c=768, heads=8, n_pad=35),
                      dict(windows=b, S=4, c=768, heads=8, n_pad=45)]
            tra_shapes = [dict(batch=b, grid=120, cin=192, c=384, heads=4,
                               window=4)]
        # the dense grids, then the rows of the window groups of stages 3
        # and 4 (the persistent layout's K1, K2 and K3 run per group)
        tokens = [dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)]
        tokens += [dict(tokens=n, c=c) for hh, c, win in
                   zip(grids[2:], cs[2:], windows)
                   for n in group_rows(b, hh, win)]
        specs = [
            ("K2 mlp_bwd_dx", "mlp_tail_bwd",
             "sam2unet_tpu/ops/pallas/fused_mlp.py:432", src_k2,
             lambda w, v: w == "mlp_bwd_dx", tokens, 2),
            ("K3 adapter_bwd", "mlp_adapter_bwd",
             "sam2unet_tpu/ops/pallas/fused_mlp.py:551", src_mlp_bwd,
             lambda w, v: w == "adapter_bwd", tokens, 2),
            ("K5 window_block_strips_bwd", "strips_bwd", f"{fab}:1082",
             src_ab_bwd,
             lambda w, v: w == "window_block_strips_bwd", k5, 0),
        ]
        specs.append(
            ("K7 window_block_bwd", "window_bwd", f"{fab}:669", src_ab_bwd,
             *k7_held(k7), 0))
        if k7_global:
            specs.append(
                ("K7 window_block_bwd (global S=484)", "window_bwd",
                 f"{fab}:669", src_ab_bwd, *k7_held(k7_global), 0))
        specs.append(
            ("K9 transition_bwd", "transition_bwd",
             "sam2unet_tpu/ops/pallas/fused_transition.py:483",
             "sam2unet_torch/csrc/fused_transition_bwd.cu",
             lambda w, v: w == "transition_bwd",
             tra_shapes + [dict(tra_shapes[-1], ties=True)], 0))
        if path == "s960train":
            # K1 in training: the dense tails and adapters of blocks 0-3
            # and 14 (one grid each), the window groups' of stages 3 and 4
            specs += [
                ("K1 fused_mlp (tail, training)", "mlp_tail", *mlp,
                 lambda w, v: w == "fused_mlp" and v == "ln", tokens, 2),
                ("K1 fused_mlp (adapter, training)", "mlp_adapter", *mlp,
                 lambda w, v: w == "fused_mlp" and v == "no_ln", tokens, 2),
                ("K6 fused_window_block (n_pad=0)", "window", f"{fab}:354",
                 src_ab, *k6_held(k6_full), 0),
                ("K6 fused_window_block (n_pad>0)", "window", f"{fab}:354",
                 src_ab, *k6_held(k6_pad), 0)]
            # ragged lengths first, so that the fp32 comparison takes the
            # 3600-token shape; then every width of the Hopper instances
            # (d padded to 64, 96, 128, 256) at S 1000 against 1337 on
            # strided views, in bf16 (the dq and dk/dv passes in fp32 run
            # csrc/flash_attention_bwd.cu, the delta pass both)
            k11 = ([dict(batch=2, S=1000, Sk=1337, heads=4, d=96)]
                   + [dict(batch=2, S=1000, Sk=1337, heads=2, d=d, strided=True)
                      for d in K11_SM90_HEAD_DIMS]
                   + [dict(batch=b, S=3600, heads=4, d=96)])
            timed = len(k11) - 1
            specs += [
                ("K11 flash_attention_bwd (delta pass)", "flash_bwd_delta",
                 f"{fa}:306", src_k11,
                 lambda w, v: w == "flash_attention_bwd_delta", k11, timed),
                ("K11a flash_attention_bwd_dq", "flash_bwd_dq", f"{fa}:314",
                 src_k11_sm90, lambda w, v: w == "flash_attention_bwd_dq", k11,
                 timed),
                ("K11b flash_attention_bwd_dkv", "flash_bwd_dkv", f"{fa}:336",
                 src_k11_sm90, lambda w, v: w == "flash_attention_bwd_dkv",
                 k11, timed),
                # the three passes through `flash_attention_bwd`, which
                # launches nothing itself: one dq pass per call
                ("K11 flash_attention_bwd (delta, dq, dk/dv)", "flash_bwd",
                 f"{fa}:297", src_k11_sm90,
                 lambda w, v: w == "flash_attention_bwd_dq", k11, timed),
            ]
        return specs
    if path == "t512video":
        # hiera_t's trunk at 512 (grids 128/64/32/16, widths 96-768) at one
        # frame: K1, K4, K8, K6 on the valid groups of 32x32 w14 and 16x16
        # w7 (one image: 4 full windows, 2 + 2 edge windows, a corner);
        # under "pallas" K14 at head dim 256 as the memory attention gives
        # it (one head over the 1024 tokens, one sequence per object,
        # timed) and at every other shape of the run: the decoder's 7
        # tokens (head dims 32 and 16, both objects; a prompt's is one
        # object) and the 32x32 w14 transition (9 windows, head dim 96)
        grids, cs = (128, 64, 32, 16), (96, 192, 384, 768)
        objects = PATHS[path]["objects"]
        k14 = [dict(batch=objects, S=7, Sk=7, heads=8, d=32),
               dict(batch=objects, S=7, Sk=1024, heads=8, d=16),
               dict(batch=objects, S=1024, Sk=7, heads=8, d=16),
               dict(batch=9 * b, S=49, Sk=196, heads=8, d=96)]
        k14_held = {f"Sq={g['S']},Sk={g['Sk']},d={g['d']}" for g in k14}
        groups = [dict(tokens=n, c=c) for hh, c, win in
                  ((32, 384, 14), (16, 768, 7))
                  for n in group_rows(b, hh, win)]
        return [
            ("K1 fused_mlp (tail)", "mlp_tail", *mlp,
             lambda w, v: w == "fused_mlp" and v == "ln",
             [dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)]
             + groups, 2),
            ("K4 fused_window_block_strips", "strips", f"{fab}:1021", src_ab,
             lambda w, v: w == "fused_window_block_strips",
             [dict(batch=b, grid=128, c=96, heads=1, window=8),
              dict(batch=b, grid=64, c=192, heads=2, window=4)], 0),
            ("K8 fused_transition_block", "transition", *tra,
             lambda w, v: w == "fused_transition_block",
             [dict(batch=b, grid=128, cin=96, c=192, heads=2, window=8),
              dict(batch=b, grid=64, cin=192, c=384, heads=4, window=4)], 0),
            ("K6 fused_window_block (n_pad=0)", "window", f"{fab}:354", src_ab,
             *k6_held([dict(windows=4 * b, S=196, c=384, heads=4),
                       dict(windows=4 * b, S=49, c=768, heads=8)]), 0),
            ("K6 fused_window_block (n_pad>0)", "window", f"{fab}:354", src_ab,
             *k6_held([dict(windows=2 * b, S=56, c=384, heads=4, n_pad=140),
                       dict(windows=b, S=16, c=384, heads=4, n_pad=180),
                       dict(windows=2 * b, S=14, c=768, heads=8, n_pad=35),
                       dict(windows=b, S=4, c=768, heads=8, n_pad=45)]), 0),
            ("K14 full_attention (head dim 256)", "full",
             "sam2unet_tpu/ops/pallas/flash_attention.py:93",
             "sam2unet_torch/csrc/flash_attention_fwd_sm90.cu",
             lambda w, v: w == "full_attention" and v.endswith(",d=256"),
             [dict(batch=objects, S=1024, Sk=1024, heads=1, d=256)], 0),
            ("K14 full_attention", "full",
             "sam2unet_tpu/ops/pallas/flash_attention.py:93",
             "sam2unet_torch/csrc/flash_attention_fwd_sm90.cu",
             lambda w, v: w == "full_attention" and v in k14_held, k14, 3),
        ]
    if path == "t1024amg":
        # hiera_t's trunk at 1024: the s1024sam2 trunk's kernels at its
        # shapes (the same grids and widths), K10 on the global blocks only
        trunk = [e for e in kernel_specs("s1024sam2", b) if "K14" not in e[0]]
        k10 = [e for e in trunk if e[0].startswith("K10")][0]
        trunk[trunk.index(k10)] = (
            k10[:4] + (lambda w, v: w == "flash_attention",
                       [dict(batch=b, S=4096, heads=4, d=96)], 0))
        return trunk
    if path == "s1024video":
        # the image encoder's kernels of s1024sam2 at one frame (K10 at head
        # dim 96 only), and K10 at head dim 256 as the memory attention
        # gives it: one head over the 4096 tokens, one sequence per object
        trunk = [e for e in kernel_specs("s1024sam2", b) if "K14" not in e[0]]
        k10 = [e for e in trunk if e[0].startswith("K10")][0]
        trunk[trunk.index(k10)] = (
            k10[:4] + (lambda w, v: w == "flash_attention"
                       and v.endswith(",d=96"),
                       [dict(batch=b, S=4096, heads=4, d=96)], 0))
        return trunk + [
            ("K10 flash_attention (head dim 256)", "flash",
             "sam2unet_tpu/ops/pallas/flash_attention.py:190",
             "sam2unet_torch/csrc/flash_attention_fwd_sm90.cu",
             lambda w, v: w == "flash_attention" and v.endswith(",d=256"),
             [dict(batch=PATHS[path]["objects"], S=4096, heads=1, d=256)], 0)]
    if path == "s1024sam2":
        # SAM2's trunk at 1024 (no adapters): grids 256/128/64/32; the mask
        # decoder's token->image attention with 16 tokens (9 points) on K10
        # at head dim 16; K14 at every shape its paths give it (the
        # "pallas" backend): this trunk's stage 3->4 transition, the
        # decoder's token self-attention and image->token attention with 8
        # tokens, SAM2-UNet's transitions at 960 (batch 16, timed) and 352
        # (batch 32)
        grids, cs = (256, 128, 64, 32), (96, 192, 384, 768)
        k14 = [dict(batch=25 * b, S=49, Sk=196, heads=8, d=96),
               dict(batch=b, S=8, Sk=8, heads=8, d=32),
               dict(batch=b, S=4096, Sk=8, heads=8, d=16),
               dict(batch=400, S=49, Sk=196, heads=8, d=96),
               dict(batch=128, S=64, Sk=256, heads=16, d=72)]
        k14_held = {f"Sq={g['S']},Sk={g['Sk']},d={g['d']}" for g in k14}
        return [
            ("K1 fused_mlp (tail)", "mlp_tail", *mlp,
             lambda w, v: w == "fused_mlp" and v == "ln",
             [dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)], 2),
            ("K4 fused_window_block_strips", "strips", f"{fab}:1021", src_ab,
             lambda w, v: w == "fused_window_block_strips",
             [dict(batch=b, grid=256, c=96, heads=1, window=8),
              dict(batch=b, grid=128, c=192, heads=2, window=4)], 0),
            ("K8 fused_transition_block", "transition", *tra,
             lambda w, v: w == "fused_transition_block",
             [dict(batch=b, grid=256, cin=96, c=192, heads=2, window=8),
              dict(batch=b, grid=128, cin=192, c=384, heads=4, window=4)], 0),
            ("K10 flash_attention", "flash",
             "sam2unet_tpu/ops/pallas/flash_attention.py:190",
             "sam2unet_torch/csrc/flash_attention_fwd_sm90.cu",
             lambda w, v: w == "flash_attention",
             [dict(batch=b, S=4096, heads=4, d=96),
              dict(batch=b, S=16, Sk=4096, heads=8, d=16)], 0),
            ("K12 fused_window_block_strips_rem", "strips_rem", f"{fab}:1566",
             src_ab, lambda w, v: w == "fused_window_block_strips_rem",
             [dict(batch=b, grid=64, c=384, heads=4, window=14),
              dict(batch=b, grid=32, c=768, heads=8, window=7)], 0),
            ("K14 full_attention", "full",
             "sam2unet_tpu/ops/pallas/flash_attention.py:93",
             "sam2unet_torch/csrc/flash_attention_fwd_sm90.cu",
             lambda w, v: w == "full_attention" and v in k14_held, k14, 3),
        ]
    if path == "s960deploy":
        # the fp32 forward at batch 1 (the deployed dtype): K12's gate
        # (the VMEM estimate of the JAX package's, at 4-byte items) refuses
        # 60x60 w14, so stage 3's ten blocks after the transition run on the
        # persistent window groups: K6 per group (16 full windows, 4 + 4
        # edge windows of 14x4 / 4x14, one 4x4 corner), K10 on the three
        # global blocks' long form, K1 per group; block 15 (30x30 w7) takes
        # K12 (tests/test_torch_export_cpu.py holds the route)
        grids, cs = (240, 120, 60, 30), (96, 192, 384, 768)
        k1 = ([dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)]
              + [dict(tokens=n, c=384) for n in group_rows(b, 60, 14)])
        s960 = {e[0]: e for e in kernel_specs("s960", b)}
        return [
            s960["K1 fused_mlp (tail)"][:5] + (k1, 2),
            s960["K1 fused_mlp (adapter)"][:5] + (k1, 2),
            s960["K4 fused_window_block_strips"],
            s960["K8 fused_transition_block"],
            ("K6 fused_window_block (n_pad=0)", "window", f"{fab}:354", src_ab,
             *k6_held([dict(windows=16 * b, S=196, c=384, heads=4)]), 0),
            ("K6 fused_window_block (n_pad>0)", "window", f"{fab}:354", src_ab,
             *k6_held([dict(windows=4 * b, S=56, c=384, heads=4, n_pad=140),
                       dict(windows=b, S=16, c=384, heads=4, n_pad=180)]), 0),
            # the deployed fp32 forward's K10 (bf16 is held at s960)
            s960["K10 flash_attention"][:3] + (
                "sam2unet_torch/csrc/flash_attention.cu",)
            + s960["K10 flash_attention"][4:],
            s960["K12 fused_window_block_strips_rem"][:5]
            + ([dict(batch=b, grid=30, c=768, heads=8, window=7)], 0),
        ]
    if path == "l352":
        grids, cs = (88, 44, 22, 11), (144, 288, 576, 1152)
        # the dense grids (the transitions' tails at 22 and 11 among them),
        # then the rows of the window groups of 22x22 w16 and 11x11 w8
        k1 = ([dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)]
              + [dict(tokens=n, c=c) for hh, c, win in
                 ((22, 576, 16), (11, 1152, 8))
                 for n in group_rows(b, hh, win)])
        return [
            ("K1 fused_mlp (tail)", "mlp_tail", *mlp,
             lambda w, v: w == "fused_mlp" and v == "ln", k1, 2),
            ("K1 fused_mlp (adapter)", "mlp_adapter", *mlp,
             lambda w, v: w == "fused_mlp" and v == "no_ln", k1, 2),
            ("K4 fused_window_block_strips", "strips", f"{fab}:1021", src_ab,
             lambda w, v: w == "fused_window_block_strips",
             [dict(batch=b, grid=88, c=144, heads=2, window=8),
              dict(batch=b, grid=44, c=288, heads=4, window=4)], 0),
            ("K6 fused_window_block (n_pad=0)", "window", f"{fab}:354", src_ab,
             *k6_held([dict(windows=b, S=256, c=576, heads=8),
                  dict(windows=b, S=64, c=1152, heads=16)]), 0),
            ("K6 fused_window_block (n_pad>0)", "window", f"{fab}:354", src_ab,
             *k6_held([dict(windows=b, S=96, c=576, heads=8, n_pad=160),
                  dict(windows=b, S=36, c=576, heads=8, n_pad=220),
                  dict(windows=b, S=24, c=1152, heads=16, n_pad=40),
                  dict(windows=b, S=9, c=1152, heads=16, n_pad=55)]), 0),
            ("K6 fused_window_block (global S=484)", "window", f"{fab}:354",
             src_ab, *k6_held([dict(windows=b, S=484, c=576, heads=8)]), 0),
            ("K8 fused_transition_block", "transition", *tra,
             lambda w, v: w == "fused_transition_block",
             [dict(batch=b, grid=88, cin=144, c=288, heads=4, window=8),
              dict(batch=b, grid=44, cin=288, c=576, heads=8, window=4)], 0),
        ]
    grids, cs = (240, 120, 60, 30), (96, 192, 384, 768)
    return [
        ("K1 fused_mlp (tail)", "mlp_tail", *mlp,
         lambda w, v: w == "fused_mlp" and v == "ln",
         [dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)], 2),
        ("K1 fused_mlp (adapter)", "mlp_adapter", *mlp,
         lambda w, v: w == "fused_mlp" and v == "no_ln",
         [dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)], 2),
        ("K4 fused_window_block_strips", "strips", f"{fab}:1021", src_ab,
         lambda w, v: w == "fused_window_block_strips",
         [dict(batch=b, grid=240, c=96, heads=1, window=8),
          dict(batch=b, grid=120, c=192, heads=2, window=4)], 0),
        ("K8 fused_transition_block", "transition", *tra,
         lambda w, v: w == "fused_transition_block",
         [dict(batch=b, grid=240, cin=96, c=192, heads=2, window=8),
          dict(batch=b, grid=120, cin=192, c=384, heads=4, window=4)], 0),
        ("K10 flash_attention", "flash",
         "sam2unet_tpu/ops/pallas/flash_attention.py:190",
         "sam2unet_torch/csrc/flash_attention_fwd_sm90.cu",
         lambda w, v: w == "flash_attention",
         [dict(batch=b, S=3600, heads=4, d=96)], 0),
        ("K12 fused_window_block_strips_rem", "strips_rem", f"{fab}:1566",
         src_ab, lambda w, v: w == "fused_window_block_strips_rem",
         [dict(batch=b, grid=60, c=384, heads=4, window=14),
          dict(batch=b, grid=30, c=768, heads=8, window=7)], 0),
    ]


def multichip_kernel_specs(k6_held, k7_held, mlp, tra, fab, src_ab, src_ab_bwd,
                           src_k2, src_mlp_bwd) -> list[tuple]:
    """The kernels of the dry run's routes at their shapes per rank (tiny
    at 2 rows; hiera_s@352, hiera_l@256 and the SP forward at 1 row) and
    of entry()'s forward (batch 1): the forward kernels of each, and the
    backward kernels of the three train models."""
    from sam2unet_torch.ops.fused_attention_block import strips_bwd_kernel

    # K1 rows x width: tiny (grids 16/8/4/2, widths 8-64), hiera_s@352
    # (grids 88/44/22/11, the window groups of 22x22 w14 and 11x11 w7),
    # hiera_l@256 (grids 64/32/16/8)
    tails = ((512, 8), (128, 16), (32, 32), (8, 64), (7744, 96), (1936, 192),
             (484, 384), (121, 768), (196, 384), (112, 384), (64, 384),
             (49, 768), (28, 768), (16, 768), (4096, 144), (1024, 288),
             (256, 576), (64, 1152))
    adapters = tuple(t for t in tails if t != (8, 64))
    k1t = [dict(tokens=n, c=c) for n, c in tails]
    k1a = [dict(tokens=n, c=c) for n, c in adapters]
    strips = [dict(batch=2, grid=16, c=8, heads=1, window=4),
              dict(batch=1, grid=88, c=96, heads=1, window=8),
              dict(batch=1, grid=44, c=192, heads=2, window=4),
              dict(batch=1, grid=64, c=144, heads=2, window=8),
              dict(batch=1, grid=32, c=288, heads=4, window=4),
              dict(batch=1, grid=16, c=576, heads=8, window=16),
              dict(batch=1, grid=8, c=1152, heads=16, window=8)]
    transitions = [dict(batch=2, grid=16, cin=8, c=16, heads=2, window=4),
                   dict(batch=1, grid=88, cin=96, c=192, heads=2, window=8),
                   dict(batch=1, grid=44, cin=192, c=384, heads=4, window=4),
                   dict(batch=1, grid=64, cin=144, c=288, heads=4, window=8),
                   dict(batch=1, grid=32, cin=288, c=576, heads=8, window=4),
                   dict(batch=1, grid=16, cin=576, c=1152, heads=16,
                        window=16)]
    windows = [dict(windows=1, S=196, c=384, heads=4),
               dict(windows=1, S=49, c=768, heads=8)]
    pads = [dict(windows=1, S=112, c=384, heads=4, n_pad=84),
            dict(windows=1, S=64, c=384, heads=4, n_pad=132),
            dict(windows=1, S=28, c=768, heads=8, n_pad=21),
            dict(windows=1, S=16, c=768, heads=8, n_pad=33)]
    glob = [dict(windows=1, S=484, c=384, heads=4),
            dict(windows=1, S=256, c=576, heads=8)]
    return [
        ("K1 fused_mlp (tail)", "mlp_tail", *mlp,
         lambda w, v: w == "fused_mlp" and v == "ln", k1t, 4),
        ("K1 fused_mlp (adapter)", "mlp_adapter", *mlp,
         lambda w, v: w == "fused_mlp" and v == "no_ln", k1a, 4),
        ("K2 mlp_bwd_dx", "mlp_tail_bwd",
         "sam2unet_tpu/ops/pallas/fused_mlp.py:432", src_k2,
         lambda w, v: w == "mlp_bwd_dx", k1t, 4),
        ("K3 adapter_bwd", "mlp_adapter_bwd",
         "sam2unet_tpu/ops/pallas/fused_mlp.py:551", src_mlp_bwd,
         lambda w, v: w == "adapter_bwd", k1a, 4),
        ("K4 fused_window_block_strips", "strips", f"{fab}:1021", src_ab,
         lambda w, v: w == "fused_window_block_strips", strips, 1),
        ("K5 window_block_strips_bwd", "strips_bwd", f"{fab}:1082", src_ab_bwd,
         lambda w, v: w == "window_block_strips_bwd",
         [g for g in strips if strips_bwd_kernel(g["window"], g["c"])], 1),
        ("K6 fused_window_block (n_pad=0)", "window", f"{fab}:354", src_ab,
         *k6_held(windows), 0),
        ("K6 fused_window_block (n_pad>0)", "window", f"{fab}:354", src_ab,
         *k6_held(pads), 0),
        ("K6 fused_window_block (global)", "window", f"{fab}:354", src_ab,
         *k6_held(glob), 0),
        ("K7 window_block_bwd", "window_bwd", f"{fab}:669", src_ab_bwd,
         *k7_held(windows + glob), 2),
        ("K8 fused_transition_block", "transition", *tra,
         lambda w, v: w == "fused_transition_block", transitions, 1),
        ("K9 transition_bwd", "transition_bwd",
         "sam2unet_tpu/ops/pallas/fused_transition.py:483",
         "sam2unet_torch/csrc/fused_transition_bwd.cu",
         lambda w, v: w == "transition_bwd",
         transitions + [dict(transitions[1], ties=True)], 1),
    ]


def opsapi_kernel_specs(b: int, mlp, fab, src_k2) -> list[tuple]:
    """The kernel entry points no model calls, at the widths of hiera_l@352
    (batch b) and hiera_s@960 (batch b // 2): K15 and K16 on every block
    width's rows, both ways of add_bias; K1 and K2 in the frozen
    `fused_mlp`'s modes at hiera_s@960's tails (stages 3 and 4); the masked
    K6 / K7 on hiera_l@352's whole stage 3 and 4 grids."""
    b960 = max(1, b // 2)
    rows = ([(b * hh * hh, c) for hh, c in zip((88, 44, 22, 11),
                                                (144, 288, 576, 1152))]
            + [(b960 * hh * hh, c) for hh, c in zip((240, 120, 60, 30),
                                                     (96, 192, 384, 768))])
    lnmm = [dict(tokens=n, c=c, add_bias=ab) for n, c in rows
            for ab in (True, False)]
    modes = {"LN, no residual": (True, False, ",no_residual"),
             "no LN, residual": (False, True, ",no_ln"),
             "no LN, no residual": (False, False, ",no_ln,no_residual")}
    # stage 4's tail first: the fp32 check takes the last shape, stage 3's,
    # under the fp32 weight gate (the main phase holds the route past it)
    tails = ((b960 * 30 * 30, 768), (b960 * 60 * 60, 384))
    masked = [dict(batch=b, grid=22, window=16, c=576, heads=8),
              dict(batch=b, grid=11, window=8, c=1152, heads=16)]
    src_mlp = "sam2unet_torch/csrc/fused_mlp.cu"
    specs = [
        ("K15 fused_ln_matmul", "ln_matmul",
         "sam2unet_tpu/ops/pallas/fused_mlp.py:208", src_mlp,
         lambda w, v: w == "fused_ln_matmul", lnmm, 4),
        ("K16 fused_ln_qkv", "ln_qkv",
         "sam2unet_tpu/ops/pallas/fused_mlp.py:279", src_mlp,
         lambda w, v: w == "fused_ln_qkv", lnmm, 4),
        ("K1 fused_mlp (frozen, each mode)", "mlp_tail", *mlp,
         lambda w, v: w == "fused_mlp",
         [dict(tokens=n, c=c, ln=ln, residual=res) for n, c in tails
          for ln, res, _ in modes.values()], 5)]
    for mode, (ln, res, tag) in modes.items():
        specs.append(
            (f"K2 mlp_bwd_dx ({mode})", "mlp_tail_bwd",
             "sam2unet_tpu/ops/pallas/fused_mlp.py:432", src_k2,
             lambda w, v, tag=tag: w == "mlp_bwd_dx" and v.endswith(tag)
             and (tag != ",no_residual" or ",no_ln" not in v),
             [dict(tokens=n, c=c, ln=ln, residual=res) for n, c in tails], 1))
    src_masked = "sam2unet_torch/csrc/fused_attention_block_masked.cu"
    return specs + [
        ("K6 fused_window_block (masked)", "window_masked", f"{fab}:354",
         src_masked,
         lambda w, v: w == "fused_window_block" and v.endswith(",masked"),
         masked, 0),
        ("K7 window_block_bwd (masked)", "window_masked_bwd", f"{fab}:669",
         src_masked,
         lambda w, v: w == "window_block_bwd" and v.endswith(",masked"),
         masked, 0)]


def bwdmodes_kernel_specs(b: int, fab: str) -> list[tuple]:
    """K7's weight-gradient mode at the groups and global blocks where the
    JAX gate takes it (hiera_l@352 stage 3, hiera_s@960 stage 3, hiera_s's
    global blocks at 256 px; batch b, the last at 4), K13b and K13a at
    hiera_s@960 / 1024's stage 3 and 4 grids (batch b and 1); hiera_s@960
    has 16 of the 56x56 group's windows an image. Each shape
    names the launch the JAX route makes (`expect`); `f32` gives the
    shape's fp32 run (a batch of 2, and its launch at 4-byte items), where
    it has one."""
    from sam2unet_torch.ops.fused_attention_block import strips_rem_bwd_regime

    wgrad = [dict(windows=b, S=256, c=576, heads=8, f32=dict(windows=2)),
             dict(windows=16 * b, S=196, c=384, heads=4, f32=dict(windows=32)),
             dict(windows=4, S=256, c=384, heads=4, f32=dict(windows=2))]
    for g in wgrad:
        g["expect"] = ("window_block_bwd", f"S={g['S']},wgrad")
    k13b = [dict(batch=b, grid=60, c=384, heads=4, window=14),
            dict(batch=1, grid=64, c=384, heads=4, window=14)]
    k13a = [dict(batch=b, grid=30, c=768, heads=8, window=7,
                 f32=dict(batch=2)),
            dict(batch=1, grid=32, c=768, heads=8, window=7)]
    for g, regime in [(g, "K13b") for g in k13b] + [(g, "K13a") for g in k13a]:
        g["expect"] = ("window_block_strips_rem_bwd",
                       f"window={g['window']},{regime}")
        if "f32" in g:
            g["f32"]["expect"] = (g["expect"][0], "window={},{}".format(
                g["window"], strips_rem_bwd_regime(
                    g["grid"], g["grid"], g["window"], g["c"], g["heads"], 4)))
    src_rem = "sam2unet_torch/csrc/fused_attention_block_rem_bwd.cu"
    return [
        ("K7 window_block_bwd (weight-grad)", "window_wgrad", f"{fab}:669",
         "sam2unet_torch/csrc/fused_attention_block_wgrad.cu",
         lambda w, v: w == "window_block_bwd" and v.endswith(",wgrad"),
         wgrad, 0),
        ("K13b window_block_strips_rem_bwd", "strips_rem_bwd", f"{fab}:1843",
         src_rem, lambda w, v: (w == "window_block_strips_rem_bwd"
                                and v.endswith(",K13b")), k13b, 0),
        ("K13a window_block_strips_rem_bwd", "strips_rem_bwd", f"{fab}:1651",
         src_rem, lambda w, v: (w == "window_block_strips_rem_bwd"
                                and v.endswith(",K13a")), k13a, 0)]


# head dims of the flash family held at small lengths: the JAX kernel
# tests' 12, and 128 and 264 (one and five 64-wide chunks past 96)
# K11's bf16 dq and dk/dv passes on csrc/flash_attention_bwd_sm90.cu: each
# padded instance (64, 96, 128, 256) and head dims between them
K11_SM90_HEAD_DIMS = (56, 64, 72, 96, 112, 128, 200, 256)


def headdims_kernel_specs(fab: str) -> list[tuple]:
    """The attention kernels at head dims the 16-byte-vector instances do not
    take (csrc/attention_any*.cu): each window-family mode at the JAX kernel
    tests' head dim 12 (c 24 over 2 heads, the transition 24 -> 48 over 4),
    K10 / K11 / K14 at 12, 128 and 264, K11 under autograd at the video
    memory attention's (2, 4096, 1, 256); and timed rows at the tokens and
    width of existing rows with only the head count changed: K6 / K7 at
    32 x 256 x 576 over 48, 4 and 2 heads (d 12, 144, 288), K10 / K11 at
    (4, 3600, ., .) with c 384 as 32 x 12, 3 x 128 and 1 x 384 (batch 4:
    the plain version's fp32 scores over 32 heads at batch 16 would not fit
    the card), K14 at (400, 49 -> 196) with c 768 as 64 x 12, 6 x 128, 2 x
    384. Each shape names its launches (`expect`); `f32` its fp32 run."""
    from sam2unet_torch.ops.fused_attention_block import strips_rem_bwd_regime

    fa = "sam2unet_tpu/ops/pallas/flash_attention.py"
    src_any = "sam2unet_torch/csrc/attention_any.cu"
    src_bwd = "sam2unet_torch/csrc/attention_any_bwd.cu"
    src_pad = "sam2unet_torch/csrc/attention_any_bwd_pad.cu"
    src_sm90 = "sam2unet_torch/csrc/flash_attention_bwd_sm90.cu"
    f32 = dict(f32={})

    def flash(b, s, nh, d, **more):
        return dict(batch=b, S=s, heads=nh, d=d, **more)

    # K10 and K14 in bf16 at 128 on the Hopper forward, at 12, 264 and 384
    # on the chunked kernels
    k10_sm90 = [flash(2, 320, 2, 128, **f32),
                flash(4, 3600, 3, 128, f32=dict(batch=1))]
    k10 = [flash(2, 320, 2, d, **f32) for d in (12, 264)] + [
        flash(4, 3600, nh, d, f32=dict(batch=1)) for nh, d in ((32, 12), (1, 384))]
    for g in k10_sm90 + k10:
        g["expect"] = ("flash_attention", f"S={g['S']},d={g['d']}")
    # K11 under autograd: bf16 on the Hopper kernels at the video memory
    # attention's (2, 4096, 1, 256), at 128, and at every width of their
    # instances with S 1000 against 1337 (q a leaf, k and v channel blocks);
    # on the chunked kernels at 12 and 264; fp32 (`f32`) on the kernels it
    # ran before
    k11_sm90 = [flash(2, 4096, 1, 256, f32=dict(batch=1)),
                flash(2, 320, 2, 128, **f32)] + [
        flash(2, 1000, 2, d, Sk=1337) for d in K11_SM90_HEAD_DIMS]
    k11 = [flash(2, 320, 2, d, **f32) for d in (12, 264)]
    for g in k11_sm90 + k11:
        sq, sk = g["S"], g.get("Sk", g["S"])
        g["expect"] = {("flash_attention", f"S={sk},d={g['d']}"): 1,
                       ("flash_attention_bwd_delta", f"S={sq}"): 1,
                       ("flash_attention_bwd_dq", f"S={sk}"): 1,
                       ("flash_attention_bwd_dkv", f"S={sk}"): 1}
    # timed: on the Hopper kernels (4, 3600, 3, 128) and (2, 4096, 1, 256),
    # on the chunked ones 32 x 12 and 1 x 384
    k11_timed_sm90 = [flash(4, 3600, 3, 128), flash(2, 4096, 1, 256)]
    k11_timed = [flash(4, 3600, nh, d) for nh, d in ((32, 12), (1, 384))]
    for g in k11_timed_sm90 + k11_timed:
        s = f"S={g['S']}"
        g["expect"] = {("flash_attention_bwd_delta", s): 1,
                       ("flash_attention_bwd_dq", s): 1,
                       ("flash_attention_bwd_dkv", s): 1}
    k14_sm90 = [flash(2, 49, 2, 128, Sk=196, **f32),
                flash(400, 49, 6, 128, Sk=196, f32=dict(batch=8))]
    k14 = [flash(2, 49, 2, d, Sk=196, **f32) for d in (12, 264)] + [
        flash(400, 49, nh, d, Sk=196, f32=dict(batch=8))
        for nh, d in ((64, 12), (2, 384))]
    for g in k14_sm90 + k14:
        g["expect"] = ("full_attention", f"Sq=49,Sk=196,d={g['d']}")
    c24 = dict(c=24, heads=2)
    k6 = [dict(windows=4, S=64, **c24, **f32),
          dict(windows=4, S=64, n_pad=16, **c24, **f32)] + [
        dict(windows=32, S=256, c=576, heads=nh, f32=dict(windows=2))
        for nh in (48, 4, 2)]
    for g in k6:
        g["expect"] = ("fused_window_block", f"S={g['S']},n_pad={g.get('n_pad', 0)}")
    k7 = [dict(windows=4, S=64, **c24, **f32)] + [
        dict(windows=32, S=256, c=576, heads=nh, f32=dict(windows=2))
        for nh in (48, 4, 2)]
    for g in k7:
        g["expect"] = ("window_block_bwd", f"S={g['S']}")
    masked = [dict(batch=2, grid=12, window=8, **c24, **f32)]
    wgrad = [dict(windows=4, S=64, **c24, **f32,
                  expect=("window_block_bwd", "S=64,wgrad"))]
    strips = [dict(batch=2, grid=16, window=8, **c24, **f32)]
    rem = [dict(batch=2, grid=30, window=8, **c24, **f32)]
    regime = strips_rem_bwd_regime(30, 30, 8, 24, 2, 2)
    rem_bwd = [dict(g, expect=("window_block_strips_rem_bwd", f"window=8,{regime}"),
                    f32=dict(expect=("window_block_strips_rem_bwd", "window=8,"
                                     + strips_rem_bwd_regime(30, 30, 8, 24, 2, 4))))
               for g in rem]
    tra = [dict(batch=2, grid=16, window=8, cin=24, c=48, heads=4, **f32)]
    src_tr = "sam2unet_tpu/ops/pallas/fused_transition.py"

    def sel(wrapper, *tags):
        return lambda w, v: w == wrapper and all(t in v for t in tags)

    def sel_d(wrapper, hopper):
        # the head dims of a route: the Hopper forward's d % 8 == 0 below
        # 256 (K10 at 256 has its own entry), or the chunked kernels' rest
        def select(w, v):
            if w != wrapper:
                return False
            d = int(v.rsplit("d=", 1)[1])
            return d != 256 and (d % 8 == 0 and d < 256) == hopper
        return select
    src_fwd = "sam2unet_torch/csrc/flash_attention_fwd_sm90.cu"
    return [
        ("K10 flash_attention (wgmma)", "flash", f"{fa}:190",
         src_fwd, sel_d("flash_attention", True), k10_sm90, 1),
        ("K10 flash_attention (any head dim)", "flash", f"{fa}:190", src_any,
         sel_d("flash_attention", False), k10, 2),
        ("K10 flash_attention (head dim 256, under autograd)", "flash",
         f"{fa}:190", src_fwd, sel("flash_attention", "d=256"),
         [flash(2, 4096, 1, 256, f32=dict(batch=1),
                expect=("flash_attention", "S=4096,d=256"))], 0),
        ("K11 flash_attention_bwd (wgmma, under autograd)", "flash_grad",
         f"{fa}:314", src_sm90,
         lambda w, v: w.startswith("flash_attention_bwd"), k11_sm90, 0),
        ("K11 flash_attention_bwd (any head dim, under autograd)", "flash_grad",
         f"{fa}:314", src_bwd,
         lambda w, v: w.startswith("flash_attention_bwd"), k11, 0),
        ("K11 flash_attention_bwd (wgmma, head dims 128 and 256, timed)",
         "flash_bwd", f"{fa}:314", src_sm90,
         lambda w, v: w.startswith("flash_attention_bwd"), k11_timed_sm90, 0),
        ("K11 flash_attention_bwd (any head dim, timed)", "flash_bwd", f"{fa}:314",
         src_bwd, lambda w, v: w.startswith("flash_attention_bwd"), k11_timed, 0),
        ("K14 full_attention (wgmma)", "full", f"{fa}:93", src_fwd,
         sel_d("full_attention", True), k14_sm90, 1),
        ("K14 full_attention (any head dim)", "full", f"{fa}:93", src_any,
         sel_d("full_attention", False), k14, 2),
        ("K4 fused_window_block_strips (head dim 12)", "strips", f"{fab}:1021",
         src_any, sel("fused_window_block_strips"),
         [dict(g, expect=("fused_window_block_strips", "window=8")) for g in strips],
         0),
        ("K12 fused_window_block_strips_rem (head dim 12)", "strips_rem",
         f"{fab}:1566", src_any, sel("fused_window_block_strips_rem"),
         [dict(g, expect=("fused_window_block_strips_rem", "window=8")) for g in rem],
         0),
        ("K5 window_block_strips_bwd (head dim 12)", "strips_bwd", f"{fab}:1082",
         src_bwd, sel("window_block_strips_bwd"),
         [dict(g, expect=("window_block_strips_bwd", "window=8")) for g in strips],
         0),
        ("K13 window_block_strips_rem_bwd (head dim 12)", "strips_rem_bwd",
         f"{fab}:{1843 if regime == 'K13b' else 1651}", src_pad,
         sel("window_block_strips_rem_bwd"), rem_bwd, 0),
        ("K6 fused_window_block (any head dim)", "window", f"{fab}:354", src_any,
         lambda w, v: w == "fused_window_block" and ",n_pad=" in v, k6, 2),
        ("K6 fused_window_block (masked, head dim 12)", "window_masked",
         f"{fab}:354", src_any, sel("fused_window_block", ",masked"),
         [dict(g, expect=("fused_window_block", "S=144,masked")) for g in masked],
         0),
        ("K7 window_block_bwd (any head dim)", "window_bwd", f"{fab}:669", src_bwd,
         lambda w, v: w == "window_block_bwd" and "," not in v, k7, 1),
        ("K7 window_block_bwd (masked, head dim 12)", "window_masked_bwd",
         f"{fab}:669", src_pad, sel("window_block_bwd", ",masked"),
         [dict(g, expect=("window_block_bwd", "S=144,masked")) for g in masked], 0),
        ("K7 window_block_bwd (weight-grad, head dim 12)", "window_wgrad",
         f"{fab}:669", src_bwd, sel("window_block_bwd", ",wgrad"), wgrad, 0),
        ("K8 fused_transition_block (head dim 12)", "transition", f"{src_tr}:256",
         src_any, sel("fused_transition_block"),
         [dict(g, expect=("fused_transition_block", "window=8")) for g in tra], 0),
        ("K9 transition_bwd (head dim 12)", "transition_bwd", f"{src_tr}:483",
         src_bwd, sel("transition_bwd"),
         [dict(g, expect=("transition_bwd", "window=8")) for g in tra], 0)]


# the widths of K1 / K2 / K3 (C, hidden) and of the window block (c, heads)
WIDTHS_MLP = ((12, 8), (13, 26), (20, 32), (2056, 64))
WIDTHS_BLOCK = ((26, 2), (20, 4), (2064, 8))


def widths_kernel_specs(fab: str) -> list[tuple]:
    """The LN and GEMM passes at widths the 16-byte-vector instances do not
    take (csrc/gemm_any.cu): K1 in the JAX package's modes (the LN tail,
    the adapter, neither LN nor the residual), K2 in the tail's and the
    no-LN modes and K3 at C 12, 13, 20 and 2056 (hidden 8, 26, 32, 64; K3's
    adapter 32 at 2056), `fused_mlp` under autograd at each (K1, then K2 or
    K3); K15 / K16 at the JAX test's 80 x 12 -> 36 with and without the
    bias, K15 at 13 -> 20 and 2060 -> 24, K16 under autograd; K6 / K7 in
    every mode (n_pad 0 and 5, masked on a 4 x 4 grid window 3, the
    weight-gradient mode, K6 then K7 under autograd) on (2 windows, 16
    tokens) at c 26 over 2 heads, 20 over 4, 2064 over 8; K4 / K5 on (2,
    16, 16, 26) w8 and K12 / K13 on (2, 30, 30, 26) w8, 2 heads; K8 / K9 at
    (2, 16, 16, 20) -> 40 w8 over 4 heads, (1, 8, 8, 2056) -> 48 w4 over 4
    and an odd cout, (2, 8, 8, 20) -> 27 w4 over 3. Timed rows, each beside
    the aligned row it pairs with: K1's tail at 15488 x 572 (hidden 2288)
    against 15488 x 576, K1 at 4096 x 2056 (hidden 8224, LN past 2048), K15
    / K16 at 15488 x 572 -> 1716 against 576 -> 1728, K2 at 7744 x 572
    against 576, K3 at 7744 x 572 (hidden 32) against 576, K6 / K7 at 32 x
    256 x 580 over 4 heads against 576, K8 at (32, 88, 88, 148) -> 296 w8
    over 2 heads against 144 -> 288 over 2 heads and over hiera_l@352's 4.
    Each shape names its launches
    (`expect`); `f32` its fp32 run; `as_kind` a kind other than its
    entry's."""
    from sam2unet_torch.ops.fused_attention_block import strips_rem_bwd_regime

    fmlp = "sam2unet_tpu/ops/pallas/fused_mlp.py"
    src_tr = "sam2unet_tpu/ops/pallas/fused_transition.py"
    src = "sam2unet_torch/csrc/gemm_any.cu"
    f32 = dict(f32={})

    def mlp_variant(c, ln, res):
        return f"C={c}" + ("" if ln else ",no_ln") + ("" if res else ",no_residual")

    k1, k2, k3 = [], [], []
    for c, hd in WIDTHS_MLP:
        base = dict(tokens=150, c=c, hidden=hd, **f32)
        k1 += [dict(base, expect=("fused_mlp", "ln")),
               dict(base, ln=False, residual=False, expect=("fused_mlp", "no_ln")),
               dict(base, as_kind="mlp_adapter", expect=("fused_mlp", "no_ln"))]
        k2 += [dict(base, expect=("mlp_bwd_dx", mlp_variant(c, True, True))),
               dict(base, ln=False, residual=False,
                    expect=("mlp_bwd_dx", mlp_variant(c, False, False)))]
        k2 += [dict(base, as_kind="mlp_grad", mode=mode,
                    expect={("fused_mlp", v): 1,
                            ("mlp_bwd_dx", mlp_variant(c, mode == "ln tail",
                                                       mode == "ln tail")): 1})
               for mode, v in (("ln tail", "ln"), ("no ln, no residual", "no_ln"))]
        ha = 32 if c > 2048 else hd
        k3 += [dict(base, hidden=ha, expect=("adapter_bwd", f"C={c}")),
               dict(base, hidden=ha, as_kind="mlp_grad", mode="adapter",
                    expect={("fused_mlp", "no_ln"): 1, ("adapter_bwd", f"C={c}"): 1})]
    k1 += [dict(tokens=15488, c=576, hidden=2304, expect=("fused_mlp", "ln")),
           dict(tokens=4096, c=2056, hidden=8224, expect=("fused_mlp", "ln")),
           dict(tokens=15488, c=572, hidden=2288, expect=("fused_mlp", "ln"))]
    k2 += [dict(tokens=7744, c=c, hidden=4 * c,
                expect=("mlp_bwd_dx", mlp_variant(c, True, True)))
           for c in (576, 572)]
    k3 += [dict(tokens=7744, c=c, hidden=32, expect=("adapter_bwd", f"C={c}"))
           for c in (576, 572)]

    def lm(c, n, add_bias=True, tokens=80, **more):
        return dict(tokens=tokens, c=c, n=n, add_bias=add_bias, **more)
    k15 = [lm(12, 36, ab, **f32) for ab in (True, False)] + [
        lm(13, 20, **f32), lm(2060, 24, **f32),
        lm(576, 1728, tokens=15488), lm(572, 1716, tokens=15488)]
    for g in k15:
        g["expect"] = ("fused_ln_matmul", f"C={g['c']},N={g['n']}")
    k16 = [lm(12, 36, ab, **f32) for ab in (True, False)] + [
        lm(12, 36, as_kind="ln_qkv_grad", **f32),
        lm(576, 1728, tokens=15488), lm(572, 1716, tokens=15488)]
    for g in k16:
        g["expect"] = ("fused_ln_qkv", f"C={g['c']},N={g['n']}")

    k6, k7 = [], []
    for c, nh in WIDTHS_BLOCK:
        win = dict(windows=2, S=16, c=c, heads=nh, **f32)
        masked = dict(batch=2, grid=4, window=3, c=c, heads=nh, **f32)
        k6 += [dict(win, n_pad=n_pad, expect=("fused_window_block",
                                              f"S=16,n_pad={n_pad}"))
               for n_pad in (0, 5)]
        k6 += [dict(masked, as_kind="window_masked",
                    expect=("fused_window_block", "S=16,masked"))]
        k7 += [dict(win, expect=("window_block_bwd", "S=16")),
               dict(masked, as_kind="window_masked_bwd",
                    expect=("window_block_bwd", "S=16,masked")),
               dict(win, as_kind="window_wgrad",
                    expect=("window_block_bwd", "S=16,wgrad")),
               dict(win, as_kind="window_grad",
                    expect={("fused_window_block", "S=16,n_pad=0"): 1,
                            ("window_block_bwd", "S=16"): 1})]
    for c in (576, 580):
        k6.append(dict(windows=32, S=256, c=c, heads=4,
                       expect=("fused_window_block", "S=256,n_pad=0")))
        k7.append(dict(windows=32, S=256, c=c, heads=4,
                       expect=("window_block_bwd", "S=256")))
    c26 = dict(c=26, heads=2, **f32)
    strips = [dict(batch=2, grid=16, window=8, **c26)]
    rem = dict(batch=2, grid=30, window=8, **c26)
    rem_bwd = [dict(rem, expect=("window_block_strips_rem_bwd", "window=8,"
                                 + strips_rem_bwd_regime(30, 30, 8, 26, 2, 2)),
                    f32=dict(expect=("window_block_strips_rem_bwd", "window=8,"
                                     + strips_rem_bwd_regime(30, 30, 8, 26, 2, 4))))]
    tra = [dict(batch=2, grid=16, window=8, cin=20, c=40, heads=4),
           dict(batch=1, grid=8, window=4, cin=2056, c=48, heads=4),
           dict(batch=2, grid=8, window=4, cin=20, c=27, heads=3)]
    k8 = [dict(g, f32={}, expect=("fused_transition_block", f"window={g['window']}"))
          for g in tra] + [
        dict(batch=32, grid=88, window=8, cin=cin, c=2 * cin, heads=nh,
             expect=("fused_transition_block", "window=8"))
        for cin, nh in ((144, 4), (144, 2), (148, 2))]
    k9 = [dict(g, f32=dict(no_near_ties=True),
               expect=("transition_bwd", f"window={g['window']}")) for g in tra]

    def sel(wrapper, *tags):
        return lambda w, v: w == wrapper and all(t in v for t in tags)
    return [
        ("K1 fused_mlp (any width)", "mlp_tail", f"{fmlp}:135", src,
         sel("fused_mlp"), k1, len(k1) - 1),
        ("K2 mlp_bwd_dx (any width)", "mlp_tail_bwd", f"{fmlp}:432", src,
         sel("mlp_bwd_dx"), k2, len(k2) - 1),
        ("K3 adapter_bwd (any width)", "mlp_adapter_bwd", f"{fmlp}:551", src,
         sel("adapter_bwd"), k3, len(k3) - 1),
        ("K15 fused_ln_matmul (any width)", "ln_matmul", f"{fmlp}:208", src,
         sel("fused_ln_matmul"), k15, len(k15) - 1),
        ("K16 fused_ln_qkv (any width)", "ln_qkv", f"{fmlp}:279", src,
         sel("fused_ln_qkv"), k16, len(k16) - 1),
        ("K6 fused_window_block (any width)", "window", f"{fab}:354", src,
         sel("fused_window_block"), k6, len(k6) - 1),
        ("K7 window_block_bwd (any width)", "window_bwd", f"{fab}:669", src,
         sel("window_block_bwd"), k7, len(k7) - 1),
        ("K4 fused_window_block_strips (any width)", "strips", f"{fab}:1021",
         src, sel("fused_window_block_strips"),
         [dict(g, expect=("fused_window_block_strips", "window=8")) for g in strips],
         0),
        ("K5 window_block_strips_bwd (any width)", "strips_bwd", f"{fab}:1082",
         src, sel("window_block_strips_bwd"),
         [dict(g, expect=("window_block_strips_bwd", "window=8")) for g in strips],
         0),
        ("K12 fused_window_block_strips_rem (any width)", "strips_rem",
         f"{fab}:1566", src, sel("fused_window_block_strips_rem"),
         [dict(rem, expect=("fused_window_block_strips_rem", "window=8"))], 0),
        ("K13 window_block_strips_rem_bwd (any width)", "strips_rem_bwd",
         f"{fab}:{1843 if 'K13b' in rem_bwd[0]['expect'][1] else 1651}", src,
         sel("window_block_strips_rem_bwd"), rem_bwd, 0),
        ("K8 fused_transition_block (any width)", "transition", f"{src_tr}:256",
         src, sel("fused_transition_block"), k8, len(k8) - 1),
        ("K9 transition_bwd (any width)", "transition_bwd", f"{src_tr}:483",
         src, sel("transition_bwd"), k9, 0)]


def shape_case(kind: str, g: dict, dtype, gen):
    """`make_case` for shape g of an entry of `kind`, at the shape's own kind
    (`as_kind`) where an entry holds shapes of several."""
    g = dict(g)
    return make_case(g.pop("as_kind", kind), dtype, gen, **g)


def plain_route(kind: str, g: dict, dtype) -> bool:
    """Whether the call takes the plain version by the JAX route: fp32 past
    the weight gate (`f32_weights_overflow`, the JAX package's
    `_f32_weights_overflow`) for K1, K15 and K16, which launch nothing
    there."""
    import torch

    from sam2unet_torch.ops.fused_mlp import f32_weights_overflow

    c = g.get("c", 0)
    hd = g.get("hidden", 4 * c if kind == "mlp_tail" else 32)
    n = g.get("n", 3 * c)
    shapes = {"mlp_tail": [(hd, c), (c, hd)], "mlp_adapter": [(hd, c), (c, hd)],
              "ln_matmul": [(n, c)], "ln_qkv": [(n, c)]}.get(kind)
    return shapes is not None and f32_weights_overflow(
        torch.empty(0, c, dtype=dtype),
        *(torch.empty(sh, device="meta") for sh in shapes))


def compare(call, tol: float) -> tuple[float, float, float, int]:
    """Max |kernel - plain| over the call's outputs, that over max |plain|
    (the worst of the outputs), the largest share of an output's tokens
    (rows of its last axis) past tol * max |plain| (1 if not finite), and
    the launches the kernel call made."""
    import torch

    from sam2unet_torch.ops import dispatch

    def outs(r):
        # fp32 copies, of fp32 outputs too: a call that writes into views it
        # was given writes them again under force_plain()
        return [t.clone() if t.dtype == torch.float32 else t.float()
                for t in (r if isinstance(r, tuple) else (r,))]

    dispatch.reset_launches()
    got = outs(call())
    launched = sum(dispatch.launches.values())
    with dispatch.force_plain():
        want = outs(call())
    torch.cuda.synchronize()
    worst_abs = worst_rel = worst_share = 0.0
    for g, w in zip(got, want):
        diff = (g - w).abs()
        err, scale = diff.max().item(), max(w.abs().max().item(), 1e-30)
        rel = err / scale
        share = (diff.reshape(-1, diff.shape[-1]).amax(-1) > tol * scale
                 ).float().mean().item()
        if not math.isfinite(err):
            rel = share = math.inf
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        worst_share = max(worst_share, share)
    return worst_abs, worst_rel, worst_share, launched


SM90_FWD_SOURCE = "sam2unet_torch/csrc/flash_attention_fwd_sm90.cu"
# the CUDA-core entry points of K10 and K14, which bf16 left for the Hopper
# forward (a bf16 call there would run attention_any.cu's mma.sync kernels)
OLD_FWD_ENTRIES = {"K10": ("k10_flash_attention", "k10_flash_attention_d256"),
                   "K14": ("k14_full_attention", "k14_full_attention_d256")}


@contextlib.contextmanager
def libraries_called():
    """The kernel libraries (`build.library`) that the calls inside ask for,
    in order: the route the wrappers took."""
    from sam2unet_torch.ops import build

    seen, library = [], build.library

    def spy(name):
        seen.append(name)
        return library(name)

    build.library = spy
    try:
        yield seen
    finally:
        build.library = library


SM90_MLP_SOURCE = "sam2unet_torch/csrc/mlp_sm90.cu"
# the kinds of K1's and K2's calls (`make_case`), whose bf16 calls at widths
# that are multiples of 8 run csrc/mlp_sm90.cu (`mlp_sm90_route`)
MLP_SM90_KINDS = ("mlp_tail", "mlp_adapter", "mlp_tail_bwd", "mlp_grad")


def mlp_widths(kind: str, g: dict) -> tuple[int, int]:
    """(C, hidden) of a K1 or K2 shape of `make_case`."""
    c = g["c"]
    return c, g.get("hidden", 4 * c if kind in ("mlp_tail", "mlp_tail_bwd") else 32)


def mlp_sm90_route(kind: str, g: dict) -> bool:
    """Whether a bf16 K1 or K2 call at shape g runs csrc/mlp_sm90.cu: C and
    hidden multiples of 8 (16-byte rows; the wrappers' tensors are
    contiguous and 16-byte aligned), and GELU on the output (the adapter's
    form) only where the adapter kernel takes it, hidden 32 and C up to
    1152; `_mlp_library` in ops/fused_mlp.py."""
    c, hd = mlp_widths(kind, g)
    gelu_out = kind == "mlp_adapter" or g.get("mode") == "adapter"
    return (c % 8 == 0 and hd % 8 == 0
            and (not gelu_out or (hd == 32 and c <= 1152)))


@contextlib.contextmanager
def mlp_old_route():
    """K1's and K2's bf16 calls on the mma.sync route they took before
    csrc/mlp_sm90.cu (csrc/fused_mlp.cu, csrc/fused_mlp_bwd.cu): the A/B of
    the timed rows."""
    from sam2unet_torch.ops import fused_mlp

    route = fused_mlp._mlp_library
    fused_mlp._mlp_library = lambda *a, **k: None
    try:
        yield
    finally:
        fused_mlp._mlp_library = route


SM90_BLOCK_BWD_SOURCE = "sam2unet_torch/csrc/block_bwd_sm90.cu"
# the kinds of K3's, K5's, K7's dx-only unmasked and K9's calls (`make_case`),
# whose bf16 calls run csrc/block_bwd_sm90.cu where `block_bwd_sm90_route`
# holds
BLOCK_BWD_KINDS = ("mlp_adapter_bwd", "window_bwd", "strips_bwd", "transition_bwd")
# K5 and K9: on l352train and s960train every shape is timed beside the
# route before, with its device time by kernel
SMALL_WINDOW_KINDS = ("strips_bwd", "transition_bwd")
# the paths whose K3 / K5 / K7 / K9 rows print their device time by kernel
# (`device_time_line`): the train steps at full batch, whose numbers PERF.md
# keeps (the multi-process dry run's rows at batch 1 read no device kernel)
DEVICE_LINE_PATHS = ("l352train", "s960train")


def block_bwd_sm90_route(kind: str, g: dict) -> bool:
    """Whether a bf16 K3, K5, K7 (dx-only, unmasked) or K9 call at shape g
    runs csrc/block_bwd_sm90.cu: K3 at C % 8 == 0 up to 1408 with hidden 32,
    K5, K7 and K9 at widths and head dims multiples of 8, the head dim up to
    128, K5 and K9 on windows of 4 or 8 (`_adapter_bwd_library`,
    `_window_bwd_library`, `_strips_bwd_library`, `_transition_bwd_library`)."""
    c = g["c"]
    if kind == "mlp_adapter_bwd":
        return c % 8 == 0 and g.get("hidden", 32) == 32 and c <= 1408
    d = c // g["heads"]
    ok = c % 8 == 0 and c % g["heads"] == 0 and d % 8 == 0 and d <= 128
    if kind == "window_bwd":
        return ok
    return ok and g["window"] in (4, 8) and g.get("cin", c) % 8 == 0


@contextlib.contextmanager
def block_bwd_old_route():
    """K3's, K5's, K7's and K9's bf16 calls on the routes they took before
    csrc/block_bwd_sm90.cu (csrc/fused_mlp_bwd.cu, csrc/fused_attention_block_bwd.cu,
    csrc/fused_transition_bwd.cu, on the mma.sync GEMM and attention
    passes): the A/B of the timed rows."""
    from sam2unet_torch.ops import fused_attention_block, fused_mlp, fused_transition

    routes = (fused_mlp._adapter_bwd_library, fused_attention_block._window_bwd_library,
              fused_attention_block._strips_bwd_library,
              fused_transition._transition_bwd_library)
    none = lambda *a, **k: None  # noqa: E731
    fused_mlp._adapter_bwd_library = fused_attention_block._window_bwd_library = none
    fused_attention_block._strips_bwd_library = none
    fused_transition._transition_bwd_library = none
    try:
        yield
    finally:
        (fused_mlp._adapter_bwd_library, fused_attention_block._window_bwd_library,
         fused_attention_block._strips_bwd_library,
         fused_transition._transition_bwd_library) = routes


def mlp_cublas_call(kind: str, g: dict, gen):
    """The products of a K1 (two) or K2 (three) call at shape g in cuBLAS,
    bf16: `torch.nn.functional.linear` and `torch.matmul`, which only this
    script calls, as the informative yardstick of the timed rows."""
    import torch
    import torch.nn.functional as F

    m, (c, hd) = g["tokens"], mlp_widths(kind, g)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(torch.bfloat16)

    x, w1, w2, h = rnd(m, c), rnd(hd, c), rnd(c, hd), rnd(m, hd)
    if kind == "mlp_tail_bwd":
        gy = rnd(m, c)
        return lambda: (F.linear(x, w1), torch.matmul(gy, w2), torch.matmul(h, w1))
    return lambda: (F.linear(x, w1), F.linear(h, w2))


def mlp_sentinel_check(gen) -> None:
    """csrc/mlp_sm90.cu's entry points called directly at 200 rows (no
    multiple of the 128-row GEMM or 64-row adapter tiles) and every width of
    the main paths, into outputs and scratch 77 rows longer that hold a
    sentinel: K1's tail and adapter (its streaming kernel), K2 with LN and
    the residual. No row past M may change; the rows below M against the
    plain version in bf16."""
    import torch

    from sam2unet_torch.ops import build, dispatch
    from sam2unet_torch.ops.fused_mlp import fused_mlp, mlp_bwd_dx

    lib, p = build.library("mlp_sm90"), dispatch.ptr
    stream = torch.cuda.current_stream().cuda_stream
    m, pad, sentinel, bf16 = 200, 77, 7.0, torch.bfloat16

    def rnd(*shape, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen, device=DEV) * scale + shift
        return t.to(bf16)

    def padded(n):
        return torch.full((m + pad, n), sentinel, dtype=bf16, device=DEV)

    def rel(got, want):
        return ((got[:m].float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    for c in (96, 144, 192, 288, 384, 576, 768, 1152):
        for hd, ln in ((4 * c, True), (32, False)):
            x = rnd(m, c)
            w1, b1 = rnd(hd, c, scale=1 / math.sqrt(c)), rnd(hd, scale=0.1)
            w2, b2 = rnd(c, hd, scale=1 / math.sqrt(hd)), rnd(c, scale=0.1)
            lw, lb = ((rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1)) if ln
                      else (None, None))
            xn, hidden, out = padded(c), padded(hd), padded(c)
            build.check(lib.k1_fused_mlp_sm90(
                1, p(x), p(w1), p(b1), p(w2), p(b2), p(lw), p(lb), p(xn),
                p(hidden), p(out), m, c, hd, c, 1, int(not ln), stream),
                "k1_fused_mlp_sm90")
            with dispatch.force_plain():
                want = fused_mlp(x, w1, b1, w2, b2, lw, lb, residual=True,
                                 gelu_out=not ln)
            errs = {"K1": rel(out, want)}
            untouched = {"K1 out": out[m:], "K1 xn": xn[m:],
                         "K1 hidden": hidden[m:]}
            if ln:
                gy = rnd(m, c)
                dh, dz, dx = padded(hd), padded(c), padded(c)
                build.check(lib.k2_mlp_bwd_dx_sm90(
                    1, p(x), p(gy), p(w1), p(b1), p(w2), p(lw), p(lb), p(xn),
                    p(dh), p(dz), p(dx), m, c, hd, c, 1, stream),
                    "k2_mlp_bwd_dx_sm90")
                with dispatch.force_plain():
                    want = mlp_bwd_dx(x, gy, w1, b1, w2, b2, lw, lb)
                errs["K2"] = rel(dx, want)
                untouched.update({"K2 dh": dh[m:], "K2 dz": dz[m:],
                                  "K2 dx": dx[m:]})
            torch.cuda.synchronize()
            moved = sorted(k for k, t in untouched.items()
                           if not bool((t == sentinel).all()))
            ok = not moved and all(e <= BF16_REL_TOL for e in errs.values())
            print(f"[kernel] csrc/mlp_sm90.cu at {m} rows, C {c}, hidden {hd}"
                  f" ({'tail' if ln else 'adapter'}): max_rel_err "
                  f"{ {k: round(v, 5) for k, v in errs.items()} } (tol "
                  f"{BF16_REL_TOL}), rows past M changed {moved}"
                  + ("" if ok else "  <-- FAIL"), flush=True)
            if not ok:
                fail(f"csrc/mlp_sm90.cu at {m} rows, C {c}, hidden {hd}: "
                     f"{errs}, rows past M changed {moved}")


def profile_events(call) -> list:
    """torch.profiler's events of one call on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return prof.events()


def device_time_line(call, calls: int = 5, attempts: int = 4) -> str:
    """The device time a call of `call` takes in each of its kernels, and
    their sum (the row's time without the wrapper's host work), from
    `calls` calls under torch.profiler. The profiler's first device records
    have come back without their kernels (the first two to four launches of
    a profile at 960, however long the pause before them; an acceptance
    call read 3 of K5's 6 kernels at one shape without them; after two
    calls of K3, two launches at 960): `calls` calls run first, and only
    the launches inside the timed calls' annotation, and their kernels,
    count. A profile whose trace still lacks one of their kernels, or whose entry-point calls launched unequal counts of
    kernels (`profile_model.trace_call_kernels`), is taken again with a
    longer pause on either side of the calls, `attempts` times in all, and
    then the run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from sam2unet_torch.utils import profile_model

    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        pause = 0.05 * 4 ** (attempt - 1)   # s: 0.05, 0.2, 0.8, 3.2
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pause)
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
            with record_function("device_time_line"):
                for _ in range(calls):
                    call()
            torch.cuda.synchronize()
            time.sleep(pause)
        with tempfile.TemporaryDirectory() as tmp:
            trace = str(Path(tmp) / "trace.json")
            prof.export_chrome_trace(trace)
            by_name, faults = profile_model.trace_call_kernels(trace, calls,
                                                              "device_time_line")
        if not by_name:
            faults.append("no device kernel recorded")
        if not faults:
            break
        print(f"[device] profile {attempt} of {attempts} read part of the calls' "
              f"kernels: {faults}", flush=True)
    else:
        fail(f"{attempts} profiles of the row each missed kernels of its calls: {faults}")
    short = lambda n: (n.replace("(anonymous namespace)::", "")  # noqa: E731
                       .replace("void ", "").split("(")[0][:48])
    ms = {n: us / calls / 1e3 for n, (us, _) in by_name.items()}
    launches = sum(k for _, k in by_name.values()) // calls
    parts = ", ".join(f"{short(n)} {v:.4f}" for n, v in sorted(ms.items(), key=lambda kv: -kv[1]))
    return (f"{sum(ms.values()):.4f} ms of device kernels a call, {launches} launches "
            f"({parts})")


def hopper_forward_check(events: list, kernel: str, what: str) -> tuple[str, bool]:
    """Which kernels ran `kernel` (K10 or K14) in the profiled events, as a
    line to print, and whether the Hopper forward's device kernel ran and
    none of the kernel's CUDA-core entry points did."""
    from sam2unet_torch.utils import profile_model

    new = sorted({e.name for e in profile_model.device_kernels(events)
                  if "fwd_sm90_kernel" in e.name})
    old = dict(collections.Counter(e.name for e in events
                                   if e.name in OLD_FWD_ENTRIES[kernel]))
    return (f"{what}: {kernel} on {new}, its CUDA-core entry points {old}",
            bool(new) and not old)


def k14_profile_worker(spec: dict) -> dict:
    """One bf16 call of each shape a path's K14 rows hold, each under
    torch.profiler after a warm-up call, in a process of its own (in the
    run's process a profile of one short call after the earlier paths
    recorded no device kernel). Returns what failed."""
    import torch

    gen = torch.Generator(device=DEV)
    gen.manual_seed(14)
    lines, faults, warm = [], [], False
    for name, kind, _r, _s, _sel, shapes, _t in kernel_specs(spec["path"], 1):
        if kind != "full":
            continue
        for g in shapes:
            call = shape_case(kind, g, torch.bfloat16, gen)[0]
            call()
            if not warm:
                # the process's first profile can come back without the
                # device's events (an acceptance call's d 256 row read
                # "K14 on []" and no other kernel): one is taken and dropped
                profile_events(call)
                warm = True
            line, ok = hopper_forward_check(
                profile_events(call), "K14",
                f"{name} {PATHS[spec['path']]['label']} bf16 {g}")
            lines.append(line)
            if not ok:
                faults.append(line)
    return dict(lines=lines, faults=faults)


def k14_profile_phase(path: str, tmp: Path) -> None:
    """`k14_profile_worker` on one rank: the K14 rows' shapes profiled."""
    (result,), wall = _torchrun(1, "k14_profile", {"path": path}, tmp, timeout=300)
    for line in result["lines"]:
        print(f"[profile] {line}", flush=True)
    print(f"[profile] {PATHS[path]['label']}: K14's rows profiled in a process "
          f"of their own, {wall:.1f} s", flush=True)
    if result["faults"]:
        fail(f"K14 ran off the Hopper forward: {result['faults']}")


def kernel_phase(path: str, batch: int, gen) -> list[dict]:
    """Phase 2 for one path. Returns the JSON entries (without launches)."""
    import torch

    from sam2unet_torch.ops import dispatch

    spec = PATHS[path]
    label = spec["label"]
    entries = []

    def expected_launch(name, g, dtype):
        # one launch of the JAX route's kernel per call, where the shape
        # names it (`compare` reset the counters before the kernel call)
        want = g.get("expect")
        if isinstance(want, tuple):
            want = {want: 1}
        if want is not None and dict(dispatch.variants) != want:
            fail(f"{name} {dtype} at {g}: launched "
                 f"{dict(dispatch.variants)}, the JAX route is {want}")

    for name, kind, replaces, source, select, shapes, timed in kernel_specs(
            path, batch):
        worst_abs = worst_rel = 0.0
        for i, g in enumerate(shapes):
            call, flops, nbytes, library = shape_case(kind, g, torch.bfloat16,
                                                      gen)
            with libraries_called() as libs:
                err, rel, share, launched = compare(call, BF16_REL_TOL)
            if not launched:
                fail(f"{name} launched nothing in bf16 at {g}")
            expected_launch(name, g, "bf16")
            if kind in ("flash", "full") and not spec.get("fp32"):
                # bf16 K10 / K14 on the route its row names
                hopper = "flash_attention_fwd_sm90" in libs
                if hopper != (source == SM90_FWD_SOURCE):
                    fail(f"{name} bf16 at {g} ran {libs}, its row names {source}")
            sk = g.get("as_kind", kind)
            if sk in MLP_SM90_KINDS and ("mlp_sm90" in libs) != mlp_sm90_route(sk, g):
                # bf16 K1 / K2 on csrc/mlp_sm90.cu at every width it takes
                fail(f"{name} bf16 at {g} ran {libs}")
            if sk in BLOCK_BWD_KINDS and ("block_bwd_sm90" in libs) != block_bwd_sm90_route(sk, g):
                # bf16 K3 / K5 / K7 (dx-only, unmasked) / K9 on csrc/block_bwd_sm90.cu
                fail(f"{name} bf16 at {g} ran {libs}")
            small = (sk in SMALL_WINDOW_KINDS and path in DEVICE_LINE_PATHS
                     and block_bwd_sm90_route(sk, g))

            near_ties = kind == "transition_bwd" and not g.get("ties")
            ok = (share <= K9_BF16_TOKEN_SHARE and rel <= K9_BF16_OUTLIER_REL
                  if near_ties else share == 0.0)
            line = (f"[kernel] {name} {label} bf16 {g}: max_abs_err {err:.4g} "
                    f"max_rel_err {rel:.4g} (tol {BF16_REL_TOL})")
            if near_ties:
                line += (f", tokens past the tolerance {share:.3g} (at most "
                         f"{K9_BF16_TOKEN_SHARE}, each within "
                         f"{K9_BF16_OUTLIER_REL})")
            if i == timed or spec.get("time_each") or small:
                ms = time_ms(call)
                with dispatch.force_plain():
                    plain_ms = time_ms(call)
                library_ms = time_ms(library) if library else None
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
                bound_ms = 1e3 * max(t_bytes, t_ops)
                bound_by = "bytes" if t_bytes > t_ops else "operations"
                line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"bound {bound_ms:.4f} ms ({bound_by})")
                if library:
                    line += f", library {library_ms:.4f} ms"
                if i == timed and sk in MLP_SM90_KINDS[:3] and mlp_sm90_route(sk, g):
                    # at the timed shape the A/B against the mma.sync route,
                    # and the products in cuBLAS on a line before
                    with mlp_old_route():
                        old_ms = time_ms(call)
                    line += f" (mma.sync route {old_ms:.4f} ms)"
                    print(f"[yardstick] {name} {label} bf16 {g}: its products "
                          f"in cuBLAS (torch.nn.functional.linear, "
                          f"torch.matmul) "
                          f"{time_ms(mlp_cublas_call(sk, g, gen)):.4f} ms",
                          flush=True)
                if (i == timed or small) and sk in BLOCK_BWD_KINDS and block_bwd_sm90_route(sk, g):
                    # at the timed shape (K5, K9: at each) the A/B against
                    # the route before, and on the train paths, on a line
                    # before, the device time of its kernels
                    with block_bwd_old_route():
                        old_ms = time_ms(call)
                    line += f" (mma.sync route {old_ms:.4f} ms)"
                    if path in DEVICE_LINE_PATHS:
                        print(f"[device] {name} {label} bf16 {g}: "
                              f"{device_time_line(call)}", flush=True)
            if i == timed:
                if (sk in BLOCK_BWD_KINDS and not spec.get("fp32")
                        and block_bwd_sm90_route(sk, g)):
                    source = SM90_BLOCK_BWD_SOURCE
                entry = dict(name=f"{name} [{label}]", route="cuda",
                             source=source, select=select, path=path,
                             replaces=replaces, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)
            print(line + ("" if ok else "  <-- FAIL"), flush=True)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            if not ok:
                fail(f"{name} disagrees with its plain version at {g}")
            del call, library
        # fp32 once, at the smallest main-path shape of the kernel; K9's at
        # its timed shape, full batch, on an input without near-ties; a path
        # whose main path runs in fp32 at every shape, as it is
        g = dict(shapes[-1])
        if kind == "transition_bwd":
            g = dict(shapes[timed], no_near_ties=True)
        for key in ("batch", "windows"):
            if key in g and kind != "transition_bwd":
                g[key] = min(g[key], 2)
        if "tokens" in g:
            g["tokens"] = min(g["tokens"], 2 * 484)
        every = [dict(g, no_near_ties=True) if kind == "transition_bwd"
                 and not g.get("ties") else g for g in shapes]
        if spec.get("fp32_listed"):
            # each shape's own fp32 run, where it has one
            runs = [dict(g, **g["f32"]) for g in shapes if "f32" in g]
        else:
            runs = every if spec.get("fp32") else [g]
        for g in runs:
            err, rel, share, launched = compare(
                shape_case(kind, g, torch.float32, gen)[0], FP32_REL_TOL)
            expected_launch(name, g, "fp32")
            plain = plain_route(g.get("as_kind", kind), g, torch.float32)
            ok = share == 0.0 and bool(launched) != plain
            print(f"[kernel] {name} {label} fp32 {g}: max_abs_err {err:.4g} "
                  f"max_rel_err {rel:.4g} (tol {FP32_REL_TOL})"
                  + (", the plain form past the fp32 weight gate (launches "
                     f"{launched})" if plain else "")
                  + ("" if ok else "  <-- FAIL"), flush=True)
            if not ok:
                fail(f"{name} fp32 disagrees with its plain version or its "
                     f"route at {g}")
            if spec.get("fp32") or spec.get("fp32_listed"):
                worst_abs = max(worst_abs, err)
        entry["max_abs_err"] = worst_abs
        entries.append(entry)
        torch.cuda.empty_cache()
    if path == "s960train":
        mlp_sentinel_check(gen)
    return entries


# ---------------------------------------------------------- main path


def write_dataset(root: Path, n: int = 4, seed: int = 0) -> None:
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    for i in range(n):
        h, w = int(rng.integers(200, 400)), int(rng.integers(200, 400))
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        yy, xx = np.mgrid[:h, :w]
        cy, cx = rng.integers(h // 4, 3 * h // 4), rng.integers(w // 4, 3 * w // 4)
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2 < (min(h, w) // 4) ** 2)
        mask = mask.astype(np.uint8) * 255
        img[mask > 0] = (img[mask > 0] * 0.3 + 170).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"s{i}.jpg")
        Image.fromarray(mask).save(root / "masks" / f"s{i}.png")


def random_checkpoint(path: Path, cfg: str, seed: int) -> None:
    """Seeded random SAM2UNet state dict of trunk `cfg`; the
    zero-initialised pos-embeds get noise so they take part."""
    import torch

    from sam2unet_torch.cli.common import build_model

    torch.manual_seed(seed)
    model = build_model(cfg, torch.device("cpu"))
    with torch.no_grad():
        model.encoder.pos_embed.normal_(0.0, 0.02)
        model.encoder.pos_embed_window.normal_(0.0, 0.02)
    torch.save(model.state_dict(), path)


def _agree(got, want) -> tuple[float, float, bool]:
    """(max |got - want| / max |want|, correlation, within MAIN_* limits)."""
    import torch

    got, want = got.flatten().double(), want.flatten().double()
    rel = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
    corr = torch.corrcoef(torch.stack([got, want]))[0, 1].item()
    ok = math.isfinite(rel) and corr >= MAIN_CORR_MIN and rel <= MAIN_REL_TOL
    return rel, corr, ok


def main_path_phase(path: str, tmp: Path) -> dict:
    import numpy as np
    import torch
    from PIL import Image

    from sam2unet_torch.cli import test_cli
    from sam2unet_torch.cli.common import build_model, load_checkpoint
    from sam2unet_torch.data.dataset import EvalDataset
    from sam2unet_torch.ops import dispatch

    spec = PATHS[path]
    label, cfg, size = spec["label"], spec["cfg"], spec["size"]
    data, ckpt, preds = tmp / "data", tmp / f"{cfg}.pth", tmp / f"preds_{path}"
    if not data.exists():
        write_dataset(data)
    random_checkpoint(ckpt, cfg, seed=0)
    argv = ["--checkpoint", str(ckpt), "--test_image_path", str(data / "images"),
            "--test_gt_path", str(data / "masks"), "--save_path", str(preds),
            "--bf16", "--batch_size", "4", "--device", DEV]
    defaults = test_cli.build_parser().parse_args(argv)
    at_defaults = (defaults.size, defaults.model_cfg) == (size, cfg)
    if not at_defaults:
        argv += ["--size", str(size), "--model_cfg", cfg]
    args = test_cli.build_parser().parse_args(argv)
    dispatch.reset_launches()
    stats = test_cli.main(args)
    torch.cuda.synchronize()
    counts, variants = dict(dispatch.launches), dict(dispatch.variants)
    print(f"[main] {label} test_cli --size {args.size} --model_cfg "
          f"{args.model_cfg} ({'the CLI defaults' if at_defaults else 'passed'}): "
          f"{stats['forwards']} forward(s) over {stats['images']} images, "
          f"mean_test_time {stats['mean_test_time']:.4f} s/image; launches "
          f"{counts}; by variant "
          f"{ {f'{w}[{v}]': n for (w, v), n in variants.items()} }", flush=True)
    per_forward = spec["per_forward"]
    for name in set(per_forward) | set(counts):
        want = per_forward.get(name, 0) * stats["forwards"]
        if counts.get(name, 0) != want:
            fail(f"{label}: {name} launched {counts.get(name, 0)} times, "
                 f"expected {want}")
    for i in range(4):
        png = np.asarray(Image.open(preds / f"s{i}.png"))
        gt = np.asarray(Image.open(data / "masks" / f"s{i}.png"))
        if png.shape != gt.shape or png.dtype != np.uint8 or png.min() == png.max():
            fail(f"{label} s{i}.png: shape {png.shape} vs GT {gt.shape}, range "
                 f"{png.min()}..{png.max()}")
    print(f"[main] {label} 4 PNGs: GT shapes, uint8, more than one value",
          flush=True)

    # the same batch through the plain versions on the card
    model = build_model(cfg, torch.device("cpu"))
    load_checkpoint(model, str(ckpt))
    model = model.to(device=DEV, dtype=torch.bfloat16)
    batch = next(EvalDataset(str(data / "images"), str(data / "masks"),
                             size).batches(4))
    x = torch.from_numpy(batch["image"]).to(DEV)
    with torch.inference_mode():
        got = model(x)[0].float()
        with dispatch.force_plain():
            want = model(x)[0].float()
    rel, corr, ok = _agree(got, want)
    print(f"[main] {label} logits kernels vs plain (bf16, batch 4): "
          f"max_rel_err {rel:.4g} (tol {MAIN_REL_TOL}) corr {corr:.6f} (min "
          f"{MAIN_CORR_MIN})" + ("" if ok else "  <-- FAIL"), flush=True)
    if not ok:
        fail(f"{label} main path logits disagree with the plain versions")
    del model, got, want
    torch.cuda.empty_cache()
    return variants


def sam2_predictor():
    """The SAM2 image predictor through `build_sam2_image_predictor` at its
    defaults (sam2_hiera_s, 1024 px) on the card in bf16, seeded random
    weights (the zero-initialised pos-embeds get noise)."""
    import torch

    from sam2unet_torch.build_sam import build_sam2_image_predictor

    torch.manual_seed(0)
    pred = build_sam2_image_predictor(device=DEV, dtype=torch.bfloat16)
    trunk = pred.model.image_encoder.trunk
    with torch.no_grad():
        trunk.pos_embed.normal_(0.0, 0.02)
        trunk.pos_embed_window.normal_(0.0, 0.02)
    return pred


def sam2_image(seed: int = 0, hw: tuple[int, int] = (720, 960)):
    import numpy as np

    return (np.random.default_rng(seed).random((*hw, 3)) * 255).astype(
        np.uint8)


SAM2_PROMPTS = {
    "one point": dict(point_coords=[[480.0, 360.0]], point_labels=[1]),
    "a box": dict(box=[300.0, 200.0, 700.0, 560.0]),
    "points and a box": dict(point_coords=[[480.0, 360.0], [350.0, 250.0]],
                             point_labels=[1, 0],
                             box=[300.0, 200.0, 700.0, 560.0]),
    "9 points (16 tokens)": dict(
        point_coords=[[100.0 + 90 * i, 80.0 + 60 * i] for i in range(9)],
        point_labels=[1, 0, 1, 1, 0, 1, 0, 1, 1]),
}


def sam2_main_phase(path: str) -> dict:
    """The SAM2 image predictor end to end: set_image on a seeded 720x960
    image and predict with each prompt type, multimask on and off, a mask
    input, set_image_batch + predict_batch over 2 images; the outputs'
    shapes and ranges; launches per set_image and per predict (counters set
    to 0 just before each call, read just after); the embedding and the
    low-res logits against force_plain(); then the same under the "pallas"
    attention backend (K14), with the SAM2-UNet hiera_s@960 forward at
    batch 16 besides, each against the default backend."""
    import numpy as np
    import torch

    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.ops.attention import set_attention_impl

    spec = PATHS[path]
    label = spec["label"]
    pred = sam2_predictor()
    image = sam2_image()
    variants: collections.Counter = collections.Counter()

    def counted(fn, want: dict, what: str):
        dispatch.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(dispatch.launches)
        variants.update(dispatch.variants)
        print(f"[main] {label} {what}: launches {counts}", flush=True)
        if counts != want:
            fail(f"{label} {what}: launches {counts}, expected {want}")
        return out

    def check(masks, ious, low, n_out: int, hw, what: str):
        ok = (masks.shape == (n_out, *hw) and masks.dtype == np.bool_
              and ious.shape == (n_out,) and low.shape == (n_out, 256, 256)
              and np.isfinite(ious).all() and (ious >= 0).all()
              and (ious <= 1).all() and np.isfinite(low).all()
              and all(m.any() for m in masks))
        print(f"[main] {label} {what}: masks {masks.shape} {masks.dtype}, "
              f"foreground share {[round(float(m.mean()), 3) for m in masks]}, "
              f"ious {np.round(ious, 4).tolist()}, low-res {low.shape}"
              + ("" if ok else "  <-- FAIL"), flush=True)
        if not ok:
            fail(f"{label} {what}: bad outputs")

    hw = image.shape[:2]
    counted(lambda: pred.set_image(image), spec["per_set_image"],
            f"set_image {hw[0]}x{hw[1]}")
    first = None
    for name, prompt in SAM2_PROMPTS.items():
        for multimask in (True, False):
            want = spec["per_predict_16"] if "16 tokens" in name else {}
            masks, ious, low = counted(
                lambda: pred.predict(**{k: np.asarray(v) for k, v in
                                        prompt.items()},
                                     multimask_output=multimask),
                want, f"predict {name}, multimask {multimask}")
            check(masks, ious, low, 3 if multimask else 1, hw,
                  f"predict {name}, multimask {multimask}")
            if first is None:
                first = (masks, ious, low)
    pt = SAM2_PROMPTS["one point"]
    best = first[2][int(np.argmax(first[1]))][None]
    masks, ious, low = counted(
        lambda: pred.predict(np.asarray(pt["point_coords"]),
                             np.asarray(pt["point_labels"]), mask_input=best,
                             multimask_output=False),
        {}, "predict one point with a mask input")
    check(masks, ious, low, 1, hw, "predict one point with a mask input")

    images = [image, sam2_image(1, (600, 800))]
    counted(lambda: pred.set_image_batch(images), spec["per_set_image"],
            "set_image_batch of 2 images (one forward)")
    ms, ious_b, lows = counted(
        lambda: pred.predict_batch(
            [np.asarray(pt["point_coords"])] * 2,
            [np.asarray(pt["point_labels"])] * 2), {}, "predict_batch")
    for m, i, lo, im in zip(ms, ious_b, lows, images):
        check(m, i, lo, 3, im.shape[:2], "predict_batch")

    def run(plain: bool = False):
        with dispatch.force_plain() if plain else contextlib.nullcontext():
            pred.set_image(image)
            low = pred.predict(np.asarray(pt["point_coords"]),
                               np.asarray(pt["point_labels"]))[2]
            emb = pred.get_image_embedding().float().clone()
        return emb, torch.from_numpy(low)

    def compare_runs(got, want, what):
        for name, g, w in zip(("image embedding", "low-res logits"), got, want):
            rel, corr, ok = _agree(g, w)
            print(f"[main] {label} {name}, {what} (bf16): max_rel_err "
                  f"{rel:.4g} (tol {MAIN_REL_TOL}) corr {corr:.6f} (min "
                  f"{MAIN_CORR_MIN})" + ("" if ok else "  <-- FAIL"), flush=True)
            if not ok:
                fail(f"{label}: {name} {what} disagree")

    auto = run()
    compare_runs(auto, run(plain=True), "kernels vs plain")

    # the "pallas" attention backend: K14 on every attention over at most
    # 1024 keys, as the JAX package's switch
    set_attention_impl("pallas")
    try:
        counted(lambda: pred.set_image(image),
                {**spec["per_set_image"], **spec["pallas_set_image"]},
                'set_image under set_attention_impl("pallas")')
        counted(lambda: pred.predict(np.asarray(pt["point_coords"]),
                                     np.asarray(pt["point_labels"])),
                spec["pallas_predict_8"],
                'predict one point (8 tokens) under "pallas"')
        compare_runs(run(), auto, '"pallas" backend vs the default')
        model, x = _model_and_input("s960", 16)
        dispatch.reset_launches()
        with torch.inference_mode():
            got = model(x)[0].float()
        torch.cuda.synchronize()
        counts = dict(dispatch.launches)
        # only K14's launches are this path's; the forward's others are the
        # s960 path's, held there
        variants.update({wv: n for wv, n in dispatch.variants.items()
                         if wv[0] == "full_attention"})
    finally:
        set_attention_impl(None)
    want = {**PATHS["s960"]["per_forward"], "full_attention": 1}
    print(f"[main] {label} SAM2-UNet hiera_s@960 forward, batch 16, under "
          f'"pallas": launches {counts}', flush=True)
    if counts != want:
        fail(f"{label}: SAM2-UNet@960 under pallas launched {counts}, "
             f"expected {want}")
    with torch.inference_mode():
        base = model(x)[0].float()
    rel, corr, ok = _agree(got, base)
    print(f"[main] {label} SAM2-UNet hiera_s@960 logits, \"pallas\" vs the "
          f"default backend (bf16, batch 16): max_rel_err {rel:.4g} corr "
          f"{corr:.6f}" + ("" if ok else "  <-- FAIL"), flush=True)
    if not ok:
        fail(f"{label}: SAM2-UNet@960 under pallas disagrees")
    del model, x, pred
    torch.cuda.empty_cache()
    return dict(variants)


def sam2_throughput_phase(path: str, card: str, n: int = 20) -> None:
    """As scripts/bench_sam2.py measures it: set_image (host clock: the
    numpy transform, the copy, the forward) and its device forward alone
    (CUDA events), then steady-state one-point predict ms (CUDA events
    around n calls after a warm-up; the device postprocess, and the host
    one), with peak memory."""
    import numpy as np
    import torch

    label = PATHS[path]["label"]
    pred = sam2_predictor()
    image = sam2_image()
    for _ in range(2):
        pred.set_image(image)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        pred.set_image(image)
    torch.cuda.synchronize()
    set_ms = (time.perf_counter() - t0) * 1e3 / reps
    x = torch.from_numpy(pred._transforms(image)[None]).to(DEV)

    def forward():
        with torch.inference_mode():
            return pred.model.forward_image(x)["backbone_fpn"][-1]
    fwd_ms = time_ms(forward, reps=10)
    pred.set_image(image)
    pt = np.array([[480.0, 360.0]])

    def predict_ms():
        pred.predict(pt, np.array([1]))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            pred.predict(pt + i, np.array([1]))
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    dev_ms = predict_ms()
    pred._transforms.max_hole_area = -1.0   # the host postprocess
    host_ms = predict_ms()
    pred._transforms.max_hole_area = 0.0
    print(f"[throughput] {label} bf16 720x960 image on {card}: set_image "
          f"{set_ms:.2f} ms (host clock; forward_image alone {fwd_ms:.2f} ms, "
          f"CUDA events), predict one point {dev_ms:.2f} ms "
          f"({1e3 / dev_ms:.1f} prompts/s steady state; device "
          f"postprocess), {host_ms:.2f} ms with the host postprocess; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    del pred, x
    torch.cuda.empty_cache()


def sam2_video_predictor(path: str = "s1024video", resident: bool = True):
    """The SAM2 video predictor of a video path through
    `build_sam2_video_predictor` on the card in bf16: at s1024video its
    defaults (sam2_hiera_s, 1024 px, binarised prompted masks, holes of up
    to 8 pixels filled), at t512video sam2_hiera_t with
    SAM2Config(image_size=512) as scripts/smoke_video.py builds it (holes
    filled, the rest of the config explicit); the weights of
    `sam2_predictor` (seeded, the pos-embeds with noise); `resident` False
    takes the host-gathered bank.

    Random weights give tracked objects a score below zero, and the SAM
    heads then replace the whole mask by -1024 (object absent): every
    comparison would hold constants. The object-score head's last bias is
    set to +10 so that the tracked masks are the model's logits."""
    import torch

    from sam2unet_torch.build_sam import build_sam2_video_predictor
    from sam2unet_torch.models.sam2_base import SAM2Config
    from sam2unet_torch.predictors.video_predictor import SAM2VideoPredictor

    spec = PATHS[path]
    kw = {}
    if spec["size"] != SAM2Config().image_size:
        kw["sam2_config"] = SAM2Config(image_size=spec["size"])
    torch.manual_seed(0)
    pred = build_sam2_video_predictor(spec["cfg"], device=DEV,
                                      dtype=torch.bfloat16, **kw)
    trunk = pred.model.image_encoder.trunk
    with torch.no_grad():
        trunk.pos_embed.normal_(0.0, 0.02)
        trunk.pos_embed_window.normal_(0.0, 0.02)
        pred.model.sam_mask_decoder.pred_obj_score_head.layers[-1].bias.fill_(
            10.0)
    if not resident:
        pred = SAM2VideoPredictor(pred.model, fill_hole_area=pred.fill_hole_area,
                                  device_resident=False)
    return pred


def video_frames(path: str, seed: int = 0):
    """The path's frames: noise with a bright disc moving right and a dark
    one moving left, as scripts/smoke_video.py draws them at 240x320 (at
    480x640 twice its size)."""
    import numpy as np

    spec = PATHS[path]
    rng = np.random.default_rng(seed)
    h, w = spec["hw"]
    k = h // 240
    yy, xx = np.mgrid[:h, :w]
    frames = (rng.random((spec["frames"], h, w, 3)) * 255).astype(np.uint8)
    for t in range(spec["frames"]):
        cx = k * (80 + 20 * t)
        frames[t][((yy - 120 * k) ** 2 + (xx - cx) ** 2) < (40 * k) ** 2] = 230
        frames[t][((yy - 60 * k) ** 2 + (xx - (w - cx)) ** 2) < (30 * k) ** 2] = 25
    return frames


def video_prompts(path: str, pred, state):
    """(what, call) of the flow's prompts on frame 0: one positive point on
    each disc (objects 1 and 2), then a mask over object 2's disc."""
    import numpy as np

    spec = PATHS[path]
    y0, y1, x0, x1 = spec["mask"]
    box = np.zeros(spec["hw"], bool)
    box[y0:y1, x0:x1] = True
    p1, p2 = ([list(p)] for p in spec["points"])
    return [("add_new_points object 1", lambda: pred.add_new_points(
                state, 0, 1, p1, [1])),
            ("add_new_points object 2", lambda: pred.add_new_points(
                state, 0, 2, p2, [1])),
            ("add_new_mask object 2", lambda: pred.add_new_mask(
                state, 0, 2, box))]


def video_flow(path: str, pred, frames, counted=None) -> dict:
    """init_state, the prompts, propagate_in_video forward and then in
    reverse from the path's frame, and (t512video) a forward drain of
    packed masks; {step: masks (objects, 1, H, W) logits (packed: 0/1) on
    the host}. `counted(fn, what, tracked)` wraps each call and each
    yielded frame (tracked: a frame the memory attention ran on)."""
    import numpy as np
    import torch

    spec = PATHS[path]

    def run(fn, what, tracked=False):
        return counted(fn, what, tracked) if counted else fn()

    def host(m):
        return (m.float().cpu() if torch.is_tensor(m)
                else torch.from_numpy(np.asarray(m)).float())

    state = run(lambda: pred.init_state(images=frames), "init_state")
    out = {}
    for what, fn in video_prompts(path, pred, state):
        _, ids, masks = run(fn, what)
        out[what] = host(masks)
    runs = [("forward", {}),
            ("reverse", dict(start_frame_idx=spec["reverse_from"],
                             reverse=True))]
    if spec.get("drain"):
        runs.append(("packed", dict(yield_packed_masks=True)))
    for tag, kw in runs:
        it = pred.propagate_in_video(state, **kw)
        while True:
            try:
                f, ids, masks = run(lambda: next(it), f"{tag} frame",
                                    tracked=True)
            except StopIteration:
                break
            if list(ids) != [1, 2]:
                fail(f"video: object ids {ids}")
            if tag == "packed":   # bit-packed along the width
                masks = np.unpackbits(masks.cpu().numpy(), axis=-1)[
                    ..., :spec["hw"][1]]
            out[f"{tag} frame {f}"] = host(masks)
    return out


def video_main_phase(path: str) -> dict:
    """The SAM2 video predictor end to end on the path's seeded frames: the
    launches of every call and of every yielded frame (counters set to 0
    just before each, read just after; a frame served from cache, the
    prompted frame 0, launches nothing), the masks' shapes and values; the
    same flow under force_plain() (video-res logits, kernels vs plain) and
    on the host-gathered bank (device_resident=False) against the device
    bank. t512video runs under set_attention_impl("pallas") (K14, with its
    launches per call: `pallas_image`, `pallas_decode` and the memory
    attention's `per_frame_d256` at head dim 256), and also under the
    default backend (no K14), against which the "pallas" logits are held;
    its drain of packed masks must equal the forward pass's masks."""
    import torch

    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.ops.attention import set_attention_impl

    spec = PATHS[path]
    label = spec["label"]
    frames = video_frames(path)
    pallas = "pallas_decode" in spec
    variants: collections.Counter = collections.Counter()
    n_tracked = collections.Counter()

    def expected(what, tracked, out, k14: bool):
        """(launches, head-dim-256 launches) of one call or frame."""
        image = dict(spec["per_image"])
        decode = {}
        if k14:
            image.update(spec["pallas_image"])
            decode = spec["pallas_decode"]
        if what == "init_state":
            return image, 0
        if not tracked:
            return dict(decode), 0
        if out[0] == 0:   # frame 0 is served from cache
            return {}, 0
        d256 = spec["per_frame_d256"] if k14 or not pallas else 0
        frame = dict(image)
        for name, n in decode.items():
            frame[name] = frame.get(name, 0) + n
        if d256:
            key = "full_attention" if pallas else "flash_attention"
            frame[key] = frame.get(key, 0) + d256
        return frame, d256

    def counter(k14: bool, seen: collections.Counter):
        d256 = (("full_attention", "Sq=1024,Sk=1024,d=256") if pallas
                else ("flash_attention", "S=4096,d=256"))

        def counted(fn, what, tracked):
            dispatch.reset_launches()
            out = fn()
            torch.cuda.synchronize()
            counts = dict(dispatch.launches)
            variants.update(dispatch.variants)
            want, want_d256 = expected(what, tracked, out, k14)
            if tracked and out[0] != 0:
                n_tracked[k14] += 1
            seen[(what, str(counts))] += 1
            if counts != want or dispatch.variants.get(d256, 0) != want_d256:
                fail(f"{label} {what}: launches {counts} by variant "
                     f"{dict(dispatch.variants)}, expected {want}")
            return out
        return counted

    def run(k14: bool, plain: bool = False, resident: bool = True,
            counted: bool = False):
        pred = sam2_video_predictor(path, resident)
        seen: collections.Counter = collections.Counter()
        set_attention_impl("pallas" if k14 else None)
        try:
            with dispatch.force_plain() if plain else contextlib.nullcontext():
                out = video_flow(path, pred, frames,
                                 counter(k14, seen) if counted else None)
        finally:
            set_attention_impl(None)
        for (what, counts), n in seen.items():
            print(f"[main] {label} {what}{' (pallas)' if k14 else ''}: "
                  f"launches {counts} (x{n})", flush=True)
        return out

    got = run(pallas, counted=True)
    hw = spec["hw"]
    n_frames = spec["frames"]
    want_tracked = ((n_frames - 1) + spec["reverse_from"]
                    + (n_frames - 1 if spec.get("drain") else 0))
    if n_tracked[pallas] != want_tracked:
        fail(f"{label}: {n_tracked[pallas]} tracked frames, expected "
             f"{want_tracked}")
    what = ("K14 at head dim 256" if pallas else "K10 at head dim 256")
    n_d256 = sum(n for (w, v), n in variants.items() if v.endswith("d=256"))
    print(f"[main] {label}: {n_tracked[pallas]} tracked frames, {what} "
          f"launched {n_d256} times ({spec['per_frame_d256']} per tracked "
          f"frame); none on the prompted frame", flush=True)
    # (objects, 1, H, W): object 1 alone after the first prompt
    bad = [k for k, m in got.items()
           if m.shape != (1 + ("object 1" not in k), 1, *hw)
           or not torch.isfinite(m).all()]
    fg = {k: [round(float((o > 0).float().mean()), 3) for o in m]
          for k, m in got.items()}
    gated = [(k, i) for k, m in got.items() for i, o in enumerate(m)
             if (o == -1024.0).all()]
    print(f"[main] {label} masks (objects, 1, {hw[0]}, {hw[1]}) at every "
          f"step, finite; foreground share by object {fg}; an object absent "
          f"(its score gated the mask) at {gated}"
          + ("  <-- FAIL" if bad else ""), flush=True)
    if bad:
        fail(f"{label}: bad masks at {bad}")
    logits = sorted(k for k in got if not k.startswith("packed"))
    packed = sorted(k for k in got if k.startswith("packed"))
    for k in packed:
        ref = got[k.replace("packed", "forward")]
        scale = float(ref.abs().max())
        off = (got[k] != (ref > 0).float()) & (ref.abs() > 1e-2 * scale)
        print(f"[main] {label} {k}: packed masks vs the forward pass's, "
              f"pixels that differ {float((got[k] != (ref > 0)).float().mean()):.3g}"
              + ("  <-- FAIL" if off.any() else ""), flush=True)
        if off.any():
            fail(f"{label}: the packed drain differs from the forward pass "
                 f"at {k} away from the threshold")

    def compare(want, what):
        g = torch.cat([got[k].flatten() for k in logits])
        w = torch.cat([want[k].flatten() for k in logits])
        rel, corr, ok = _agree(g, w)
        flips = float(((g > 0) != (w > 0)).float().mean())
        print(f"[main] {label} video-res logits of every step, {what} "
              f"(bf16): max_rel_err {rel:.4g} (tol {MAIN_REL_TOL}) corr "
              f"{corr:.6f} (min {MAIN_CORR_MIN}); mask pixels that differ "
              f"{flips:.3g}" + ("" if ok else "  <-- FAIL"), flush=True)
        if not ok:
            fail(f"{label}: {what} disagree")

    compare(run(pallas, plain=True), "kernels vs plain")
    compare(run(pallas, resident=False),
            "device-resident bank vs host-gathered bank")
    if pallas:
        compare(run(False, counted=True),
                '"pallas" backend vs the default backend')
    torch.cuda.empty_cache()
    return dict(variants)


def video_throughput_phase(path: str, card: str) -> None:
    """add_new_points ms (host clock, the prompt's decode and video-res
    consolidation), steady-state tracked frames (CUDA events around each
    yielded frame of further propagations, its masks copied to the host as
    bool; frames 1 and 2 left out), frames/s, peak memory, under each of
    the path's backends (t512video: "pallas" and the default); and one call
    of the memory attention's masked cross-attention (the einsum form, fp32
    scores) at its shape, for the profile's reading."""
    import torch

    from sam2unet_torch.ops.attention import einsum_attention, set_attention_impl

    spec = PATHS[path]
    label = spec["label"]
    frames = video_frames(path)
    tokens = (spec["size"] // 16) ** 2
    impls = ["pallas", None] if "pallas_decode" in spec else [None]
    for impl in impls:
        set_attention_impl(impl)
        try:
            pred = sam2_video_predictor(path)
            state = pred.init_state(images=frames)
            for _, fn in video_prompts(path, pred, state):
                fn()
            point = [list(spec["points"][0])]
            reps, t0 = 5, time.perf_counter()
            for _ in range(reps):
                pred.add_new_points(state, 0, 1, point, [1])
            torch.cuda.synchronize()
            points_ms = (time.perf_counter() - t0) * 1e3 / reps
            list(pred.propagate_in_video(state))   # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(max(1, 24 // spec["frames"])):
                it = pred.propagate_in_video(state)
                while True:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    try:
                        f, _, masks = next(it)
                    except StopIteration:
                        break
                    masks = (masks > 0).cpu()
                    end.record()
                    end.synchronize()
                    if f >= 3:   # frame 0 is served from cache
                        times.append(start.elapsed_time(end))
        finally:
            set_attention_impl(None)
        ms = sum(times) / len(times)
        backend = f' under "{impl}"' if impl else ""
        print(f"[throughput] {label}{backend} bf16, 2 objects, "
              f"{spec['hw'][0]}x{spec['hw'][1]} frames on {card}: "
              f"add_new_points {points_ms:.2f} ms (host clock), tracked frame "
              f"{ms:.2f} ms ({1e3 / ms:.1f} frames/s steady state over "
              f"{len(times)} frames, CUDA events, masks to the host), peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        del pred, state
        torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    n_keys = 7 * tokens + 64
    q = torch.randn(2, tokens, 1, 256, generator=gen, device=DEV).bfloat16()
    k, v = (torch.randn(2, n_keys, 1, 256, generator=gen, device=DEV).bfloat16()
            for _ in range(2))
    valid = torch.ones(2, n_keys, dtype=torch.bool, device=DEV)
    cross_ms = time_ms(lambda: einsum_attention(q, k, v, key_valid=valid),
                       reps=5)
    print(f"[throughput] {label}: the masked cross-attention alone (einsum "
          f"form, {tokens} x {n_keys} keys, d 256) {cross_ms:.3f} ms a call, "
          f"4 per frame", flush=True)
    del q, k, v
    torch.cuda.empty_cache()


def amg_generator(path: str):
    """The automatic mask generator of scripts/bench_amg.py on the card:
    build_sam2 of the path's config in bf16 (seeded random weights, the
    pos-embeds with noise), the path's points per side, the iou and
    stability filters at 0 (random weights would fail them all)."""
    import torch

    from sam2unet_torch.build_sam import build_sam2
    from sam2unet_torch.predictors.amg import SAM2AutomaticMaskGenerator

    spec = PATHS[path]
    torch.manual_seed(0)
    model = build_sam2(spec["cfg"], device=DEV, dtype=torch.bfloat16)
    trunk = model.image_encoder.trunk
    with torch.no_grad():
        trunk.pos_embed.normal_(0.0, 0.02)
        trunk.pos_embed_window.normal_(0.0, 0.02)
    return SAM2AutomaticMaskGenerator(
        model, points_per_side=spec["points_per_side"], pred_iou_thresh=0.0,
        stability_score_thresh=0.0)


def amg_image(path: str):
    """scripts/bench_amg.py's image: two sinusoids, noise and a bright
    disc."""
    import numpy as np

    rng = np.random.default_rng(0)
    h, w = PATHS[path]["hw"]
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([127 + 90 * np.sin(yy / 37.0), 127 + 90 * np.cos(xx / 29.0),
                    rng.random((h, w)) * 60 + 90], axis=-1)
    img = img.clip(0, 255).astype(np.uint8)
    img[((yy - h // 2) ** 2 + (xx - w // 2) ** 2) < (h // 4) ** 2] = 240
    return img


def amg_batches(amg, image):
    """`_predict_amg` of each point batch of `generate` on the set image
    (one crop): [(masks, ious, low-res logits, stability scores)], numpy."""
    import numpy as np

    from sam2unet_torch.utils.amg import batch_iterator

    pred = amg.predictor
    pred.set_image(image)
    hw = image.shape[:2]
    out = []
    for (pts,) in batch_iterator(amg.points_per_batch,
                                 amg.point_grids[0] * np.array(hw)[None, ::-1]):
        c = pred._transforms.transform_coords(pts, normalize=True, orig_hw=hw)
        out.append(pred._predict_amg(c[:, None], np.ones((len(c), 1), np.int32),
                                     need_low_res=True))
    return out


def amg_main_phase(path: str) -> dict:
    """The AMG end to end at scripts/bench_amg.py's point: `generate` with
    its launches (counters set to 0 just before, read just after: one
    set_image, its decodes none), its records (segmentation at the image's
    size, bool; predicted IoU in [0, 1.5], as bench_amg.py checks); then
    each point batch's `_predict_amg`: the device postprocess (clip,
    resize, stability score, threshold) against the host one on the same
    low-res logits (`postprocess_masks`, `calculate_stability_score`):
    masks equal but at pixels within 1e-4 of the threshold, stability
    scores equal but for what such pixels move; and the batches' ious,
    stability scores and low-res logits with the kernels against
    force_plain() (the other paths' correlation and max-error limits)."""
    import numpy as np
    import torch

    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.utils.amg import calculate_stability_score

    spec = PATHS[path]
    label = spec["label"]
    amg, image = amg_generator(path), amg_image(path)
    dispatch.reset_launches()
    t0 = time.perf_counter()
    records = amg.generate(image)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts, variants = dict(dispatch.launches), dict(dispatch.variants)
    print(f"[main] {label} generate {image.shape[0]}x{image.shape[1]}, "
          f"{spec['points_per_side']} points per side: {len(records)} records "
          f"in {first_s:.2f} s (host clock, first call); launches {counts}",
          flush=True)
    if counts != spec["per_set_image"]:
        fail(f"{label} generate: launches {counts}, expected "
             f"{spec['per_set_image']}")
    hw = tuple(spec["hw"])
    bad = [i for i, r in enumerate(records)
           if r["segmentation"].shape != hw or r["segmentation"].dtype != np.bool_
           or not 0.0 <= r["predicted_iou"] <= 1.5
           or r["area"] != int(r["segmentation"].sum())]
    areas = sorted((r["area"] for r in records), reverse=True)[:5]
    print(f"[main] {label} records: segmentation {hw} bool, predicted_iou "
          f"in [0, 1.5], area = mask sum; top areas {areas}"
          + ("  <-- FAIL" if bad or not records else ""), flush=True)
    if bad or not records:
        fail(f"{label}: bad records {bad[:5]} of {len(records)}")

    got = amg_batches(amg, image)
    worst_flips = worst_stab = 0.0
    for i, (masks, ious, low, stab) in enumerate(got):
        logits = amg.predictor._transforms.postprocess_masks(low, hw)
        flips = (masks != (logits > 0)) & (np.abs(logits) > 1e-4)
        near_hi = (np.abs(logits - 1.0) <= 1e-4).sum((-1, -2))
        near_lo = (np.abs(logits + 1.0) <= 1e-4).sum((-1, -2))
        lo = np.maximum((logits > -1.0).sum((-1, -2)) - near_lo, 1)
        dstab = np.abs(stab - calculate_stability_score(logits, 0.0, 1.0))
        worst_flips = max(worst_flips, float(flips.mean()))
        worst_stab = max(worst_stab, float(dstab.max()))
        if flips.any() or (dstab > (near_hi + near_lo) / lo + 1e-6).any():
            fail(f"{label} batch {i}: the device postprocess disagrees with "
                 f"the host one")
    print(f"[main] {label} {len(got)} batches of {amg.points_per_batch} "
          f"points: device postprocess vs host on the same logits: masks "
          f"equal but within 1e-4 of the threshold, stability scores "
          f"(largest gap {worst_stab:.3g}) as the near-threshold pixels "
          f"allow", flush=True)
    with dispatch.force_plain():
        want = amg_batches(amg, image)
    for j, name in ((1, "ious"), (2, "low-res logits")):
        g = torch.from_numpy(np.concatenate([b[j].ravel() for b in got]))
        w = torch.from_numpy(np.concatenate([b[j].ravel() for b in want]))
        rel, corr, ok = _agree(g, w)
        print(f"[main] {label} {name} of every batch, kernels vs plain "
              f"(bf16): max_rel_err {rel:.4g} (tol {MAIN_REL_TOL}) corr "
              f"{corr:.6f} (min {MAIN_CORR_MIN})" + ("" if ok else "  <-- FAIL"),
              flush=True)
        if not ok:
            fail(f"{label}: {name} kernels vs plain disagree")
    # masks and stability scores are thresholds of the full-size logits: a
    # mask's pixels and the score's two counts can change only where the
    # two runs' logits straddle the threshold (or thr +- 1), i.e. within
    # that mask's largest logit gap of it
    flips = dstab = 0.0
    for (gm, _, glow, gs), (wm, _, wlow, ws) in zip(got, want):
        gl, wl = (amg.predictor._transforms.postprocess_masks(x, hw)
                  for x in (glow, wlow))
        gap = np.abs(gl - wl).max((-1, -2), keepdims=True)
        near_lo = (np.abs(wl + 1.0) <= gap).sum((-1, -2))
        near = (np.abs(wl - 1.0) <= gap).sum((-1, -2)) + near_lo
        lo = np.maximum((wl > -1.0).sum((-1, -2)) - near_lo, 1)
        off = (gm != wm) & (np.abs(wl) > gap)
        flips += float((gm != wm).mean()) / len(got)
        dstab = max(dstab, float(np.abs(gs - ws).max()))
        if off.any() or (np.abs(gs - ws) > near / lo + 1e-6).any():
            fail(f"{label}: masks or stability scores, kernels vs plain, "
                 f"differ beyond their logits' gap")
        del gl, wl
    print(f"[main] {label} masks and stability scores of every batch, "
          f"kernels vs plain (bf16): mask pixels that differ {flips:.3g}, "
          f"all within their logits' gap of the threshold; stability "
          f"scores' largest gap {dstab:.4g}, within what the pixels near "
          f"thr +- 1 allow", flush=True)
    del amg
    torch.cuda.empty_cache()
    return variants


def amg_throughput_phase(path: str, card: str) -> None:
    """`generate` wall time by the host clock: a first call on a new
    generator (its builds and caches) and the steady state (the mean of 3
    more), with peak memory."""
    import torch

    label = PATHS[path]["label"]
    amg, image = amg_generator(path), amg_image(path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n = len(amg.generate(image))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(3):
        amg.generate(image)
    steady_s = (time.perf_counter() - t0) / 3
    print(f"[throughput] {label} bf16 {image.shape[0]}x{image.shape[1]}, "
          f"{PATHS[path]['points_per_side']} points per side on {card}: "
          f"generate {n} records, first {first_s:.3f} s, steady {steady_s:.3f} "
          f"s (host clock); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del amg
    torch.cuda.empty_cache()


def train_main_phase(path: str, tmp: Path, step_seeds: list[int],
                     step_report: str = "") -> dict:
    """The train CLI end to end (with `resume`, once more from its saved
    train state), its checkpoint through the test CLI, and one train step's
    loss and gradients, kernels against plain versions."""
    import torch

    from sam2unet_torch.cli import test_cli, train_cli
    from sam2unet_torch.cli.common import build_model
    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.train.optim import cosine_step_lr, is_trainable

    spec = PATHS[path]
    label, cfg, size = spec["label"], spec["cfg"], spec["size"]
    data, train_data = tmp / "data", tmp / "train"
    ckpt, out = tmp / f"{cfg}.pth", tmp / f"train_run_{path}"
    if not data.exists():
        write_dataset(data)
    if not train_data.exists():
        write_dataset(train_data, n=16, seed=1)
    if not ckpt.exists():
        random_checkpoint(ckpt, cfg, seed=0)
    common = ["--save_path", str(out), "--checkpoint", str(ckpt),
              "--train_image_path", str(train_data / "images"),
              "--train_mask_path", str(train_data / "masks"),
              "--test_image_path", str(data / "images"),
              "--test_gt_path", str(data / "masks"), "--bf16",
              "--num_workers", "4", "--device", DEV]
    defaults = train_cli.build_parser().parse_args(common)
    at_defaults = ((defaults.size, defaults.model_cfg, defaults.batch_size)
                   == (size, cfg, spec["cli_batch"]))
    point = [] if at_defaults else ["--size", str(size), "--model_cfg", cfg,
                                    "--batch_size", str(spec["cli_batch"])]
    extra = ["--save_train_state"] if spec.get("resume") else []
    shown = " ".join(point + extra) or "no other flag"
    args = train_cli.build_parser().parse_args(
        common + point + extra + ["--epoch", "2"])
    dispatch.reset_launches()
    t0 = time.perf_counter()
    stats = train_cli.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, variants = dict(dispatch.launches), dict(dispatch.variants)
    steps, evals = stats["steps"], stats["eval_forwards"]
    print(f"[main] {label} train_cli --bf16 --epoch 2 {shown} "
          f"({'the CLI defaults' if at_defaults else 'passed'}: --size "
          f"{args.size} --model_cfg {args.model_cfg} --batch_size "
          f"{args.batch_size}): {steps} steps, {evals} eval forwards in "
          f"{seconds:.1f} s (host clock, kernel build excluded); losses "
          f"{[round(v, 4) for v in stats['losses']]}; launches {counts}",
          flush=True)
    if not stats["losses"] or not all(math.isfinite(v) for v in stats["losses"]):
        fail(f"{label}: a logged loss is not finite: {stats['losses']}")
    per_forward = PATHS[spec["eval_path"]]["per_forward"]
    per_step = spec["per_step"]
    for name in sorted(set(per_step) | set(counts)):
        want = per_step.get(name, 0) * steps + per_forward.get(name, 0) * evals
        got = counts.get(name, 0)
        print(f"[main] {label} {name}: {got} launches = "
              f"{(got - per_forward.get(name, 0) * evals) / max(steps, 1):g} per "
              f"train step (table {per_step.get(name, 0)}) over {steps} steps "
              f"+ {per_forward.get(name, 0)} per eval forward", flush=True)
        if got != want:
            fail(f"{label}: {name} launched {got} times, expected {want}")
    if "flash_attention_bwd_dq" in per_step:
        print(f"[main] {label} flash_attention_bwd (K11, counted by its "
              f"delta, dq and dk/dv passes): "
              f"{counts['flash_attention_bwd_dq'] / max(steps, 1):g} per train "
              f"step", flush=True)

    log = Path(stats["log"]).read_text()
    if log.count("epoch-") < 2 or log.count("mIoU") != 2:
        fail(f"{label}: log.txt lacks the two epoch reports:\n{log}")
    if not stats["saved"]:
        fail(f"{label}: no checkpoint was written")
    start = torch.load(ckpt, map_location="cpu", weights_only=True)
    saved = torch.load(stats["saved"][-1], map_location="cpu", weights_only=True)
    names = [n for n, _ in build_model(cfg, torch.device("cpu")).named_parameters()]
    trainable = [n for n in names if is_trainable(n)]

    def check_moved(new, old, what):
        moved = [n for n in names if not torch.equal(new[n], old[n])]
        frozen_moved = sorted(set(moved) - set(trainable))
        still = sorted(set(trainable) - set(moved))
        print(f"[main] {label} {what}: {len(trainable)} trainable parameters, "
              f"{len(moved)} moved; frozen moved {len(frozen_moved)}", flush=True)
        if frozen_moved or still:
            fail(f"{label} {what}: frozen parameters moved {frozen_moved[:5]}, "
                 f"trainable ones did not {still[:5]}")

    check_moved(saved, start, f"checkpoint {Path(stats['saved'][-1]).name} "
                              "(log.txt holds the 2 epoch reports)")
    preds = tmp / f"train_preds_{path}"
    targs = test_cli.build_parser().parse_args([
        "--checkpoint", stats["saved"][-1], "--test_image_path",
        str(data / "images"), "--test_gt_path", str(data / "masks"),
        "--save_path", str(preds), "--bf16", "--batch_size", "4",
        "--device", DEV] + point[:4])
    tstats = test_cli.main(targs)
    if len(list(preds.glob("*.png"))) != 4:
        fail(f"{label}: the test CLI did not write 4 PNGs from the checkpoint")
    print(f"[main] {label} test_cli loaded the checkpoint strictly: "
          f"{tstats['forwards']} forward(s), mean_test_time "
          f"{tstats['mean_test_time']:.4f} s/image", flush=True)

    losses = list(stats["losses"])
    if spec.get("resume"):
        from sam2unet_torch.train.checkpoints import jax_train_state_path

        state = jax_train_state_path(stats["saved"][-1])
        if not Path(state).is_dir() or Path(
                stats["saved"][-1] + "_train_state").exists():
            fail(f"{label}: --save_train_state wrote no {state}, or a second "
                 "train state beside it")
        again = train_cli.main(train_cli.build_parser().parse_args(
            common + point + ["--epoch", "3", "--resume", state]))
        torch.cuda.synchronize()
        spe = steps // 2
        first_lr = cosine_step_lr(args.lr, steps, 3, spe)
        print(f"[main] {label} train_cli --resume {Path(state).name} --epoch 3: "
              f"from step {steps}, {again['steps']} step(s) (epochs 0-2 again, "
              f"as the JAX CLI), global step {again['global_step']}, first "
              f"rate {again['lrs'][0]:.6g} (the schedule at step {steps}: "
              f"{first_lr:.6g}), losses "
              f"{[round(v, 4) for v in again['losses']]}", flush=True)
        if ((again["steps"], again["global_step"]) != (3 * spe, steps + 3 * spe)
                or again["lrs"][0] != first_lr or not again["saved"]
                or not all(math.isfinite(v) for v in again["losses"])):
            fail(f"{label}: the resumed run did not train epochs 0-2 from step "
                 f"{steps}: {again}")
        check_moved(torch.load(again["saved"][-1], map_location="cpu",
                               weights_only=True), saved,
                    "resumed run's checkpoint against the 2-epoch one")
        losses += again["losses"]
        if min(losses[1:]) >= losses[0]:
            fail(f"{label}: the loss did not fall: {losses}")
        print(f"[main] {label} loss fell from {losses[0]:.4f} to "
              f"{min(losses[1:]):.4f} over {len(losses)} steps", flush=True)
    del start, saved
    step_compare(path, ckpt, step_seeds, step_report)
    if spec.get("remat"):
        remat_compare(path, ckpt)
    return variants


# the hand-written kernels the train CLI's trace must name (by the C entry
# points' profiler annotations, ops/build.py)
TRACE_KERNELS = {"K1": ("k1_fused_mlp_sm90",), "K2": ("k2_mlp_bwd_dx_sm90",),
                 "K3": ("k3_adapter_bwd_sm90",), "K7": ("k7_window_block_bwd_sm90",),
                 "K5": ("k5_window_block_strips_bwd_sm90",),
                 "K9": ("k9_transition_bwd_sm90",),
                 "K10": ("k10_flash_attention_sm90",),
                 "K11": ("k11_flash_attention_bwd_delta",
                         "k11_flash_attention_bwd_dq_sm90",
                         "k11_flash_attention_bwd_dkv_sm90")}
# K1's, K2's, K3's, K5's, K7's and K9's entry points, K10's forward and
# K11's dq and dk/dv passes in bf16 before the Hopper kernels took them
OLD_BF16 = ("k1_fused_mlp", "k2_mlp_bwd_dx", "k3_adapter_bwd", "k7_window_block_bwd",
            "k5_window_block_strips_bwd", "k9_transition_bwd",
            "k10_flash_attention", "k10_flash_attention_d256",
            "k11_flash_attention_bwd_dq", "k11_flash_attention_bwd_dkv")


def cli_main_phase(path: str, tmp: Path, card: str) -> dict:
    """The train CLI at its defaults with --full_eval and --profile_dir, the
    device evaluation of its checkpoint, the test CLI and the eval CLI on
    it; the loader A/B (native against PIL) on the epoch's img/s."""
    import os

    import torch

    from sam2unet_torch.cli import eval_cli, test_cli, train_cli
    from sam2unet_torch.data import native_loader
    from sam2unet_torch.data.dataset import EvalDataset
    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.train.engine import evaluate
    from sam2unet_torch.utils.profile_model import trace_device_time

    spec = PATHS[path]
    label, cfg, size = spec["label"], spec["cfg"], spec["size"]
    train_data, data = tmp / "cli_train", tmp / "cli_test"
    ckpt, out, prof = tmp / f"{cfg}.pth", tmp / "cli_run", tmp / "cli_trace"
    write_dataset(train_data, n=spec["train_images"], seed=2)
    write_dataset(data, n=spec["eval_images"], seed=3)
    if not ckpt.exists():
        random_checkpoint(ckpt, cfg, seed=0)
    print(f"[main] {label} data loader: {native_loader.status()}", flush=True)
    common = ["--checkpoint", str(ckpt),
              "--train_image_path", str(train_data / "images"),
              "--train_mask_path", str(train_data / "masks"),
              "--test_image_path", str(data / "images"),
              "--test_gt_path", str(data / "masks"), "--bf16", "--epoch", "1",
              "--num_workers", "8", "--device", DEV]
    args = train_cli.build_parser().parse_args(
        common + ["--save_path", str(out), "--full_eval",
                  "--profile_dir", str(prof)])
    if (args.size, args.model_cfg, args.batch_size) != (size, cfg, 16):
        fail(f"{label}: the train CLI's defaults are no longer hiera_s@960 "
             f"batch 16: {args.size}, {args.model_cfg}, {args.batch_size}")
    dispatch.reset_launches()
    stats = train_cli.main(args)
    torch.cuda.synchronize()
    counts, variants = dict(dispatch.launches), dict(dispatch.variants)
    steps, evals = stats["steps"], stats["eval_forwards"]
    ips = spec["train_images"] / stats["epoch_seconds"][0]
    report = stats["reports"][0]
    print(f"[main] {label} train_cli --bf16 --epoch 1 --full_eval "
          f"--profile_dir (the CLI defaults: --size {args.size} --model_cfg "
          f"{args.model_cfg} --batch_size {args.batch_size}): {steps} steps, "
          f"epoch {stats['epoch_seconds'][0]:.2f} s, {ips:.2f} img/s (host "
          f"clock, steps 10-14 under the profiler) on {card}; losses "
          f"{[round(v, 4) for v in stats['losses']]}; launches {counts}",
          flush=True)
    print(f"[main] {label} --full_eval (host path, {spec['eval_images']} "
          f"images): mIoU {report['mIoU']:.4f}, mDice {report['mDice']:.4f}, "
          f"{stats['eval_seconds'][0]:.2f} s on {card}; report {report}",
          flush=True)
    if steps != spec["train_images"] // 16 or not stats["saved"]:
        fail(f"{label}: {steps} steps and checkpoints {stats['saved']}")
    if not all(math.isfinite(v) for v in stats["losses"]):
        fail(f"{label}: a logged loss is not finite: {stats['losses']}")
    per_step = PATHS["s960train"]["per_step"]
    per_forward = PATHS["s960"]["per_forward"]
    for name in sorted(set(per_step) | set(counts)):
        want = per_step.get(name, 0) * steps + per_forward.get(name, 0) * evals
        if counts.get(name, 0) != want:
            fail(f"{label}: {name} launched {counts.get(name, 0)} times, "
                 f"expected {want} ({steps} steps, {evals} eval forwards)")
    print(f"[main] {label} launches = s960train's per step x {steps} + "
          f"s960's per eval forward x {evals}", flush=True)

    # the trace of steps 10-14
    trace = stats["trace"]
    if not trace or not Path(trace).is_file():
        fail(f"{label}: --profile_dir wrote no trace ({trace})")
    by_name = trace_device_time(trace)
    if not by_name:
        fail(f"{label}: the trace {trace} holds no device kernel")
    busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    print(f"[main] {label} trace {trace} ({Path(trace).stat().st_size} "
          f"bytes), steps 10-14 on {card}: device kernels busy "
          f"{busy / 1e3:.2f} ms; the five most expensive kernels by device "
          f"time:", flush=True)
    for name, (us, n) in top:
        print(f"[main]   {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% {n:6d} "
              f"calls  {name[:100]}", flush=True)
    for k, entries in TRACE_KERNELS.items():
        us = sum(by_name.get(e, [0.0])[0] for e in entries)
        n = sum(by_name.get(e, [0, 0])[1] for e in entries)
        print(f"[main] {label} trace: {k} ({'/'.join(entries)}) {us / 1e3:.3f} "
              f"ms over {n} device kernels", flush=True)
        if not us:
            fail(f"{label}: the trace names no device time of {k}")
    old = {e: by_name[e][1] for e in OLD_BF16 if e in by_name}
    if old:
        fail(f"{label}: K1, K2, K3, K5, K7, K9, K10 or K11 in bf16 ran off the Hopper "
             f"kernels: {old}")

    # the device evaluation at the same weights, the test and eval CLIs
    model = _train_model(cfg, Path(stats["saved"][-1]))
    t0 = time.perf_counter()
    device_report, _ = evaluate(model, EvalDataset(
        str(data / "images"), str(data / "masks"), size), 16, size,
        torch.device(DEV))
    torch.cuda.synchronize()
    print(f"\n[main] {label} device eval of the checkpoint (the CLI's "
          f"default): mIoU {device_report['mIoU']:.4f}, mDice "
          f"{device_report['mDice']:.4f}, {time.perf_counter() - t0:.2f} s "
          f"on {card}", flush=True)
    del model
    preds = tmp / "cli_preds"
    tstats = test_cli.main(test_cli.build_parser().parse_args([
        "--checkpoint", stats["saved"][-1], "--test_image_path",
        str(data / "images"), "--test_gt_path", str(data / "masks"),
        "--save_path", str(preds), "--bf16", "--batch_size", "4",
        "--device", DEV]))
    final = eval_cli.main(eval_cli.build_parser().parse_args(
        ["--pred_path", str(preds), "--gt_path", str(data / "masks")]))
    print(f"[main] {label} test_cli ({tstats['forwards']} forwards, "
          f"mean_test_time {tstats['mean_test_time']:.4f} s/image) then "
          f"eval_cli: mIoU {final['mIoU']:.4f}, mDice {final['mDice']:.4f} "
          f"on {card}", flush=True)
    for name, rep in (("full_eval", report), ("device eval", device_report),
                      ("eval_cli", final)):
        if not all(math.isfinite(v) for v in rep.values()):
            fail(f"{label}: the {name} report is not finite: {rep}")

    # the loader A/B: the same run without the profiler and the host eval,
    # native then PIL then native then PIL
    if not native_loader.available():
        print(f"[main] {label} loader A/B skipped: {native_loader.status()}",
              flush=True)
        return variants
    rates = collections.defaultdict(list)
    for i, mode in enumerate(("native", "PIL", "native", "PIL")):
        os.environ.pop("SAM2UNET_NO_NATIVE_LOADER", None)
        if mode == "PIL":
            os.environ["SAM2UNET_NO_NATIVE_LOADER"] = "1"
        try:
            ab = train_cli.main(train_cli.build_parser().parse_args(
                common + ["--save_path", str(tmp / f"cli_ab{i}")]))
        finally:
            os.environ.pop("SAM2UNET_NO_NATIVE_LOADER", None)
        rates[mode].append(spec["train_images"] / ab["epoch_seconds"][0])
    print(f"[main] {label} loader A/B, epoch img/s (host clock, 15 steps, "
          f"order native, PIL, native, PIL) on {card}: native "
          f"{[round(r, 2) for r in rates['native']]}, PIL "
          f"{[round(r, 2) for r in rates['PIL']]}", flush=True)
    return variants


def _dir_bytes(root: Path) -> int:
    return sum(f.stat().st_size for f in root.rglob("*") if f.is_file())


def interop_main_phase(path: str, tmp: Path, card: str,
                       rates: dict[str, float]) -> dict:
    """The Orbax round trip, the test CLI from the directory and from the
    .pth, the FLOP audit (with the achieved TFLOP/s of this run's l352,
    s960 and s960train throughput), the profiles' entry-point calls; the
    launch counts over all of it."""
    import torch

    from sam2unet_torch.cli import test_cli
    from sam2unet_torch.interop.from_jax import (
        jax_to_state_dict,
        state_dict_to_jax,
    )
    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.train.checkpoints import (
        load_any_checkpoint,
        save_variables,
    )
    from sam2unet_torch.utils import flops_audit, profile_model
    from sam2unet_torch.utils.profile_model import ENTRY_WRAPPER

    spec = PATHS[path]
    label, cfg, size = spec["label"], spec["cfg"], spec["size"]
    t_path = time.perf_counter()
    ckpt, orbax_dir = tmp / f"{cfg}.pth", tmp / "SAM2-UNet_epoch-latest"
    if not ckpt.exists():
        random_checkpoint(ckpt, cfg, seed=0)
    dispatch.reset_launches()

    # 1. the checkpoint through an Orbax directory and back, bit for bit
    state = torch.load(ckpt, map_location="cpu", weights_only=True)
    t0 = time.perf_counter()
    save_variables(str(orbax_dir), state_dict_to_jax(state))
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = jax_to_state_dict(load_any_checkpoint(str(orbax_dir)),
                             state.keys())
    t_read = time.perf_counter() - t0
    differ = [k for k in state if back[k].dtype != state[k].dtype
              or not torch.equal(back[k], state[k])]
    n_params = sum(v.numel() for v in state.values())
    print(f"[main] {label} Orbax round trip: {len(state)} tensors, "
          f"{n_params} values, {_dir_bytes(orbax_dir)} bytes on disk "
          f"(zstd level 1), write {t_write:.3f} s (state_dict_to_jax + "
          f"save_variables), read {t_read:.3f} s (load_any_checkpoint + "
          f"jax_to_state_dict), host of the card machine; {len(differ)} "
          f"tensors differ", flush=True)
    if differ:
        fail(f"{label}: the Orbax round trip changed {differ[:5]}")

    # 2. the test CLI on the directory and on the .pth: the same PNGs
    data = tmp / "interop_data"
    write_dataset(data, n=spec["images"], seed=4)
    pngs, forwards = {}, 0
    for name, source in (("dir", orbax_dir), ("pth", ckpt)):
        out = tmp / f"interop_preds_{name}"
        args = test_cli.build_parser().parse_args([
            "--checkpoint", str(source), "--test_image_path",
            str(data / "images"), "--test_gt_path", str(data / "masks"),
            "--save_path", str(out), "--bf16", "--batch_size",
            str(spec["cli_batch"]), "--device", DEV])
        if (args.size, args.model_cfg) != (size, cfg):
            fail(f"{label}: the test CLI's defaults are no longer {cfg}@{size}")
        t0 = time.perf_counter()
        stats = test_cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        forwards += stats["forwards"]
        pngs[name] = {p.name: p.read_bytes() for p in sorted(out.glob("*.png"))}
        print(f"[main] {label} test_cli --checkpoint <{name}> --bf16 "
              f"--batch_size {spec['cli_batch']} (--size {args.size} "
              f"--model_cfg {args.model_cfg}, the CLI defaults): "
              f"{stats['images']} images, mean_test_time "
              f"{stats['mean_test_time']:.4f} s/image ("
              f"{1 / stats['mean_test_time']:.2f} images/s), whole run "
              f"{wall:.2f} s ({stats['images'] / wall:.2f} images/s, model "
              f"build and load included) on {card}", flush=True)
    if len(pngs["dir"]) != spec["images"] or pngs["dir"] != pngs["pth"]:
        fail(f"{label}: the PNGs from the Orbax directory differ from the "
             f".pth's ({len(pngs['dir'])} and {len(pngs['pth'])} files)")
    print(f"[main] {label} {spec['images']} PNGs byte-identical from the "
          f"directory and from the .pth", flush=True)

    # 3. the FLOP audit (the plain versions on the card, fp32, batch 1)
    flops = {}
    for acfg, asize in spec["audits"]:
        t0 = time.perf_counter()
        flops[(acfg, asize)] = f = flops_audit.audit(acfg, asize, "both", DEV)
        print(f"[main] {label} flops_audit {acfg}@{asize}: infer "
              f"{f['infer']:.6g}, train {f['train']:.6g} FLOP/img "
              f"(FlopCounterMode, matrix products, convolutions and "
              f"attention), {time.perf_counter() - t0:.2f} s on {card}",
              flush=True)
        if not all(math.isfinite(v) and v > 0 for v in f.values()):
            fail(f"{label}: the audit of {acfg}@{asize} is not positive: {f}")
    for rp in ("l352", "s960", "s960train"):
        point = (PATHS[rp]["cfg"], PATHS[rp]["size"])
        if rp not in rates or point not in flops:
            print(f"[main] {label} achieved TFLOP/s at {rp}: not measured "
                  f"(its throughput phase did not run)", flush=True)
            continue
        mode = "train" if PATHS[rp].get("train") else "infer"
        tflops = flops[point][mode] * rates[rp] / 1e12
        print(f"[main] {label} achieved TFLOP/s at {rp} (the count x this "
              f"run's {rates[rp]:.2f} img/s): {tflops:.2f}, "
              f"{tflops / (BF16_FLOPS / 1e12):.4f} of the bf16 dense peak "
              f"on {card}", flush=True)

    # 4. the profiles: entry-point calls in each trace against the tables
    for mode, table, key in (("infer", "s960", "per_forward"),
                             ("train", "s960train", "per_step")):
        want = PATHS[table][key]
        prof = profile_model.run(mode, spec["batch"], size, cfg, top=10,
                                 steps=spec["steps"], device=DEV)
        got = collections.Counter()
        for entry, n in prof["calls"].items():
            got[ENTRY_WRAPPER[entry]] += n
        print(f"[main] {label} profile_model --mode {mode} --batch "
              f"{spec['batch']}: {prof['wall_ms']:.2f} ms a step (host "
              f"clock, profiler on), device kernels {prof['busy_ms']:.2f} ms "
              f"a step; entry-point calls over {spec['steps']} steps "
              f"{dict(got)}", flush=True)
        for name in sorted(set(want) | set(got)):
            if got.get(name, 0) != want.get(name, 0) * spec["steps"]:
                fail(f"{label}: the {mode} trace calls {name} "
                     f"{got.get(name, 0)} times, expected "
                     f"{want.get(name, 0)} x {spec['steps']} ({table})")
        print(f"[main] {label} the {mode} trace's calls = {table}'s "
              f"{key.replace('_', ' ')} x {spec['steps']}", flush=True)

    torch.cuda.synchronize()
    counts, variants = dict(dispatch.launches), dict(dispatch.variants)
    # the profiles' warm-up step and their steps; the test CLI's forwards
    infer_n, train_n = forwards + spec["steps"] + 1, spec["steps"] + 1
    per_forward, per_step = PATHS["s960"]["per_forward"], \
        PATHS["s960train"]["per_step"]
    for name in sorted(set(per_forward) | set(per_step) | set(counts)):
        want = (per_forward.get(name, 0) * infer_n
                + per_step.get(name, 0) * train_n)
        if counts.get(name, 0) != want:
            fail(f"{label}: {name} launched {counts.get(name, 0)} times, "
                 f"expected {want} ({infer_n} forwards, {train_n} steps)")
    print(f"[main] {label} launches = s960's per forward x {infer_n} + "
          f"s960train's per step x {train_n}; the path took "
          f"{time.perf_counter() - t_path:.1f} s", flush=True)
    return variants


def _fp32_model(cfg: str, ckpt: Path, fold: bool = False):
    """The checkpoint's SAM2UNet on the card in fp32 (the deployed dtype),
    its BatchNorms folded when `fold`."""
    import torch

    from sam2unet_torch.cli.common import build_model, load_checkpoint
    from sam2unet_torch.nn.fold_bn import fold_model

    model = build_model(cfg, torch.device("cpu"))
    load_checkpoint(model, str(ckpt))
    if fold:
        fold_model(model)
    return model.to(DEV)


def deploy_main_phase(path: str, tmp: Path, card: str) -> dict:
    """The export CLI and the deploy CLI at their defaults (torch_export),
    the segmenter's run() called directly and its masks against the native
    module's with the kernels, the ONNX leg, the fold-BN A/B."""
    import numpy as np
    import torch
    from PIL import Image

    from sam2unet_torch.cli import deploy_cli, export_cli
    from sam2unet_torch.ops import dispatch

    spec = PATHS[path]
    label, cfg, size, small = (spec["label"], spec["cfg"], spec["size"],
                               spec["onnx_size"])
    data, ckpt = tmp / "deploy_data", tmp / f"deploy_{cfg}.pth"
    write_dataset(data, n=spec["images"], seed=5)
    random_checkpoint(ckpt, cfg, seed=0)
    state = torch.load(ckpt, weights_only=True)
    state["head.bias"].fill_(DEPLOY_HEAD_BIAS)
    torch.save(state, ckpt)
    names = sorted(p.name for p in (data / "images").iterdir())
    # native forwards with the kernels on this path, by what they are for
    forwards: collections.Counter = collections.Counter()
    dispatch.reset_launches()

    def export(fmt: str, out: Path, extra=()) -> dict:
        args = export_cli.build_parser().parse_args(
            ["--checkpoint", str(ckpt), "--output", str(out), "--device", DEV]
            + (["--format", fmt] if fmt != "torch_export" else []) + list(extra))
        if fmt == "torch_export" and (args.size, args.model_cfg, args.format) \
                != (size, cfg, fmt):
            fail(f"{label}: the export CLI's defaults are no longer {cfg}@{size} "
                 f"torch_export: {args.model_cfg}@{args.size} {args.format}")
        t0 = time.perf_counter()
        stats = export_cli.main(args)
        stats["verify_seconds"] = (time.perf_counter() - t0
                                   - stats["export_seconds"])
        stats["mb"] = out.stat().st_size / 2**20
        return stats

    def deploy(backend: str, model_path: Path, at: int) -> dict:
        save = tmp / f"deploy_{backend}_{at}"
        argv = ["--model_path", str(model_path), "--test_image_path",
                str(data / "images"), "--test_gt_path", str(data / "masks"),
                "--save_path", str(save), "--device", DEV]
        if backend != "torch_export":
            argv += ["--backend", backend]
        if at != size:
            argv += ["--size", str(at)]
        stats = deploy_cli.main(deploy_cli.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        stats["save"] = save
        if stats["images"] != len(names) or not all(
                t > 0 for t in stats["process_times"]):
            fail(f"{label} deploy_cli --backend {backend}: a segment failed "
                 f"(process_time 0, the segmenter's zero-mask fallback): "
                 f"{stats['process_times']}")
        # the segmenter's run() once, directly: no catch-all in the way
        seg = stats["segmenter"]
        batch, _, _ = seg.preprocess(np.asarray(Image.open(
            data / "images" / names[0]).convert("RGB")))
        out = np.asarray(seg.run(batch)["output"])
        if out.shape != (1, at, at, 1) or not np.isfinite(out).all():
            fail(f"{label} {backend} run(): shape {out.shape}, finite "
                 f"{np.isfinite(out).all()}")
        rep = stats["report"]
        print(f"[main] {label} deploy_cli --backend {backend} --size {at} over "
              f"{stats['images']} images: average process_time "
              f"{np.mean(stats['times']):.4f} s (run() alone "
              f"{np.mean(stats['process_times']):.4f} s), "
              f"{stats['images'] / stats['seconds']:.2f} images/s (host clock, "
              f"PNGs and evaluation included) on {card}; mIoU {rep['mIoU']:.4f}"
              f", mDice {rep['mDice']:.4f}; run() called directly: "
              f"{out.shape} finite", flush=True)
        return stats

    # 1-2. the .pt2 program at the CLIs' defaults; its masks against the
    # native module's with the kernels through the same pre and post process
    pt2 = tmp / "deploy.pt2"
    ex = export("torch_export", pt2)
    forwards["verify_export"] += 1
    print(f"[main] {label} export_cli (the CLI defaults: --format "
          f"torch_export --size {size} --model_cfg {cfg}): exported in "
          f"{ex['export_seconds']:.2f} s ({ex['mb']:.1f} MiB), verified "
          f"against the native forward with the kernels in "
          f"{ex['verify_seconds']:.2f} s: max abs diff {ex['max_diff']:.3e} "
          f"(tolerance 1e-1) on {card}", flush=True)
    run = deploy("torch_export", pt2, size)
    seg, model = run["segmenter"], _fp32_model(cfg, ckpt)
    shares, fg, art, nat = [], [], [], []
    with torch.inference_mode():
        for name in names:
            image = np.asarray(Image.open(data / "images" / name).convert("RGB"))
            batch, padding, hw = seg.preprocess(image)
            logits = model(torch.from_numpy(batch).to(DEV))[0]
            forwards["native masks"] += 1
            nat.append(logits.float().cpu())
            art.append(torch.from_numpy(seg.run(batch)["output"]))
            native = seg.postprocess(nat[-1].numpy(), padding, hw)
            deployed = np.asarray(Image.open(
                run["save"] / (Path(name).stem + ".png")))
            shares.append(float((native != deployed).mean()))
            fg.append(float((native == 255).mean()))
    rel, corr, ok_logits = _agree(torch.cat(art), torch.cat(nat))
    ok = max(shares) <= DEPLOY_MASK_SHARE and ok_logits
    print(f"[main] {label} the artifact against the native module with the "
          f"kernels (fp32, same pre and post process, {len(names)} images): "
          f"logits max_rel_err {rel:.3g} (tol {MAIN_REL_TOL}) corr {corr:.6f} "
          f"(min {MAIN_CORR_MIN}); mask pixels that differ, worst image "
          f"{max(shares):.3g}, mean {np.mean(shares):.3g} (at most "
          f"{DEPLOY_MASK_SHARE}); foreground share of the native masks "
          f"{min(fg):.3f}..{max(fg):.3f}" + ("" if ok else "  <-- FAIL"),
          flush=True)
    if not ok:
        fail(f"{label}: the .pt2 program disagrees with the native module "
             f"(logits {rel:.3g}, corr {corr:.6f}; masks {max(shares):.3g})")
    del seg, run

    # 3. ONNX: at 960 the export (its check, one ~35 s forward of the numpy
    # runner, is left to the 352 export: the same graph at another size, so
    # that the script keeps inside its time limit); the check and the 16
    # images at `onnx_size`, full width
    ox = export("onnx", tmp / "deploy960.onnx", ["--skip_verify"])
    print(f"[main] {label} export_cli --format onnx --size {size} "
          f"--skip_verify: exported in {ox['export_seconds']:.2f} s "
          f"({ox['mb']:.1f} MiB) on {card}", flush=True)
    onnx_small = tmp / f"deploy{small}.onnx"
    small_ex = export("onnx", onnx_small, ["--size", str(small)])
    print(f"[main] {label} export_cli --format onnx --size {small}: exported "
          f"in {small_ex['export_seconds']:.2f} s, verified in "
          f"{small_ex['verify_seconds']:.2f} s: max abs diff "
          f"{small_ex['max_diff']:.3e}",
          flush=True)
    orun = deploy("onnx", onnx_small, small)
    print(f"[main] {label} the ONNX leg ran on: {orun['onnx_runtime']}; its "
          f"check and 16 images at --size {small} (hiera_s's full width): at "
          f"{size} one forward of that runtime takes ~35 s, and 16 of them "
          f"would not fit this script's time limit", flush=True)
    del orun

    # 4. fold-BN A/B: the native forward at 960 with the kernels, fp32
    folded = _fp32_model(cfg, ckpt, fold=True)
    x = torch.randn(1, size, size, 3, device=DEV,
                    generator=torch.Generator(DEV).manual_seed(7))

    def forward(m):
        def fn():
            forwards["fold-BN A/B"] += 1
            with torch.inference_mode():
                return m(x)
        return fn

    want, got = forward(model)(), forward(folded)()
    gap = max(((g - w).abs().max() / w.abs().max()).item()
              for g, w in zip(got, want))
    times = collections.defaultdict(list)
    for name, m in (("unfolded", model), ("folded", folded),
                    ("folded", folded), ("unfolded", model)):
        times[name].append(time_ms(forward(m), reps=10))
    ok = gap <= FOLD_REL_TOL
    print(f"[main] {label} fold-BN A/B (fp32, batch 1, with the kernels, CUDA "
          f"events, order unfolded, folded, folded, unfolded) on {card}: "
          f"unfolded {[round(t, 3) for t in times['unfolded']]} ms, folded "
          f"{[round(t, 3) for t in times['folded']]} ms; max gap "
          f"{gap:.3g} of max |unfolded| (at most {FOLD_REL_TOL})"
          + ("" if ok else "  <-- FAIL"), flush=True)
    if not ok:
        fail(f"{label}: the folded forward is {gap:.3g} off the unfolded one")
    del model, folded
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    counts, variants = dict(dispatch.launches), dict(dispatch.variants)
    n = sum(forwards.values())
    per_forward = spec["per_forward"]
    for name in sorted(set(per_forward) | set(counts)):
        if counts.get(name, 0) != per_forward.get(name, 0) * n:
            fail(f"{label}: {name} launched {counts.get(name, 0)} times, "
                 f"expected {per_forward.get(name, 0) * n} ({n} native "
                 f"forwards)")
    print(f"[main] {label} launches {counts} = per fp32 forward x {n} "
          f"native forwards at batch 1 ({dict(forwards)}); the artifacts "
          f"launch none (traced under force_plain)", flush=True)
    return variants


def grouping_ab_phase(path: str, batch: int, card: str) -> None:
    """The path's step (a forward or a train step) with the persistent
    window groups and per block (SAM2UNET_DISABLE_GROUPED=1), alternating:
    ms by CUDA events, 5 steps after 2 warm-ups each time."""
    import os

    import torch

    run, what = _runner(path, batch)
    ms = collections.defaultdict(list)
    try:
        for mode in ("grouped", "per-block", "grouped", "per-block"):
            os.environ.pop("SAM2UNET_DISABLE_GROUPED", None)
            if mode == "per-block":
                os.environ["SAM2UNET_DISABLE_GROUPED"] = "1"
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run()
            end.record()
            end.synchronize()
            ms[mode].append(start.elapsed_time(end) / 5)
    finally:
        os.environ.pop("SAM2UNET_DISABLE_GROUPED", None)
    print(f"[ab] {PATHS[path]['label']} bf16 batch {batch}, ms/{what}, order "
          f"grouped, per-block, grouped, per-block, on {card}: grouped "
          f"{[round(v, 2) for v in ms['grouped']]}, per-block "
          f"{[round(v, 2) for v in ms['per-block']]}", flush=True)
    del run
    torch.cuda.empty_cache()


def mlp_route_ab_phase(path: str, batch: int, card: str) -> None:
    """Optional (`--phases mlp_ab`): the path's end-to-end time with K1's and
    K2's bf16 calls on the mma.sync route they took before csrc/mlp_sm90.cu
    (`mlp_old_route`) and on csrc/mlp_sm90.cu, in one process in the order
    old, new, new, old: a training path's step (`throughput_phase`), a video
    path's tracked frame (`video_throughput_phase`)."""
    for old in (True, False, False, True):
        route = ("the mma.sync route (csrc/fused_mlp.cu, csrc/fused_mlp_bwd.cu)"
                 if old else "csrc/mlp_sm90.cu")
        print(f"[mlp_ab] {PATHS[path]['label']}: K1 and K2 in bf16 on {route}",
              flush=True)
        with mlp_old_route() if old else contextlib.nullcontext():
            if PATHS[path].get("video"):
                video_throughput_phase(path, card)
            else:
                throughput_phase(path, batch, card)


def _train_model(cfg: str, ckpt: Path | None = None, bf16: bool = True):
    """A model for training on the card: with bf16, the frozen trunk in
    bf16 and the rest fp32; else all fp32."""
    import torch

    from sam2unet_torch.cli.common import build_model, load_checkpoint
    from sam2unet_torch.models.sam2unet import cast_frozen

    torch.manual_seed(1)
    model = build_model(cfg, torch.device("cpu"))
    if ckpt is not None:
        load_checkpoint(model, str(ckpt))
    model = model.to(DEV)
    if bf16:
        cast_frozen(model, torch.bfloat16)
    return model


def _train_batch(batch: int, size: int, seed: int):
    import torch

    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    x = torch.randn(batch, size, size, 3, device=DEV, generator=g)
    yy, xx = torch.meshgrid(torch.arange(size, device=DEV),
                            torch.arange(size, device=DEV), indexing="ij")
    r = size // 4
    y = ((yy - size // 2) ** 2 + (xx - size // 3) ** 2 < r * r).float()
    return x, y[None, :, :, None].expand(batch, size, size, 1).contiguous()


def _leaf_agreement(got: dict, want: dict) -> dict:
    """Per trainable leaf: (correlation, max |got - want| / max |want|)."""
    import torch

    out = {}
    for n, b in want.items():
        a, b = got[n].flatten().double(), b.flatten().double()
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        corr = (torch.corrcoef(torch.stack([a, b]))[0, 1].item()
                if a.numel() > 1 else 1.0)
        if not (math.isfinite(rel) and math.isfinite(corr)):
            corr, rel = -1.0, math.inf
        out[n] = (corr, rel)
    return out


def _hold_step(label: str, what: str, runs: dict) -> tuple[bool, dict]:
    """One step's loss and gradients, kernels against the plain versions,
    as s960train holds them: `runs[(bf16, plain)]` = (loss, {leaf:
    gradient}). fp32: loss to 1e-5, every leaf to correlation 0.9999 and
    1e-2 of max |plain|. bf16: the loss to STEP_LOSS_RTOL; each leaf's gap
    to the fp32 plain gradient, 1 - corr, within STEP_GAP_RATIO x the
    plain bf16 gap of the same leaf + STEP_GAP_MARGIN, and the mean gap
    within STEP_GAP_MEAN_RATIO x the plain's. Prints a line per dtype;
    returns (all held, each leaf's bf16 gaps (kernels, plain))."""
    ok, gaps = True, {}
    for bf16 in (False, True):
        (lk, gk), (lp, gp) = runs[bf16, False], runs[bf16, True]
        if gk.keys() != gp.keys() or not gk:
            fail(f"{label}: kernels and plain versions give gradients to "
                 "different parameters")
        agree = _leaf_agreement(gk, gp)
        loss_rel = abs(lk - lp) / abs(lp)
        corr_n, (corr, _) = min(agree.items(), key=lambda kv: kv[1][0])
        rel_n, (_, rel) = max(agree.items(), key=lambda kv: kv[1][1])
        line = (f"[main] {label}, kernels vs plain ({'bf16' if bf16 else 'fp32'}"
                f", {what}): loss {lk:.6f} vs {lp:.6f} (rel {loss_rel:.3g}); "
                f"{len(gp)} gradients: worst correlation {corr:.6f} "
                f"({corr_n}), worst max_rel_err {rel:.4g} ({rel_n})")
        if not bf16:
            good = (loss_rel <= 1e-5 and corr >= max(MAIN_CORR_MIN, 0.9999)
                    and rel <= min(MAIN_REL_TOL, 1e-2))
            line += " (tol: loss 1e-5, correlation 0.9999, max_rel_err 0.01)"
        else:
            ref = runs[False, True][1]
            k_ref, p_ref = _leaf_agreement(gk, ref), _leaf_agreement(gp, ref)
            leaf = {n: (1 - k_ref[n][0], 1 - p_ref[n][0]) for n in ref}
            gaps = leaf
            over = {n: k - (STEP_GAP_RATIO * p + STEP_GAP_MARGIN)
                    for n, (k, p) in leaf.items()}
            worst = max(over, key=over.get)
            ratio_n = max(leaf, key=lambda n: leaf[n][0] / max(leaf[n][1], 1e-12))
            k_mean = sum(k for k, _ in leaf.values()) / len(leaf)
            p_mean = sum(p for _, p in leaf.values()) / len(leaf)
            good = (loss_rel <= STEP_LOSS_RTOL and over[worst] <= 0
                    and k_mean <= STEP_GAP_MEAN_RATIO * p_mean)
            line += (f"; 1 - correlation with the fp32 gradient, kernels vs "
                     f"plain bf16: mean over the leaves {k_mean:.4g} vs "
                     f"{p_mean:.4g}; closest to the limit {worst} "
                     f"{leaf[worst][0]:.4g} vs {leaf[worst][1]:.4g}; largest "
                     f"ratio {ratio_n} {leaf[ratio_n][0]:.4g} vs "
                     f"{leaf[ratio_n][1]:.4g} (tol: loss {STEP_LOSS_RTOL}; "
                     f"each leaf <= {STEP_GAP_RATIO} x plain's + "
                     f"{STEP_GAP_MARGIN}; mean <= {STEP_GAP_MEAN_RATIO} x "
                     f"plain's)")
        print(line + ("" if good else "  <-- FAIL"), flush=True)
        ok = ok and good
    return ok, gaps


def step_compare(path: str, ckpt: Path, seeds: list[int],
                 report: str = "") -> None:
    """One train step's loss and trainable gradients, the kernels against
    the plain versions, same parameters and batch (the path's `step_batch`,
    one batch per seed), in fp32 and in bf16. fp32 holds every leaf to MAIN_CORR_MIN and
    MAIN_REL_TOL and tighter (correlation >= 0.9999, max error <= 1e-2 of
    max |plain|). In bf16 the deep gradients decorrelate from the fp32 ones
    by rounding alone, in the plain version as in the kernels; each leaf's
    gap to the fp32 gradient, 1 - corr(kernel bf16, fp32), is held to the
    same leaf's plain bf16 gap (STEP_GAP_RATIO, STEP_GAP_MARGIN), and their
    mean to the plain's (STEP_GAP_MEAN_RATIO). `report` names a JSON file
    for every leaf's two gaps per seed."""
    import torch

    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.train.loss import multi_head_loss
    from sam2unet_torch.train.optim import trainable_parameters

    spec = PATHS[path]
    label, batch = spec["label"], spec["step_batch"]
    runs = {}
    for bf16 in (True, False):
        model = _train_model(spec["cfg"], ckpt, bf16)
        model.train()
        for seed in seeds:
            x, y = _train_batch(batch, spec["size"], seed=seed)
            for plain in (False, True):
                model.zero_grad(set_to_none=True)
                with dispatch.force_plain() if plain else contextlib.nullcontext():
                    loss = multi_head_loss(model(x), y)
                    loss.backward()
                runs[seed, bf16, plain] = (loss.item(), {
                    n: p.grad.float().clone()
                    for n, p in trainable_parameters(model) if p.grad is not None})
        del model
        torch.cuda.empty_cache()
    ok, gaps = True, {}
    for seed in seeds:
        good, gaps[seed] = _hold_step(
            f"{label} one step, seed {seed}", f"batch {batch}",
            {k[1:]: v for k, v in runs.items() if k[0] == seed})
        ok = ok and good
    if report:
        Path(report).parent.mkdir(parents=True, exist_ok=True)
        Path(report).write_text(json.dumps(
            {str(s): {n: list(v) for n, v in g.items()} for s, g in gaps.items()}))
    if not ok:
        fail(f"{label}: one train step's kernels disagree with the plain "
             "versions")
    del runs
    torch.cuda.empty_cache()


def remat_compare(path: str, ckpt: Path) -> None:
    """Each trunk block under `torch.utils.checkpoint` (the train CLI's
    --remat) against the same bf16 model without it: the same kernels on the
    same inputs, so one train step's loss and every trainable gradient are
    held to 1e-6 of the leaf's max (in practice bitwise). PyTorch's
    convolution, BatchNorm and interpolation backwards in the neck and
    decoder use atomics, so two identical steps already differ there: the
    comparison runs under `torch.use_deterministic_algorithms`, where a
    repeat of the step without remat must come out equal too, and the gaps
    without that mode are printed beside it. Also checks the launches of the
    step with remat, which runs every trunk block's forward twice."""
    import torch

    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.train.loss import multi_head_loss
    from sam2unet_torch.train.optim import trainable_parameters

    spec = PATHS[path]
    label, batch = spec["label"], spec["step_batch"]
    model = _train_model(spec["cfg"], ckpt, bf16=True)
    model.train()
    x, y = _train_batch(batch, spec["size"], seed=2)

    def step(remat: bool):
        model.encoder.remat = remat
        model.zero_grad(set_to_none=True)
        dispatch.reset_launches()
        loss = multi_head_loss(model(x), y)
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.float().clone()
                 for n, p in trainable_parameters(model) if p.grad is not None}
        return loss.item(), grads, dict(dispatch.launches)

    def worst(got, want):
        if got.keys() != want.keys() or not want:
            fail(f"{label}: remat gives gradients to other parameters")
        return max(((got[n] - want[n]).abs().max().item()
                    / max(want[n].abs().max().item(), 1e-30), n) for n in want)

    def three():
        (l0, g0, c0), (l0b, g0b, _), (l1, g1, c1) = (step(False), step(False),
                                                     step(True))
        return (l0, l0b, l1), worst(g0b, g0), worst(g1, g0), len(g0), c0, c1

    _, loose_noise, loose_diff, _, _, _ = three()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (l0, l0b, l1), noise, diff, leaves, c0, c1 = three()
    finally:
        torch.use_deterministic_algorithms(False)
    ok = (l0 == l0b and abs(l1 - l0) <= 1e-6 * abs(l0) and noise[0] <= 1e-6
          and diff[0] <= 1e-6)
    print(f"[main] {label} with remat vs without (bf16, batch {batch}, "
          f"deterministic algorithms): one step's loss {l1:.6f} vs {l0:.6f}; "
          f"all {leaves} trainable gradients: worst max_rel_err {diff[0]:.3g} "
          f"({diff[1]}), between two steps without remat {noise[0]:.3g} (tol "
          f"1e-6 each); without deterministic algorithms {loose_diff[0]:.3g} "
          f"({loose_diff[1]}) against {loose_noise[0]:.3g} ({loose_noise[1]}) "
          f"between two steps without remat; launches with remat {c1}"
          + ("" if ok else "  <-- FAIL"), flush=True)
    want0 = spec["per_step"]
    want1 = {**want0, **spec["per_step_remat"]}
    if c0 != want0 or c1 != want1:
        fail(f"{label}: launches of one step {c0} (expected {want0}), with "
             f"remat {c1} (expected {want1})")
    if not ok:
        fail(f"{label}: remat changes one train step's loss or gradients")
    del model
    torch.cuda.empty_cache()


def _model_and_input(path: str, batch: int):
    import torch

    from sam2unet_torch.cli.common import build_model

    size = PATHS[path]["size"]
    torch.manual_seed(1)
    model = build_model(PATHS[path]["cfg"], torch.device(DEV), torch.bfloat16)
    x = torch.randn(batch, size, size, 3, device=DEV, dtype=torch.bfloat16)
    return model, x


def _runner(path: str, batch: int, remat: bool = False,
            predict: bool = False):
    """(one step of the path: a forward, a train step, or for the SAM2
    predictor a set_image or, with `predict`, a one-point predict on the
    set image; its output); `remat` puts each trunk block of a training path
    under checkpointing."""
    import numpy as np
    import torch

    spec = PATHS[path]
    if spec.get("video"):
        from sam2unet_torch.ops.attention import set_attention_impl

        # t512video: a tracked frame under the "pallas" backend
        impl = "pallas" if "pallas_decode" in spec else None

        def under_impl(fn):
            set_attention_impl(impl)
            try:
                return fn()
            finally:
                set_attention_impl(None)

        pred, frames = sam2_video_predictor(path), video_frames(path)
        state = under_impl(lambda: pred.init_state(images=frames))
        for _, fn in video_prompts(path, pred, state):
            under_impl(fn)
        under_impl(lambda: list(pred.propagate_in_video(state)))
        it = pred.propagate_in_video(state, start_frame_idx=1)
        return (lambda: under_impl(lambda: next(it)[2])), "tracked frame"
    if spec.get("amg"):
        amg, image = amg_generator(path), amg_image(path)
        return (lambda: torch.tensor([r["area"] for r in amg.generate(image)],
                                     dtype=torch.float32)), "generate"
    if spec.get("sam2"):
        pred, image = sam2_predictor(), sam2_image()
        pred.set_image(image)
        if predict:
            pt, lab = np.array([[480.0, 360.0]]), np.array([1])
            return (lambda: torch.from_numpy(pred.predict(pt, lab)[2])), "predict"

        def set_image():
            pred.set_image(image)
            return pred.get_image_embedding()
        return set_image, "set_image"
    if not spec.get("train"):
        model, x = _model_and_input(path, batch)

        def forward():
            with torch.inference_mode():
                return model(x)[0]
        return forward, "forward"
    from sam2unet_torch.train.engine import train_step
    from sam2unet_torch.train.optim import make_optimizer

    model = _train_model(spec["cfg"])
    model.encoder.remat = remat
    optimizer = make_optimizer(model)
    x, y = _train_batch(batch, spec["size"], seed=3)
    return (lambda: train_step(model, optimizer, x, y)), "train step"


def throughput_phase(path: str, batch: int, card: str,
                     remat: bool = False) -> float:
    """img/s of the path's step at `batch`; a batch that does not fit the
    card's memory is reported with its size and halved."""
    import torch

    label = PATHS[path]["label"] + (" with remat" if remat else "")
    reps = 5
    while True:
        run, what = _runner(path, batch, remat)
        torch.cuda.reset_peak_memory_stats()
        try:
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                out = run()
            end.record()
            end.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            peak = torch.cuda.max_memory_allocated() / 2**30
            total = torch.cuda.get_device_properties(0).total_memory / 2**30
            print(f"[throughput] {label} bf16 batch {batch} does NOT fit the "
                  f"card's memory ({peak:.2f} GiB allocated of {total:.2f} "
                  f"GiB when it ran out): running batch {batch // 2}",
                  flush=True)
            del run
            torch.cuda.empty_cache()
            batch //= 2
            if batch < 1:
                fail(f"{label}: no batch fits the card's memory")
    if not torch.isfinite(out).all():
        fail(f"{label} throughput {what} produced non-finite values")
    ms = start.elapsed_time(end) / reps
    ips = batch / (ms / 1e3)
    print(f"[throughput] {label} bf16 batch {batch}: {ms:.2f} "
          f"ms/{what}, {ips:.1f} img/s on {card}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del run, out
    torch.cuda.empty_cache()
    return ips


def mlp_profile_check(by_entry: dict, device: dict, path: str, what: str) -> None:
    """K1's and K2's entry points in a profiled s960 forward or s960train
    step (bf16): their device kernels must be csrc/mlp_sm90.cu's
    (`mlp_gemm_sm90_kernel`, `mlp_adapter_sm90_kernel`, beside the LN
    passes), none the mma.sync GEMM's (`gemm_bf16_kernel`,
    `gemm_bf16_bwd_kernel`), and their CUDA-core entry points
    (`k1_fused_mlp`, `k2_mlp_bwd_dx`) must not run. For the step, each
    entry point's device time and calls (the kernels launched inside its
    annotation). `by_entry` and `device` are the step's trace read by
    `profile_model.trace_entry_kernels` and `trace_device_time`."""
    label, faults = PATHS[path]["label"], []
    entries = ("k1_fused_mlp", "k2_mlp_bwd_dx") if path == "s960train" else (
        "k1_fused_mlp",)
    for entry in entries:
        new = by_entry.get(f"{entry}_sm90", {})
        old = by_entry.get(entry, {})
        mma_sync = sorted(k for k in new if "gemm_bf16" in k)
        print(f"[profile] {label} {what}: {entry}_sm90 device kernels "
              f"{ {k[:60]: (round(v[0] / 1e3, 3), v[1]) for k, v in new.items()} } "
              f"(ms, calls); the CUDA-core entry point {entry}: "
              f"{sum(v[1] for v in old.values())} kernels", flush=True)
        if not any("_sm90_kernel" in k for k in new) or mma_sync or old:
            faults.append(entry)
    if path == "s960train":
        entry_time_table(device, path, what)
        k12 = sum(v[0] for n, v in device.items() if n.startswith(
            ("k1_fused_mlp", "k2_mlp_bwd_dx")))
        print(f"[profile] {label} {what}: K1 + K2 {k12 / 1e3:.2f} ms a step",
              flush=True)
    if faults:
        fail(f"{label}: {faults} ran off csrc/mlp_sm90.cu's kernels")


def entry_time_table(device: dict, path: str, what: str) -> None:
    """The device time of each hand-written entry point in a profiled
    forward or step (the kernels launched inside its annotation), largest
    first, of all device kernels' time. `device`: the trace read by
    `profile_model.trace_device_time`."""
    from sam2unet_torch.utils import profile_model

    rows = sorted(((n, v) for n, v in device.items() if n in profile_model.ENTRY_WRAPPER),
                  key=lambda kv: -kv[1][0])
    total = sum(v[0] for v in device.values())
    print(f"[profile] {PATHS[path]['label']} {what}: device time by entry point "
          f"(the kernels launched inside its annotation), of {total / 1e3:.2f} ms "
          f"of device kernels:", flush=True)
    for n, (us, calls) in rows:
        print(f"[profile]   {n:36s} {us / 1e3:9.3f} ms {calls:5d} kernels", flush=True)


def block_bwd_profile_check(by_entry: dict, path: str, what: str) -> None:
    """K3's, K5's, K7's and K9's entry points in a profiled l352train or
    s960train step (bf16): every call must run csrc/block_bwd_sm90.cu's
    entry points (`k3_adapter_bwd_sm90`, `k5_window_block_strips_bwd_sm90`,
    `k7_window_block_bwd_sm90`, `k9_transition_bwd_sm90`), whose device
    kernels are its own, csrc/gemm_sm90.cuh's GEMM, K11's dk/dv pass, K9's
    unpool and the LN passes, none the mma.sync GEMM's (`gemm_bf16_kernel`,
    `gemm_bf16_bwd_kernel`) or attention passes (`attn_kernel`,
    `attn_bwd_*`), and their CUDA-core entry points (`k3_adapter_bwd`,
    `k5_window_block_strips_bwd`, `k7_window_block_bwd`,
    `k9_transition_bwd`) must not run. `by_entry`: the step's trace read by
    `profile_model.trace_entry_kernels`."""
    label, faults = PATHS[path]["label"], []
    own = ("k3_adapter_bwd_sm90_kernel", "k3_reduce_kernel", "mlp_gemm_sm90_kernel",
           "k7_qside_sm90_kernel", "k11_dkv_sm90_kernel", "ln_rows_kernel",
           "ln_bwd_rows_kernel", "k5_k9_window_attn_bwd_kernel", "unpool2x2_kernel")
    for entry in ("k3_adapter_bwd", "k5_window_block_strips_bwd", "k7_window_block_bwd",
                  "k9_transition_bwd"):
        new = by_entry.get(f"{entry}_sm90", {})
        old = by_entry.get(entry, {})
        other = sorted(k for k in new if not any(o in k for o in own))
        print(f"[profile] {label} {what}: {entry}_sm90 device kernels "
              f"{ {k[:60]: (round(v[0] / 1e3, 3), v[1]) for k, v in new.items()} } "
              f"(ms, calls); the CUDA-core entry point {entry}: "
              f"{sum(v[1] for v in old.values())} kernels", flush=True)
        if not new or other or old:
            faults.append((entry, other, sorted(old)[:4]))
    if faults:
        fail(f"{label}: K3 / K5 / K7 / K9 ran off csrc/block_bwd_sm90.cu's kernels: "
             f"{faults}")


def profile_phase(path: str, batch: int, card: str,
                  predict: bool = False) -> None:
    """Optional: device time by kernel over one forward, train step,
    set_image or predict (torch.profiler), and the device's idle share of
    its wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sam2unet_torch.utils import profile_model

    run, what = _runner(path, batch, predict=predict)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # the device kernels only (not the entry points' GPU user annotations,
    # which span the kernels they launch), busy the union of their intervals
    kernels = profile_model.device_kernels(prof.events())
    if not kernels:
        fail("the profiler recorded no device time")
    by_name: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_us, span_us = profile_model.busy_span_us(kernels)
    busy_ms, span_ms = busy_us / 1e3, span_us / 1e3
    print(f"[profile] {PATHS[path]['label']} bf16 batch {batch}, one {what}, "
          f"on {card}: host wall {wall_ms:.2f} ms (profiler on), device span "
          f"{span_ms:.2f} ms, kernels busy {busy_ms:.2f} ms, idle share of "
          f"the span {1 - busy_ms / span_ms:.3f}, {len(kernels)} device "
          f"kernels", flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"[profile] {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
              f"{n:5d} calls  {name[:100]}", flush=True)
    if path in ("s960", "s1024video"):
        line, ok = hopper_forward_check(prof.events(), "K10",
                                        f"{PATHS[path]['label']} {what}")
        print(f"[profile] {line}", flush=True)
        if not ok:
            fail(f"K10 ran off the Hopper forward: {line}")
    if path in ("s960", "s960train", "l352train", "l352"):
        # the trace once (a profile exports one), read by the checks and,
        # for the l352 forward, the device time by entry point (the ranking
        # of the forward kernels K6, K4 and K8 on device time)
        with tempfile.TemporaryDirectory() as tmp:
            trace = str(Path(tmp) / "trace.json")
            prof.export_chrome_trace(trace)
            by_entry = profile_model.trace_entry_kernels(trace)
            device = profile_model.trace_device_time(trace)
        if path in ("s960", "s960train"):
            mlp_profile_check(by_entry, device, path, what)
        if path in ("l352train", "s960train"):
            block_bwd_profile_check(by_entry, path, what)
        if path == "l352":
            entry_time_table(device, path, what)
    if path == "s960train":
        # K11's dq and dk/dv passes on the Hopper kernels, none on the old
        # bf16 instances (gone from csrc/flash_attention_bwd.cu)
        k11 = {name: v for name, v in by_name.items()
               if "k11_" in name or "flash_bwd_" in name}
        for name, (us, n) in k11.items():
            print(f"[profile] K11 {us / 1e3:9.3f} ms {n:5d} calls  {name[:100]}",
                  flush=True)
        if (not any("k11_dq_sm90_kernel" in n for n in k11)
                or not any("k11_dkv_sm90_kernel" in n for n in k11)
                or any("flash_bwd_dq_kernel" in n or "flash_bwd_dkv_kernel" in n
                       for n in k11)):
            fail(f"the s960train step's K11 ran off the Hopper kernels: {sorted(k11)}")
    # where the host's time goes: operators by their own CPU time
    host = sorted((e for e in prof.key_averages()
                   if e.device_type != DeviceType.CUDA),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    for e in host:
        print(f"[profile] host {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"{e.count:6d} calls  {e.key[:80]}", flush=True)
    del run
    torch.cuda.empty_cache()


# ------------------------------------------------------------- s960dp


def _torchrun(n: int, kind: str, spec: dict, tmp: Path, timeout: float):
    """Run this script's `--dp_worker kind` on `n` ranks of one card through
    torch.distributed.run (--standalone: a rendezvous on localhost), under
    `timeout` seconds; every process it starts is gone when it returns.
    Returns each rank's result (JSON) and the run's wall seconds."""
    spec_path = tmp / f"dp_{kind}_spec.json"
    spec_path.write_text(json.dumps(dict(spec, out=str(tmp))))
    log_path = tmp / f"dp_{kind}.log"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", str(REPO / "chip_smoke.py"),
           "--dp_worker", kind, "--dp_spec", str(spec_path)]
    t0 = time.perf_counter()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=str(REPO), start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    wall = time.perf_counter() - t0
    if rc != 0:
        tail = log_path.read_text(errors="replace")[-6000:]
        fail(f"{kind} on {n} rank(s) {'timed out' if rc is None else f'exited {rc}'}"
             f" after {wall:.1f} s:\n{tail}")
    out = []
    for r in range(n):
        out.append(json.loads((tmp / f"dp_{kind}_rank{r}.json").read_text()))
    return out, wall


def _dp_flat(tensors: dict) -> dict:
    """fp32 host copies."""
    return {k: v.detach().float().cpu().clone() for k, v in tensors.items()}


def _bn_stats(model) -> dict:
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _step_record(model) -> dict:
    """The trainable gradients (the ranks' mean) and the BatchNorm running
    statistics after a step, fp32 host copies."""
    from sam2unet_torch.train.optim import trainable_parameters

    return {"grads": _dp_flat({n: p.grad for n, p in trainable_parameters(model)}),
            "stats": _dp_flat(_bn_stats(model))}


def dp_step_worker(spec: dict) -> dict:
    """One rank of (a): the bf16 train model with SyncBN, this rank's rows of
    the global batch, `steps` train steps (counters set to 0 just before,
    read just after); then one more step with every all-reduce timed."""
    import torch
    import torch.distributed as dist

    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.parallel.mesh import make_mesh, shard_batch
    from sam2unet_torch.train.engine import train_step
    from sam2unet_torch.train.optim import make_optimizer, trainable_parameters

    mesh = make_mesh(DEV)
    model = _train_model(spec["cfg"], Path(spec["ckpt"]), bf16=True).train()
    opt = make_optimizer(model)
    x, y = _train_batch(spec["batch"], spec["size"], seed=spec["seed"])
    x, y = shard_batch(mesh, x), shard_batch(mesh, y)
    losses, ms, first = [], [], None
    torch.cuda.synchronize()
    dispatch.reset_launches()
    for _ in range(spec["steps"]):
        t0 = time.perf_counter()
        losses.append(float(train_step(model, opt, x, y)))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        first = first or _step_record(model)
    counts = dict(dispatch.launches)
    variants = [[w, v, n] for (w, v), n in dispatch.variants.items()]
    path = Path(spec["out"]) / f"dp_step_tensors_rank{mesh.rank}.pt"
    torch.save(dict(first, params=_dp_flat(dict(trainable_parameters(model)))),
                path)
    # one more step, each all-reduce synchronised and timed on the host
    real, spent = dist.all_reduce, []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    dist.all_reduce = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(model, opt, x, y)
        torch.cuda.synchronize()
        timed_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        dist.all_reduce = real
    return {"rank": mesh.rank, "world": mesh.world,
            "backend": dist.get_backend(), "losses": losses, "ms": ms,
            "counts": counts, "variants": variants, "tensors": str(path),
            "all_reduce_ms": 1e3 * sum(spent), "all_reduces": len(spent),
            "timed_step_ms": timed_ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def dp_cli_worker(spec: dict) -> dict:
    """One rank of (b): the train CLI, every write this process makes under
    the save path recorded (an audit hook; torch.save, which writes from
    C++, wrapped)."""
    import torch

    from sam2unet_torch.cli import train_cli
    from sam2unet_torch.ops import dispatch

    root = os.path.realpath(spec["save_path"])
    writes = []

    def audit(event, args):
        if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
            mode, flags = args[1] or "", args[2] or 0
            writing = any(c in mode for c in "wax+") or flags & (
                os.O_WRONLY | os.O_RDWR | os.O_CREAT)
        elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove",
                       "shutil.rmtree", "os.rmdir"):
            writing = True
        else:
            return
        path = os.path.realpath(os.fsdecode(args[0]))
        if writing and path.startswith(root):
            writes.append(f"{event} {os.path.relpath(path, root)}")

    sys.addaudithook(audit)
    real_save = torch.save   # writes from C++: no audit event

    def save(obj, f, *a, **k):
        path = os.path.realpath(os.fsdecode(f))
        if path.startswith(root):
            writes.append(f"torch.save {os.path.relpath(path, root)}")
        return real_save(obj, f, *a, **k)

    torch.save = save
    # what the CLI hands to the JAX-layout train state's writer, kept
    # outside the save path for the check of what it wrote
    real_jax_save = train_cli.save_jax_train_state

    def jax_save(path, model_state, model, optimizer, step):
        real_save({"model": model_state, "optimizer": optimizer.state_dict(),
                   "step": step}, Path(spec["out"]) / "dp_saved_state.pt")
        return real_jax_save(path, model_state, model, optimizer, step)

    train_cli.save_jax_train_state = jax_save
    dispatch.reset_launches()
    stats = train_cli.main(train_cli.build_parser().parse_args(spec["argv"]))
    stats.pop("reports")
    return {"stats": stats, "writes": writes,
            "counts": dict(dispatch.launches),
            "variants": [[w, v, n] for (w, v), n in dispatch.variants.items()]}


def dp_worker_main(kind: str, spec_path: str) -> None:
    """A rank started by `_torchrun`: run the worker, write its result."""
    import torch

    spec = json.loads(Path(spec_path).read_text())
    result = DP_WORKERS[kind](spec)
    rank = int(os.environ.get("RANK", "0"))
    Path(spec["out"], f"dp_{kind}_rank{rank}.json").write_text(
        json.dumps(result))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _per_rank_launches(label: str, what: str, counts: dict, per: dict,
                       n: int) -> None:
    for name in sorted(set(per) | set(counts)):
        if counts.get(name, 0) != per.get(name, 0) * n:
            fail(f"{label}: {what}: {name} launched {counts.get(name, 0)} "
                 f"times, expected {per.get(name, 0)} x {n}")


def dp_main_phase(path: str, tmp: Path, card: str) -> dict:
    """(a) two ranks on the card over gloo against one process, (b) the
    train CLI on two ranks and resumed from its JAX-layout train state.
    Returns the ranks' launch variants."""
    import torch

    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.train.checkpoints import (
        jax_train_state_path,
        restore_train_state,
    )
    from sam2unet_torch.train.engine import train_step
    from sam2unet_torch.train.loss import multi_head_loss
    from sam2unet_torch.train.optim import cosine_step_lr, make_optimizer

    spec = PATHS[path]
    label, cfg, size, batch = spec["label"], spec["cfg"], spec["size"], spec["batch"]
    ranks, steps = spec["ranks"], spec["steps"]
    per_step = PATHS["s960train"]["per_step"]
    per_forward = PATHS["s960"]["per_forward"]
    t_path = time.perf_counter()
    ckpt = tmp / f"{cfg}.pth"
    if not ckpt.exists():
        random_checkpoint(ckpt, cfg, seed=0)
    variants = collections.Counter()

    # (a) one process: step 1's gradients and statistics in fp32 (the
    # reference), then the bf16 steps; each model freed before the next
    x, y = _train_batch(batch, size, seed=spec["seed"])
    model = _train_model(cfg, ckpt, bf16=False).train()
    model.zero_grad(set_to_none=True)
    multi_head_loss(model(x), y).backward()
    fp32 = _step_record(model)
    del model
    torch.cuda.empty_cache()
    model = _train_model(cfg, ckpt, bf16=True).train()
    opt = make_optimizer(model)
    losses, ms, one = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(train_step(model, opt, x, y)))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        one = one or _step_record(model)
    _per_rank_launches(label, "one process", dict(dispatch.launches),
                       per_step, steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, opt, x, y
    torch.cuda.empty_cache()
    print(f"[main] {label} one process, global batch {batch}, bf16: losses "
          f"{[round(v, 6) for v in losses]}, step ms "
          f"{[round(v, 1) for v in ms]} (host clock, synchronised), peak "
          f"{peak:.2f} GiB on {card}", flush=True)

    (r0, r1), wall = _torchrun(ranks, "step", {
        "cfg": cfg, "ckpt": str(ckpt), "size": size, "batch": batch,
        "seed": spec["seed"], "steps": steps}, tmp, timeout=300)
    print(f"[main] {label} {ranks} ranks on one card over {r0['backend']} "
          f"(NCCL refuses two ranks on one device), {batch // ranks} rows "
          f"each, SyncBN: losses {[round(v, 6) for v in r0['losses']]} "
          f"(rank 1 {[round(v, 6) for v in r1['losses']]}), step ms rank 0 "
          f"{[round(v, 1) for v in r0['ms']]}, rank 1 "
          f"{[round(v, 1) for v in r1['ms']]} against one process's "
          f"{[round(v, 1) for v in ms]} (host clock, synchronised; the ranks "
          f"share the card); all-reduces in a timed extra step: "
          f"{r0['all_reduces']} taking {r0['all_reduce_ms']:.1f} ms of its "
          f"{r0['timed_step_ms']:.1f} ms "
          f"({r0['all_reduce_ms'] / r0['timed_step_ms']:.3f}; each "
          f"synchronised); peak {r0['peak_gib']:.2f} GiB a rank; the run "
          f"{wall:.1f} s with the processes' start on {card}", flush=True)
    if r0["backend"] != "gloo" or r0["world"] != ranks:
        fail(f"{label}: the ranks ran on {r0['backend']} at world {r0['world']}")
    if r0["losses"] != r1["losses"]:
        fail(f"{label}: the ranks report different global losses")
    for k, (a, b) in enumerate(zip(r0["losses"], losses)):
        if abs(a - b) > STEP_LOSS_RTOL * abs(b):
            fail(f"{label}: step {k + 1}'s loss {a} on {ranks} ranks, {b} in "
                 f"one process (tol {STEP_LOSS_RTOL})")
    for r in (r0, r1):
        _per_rank_launches(label, f"rank {r['rank']}", r["counts"], per_step,
                           steps)
        variants.update({(w, v): n for w, v, n in r["variants"]})
    print(f"[main] {label} launches per rank over {steps} steps = s960train's "
          f"per step x {steps}: "
          f"{ {k: r0['counts'][k] for k in sorted(r0['counts'])} }", flush=True)
    t0, t1 = (torch.load(r["tensors"], weights_only=True) for r in (r0, r1))
    for part in ("params", "stats", "grads"):
        differ = [k for k in t0[part] if not torch.equal(t0[part][k], t1[part][k])]
        if differ:
            fail(f"{label}: the ranks' {part} differ: {differ[:4]}")
    # step 1's gradients (the same parameters in both runs): each bf16
    # run's gap to the fp32 gradient, s960train's bf16 bound with the
    # one-process run in the plain version's place, on three readings of
    # each leaf: 1 - corr; the max relative gap; and the norm's relative
    # gap, which a fault of scale (gradients summed over the ranks, or
    # divided twice) moves while it leaves the correlation at 1
    def readings(got: dict) -> dict:
        agree = _leaf_agreement(got, fp32["grads"])
        return {n: (1 - agree[n][0], agree[n][1],
                    abs(float(got[n].double().norm())
                        / max(float(b.double().norm()), 1e-30) - 1))
                for n, b in fp32["grads"].items()}

    direct = _leaf_agreement(t0["grads"], one["grads"])
    dp_r, one_r = readings(t0["grads"]), readings(one["grads"])
    kinds = ("1 - corr", "max_rel_gap", "norm gap")
    for n in sorted(dp_r):
        print(f"[dp-leaf] {n}: {ranks} ranks vs one process 1-corr "
              f"{1 - direct[n][0]:.3g} max_rel_gap {direct[n][1]:.3g}; to fp32 "
              + ", ".join(f"{kind} {dp_r[n][i]:.3g} vs {one_r[n][i]:.3g}"
                          for i, kind in enumerate(kinds)), flush=True)
    rel_n = max(direct, key=lambda n: direct[n][1])
    print(f"[main] {label} step 1's gradients of the {len(dp_r)} trainable "
          f"leaves, {ranks} ranks (the mean of the ranks') against one "
          f"process: worst 1 - corr {max(1 - c for c, _ in direct.values()):.4g}"
          f", largest max_rel_gap {rel_n} {direct[rel_n][1]:.4g}", flush=True)
    bad = []
    for i, kind in enumerate(kinds):
        over = {n: dp_r[n][i] - (STEP_GAP_RATIO * one_r[n][i] + STEP_GAP_MARGIN)
                for n in dp_r}
        worst = max(over, key=over.get)
        mean_dp = sum(r[i] for r in dp_r.values()) / len(dp_r)
        mean_one = sum(r[i] for r in one_r.values()) / len(one_r)
        good = over[worst] <= 0 and mean_dp <= (STEP_GAP_MEAN_RATIO * mean_one
                                                + (STEP_GAP_MARGIN if i else 0))
        print(f"[main] {label} step 1's gradients, {kind} to the fp32 "
              f"gradient: mean {mean_dp:.4g} vs one process's {mean_one:.4g}, "
              f"closest to the limit {worst} {dp_r[worst][i]:.4g} vs "
              f"{one_r[worst][i]:.4g} (tol, s960train's bf16 bounds: each "
              f"leaf <= {STEP_GAP_RATIO} x one process's + {STEP_GAP_MARGIN}; "
              f"mean <= {STEP_GAP_MEAN_RATIO} x one process's"
              f"{'' if i == 0 else f' + {STEP_GAP_MARGIN}'})"
              f"{'' if good else '  <-- FAIL'}", flush=True)
        if not good:
            bad.append(kind)
    if bad:
        fail(f"{label}: the {ranks}-rank gradients disagree with one "
             f"process's ({', '.join(bad)})")

    def rel_gap(a: dict, b: dict, k: str) -> float:
        """max |a - b| of a statistic over its layer's scale: the largest
        variance, for a mean its square root (a mean near 0 has no scale
        of its own)."""
        var = b[k.rsplit(".", 1)[0] + ".running_var"]
        scale = float(var.abs().max()) ** (0.5 if k.endswith("mean") else 1)
        return float((a[k] - b[k]).abs().max()) / max(scale, 1e-30)

    stat_gap = {k: (rel_gap(t0["stats"], fp32["stats"], k),
                    rel_gap(one["stats"], fp32["stats"], k))
                for k in fp32["stats"]}
    direct_gap = {k: rel_gap(t0["stats"], one["stats"], k) for k in one["stats"]}
    k_max = max(direct_gap, key=direct_gap.get)
    bad = [k for k, (g, r) in stat_gap.items()
           if g > STEP_GAP_RATIO * r + STEP_GAP_MARGIN]
    print(f"[main] {label} BatchNorm running statistics after step 1, "
          f"{ranks} ranks (SyncBN: the global batch's fp32 moments, unbiased "
          f"over the global count) against one process: max gap "
          f"{direct_gap[k_max]:.4g} of the layer's variance (a mean's: of its "
          f"standard deviation; {k_max}); to the "
          f"fp32 run's: worst {max(g for g, _ in stat_gap.values()):.4g} vs "
          f"one process's {max(r for _, r in stat_gap.values()):.4g} (tol "
          f"each <= {STEP_GAP_RATIO} x one process's + {STEP_GAP_MARGIN})",
          flush=True)
    if bad:
        fail(f"{label}: the ranks' BatchNorm statistics disagree: {bad[:4]}")
    del t0, t1, fp32, one

    # (b) the train CLI on 2 ranks, then resumed from its JAX-layout state
    train_data, data = tmp / "dp_train", tmp / "dp_test"
    write_dataset(train_data, n=spec["train_images"], seed=6)
    write_dataset(data, n=spec["eval_images"], seed=7)
    out = tmp / "dp_run"
    common = ["--save_path", str(out), "--checkpoint", str(ckpt),
              "--train_image_path", str(train_data / "images"),
              "--train_mask_path", str(train_data / "masks"),
              "--test_image_path", str(data / "images"),
              "--test_gt_path", str(data / "masks"), "--bf16",
              "--num_workers", "4", "--device", DEV, "--shard_map"]
    first, wall1 = _torchrun(ranks, "cli", {
        "argv": common + ["--epoch", "1", "--save_train_state"],
        "save_path": str(out)}, tmp, timeout=300)
    f0, f1 = first
    s0 = f0["stats"]
    print(f"[main] {label} torchrun --nproc_per_node {ranks} train_cli --bf16 "
          f"--epoch 1 --save_train_state --shard_map (the CLI defaults: "
          f"hiera_s, 960, global batch 16), {spec['train_images']} images: "
          f"{s0['steps']} steps, losses {[round(v, 4) for v in s0['losses']]}, "
          f"epoch {s0['epoch_seconds'][0]:.2f} s "
          f"({spec['train_images'] / s0['epoch_seconds'][0]:.2f} img/s, host "
          f"clock), eval {s0['eval_seconds'][0]:.2f} s; the run {wall1:.1f} s "
          f"with the processes' start on {card}", flush=True)
    names = sorted({re.sub(r"\.tmp\d+$", "", w.split(" ", 1)[1].split("/")[0])
                    for w in f0["writes"]} - {"."})
    print(f"[main] {label} writes under the save path: rank 0 "
          f"{len(f0['writes'])} ({names}), rank 1 {len(f1['writes'])} "
          f"{f1['writes'][:5]}", flush=True)
    if f1["writes"] or f1["stats"]["saved"] or not s0["saved"] or not any(
            w.endswith("log.txt") for w in f0["writes"]) or not any(
            w == f"torch.save {Path(s0['saved'][-1]).name}" for w in f0["writes"]):
        fail(f"{label}: rank 1 wrote {f1['writes'][:5]}, or rank 0 wrote no "
             "log and snapshot")
    if s0["losses"] != f1["stats"]["losses"] or not all(
            math.isfinite(v) for v in s0["losses"]):
        fail(f"{label}: the ranks' losses differ or are not finite")
    snapshot = s0["saved"][-1]
    jax_dir = jax_train_state_path(snapshot)
    saved = torch.load(tmp / "dp_saved_state.pt", map_location="cpu",
                       weights_only=True)
    model = _train_model(cfg, None, bf16=False).cpu()
    opt = make_optimizer(model)
    step = restore_train_state(jax_dir, model, opt)
    got, want = opt.state_dict()["state"], saved["optimizer"]["state"]
    differ = [i for i in want if any(not torch.equal(got[i][k], want[i][k])
                                     for k in ("exp_avg", "exp_avg_sq", "step"))]
    model_differ = [k for k, v in saved["model"].items()
                    if not k.endswith("num_batches_tracked")
                    and not torch.equal(model.state_dict()[k], v)]
    print(f"[main] {label} {Path(jax_dir).name} (the JAX TrainState layout, "
          f"the one train state beside the snapshot) restored: step {step}, "
          f"{len(want)} AdamW states, {len(differ)} differ from the saved "
          f"optimizer's (exp_avg, exp_avg_sq, step, bit for bit); "
          f"{len(model_differ)} model tensors differ", flush=True)
    if Path(snapshot + "_train_state").exists():
        fail(f"{label}: --save_train_state wrote a second train state")
    if step != s0["global_step"] or differ or model_differ or len(got) != len(want):
        fail(f"{label}: the JAX-layout train state did not restore what was "
             f"saved: step {step}, moments {differ[:4]}, model {model_differ[:4]}")
    del model, opt, saved
    resumed, wall2 = _torchrun(ranks, "cli", {
        "argv": common + ["--epoch", "2", "--resume", jax_dir],
        "save_path": str(out)}, tmp, timeout=300)
    a0, a1 = resumed
    spe = s0["steps"]
    want_lr = cosine_step_lr(1e-3, step, 2, spe)
    print(f"[main] {label} resumed from {Path(jax_dir).name} with --epoch 2: "
          f"{a0['stats']['steps']} steps (epochs 0-1, as the JAX CLI), global "
          f"step {a0['stats']['global_step']}, first rate "
          f"{a0['stats']['lrs'][0]:.9g} = the schedule at step {step} "
          f"({want_lr:.9g}), losses "
          f"{[round(v, 4) for v in a0['stats']['losses']]}; rank 1 wrote "
          f"{len(a1['writes'])} files; the run {wall2:.1f} s", flush=True)
    if (a0["stats"]["lrs"][0] != want_lr or a1["writes"]
            or a0["stats"]["global_step"] != step + 2 * spe):
        fail(f"{label}: the resumed run: first rate {a0['stats']['lrs'][0]} "
             f"(want {want_lr}), rank 1 writes {a1['writes'][:4]}")
    for run in (first, resumed):
        for r in run:
            st = r["stats"]
            per = {k: per_step.get(k, 0) * st["steps"]
                   + per_forward.get(k, 0) * st["eval_forwards"]
                   for k in set(per_step) | set(per_forward)}
            _per_rank_launches(label, f"train CLI rank {st['rank']}",
                               r["counts"], per, 1)
            variants.update({(w, v): n for w, v, n in r["variants"]})

    print(f"[main] {label} the path took {time.perf_counter() - t_path:.1f} s",
          flush=True)
    return dict(variants)


# ------------------------------------------------------------- s352mc


def mc_sp_worker(spec: dict) -> dict:
    """One of 4 ranks on a (2, 2) mesh: ring_sdpa's forward and gradient at
    (1, 484, 4, 96) over the model axis (seeded q, k, v and cotangent, this
    rank's token slice), gathered whole; then the dry run's SP forward in
    bf16 (this rank's data row). Rank 0 writes the ring's tensors, the
    model index 0 ranks their rows' bf16 outputs."""
    import torch

    from sam2unet_torch.ops import sp_attention
    from sam2unet_torch.parallel import dryrun
    from sam2unet_torch.parallel.mesh import all_gather_cat, make_mesh, shard_batch

    mesh = make_mesh(DEV, model_parallel=2)
    group, n = mesh.model_group, mesh.model_parallel
    g = torch.Generator().manual_seed(5)
    q, k, v, cot = (torch.randn(1, 484, 4, 96, generator=g) for _ in range(4))
    sl = 484 // n
    own = slice(mesh.model_index * sl, (mesh.model_index + 1) * sl)
    leaves = [t[:, own].to(mesh.device).requires_grad_(True) for t in (q, k, v)]
    o = sp_attention.ring_sdpa(*leaves, group)
    (o * cot[:, own].to(mesh.device)).sum().backward()
    ring = {name: all_gather_cat(t.detach(), 1, group).cpu()
            for name, t in zip(("o", "dq", "dk", "dv"),
                               [o] + [t.grad for t in leaves])}
    out = Path(spec["out"])
    if mesh.rank == 0:
        torch.save(dict(ring, q=q, k=k, v=v, cot=cot), out / "mc_ring.pt")
    xs, _ = dryrun.phase_batch(mesh.data_size, 352, dryrun.phase_seed("sp"))
    model = dryrun.phase_model("sam2_hiera_s", sp_group=group, sp_degree=n)
    model = model.to(device=mesh.device, dtype=torch.bfloat16).eval()
    sp_attention.calls.clear()
    with torch.inference_mode():
        outs = model(shard_batch(mesh, xs))
    if mesh.model_index == 0:
        torch.save([t.float().cpu() for t in outs],
                   out / f"mc_sp_bf16_rows{mesh.data_index}.pt")
    return {"rank": mesh.rank, "ring_calls": sp_attention.calls["ring_sdpa"],
            "backend": torch.distributed.get_backend()}


# the ranks' work of s960dp and s352mc (`--dp_worker`)
DP_WORKERS = {"step": dp_step_worker, "cli": dp_cli_worker, "mc_sp": mc_sp_worker}


def _mc_faults(got: dict, want: dict) -> list[str]:
    """The leaves where a dry-run step's record departs from the one-process
    step's (`MC_*` tolerances): loss, gradients, parameters after AdamW
    (a gradient near zero may flip Adam's first +-lr update), statistics."""
    bad = []
    if abs(got["loss"] - want["loss"]) > MC_LOSS_RTOL * abs(want["loss"]):
        bad.append(f"loss {got['loss']} vs {want['loss']}")
    grads = {k[6:]: v for k, v in want["tensors"].items() if k.startswith("grads/")}
    floor = MC_NOISE_FLOOR * max(float(w.abs().max()) for w in grads.values())
    for name, w in grads.items():
        g = got["tensors"][f"grads/{name}"]
        scale = max(float(w.abs().max()), floor)
        if float((g - w).abs().max()) > MC_GRAD_TOL * scale:
            bad.append(f"grad {name}")
        elif scale > floor and _leaf_agreement({"a": g}, {"a": w})["a"][0] < MC_GRAD_CORR:
            bad.append(f"grad corr {name}")
        near = w.abs() <= MC_GRAD_TOL * scale
        lr = 1e-3
        allowed = near * (2 * lr) + (~near) * (1e-2 * lr)
        if not bool(((got["tensors"][f"params/{name}"]
                      - want["tensors"][f"params/{name}"]).abs() <= allowed).all()):
            bad.append(f"param {name}")
    for key, w in want["tensors"].items():
        if key.startswith("stats/"):
            # a mean's gap over its layer's standard deviation (a mean near
            # 0 has no scale of its own), a variance's over its largest
            var = want["tensors"][key.rsplit(".", 1)[0] + ".running_var"]
            if key.endswith("running_var"):
                tol, scale = 1e-4, float(var.max())
            else:
                tol, scale = 1e-5, float(var.max()) ** 0.5
            if float((got["tensors"][key] - w).abs().max()) > tol * scale:
                bad.append(key)
    return bad


def _mc_one_process(cfg: str, rfb_out, size: int, key: str, n: int) -> dict:
    """The dry run's step of phase `key` in one process on the card: the
    same parameters (`phase_model`), the whole batch, fp32."""
    import torch

    from sam2unet_torch.parallel import dryrun
    from sam2unet_torch.train.engine import train_step
    from sam2unet_torch.train.optim import make_optimizer, trainable_parameters

    model = dryrun.phase_model(cfg, rfb_out).to(DEV)
    opt = make_optimizer(model, lr=dryrun.LR)
    x, y = dryrun.phase_batch(n, size, dryrun.phase_seed(key))
    loss = float(train_step(model, opt, torch.from_numpy(x).to(DEV),
                            torch.from_numpy(y).to(DEV)))
    named = trainable_parameters(model)
    tensors = {f"params/{k}": p.detach().cpu() for k, p in named}
    tensors.update({f"grads/{k}": p.grad.cpu() for k, p in named})
    tensors.update({f"stats/{k}": v.cpu() for k, v in model.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))})
    return {"loss": loss, "tensors": tensors}


def multichip_main_phase(path: str, tmp: Path, card: str) -> dict:
    """entry() on the card, then dryrun_multichip(4) with every phase,
    its records against one process, the ring's gradient and the bf16 SP
    forward. Returns the launch variants of entry() and of the ranks."""
    import torch

    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.parallel import dryrun

    spec = PATHS[path]
    label, ranks = spec["label"], spec["ranks"]
    t_path = time.perf_counter()
    variants = collections.Counter()

    # entry(): the flagship forward, bf16 on the card
    dispatch.reset_launches()
    fn, (model, x) = dryrun.entry(DEV)
    outs = fn(model, x)
    torch.cuda.synchronize()
    variants.update(dispatch.variants)
    shapes = [tuple(o.shape) for o in outs]
    print(f"[main] {label} entry(): {type(model).__name__}(hiera_s) "
          f"{next(model.parameters()).dtype} on {x.device}, heads {shapes}, "
          f"launches {dict(dispatch.launches)}", flush=True)
    if shapes != [(1, 352, 352, 1)] * 3 or not all(
            bool(torch.isfinite(o).all()) for o in outs):
        fail(f"{label}: entry()'s forward gave {shapes} or non-finite values")
    del fn, model, x, outs
    torch.cuda.empty_cache()

    # the dry run, every phase, four ranks on the card; TF32 off in the
    # ranks' cuBLAS and cuDNN too (NVIDIA_TF32_OVERRIDE), as in this process
    record = tmp / "mc_record"
    knobs = {"DRYRUN_FULL": "1", "DRYRUN_BUDGET_S": "100000",
             "NVIDIA_TF32_OVERRIDE": "0"}
    os.environ.update(knobs)
    t0 = time.perf_counter()
    try:
        dryrun.dryrun_multichip(ranks, DEV, record=str(record))
    except RuntimeError as e:
        fail(f"{label}: {e}")
    finally:
        for k in knobs:
            os.environ.pop(k)
    wall = time.perf_counter() - t0
    phases = dryrun.PHASES + dryrun.HEAVY
    recs = {}
    for i, (name, key, *_) in enumerate(phases, 1):
        recs[key] = [torch.load(record / f"{key}_rank{r}.pt", weights_only=True)
                     for r in range(ranks)]
        per_rank = [dict(sorted(r["launches"].items())) for r in recs[key]]
        for r in recs[key]:
            variants.update({(w, v): c for w, v, c in r["variants"]})
        print(f"[main] {label} phase {i}/{len(phases)} {name}: "
              f"{recs[key][0]['seconds']:.2f} s (rank 0's clock; a timing of "
              f"the mechanism, {ranks} ranks sharing the card over gloo) on "
              f"{card}; launches per rank "
              f"{per_rank[0] if all(p == per_rank[0] for p in per_rank) else per_rank}",
              flush=True)
    print(f"[main] {label} all {len(phases)} phases {wall:.1f} s with the "
          f"ranks' start on {card}", flush=True)

    # the steps against one process
    for key, (cfg, rfb_out, size) in {
            "tiny": ("hiera_test", 8, 64), "s352dp": ("sam2_hiera_s", None, 352),
            "s352sm": ("sam2_hiera_s", None, 352)}.items():
        want = _mc_one_process(cfg, rfb_out, size, key, ranks)
        torch.cuda.empty_cache()
        got = recs[key][0]
        bad = _mc_faults(got, want)
        losses = sorted({r["loss"] for r in recs[key]})
        print(f"[main] {label} {key}: loss {got['loss']:.7f} on every rank "
              f"{losses}, one process {want['loss']:.7f}; "
              f"{sum(k.startswith('grads/') for k in want['tensors'])} trainable "
              f"leaves (gradients, parameters after AdamW) and "
              f"{sum(k.startswith('stats/') for k in want['tensors'])} "
              f"statistics: {len(bad)} outside the one-step tolerances "
              f"{bad[:4]}", flush=True)
        if bad or len(losses) != 1:
            fail(f"{label}: {key} departs from one process: {bad[:6]}")
    tiny = recs["tiny"]
    print(f"[main] {label} tiny dp x tp: a rank holds "
          f"{[r['held_bytes'] for r in tiny]} bytes of the split leaves and "
          f"their moments, {tiny[0]['full_bytes']} whole", flush=True)
    if not all(2 * r["held_bytes"] == r["full_bytes"] > 0 for r in tiny):
        fail(f"{label}: a rank does not hold half of the split leaves' bytes")

    # the SP forward against the dense one, fp32
    xs, _ = dryrun.phase_batch(2, 352, dryrun.phase_seed("sp"))
    dense = dryrun.phase_model("sam2_hiera_s").to(DEV).eval()
    with torch.inference_mode():
        want = [t.float().cpu() for t in dense(torch.from_numpy(xs).to(DEV))]
        want_bf16 = [t.float().cpu() for t in dense.to(torch.bfloat16)(
            torch.from_numpy(xs).to(DEV))]
    del dense
    torch.cuda.empty_cache()
    sp = sorted((r for r in recs["sp"] if "outs" in r), key=lambda r: r["rows"])
    got = [torch.cat([r["outs"][i] for r in sp]) for i in range(3)]
    rel = [float((g - w).abs().max()) / float(w.abs().max())
           for g, w in zip(got, want)]
    rings = [r["ring_calls"] for r in recs["sp"]]
    print(f"[main] {label} SP forward (fp32, global blocks over the model "
          f"axis) against the dense forward: max gap / max of each head "
          f"{[f'{v:.3g}' for v in rel]} (tol {SP_FP32_TOL}); ring_sdpa calls "
          f"per rank {rings} (3 global blocks, one forward each)", flush=True)
    if max(rel) > SP_FP32_TOL or rings != [3] * ranks:
        fail(f"{label}: the SP forward departs from the dense one or the ring "
             f"ran {rings} times")

    # the ring's gradient and the bf16 SP forward, four ranks again
    res, wall2 = _torchrun(ranks, "mc_sp", {}, tmp, timeout=300)
    ring = torch.load(tmp / "mc_ring.pt", weights_only=True)
    leaves = [ring[n].to(DEV).requires_grad_(True) for n in ("q", "k", "v")]
    o = torch.nn.functional.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in leaves)).transpose(1, 2)
    (o * ring["cot"].to(DEV)).sum().backward()
    ref = {"o": o.detach().cpu(), **{d: t.grad.cpu() for d, t in
                                     zip(("dq", "dk", "dv"), leaves)}}
    ring_rel = {n: float((ring[n] - w).abs().max()) / float(w.abs().max())
                for n, w in ref.items()}
    print(f"[main] {label} ring_sdpa over the model axis (2 ranks a row, "
          f"{res[0]['backend']}) at (1, 484, 4, 96) fp32 against dense "
          f"autograd: max gap / max {({k: f'{v:.3g}' for k, v in ring_rel.items()})}"
          f" (tol {SP_FP32_TOL}); the run {wall2:.1f} s", flush=True)
    if max(ring_rel.values()) > SP_FP32_TOL:
        fail(f"{label}: the ring's forward or gradient departs from dense")
    got16 = [torch.cat([torch.load(tmp / f"mc_sp_bf16_rows{d}.pt",
                                   weights_only=True)[i] for d in range(2)])
             for i in range(3)]
    gap_sp = [float((g - w).abs().max()) / float(w.abs().max())
              for g, w in zip(got16, want)]
    gap_dense = [float((g - w).abs().max()) / float(w.abs().max())
                 for g, w in zip(want_bf16, want)]
    bound = [STEP_GAP_RATIO * d + STEP_GAP_MARGIN for d in gap_dense]
    print(f"[main] {label} SP forward in bf16 against the dense fp32 forward: "
          f"max gap / max {[f'{v:.4g}' for v in gap_sp]}, the dense bf16 "
          f"forward's {[f'{v:.4g}' for v in gap_dense]}, bound "
          f"{[f'{v:.4g}' for v in bound]} ({STEP_GAP_RATIO} x the dense's + "
          f"{STEP_GAP_MARGIN}); ring calls per rank "
          f"{[r['ring_calls'] for r in res]}", flush=True)
    if any(g > b for g, b in zip(gap_sp, bound)) or any(
            r["ring_calls"] != 3 for r in res):
        fail(f"{label}: the bf16 SP forward is past its bound")
    print(f"[main] {label} the path took {time.perf_counter() - t_path:.1f} s",
          flush=True)
    return dict(variants)


def opsapi_main_phase(path: str, batch: int) -> dict:
    """The kernel entry points no model calls, through the functions and
    modules a user calls (seeded random weights and inputs): the launches
    of the run (counters set to 0 just before, read just after) against
    PATHS' table, each fp32 call past the weight gate with none; then the
    checks: K16's q, k, v equal to K15's column blocks bit for bit, the
    fused-LN `MultiScaleAttention` against the same call on LN(x), the
    frozen MLPs' outputs and dx and the masked blocks' outputs and dx
    against the plain versions, the masked blocks against the valid-group
    route (window_partition_valid + K6 with n_pad) on the same inputs."""
    import torch

    from sam2unet_torch.models.hiera import MultiScaleAttention
    from sam2unet_torch.nn.layers import MLP, gelu, layer_norm_plain
    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.ops.fused_attention_block import (
        fused_window_block,
        valid_group_blocks,
    )
    from sam2unet_torch.ops.fused_mlp import (
        f32_weights_overflow,
        fused_ln_matmul,
        fused_ln_qkv,
        fused_mlp,
    )
    from sam2unet_torch.ops.windowing import grid_window_mask

    spec, label = PATHS[path], PATHS[path]["label"]
    torch.manual_seed(14)   # the modules' own initialisation
    gen = torch.Generator(device=DEV)
    gen.manual_seed(14)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen, device=DEV) * scale + shift
        return t.to(dtype)

    def lin(o, i, dtype=torch.bfloat16):
        return (rnd(o, i, dtype=dtype, scale=1.0 / math.sqrt(i)),
                rnd(o, dtype=dtype, scale=0.1))

    def ln_params(c, dtype=torch.bfloat16):
        return (rnd(c, dtype=dtype, scale=0.1, shift=1.0),
                rnd(c, dtype=dtype, scale=0.1))

    b960 = max(1, batch // 2)
    rows = ([(batch * hh * hh, c) for hh, c in zip((88, 44, 22, 11),
                                                    (144, 288, 576, 1152))]
            + [(b960 * hh * hh, c) for hh, c in zip((240, 120, 60, 30),
                                                     (96, 192, 384, 768))])
    tails = ((b960 * 60 * 60, 384), (b960 * 30 * 30, 768))
    modes = ((True, False), (False, True))   # fused_mlp's; MLP(fused=True)'s
    grids = ((22, 16, 576, 8), (11, 8, 1152, 16))   # is (False, False)

    # ---- the main path: counters at 0 just before, read just after
    dispatch.reset_launches()
    t0 = time.perf_counter()
    split_ok = True
    for n, c in rows:
        x, (w, bias), (lw, lb) = rnd(n, c), lin(3 * c, c), ln_params(c)
        for add_bias in (True, False):
            full = fused_ln_matmul(x, w, bias, lw, lb, add_bias)
            q, k, v = fused_ln_qkv(x, w, bias, lw, lb, add_bias)
            split_ok &= (bool(torch.equal(torch.cat([q, k, v], -1), full))
                         and all(t.is_contiguous() for t in (q, k, v)))
        del x, full, q, k, v
    msa = MultiScaleAttention(576, 576, 8).to(DEV, torch.bfloat16)
    xw = rnd(batch * 4, 16, 16, 576)   # 22x22 padded to 32x32: 4 windows
    msa_ln = ln_params(576)
    with torch.no_grad():
        msa_out = msa(xw, *msa_ln)
    mlps = []
    for n, c in tails:
        mod = MLP(c, 4 * c, c, activation=gelu, fused=True).to(
            DEV, torch.bfloat16).requires_grad_(False)
        x, gy = rnd(n, c).requires_grad_(True), rnd(n, c)
        y = mod(x)
        (dx,) = torch.autograd.grad(y, x, gy)
        mlps.append(("MLP(fused=True)", mod.layers[0].weight, mod.layers[0].bias,
                     mod.layers[1].weight, mod.layers[1].bias, {}, False, x,
                     gy, y, dx))
        for ln, residual in modes:
            (w1, b1), (w2, b2) = lin(4 * c, c), lin(c, 4 * c)
            kw = dict(zip(("ln_w", "ln_b"), ln_params(c))) if ln else {}
            y = fused_mlp(x, w1, b1, w2, b2, residual=residual, **kw)
            (dx,) = torch.autograd.grad(y, x, gy)
            mlps.append((f"fused_mlp(ln={ln}, residual={residual})", w1, b1,
                         w2, b2, kw, residual, x, gy, y, dx))
    blocks = []
    for hh, win, c, nh in grids:
        mask, lm = (torch.from_numpy(a).to(DEV)
                    for a in grid_window_mask(hh, hh, win))
        (wq, bq), (wp, bp), (lw, lb) = lin(3 * c, c), lin(c, c), ln_params(c)
        weights = (wq, bq, lw, lb, wp, bp)
        x = rnd(batch, hh * hh, c).requires_grad_(True)
        gy = rnd(batch, hh * hh, c)
        y = fused_window_block(x, *weights, num_heads=nh, attn_mask=mask,
                               pad_logmult=lm)
        (dx,) = torch.autograd.grad(y, x, gy)
        blocks.append((hh, win, c, nh, mask, lm, weights, x, gy, y, dx))
    # fp32 at batch 2 on both sides of the weight gate: launches per call
    gated = []
    for n, c in ((2 * 3600, 384), (2 * 900, 768)):
        (w1, b1), (w2, b2) = lin(4 * c, c, torch.float32), lin(c, 4 * c,
                                                                torch.float32)
        x = rnd(n, c, dtype=torch.float32).requires_grad_(True)
        before = sum(dispatch.launches.values())
        torch.autograd.grad(fused_mlp(x, w1, b1, w2, b2), x,
                            torch.ones(n, c, device=DEV))
        gated.append((f"fused_mlp fp32 {n}x{c}",
                      f32_weights_overflow(x, w1, w2),
                      sum(dispatch.launches.values()) - before))
    for n, c in ((2 * 121, 1152), (2 * 900, 768)):
        x, (w, bias) = rnd(n, c, dtype=torch.float32), lin(3 * c, c,
                                                           torch.float32)
        before = sum(dispatch.launches.values())
        fused_ln_matmul(x, w, bias, *ln_params(c, torch.float32))
        gated.append((f"fused_ln_matmul fp32 {n}x{c}",
                      f32_weights_overflow(x, w),
                      sum(dispatch.launches.values()) - before))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, variants = dict(dispatch.launches), dict(dispatch.variants)
    print(f"[main] {label} the run {wall:.2f} s (host clock, first calls "
          f"included); launches {counts}; by variant "
          f"{ {f'{w}[{v}]': n for (w, v), n in variants.items()} }", flush=True)
    per_run = spec["per_run"]
    for name in set(per_run) | set(counts):
        if counts.get(name, 0) != per_run.get(name, 0):
            fail(f"{label}: {name} launched {counts.get(name, 0)} times, "
                 f"expected {per_run.get(name, 0)}")
    for what, past_gate, n in gated:
        print(f"[main] {label} {what}: "
              + ("past the fp32 weight gate, the plain form" if past_gate
                 else "under the gate, the kernels") + f"; launches {n}",
              flush=True)
        if (n == 0) != past_gate:
            fail(f"{label}: {what} took the wrong route ({n} launches)")

    # ---- the checks
    print(f"[main] {label} K16's q, k, v equal K15's column blocks bit for "
          f"bit, three contiguous tensors, at all {len(rows)} widths, both "
          f"add_bias: {split_ok}", flush=True)
    if not split_ok:
        fail(f"{label}: fused_ln_qkv departs from fused_ln_matmul")
    with torch.no_grad():
        want = msa(layer_norm_plain(xw, *msa_ln))
    rel, corr, ok = _agree(msa_out.float(), want.float())
    print(f"[main] {label} MultiScaleAttention(x, ln_w, ln_b) (K15) against "
          f"the call on LN(x), {tuple(xw.shape)} bf16: max_rel_err {rel:.4g} "
          f"(tol {BF16_REL_TOL}) corr {corr:.6f}", flush=True)
    if not ok or rel > BF16_REL_TOL:
        fail(f"{label}: the fused-LN MultiScaleAttention departs")
    worst = 0.0
    for what, w1, b1, w2, b2, kw, residual, x, gy, y, dx in mlps:
        with dispatch.force_plain():
            x0 = x.detach().requires_grad_(True)
            y0 = fused_mlp(x0, w1, b1, w2, b2, residual=residual, **kw)
            (dx0,) = torch.autograd.grad(y0, x0, gy)
        for got, ref, name in ((y, y0, "out"), (dx, dx0, "dx")):
            rel = ((got.float() - ref.float()).abs().max()
                   / ref.float().abs().max()).item()
            worst = max(worst, rel)
            print(f"[main] {label} {what} {tuple(x.shape)} {name} kernels vs "
                  f"plain: max_rel_err {rel:.4g} (tol {BF16_REL_TOL})",
                  flush=True)
            if not rel <= BF16_REL_TOL:
                fail(f"{label}: {what} {name} departs from the plain version")
    for hh, win, c, nh, mask, lm, weights, x, gy, y, dx in blocks:
        with dispatch.force_plain():
            x0 = x.detach().requires_grad_(True)
            y0 = fused_window_block(x0, *weights, num_heads=nh,
                                    attn_mask=mask, pad_logmult=lm)
            (dx0,) = torch.autograd.grad(y0, x0, gy)
        with torch.no_grad():
            groups = valid_group_blocks(
                fused_window_block, x.detach().reshape(batch, hh, hh, c),
                *weights, num_heads=nh, window=win).reshape(y.shape)
        for got, ref, name in ((y, y0, "out vs plain"), (dx, dx0, "dx vs plain"),
                               (y, groups, "out vs the valid-group route")):
            rel = ((got.float() - ref.float()).abs().max()
                   / ref.float().abs().max()).item()
            worst = max(worst, rel)
            print(f"[main] {label} masked block {hh}x{hh} w{win} c{c} "
                  f"({batch}, {hh * hh}, {c}) {name}: max_rel_err {rel:.4g} "
                  f"(tol {BF16_REL_TOL})", flush=True)
            if not rel <= BF16_REL_TOL:
                fail(f"{label}: the masked block's {name} departs")
    del mlps, blocks
    torch.cuda.empty_cache()
    return variants


def bwdmodes_main_phase(path: str) -> dict:
    """K7's weight-gradient mode and K13 through the modules, as the JAX
    package reaches its kernels: (b) a trainable `Hiera(use_adapters=False)`
    in training, the gradient of a fixed scalar of its four outputs with
    respect to every parameter; (c) `SAM2UNet` in eval mode, the structure
    loss's gradient with respect to its trainable set through the frozen
    trunk. Each in bf16 and fp32, kernels against force_plain(), held as
    s960train holds a step (`_hold_step`); the bf16 kernel run's launches
    (counters set to 0 just before, read just after) against PATHS' tables,
    the fp32 run's of the new kernels too (at 4-byte items K12's gate
    refuses the 60x60 w14 blocks, so (c) runs K13a only). Returns the bf16
    runs' variants."""
    import torch

    from sam2unet_torch.configs import hiera_config
    from sam2unet_torch.models.hiera import Hiera
    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.train.loss import multi_head_loss
    from sam2unet_torch.train.optim import trainable_parameters

    spec = PATHS[path]
    label = spec["label"]
    seen = collections.Counter()

    def counted(run):
        dispatch.reset_launches()
        out = run()
        torch.cuda.synchronize()
        return out, dict(dispatch.launches), dict(dispatch.variants)

    def hold_counts(what, counts, table):
        print(f"[main] {label} {what}: launches {counts}", flush=True)
        for name in set(table) | set(counts):
            if counts.get(name, 0) != table.get(name, 0):
                fail(f"{label} {what}: {name} launched {counts.get(name, 0)} "
                     f"times, expected {table.get(name, 0)}")

    # ---- (b) the trainable trunk, one training step's gradients
    size, b = spec["trunk_size"], spec["trunk_batch"]
    torch.manual_seed(15)
    trunk32 = Hiera(hiera_config(spec["trunk_cfg"]), use_adapters=False)
    trunk32 = trunk32.to(DEV).train()
    g = torch.Generator(device=DEV)
    g.manual_seed(15)
    x = torch.randn(b, size, size, 3, device=DEV, generator=g)
    # the scalar: the four outputs' mean squared distances to fixed targets
    # (a loss of order 1, so that its relative gap reads the rounding)
    targets = [torch.randn(b, size // 4 >> i, size // 4 >> i,
                           trunk32.cfg.embed_dim << i, device=DEV,
                           generator=g) for i in range(4)]
    runs, t0 = {}, time.perf_counter()
    for bf16 in (True, False):
        trunk = (copy.deepcopy(trunk32).to(torch.bfloat16) if bf16
                 else trunk32)
        params = dict(trunk.named_parameters())
        xin = x.to(torch.bfloat16) if bf16 else x
        for plain in (False, True):
            def step():
                with dispatch.force_plain() if plain else contextlib.nullcontext():
                    outs = trunk(xin)
                    loss = sum(((o.float() - t) ** 2).mean()
                               for o, t in zip(outs, targets))
                    grads = torch.autograd.grad(loss, list(params.values()))
                return loss.item(), {n: gr.float() for n, gr in
                                     zip(params, grads)}
            if plain:
                runs[bf16, plain] = step()
                continue
            runs[bf16, plain], counts, variants = counted(step)
            if bf16:
                hold_counts(f"{spec['trunk_cfg']}@{size} trainable trunk, "
                            f"one bf16 step at batch {b}", counts,
                            spec["per_step"])
                seen.update(variants)
            else:
                wg = sum(n for (w, v), n in variants.items()
                         if w == "window_block_bwd" and v.endswith(",wgrad"))
                print(f"[main] {label} the same step in fp32: launches "
                      f"{counts}", flush=True)
                if wg != spec["per_step"]["window_block_bwd"]:
                    fail(f"{label}: the fp32 step launched K7's "
                         f"weight-gradient mode {wg} times")
        del trunk
    ok, _ = _hold_step(f"{label} {spec['trunk_cfg']}@{size} trainable trunk",
                       f"batch {b}, {len(runs[False, True][1])} parameters",
                       runs)
    print(f"[main] {label} (b) {time.perf_counter() - t0:.1f} s (host clock, "
          f"4 gradients)", flush=True)
    del trunk32, runs, x, targets
    torch.cuda.empty_cache()

    # ---- (c) SAM2UNet in eval mode: a gradient through the frozen trunk
    size, b = spec["model_size"], spec["model_batch"]
    x, y = _train_batch(b, size, seed=15)
    runs, t0 = {}, time.perf_counter()
    for bf16 in (True, False):
        model = _train_model(spec["model_cfg"], None, bf16).eval()
        params = dict(trainable_parameters(model))
        for plain in (False, True):
            def grad():
                with dispatch.force_plain() if plain else contextlib.nullcontext():
                    loss = multi_head_loss(model(x), y)
                    grads = torch.autograd.grad(loss, list(params.values()))
                return loss.item(), {n: gr.float() for n, gr in
                                     zip(params, grads)}
            if plain:
                runs[bf16, plain] = grad()
                continue
            runs[bf16, plain], counts, variants = counted(grad)
            if bf16:
                hold_counts(f"{spec['model_cfg']}@{size} SAM2UNet eval-mode "
                            f"gradient, bf16 batch {b}", counts,
                            spec["per_backward"])
                seen.update(variants)
            else:
                k13 = {v: n for (w, v), n in variants.items()
                       if w == "window_block_strips_rem_bwd"}
                print(f"[main] {label} the same gradient in fp32: launches "
                      f"{counts}; K13 {k13}", flush=True)
                if k13 != {"window=7,K13a": 1}:
                    fail(f"{label}: the fp32 eval-mode gradient launched K13 "
                         f"{k13}, expected K13a once (block 15)")
        del model
        torch.cuda.empty_cache()
    good, _ = _hold_step(f"{label} {spec['model_cfg']}@{size} SAM2UNet "
                         "eval-mode gradient",
                         f"batch {b}, {len(runs[False, True][1])} trainable "
                         "leaves", runs)
    print(f"[main] {label} (c) {time.perf_counter() - t0:.1f} s (host clock, "
          f"4 gradients)", flush=True)
    if not (ok and good):
        fail(f"{label}: a model gradient's kernels disagree with the plain "
             "versions")
    del runs
    torch.cuda.empty_cache()
    return dict(seen)


def headdims_main_phase(path: str) -> dict:
    """The main path of headdims: one bf16 call of every shape of the
    kernel phase (`headdims_kernel_specs`, each built by `make_case` through
    the functions a user calls, the backwards under autograd or through
    their wrappers), the counters set to 0 just before the calls and read
    just after, held against the launches the shapes name (`expect`). The
    kernel phase holds each call against its plain version. Returns the
    run's variants."""
    import torch

    from sam2unet_torch.ops import dispatch

    label = PATHS[path]["label"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(16)
    calls, want = [], collections.Counter()
    for _name, kind, _r, _s, _sel, shapes, _t in kernel_specs(path, 1):
        for g in shapes:
            calls.append(shape_case(kind, g, torch.bfloat16, gen)[0])
            e = g["expect"]
            want.update({e: 1} if isinstance(e, tuple) else e)
    t0 = time.perf_counter()
    dispatch.reset_launches()
    for call in calls:
        call()
    torch.cuda.synchronize()
    got = dict(dispatch.variants)
    print(f"[main] {label}: {len(calls)} calls, launches "
          f"{ {f'{w}[{v}]': n for (w, v), n in sorted(got.items())} } "
          f"({time.perf_counter() - t0:.2f} s host clock)", flush=True)
    if got != dict(want):
        fail(f"{label}: the run launched {got}, its shapes name {dict(want)}")
    del calls
    torch.cuda.empty_cache()
    return got


def device_kernel_ms(call) -> dict[str, float]:
    """Device time (ms) by kernel name of one call (torch.profiler)."""
    from sam2unet_torch.utils import profile_model

    ms: dict[str, float] = collections.defaultdict(float)
    for e in profile_model.device_kernels(profile_events(call)):
        ms[e.name] += e.time_range.elapsed_us() / 1e3
    if not ms:
        fail("the profiler recorded no device kernel")
    return dict(ms)


def widths_profile_worker(spec: dict) -> dict:
    """The profiles of the widths path, in a process of its own (a profiler
    that no earlier path of the run has used; in the whole run's process a
    later profile recorded no device kernel): one ragged call of each
    family, each timed row (ragged and aligned), one hiera_l@352 forward at
    batch 1. Returns the lines to print and what failed."""
    import torch

    gen = torch.Generator(device=DEV)
    gen.manual_seed(17)
    lines, faults = [], []
    for name, kind, _r, _s, _sel, shapes, _t in kernel_specs("widths", 1):
        call = shape_case(kind, shapes[0], torch.bfloat16, gen)[0]
        call()
        ragged = sorted(n for n in device_kernel_ms(call) if "gany_" in n)
        lines.append(f"profile of {name} at {shapes[0]}: gemm_any kernels "
                     f"{[n[:60] for n in ragged]}")
        if not ragged:
            faults.append(f"{name} at {shapes[0]} launched no gemm_any kernel")
        # where the timed rows' time goes, ragged and aligned
        for g in shapes:
            if g.get("tokens", 0) > 1000 or g.get("batch", 0) >= 32 or (
                    g.get("windows", 0) >= 32):
                call = shape_case(kind, g, torch.bfloat16, gen)[0]
                call()
                ms = device_kernel_ms(call)
                top = sorted(ms.items(), key=lambda kv: -kv[1])[:4]
                lines.append(
                    f"device ms of {name} at "
                    f"{ {k: v for k, v in g.items() if k != 'expect'} }: total "
                    f"{sum(ms.values()):.4f}, gemm_any "
                    f"{sum(v for n, v in ms.items() if 'gany_' in n):.4f}; top "
                    f"{[(n[:40], round(v, 4)) for n, v in top]}")
    model, x = _model_and_input("l352", 1)
    with torch.inference_mode():
        model(x)
        names = device_kernel_ms(lambda: model(x))
    ragged = sorted(n for n in names if "gany_" in n)
    lines.append(f"profile of one hiera_l@352 forward (bf16, batch 1): "
                 f"{len(names)} device kernels, gemm_any kernels {ragged}")
    if ragged:
        faults.append(f"hiera_l@352's forward launched gemm_any kernels: {ragged}")
    return dict(lines=lines, faults=faults)


DP_WORKERS["widths_profile"] = widths_profile_worker
DP_WORKERS["k14_profile"] = k14_profile_worker


def widths_main_phase(path: str, tmp: Path) -> dict:
    """The main path of widths: one bf16 call of every shape of the kernel
    phase (`widths_kernel_specs`, each built by `make_case` through the
    functions a user calls, the backwards under autograd or through their
    wrappers), the counters set to 0 just before the calls and read just
    after, held against the launches the shapes name (`expect`). Then, in a
    process of its own (`widths_profile_worker`), torch.profiler over one
    ragged call of each family: each launches a kernel of csrc/gemm_any.cu
    (`gany_`); over each timed row, ragged and aligned (device ms by
    kernel: where a ragged row's time goes); and over one hiera_l@352
    forward (batch 1), which launches none. The kernel phase holds each
    call against its plain version. Returns the run's variants."""
    import torch

    from sam2unet_torch.ops import dispatch

    label = PATHS[path]["label"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(17)
    calls, want = [], collections.Counter()
    for _name, kind, _r, _s, _sel, shapes, _t in kernel_specs(path, 1):
        for g in shapes:
            calls.append(shape_case(kind, g, torch.bfloat16, gen)[0])
            e = g["expect"]
            want.update({e: 1} if isinstance(e, tuple) else e)
    t0 = time.perf_counter()
    dispatch.reset_launches()
    for call in calls:
        call()
    torch.cuda.synchronize()
    got = dict(dispatch.variants)
    print(f"[main] {label}: {len(calls)} calls, launches "
          f"{ {f'{w}[{v}]': n for (w, v), n in sorted(got.items())} } "
          f"({time.perf_counter() - t0:.2f} s host clock)", flush=True)
    if got != dict(want):
        fail(f"{label}: the run launched {got}, its shapes name {dict(want)}")
    del calls
    torch.cuda.empty_cache()
    (result,), wall = _torchrun(1, "widths_profile", {}, tmp, timeout=300)
    for line in result["lines"]:
        print(f"[main] {label} {line}", flush=True)
    print(f"[main] {label} profiles: {wall:.1f} s in a process of their own",
          flush=True)
    if result["faults"]:
        fail("; ".join(result["faults"]))
    return got


def sm90_build(out_dir: Path) -> None:
    """The Hopper kernels' registers and spills (`-Xptxas -v`) and dynamic
    shared memory: K11's dq and dk/dv passes, K10 / K14's forward and K1 /
    K2's GEMM and adapter (csrc/mlp_sm90.cu); a spill, ptxas serializing
    their wgmma (its "Potential Performance Loss" notes), or ptxas injecting
    a warpgroup.arrive (C7519) into csrc/mlp_sm90.cu's kernels, fails the
    run (csrc/block_bwd_sm90.cu's too: `block_bwd_sm90_build`)."""
    from sam2unet_torch.ops import build

    summary = build.ptxas_summary(out_dir)
    for src in ("flash_attention_bwd_sm90", "flash_attention_fwd_sm90", "mlp_sm90",
                "block_bwd_sm90"):
        serialized = [ln.strip() for ln in
                      (out_dir / f"{src}.log").read_text().splitlines()
                      if "Performance Loss" in ln]
        if serialized:
            fail(f"ptxas serializes the wgmma of {src}.cu: {serialized}")
        spilled = [ln for ln in summary if ln.startswith(f"{src}:")
                   and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        if spilled:
            fail(f"the Hopper kernels of {src}.cu spill: {spilled}")
    # a query, not an entry point that launches: read from the library itself
    lib = ctypes.CDLL(str(out_dir / "libflash_attention_bwd_sm90.so"))
    smem = lib.k11_flash_attention_bwd_sm90_smem
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    lines = [ln for ln in summary if ln.startswith("flash_attention_bwd_sm90:")]
    for d in (64, 96, 128, 256):
        kernels = [ln.split(": ", 2)[2] for ln in lines
                   if f"_sm90_kernelILi{d}E" in ln]
        print(f"[ptxas] K11 Hopper instance d {d}: {smem(d)} bytes of dynamic "
              f"shared memory a block (both passes); {kernels}", flush=True)
        if len(kernels) != 2:
            fail(f"the build reports {len(kernels)} K11 Hopper kernels at d {d}")
    lib = ctypes.CDLL(str(out_dir / "libflash_attention_fwd_sm90.so"))
    smem = lib.flash_attention_fwd_sm90_smem
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    lines = [ln for ln in summary if ln.startswith("flash_attention_fwd_sm90:")]
    for d in (64, 96, 128, 256):
        # K10 and K14 in the layouts of the head dim: rows and pairs, or
        # at 256 cols (csrc/flash_attention_fwd_sm90.cu)
        kernels = [ln.split(": ", 2)[2] for ln in lines
                   if f"fwd_sm90_kernelILi{d}E" in ln]
        sizes = (f"cols {smem(d, 1000)}" if d == 256 else
                 f"rows {smem(d, 1000)}, pairs {smem(d, 64)}")
        print(f"[ptxas] K10 / K14 Hopper instance d {d}: dynamic shared "
              f"memory a block (bytes) {sizes}; {kernels}", flush=True)
        if len(kernels) != (2 if d == 256 else 4):
            fail(f"the build reports {len(kernels)} K10 / K14 Hopper kernels "
                 f"at d {d}")
    # K1 and K2: the GEMM's instances by column tile and kind, the adapter's
    kinds = ("GELU (K1's first product)", "out (K1's second)",
             "dual (K2's dh)", "dz (K2's dh W1)")
    gemm, adapter = [], []
    for ln in summary:
        hit = re.search(r"mlp_gemm_sm90_kernelILi(\d+)ELi(\d)E.*?: (.*)", ln)
        if ln.startswith("mlp_sm90:") and hit:
            gemm.append(f"BN {hit[1]} {kinds[int(hit[2])]}: {hit[3]}")
        hit = re.search(r"mlp_adapter_sm90_kernelILb(\d)E.*?: (.*)", ln)
        if ln.startswith("mlp_sm90:") and hit:
            adapter.append(f"W2 {'whole' if hit[1] == '1' else 'streamed'}: {hit[2]}")
    for ln in gemm + adapter:
        print(f"[ptxas] K1 / K2 Hopper instance (csrc/mlp_sm90.cu) {ln}", flush=True)
    if len(gemm) != 10 or len(adapter) != 2:
        fail(f"the build reports {len(gemm)} K1 / K2 GEMM and {len(adapter)} "
             f"adapter instances of csrc/mlp_sm90.cu (10 and 2)")
    # where ptxas injects a warpgroup.arrive (C7519: registers a wgmma
    # reads may be written before it issues) the warpgroup waits there; the
    # adapter kernel carried two an instance, at the wgmma of its first
    # product's runtime-count k-loop and the commit after it, until that
    # loop fenced each k-step (PERF.md §6): none may come back
    injected = [ln.strip() for ln in
                (out_dir / "mlp_sm90.log").read_text().splitlines() if "C7519" in ln]
    if injected:
        fail(f"ptxas injected warpgroup.arrive (C7519) into csrc/mlp_sm90.cu: "
             f"{injected}")


def block_bwd_sm90_build(out_dir: Path) -> None:
    """K3's, K5's, K7's and K9's Hopper kernels (csrc/block_bwd_sm90.cu):
    registers, spills and shared memory a block (K3's plan at each main-path
    width, K7's query-side and dk/dv blocks at each head-dim instance, K5's
    and K9's small-window pass at each window, mode and head-dim instance); a
    spill, a serialization note (checked with the other Hopper sources) or
    any warpgroup.arrive ptxas injects (C7519) fails the run."""
    from sam2unet_torch.ops import build

    build.library("block_bwd_sm90")   # its undefined LN symbols: gemm_any first
    summary = [ln for ln in build.ptxas_summary(out_dir)
               if ln.startswith("block_bwd_sm90:")]
    lib = ctypes.CDLL(str(out_dir / "libblock_bwd_sm90.so"))
    plan = (ctypes.c_int * 3)()
    for c in (96, 144, 192, 288, 384, 576, 768, 1152):
        lib.k3_adapter_bwd_sm90_plan(c, plan)
        print(f"[ptxas] K3 Hopper plan (csrc/block_bwd_sm90.cu) C {c}: {plan[0]} bytes "
              f"of dynamic shared memory a block, a ring of {plan[1]} 64 x 64 slots, "
              f"the weight-gradient partials in "
              f"{'shared' if plan[2] else 'device'} memory", flush=True)
        if not plan[0]:
            fail(f"K3's Hopper kernel takes no plan at C {c}")
    smem = lib.k7_window_block_bwd_sm90_smem
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    sw = lib.k5_k9_window_attn_smem
    sw.argtypes, sw.restype = [ctypes.c_int] * 3, ctypes.c_int
    wanted = {"k3_adapter_bwd_sm90_kernel": 2, "k3_reduce_kernel": 1,
              "k7_qside_sm90_kernel": 3, "k11_dkv_sm90_kernel": 3,
              "mlp_gemm_sm90_kernel": 5, "k5_k9_window_attn_bwd_kernel": 12}
    for name, n in wanted.items():
        lines = [ln.split(": ", 2)[1:] for ln in summary if name in ln]
        for fn, regs in lines:
            hit = re.search(r"ILi(\d+)E", fn) if "k7" in name or "k11" in name else None
            extra = (f" ({smem(int(hit[1]), 'k11' in name)} bytes of dynamic shared "
                     f"memory)" if hit else "")
            sw_hit = re.search(r"ILi(\d)ELb(\d)ELi(\d+)E", fn) if "k5_k9" in name else None
            if sw_hit:   # <window, q-pool, padded head dim>
                extra = (f" (window {sw_hit[1]}, {'K9' if sw_hit[2] == '1' else 'K5'}, "
                         f"head dims up to {sw_hit[3]}: "
                         f"{sw(int(sw_hit[1]), int(sw_hit[2]), int(sw_hit[3]))} bytes of "
                         f"dynamic shared memory)")
            print(f"[ptxas] K3 / K5 / K7 / K9 Hopper kernel {name} "
                  f"{fn[fn.find(name) + len(name):][:24]}: {regs}{extra}", flush=True)
        if len(lines) != n:
            fail(f"the build reports {len(lines)} instances of {name} in "
                 f"csrc/block_bwd_sm90.cu ({n})")
    injected = [ln.strip() for ln in
                (out_dir / "block_bwd_sm90.log").read_text().splitlines() if "C7519" in ln]
    if injected:
        fail(f"ptxas injected warpgroup.arrive (C7519) into csrc/block_bwd_sm90.cu: "
             f"{injected}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="build,kernels,main,throughput")
    ap.add_argument("--paths",
                    default="l352,s960,l352train,s960train,s1024sam2,"
                            "s1024video,t512video,t1024amg,s960cli,s960deploy,"
                            "s960interop,s960dp,s352mc,opsapi,bwdmodes,"
                            "headdims,widths")
    ap.add_argument("--batch", type=int, default=32,
                    help="kernel, throughput and profile batch at hiera_l@352")
    ap.add_argument("--batch960", type=int, default=16,
                    help="the same at hiera_s@960")
    ap.add_argument("--batch_train", type=int, default=16,
                    help="the same for the hiera_l@352 training path")
    ap.add_argument("--batch_train960", type=int, default=16,
                    help="the same for the hiera_s@960 training path (the "
                         "train CLI's default batch)")
    ap.add_argument("--step_seeds", default="2",
                    help="batches (by seed) of the one-step kernels-vs-plain "
                         "comparison")
    ap.add_argument("--step_report", default="",
                    help="JSON file for that comparison's per-leaf gaps")
    ap.add_argument("--dp_worker", choices=sorted(DP_WORKERS),
                    help="(internal) run one rank of s960dp or s352mc, or "
                         "widths' profiles")
    ap.add_argument("--dp_spec", default="", help="(internal) its inputs")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    paths = args.paths.split(",")
    if not set(paths) <= set(PATHS):
        print(f"chip_smoke: unknown path in {paths} (have {sorted(PATHS)})")
        sys.exit(2)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", flush=True)
        sys.exit(2)
    if not (REPO / "sam2unet_torch" / "ops" / "build.py").is_file():
        print("chip_smoke: the sam2unet_torch package is not beside this "
              "script", flush=True)
        sys.exit(2)
    sys.path.insert(0, str(REPO))
    from sam2unet_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.dp_worker:
        dp_worker_main(args.dp_worker, args.dp_spec)
        return
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    out_dir = build.build_all()
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s into "
          f"{out_dir.relative_to(REPO)}; nvcc seconds by source "
          f"{ {k: round(v, 1) for k, v in build.build_seconds.items()} }",
          flush=True)
    for line in build.ptxas_summary(out_dir):
        print(f"[ptxas] {line}", flush=True)
    sm90_build(out_dir)
    block_bwd_sm90_build(out_dir)

    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    entries, variants, rates = [], {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for path in paths:
            t_path = time.perf_counter()
            try:
                batch = PATHS[path].get("batch") or getattr(args, BATCH_FLAG[path])
                if "kernels" in phases:
                    entries += kernel_phase(path, batch, gen)
                    if PATHS[path].get("profile_k14"):
                        k14_profile_phase(path, Path(tmp))
                if "main" in phases:
                    if PATHS[path].get("video"):
                        variants[path] = video_main_phase(path)
                    elif PATHS[path].get("amg"):
                        variants[path] = amg_main_phase(path)
                    elif PATHS[path].get("sam2"):
                        variants[path] = sam2_main_phase(path)
                    elif PATHS[path].get("cli"):
                        variants[path] = cli_main_phase(path, Path(tmp), card)
                    elif PATHS[path].get("deploy"):
                        variants[path] = deploy_main_phase(path, Path(tmp), card)
                    elif PATHS[path].get("dp"):
                        variants[path] = dp_main_phase(path, Path(tmp), card)
                    elif PATHS[path].get("multichip"):
                        variants[path] = multichip_main_phase(path, Path(tmp), card)
                    elif PATHS[path].get("opsapi"):
                        variants[path] = opsapi_main_phase(path, batch)
                    elif PATHS[path].get("bwdmodes"):
                        variants[path] = bwdmodes_main_phase(path)
                    elif PATHS[path].get("headdims"):
                        variants[path] = headdims_main_phase(path)
                    elif PATHS[path].get("widths"):
                        variants[path] = widths_main_phase(path, Path(tmp))
                    elif PATHS[path].get("interop"):
                        variants[path] = interop_main_phase(path, Path(tmp), card,
                                                            rates)
                    elif PATHS[path].get("train"):
                        variants[path] = train_main_phase(
                            path, Path(tmp), [int(s) for s in args.step_seeds.split(",")],
                            args.step_report)
                    else:
                        variants[path] = main_path_phase(path, Path(tmp))
                if "mlp_ab" in phases:
                    mlp_route_ab_phase(path, batch, card)
                if ("held_by" in PATHS[path] or PATHS[path].get("deploy")
                        or PATHS[path].get("multichip")
                        or PATHS[path].get("opsapi")
                        or PATHS[path].get("bwdmodes")
                        or PATHS[path].get("headdims")
                        or PATHS[path].get("widths")):
                    continue   # their times and A/Bs are the main phase's
                if "throughput" in phases and PATHS[path].get("video"):
                    video_throughput_phase(path, card)
                elif "throughput" in phases and PATHS[path].get("amg"):
                    amg_throughput_phase(path, card)
                elif "throughput" in phases and PATHS[path].get("sam2"):
                    sam2_throughput_phase(path, card)
                elif "throughput" in phases:
                    rates[path] = throughput_phase(path, batch, card)
                    if PATHS[path].get("remat"):
                        throughput_phase(path, batch, card, remat=True)
                    if PATHS[path].get("grouping_ab"):
                        grouping_ab_phase(path, batch, card)
                if "profile" in phases:
                    profile_phase(path, batch, card)
                    if PATHS[path].get("sam2"):
                        profile_phase(path, batch, card, predict=True)
            finally:
                print(f"[path] {PATHS[path]['label']}: {time.perf_counter() - t_path:.1f} s "
                      f"(host clock, every phase of the path)", flush=True)

    # a wrapper that a path's entries hold against the plain version is held
    # at every shape (variant) that path's run gave it
    for path, seen in variants.items():
        holders = PATHS[path].get("held_by", (path,))
        selects = [e["select"] for e in entries if e["path"] in holders]
        held = {w for w, v in seen if any(sel(w, v) for sel in selects)}
        loose = sorted(f"{w}[{v}]" for w, v in seen
                       if w in held and not any(sel(w, v) for sel in selects))
        if loose:
            fail(f"{PATHS[path]['label']}: launched on the main path at shapes "
                 f"no kernel check holds against the plain version: {loose}")
    for e in entries:
        select, path = e.pop("select"), e.pop("path")
        e["launches"] = sum(n for (w, v), n in variants.get(path, {}).items()
                            if select(w, v))
        if path in variants and not e["launches"]:
            fail(f"{e['name']} was not launched on its main path")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
