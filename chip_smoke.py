#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (retinex_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; no phase is skipped):

1. The card's name and power limit; build the CUDA kernels from every
   ``retinex_tpu_torch/csrc/*.cu`` (one nvcc per source, all at once,
   printing the seconds and the ptxas report: registers, stack and spills,
   and for ``conv_wgmma``, ``conv_pipelined``, ``conv_narrow``,
   ``fam_fused`` and ``fam_tail_wgmma`` each entry function); the instructions a pixel issues in
   each instance of K1 and K3 (``sass_instructions_per_px``) and in the
   pixel loops of K7 and K9 (the instances phase 3 times,
   ``sass_loop_instructions_per_px``), read from the libraries' SASS, which
   their bounds use (K3's tile-coordinate mode too); K1's instances are
   counted, beside the libraries' build, once more from a build without
   their near-tie test (``start_count_build``), which is the count their
   bounds take: the operations the function needs, not the exact
   rounding's overhead; K16's two kernels take the counts of the K1 and K3
   instances that compute their functions (``K16_FUNCTION``).
2. K1-K3: on a seeded u8 frame at 1088x1920 (the main path's shape) and at
   2160x3840 (a cell width of 240 columns), and on the directory's batches
   [8,3,1088,1920], [4,3,1088,1920] and [4,3,640,640], each kernel is held to
   its plain PyTorch version on the card: K1 and K3 in their u8 planar
   instances (lab_fwd_u8, clahe_apply_u8) and their float instances
   (lab_fwd_f32_nhwc on a seeded float frame past [0, 1] with exact .5
   ties, stored channels first as the nets' outputs are, and NHWC;
   clahe_apply_f32_nhwc, whose values must be clahe_apply_u8's / 255)
   within 1 level on under 1e-4 of the bytes, K2 (clahe_tables) identical;
   on a batch, the first and last image equal the kernels run on that image
   alone; at 1088x1920 K2 also at 4x4 and 16x16 tiles (``--clahe_tiles``),
   identical. Then both instances of K1 over every sRGB triple and of K3
   over every (L, a, b) triple (``cube_phase``: a [1,3,4096,4096] cube,
   identity LUTs for K3), held the same way, the count of differing bytes
   printed. Median kernel times over 25 launches (CUDA events) at both
   single-frame shapes, K2's at each tile count; K3's launch plan against
   its neighbours at 1088x1920 (``k3_plan_sweep``, same bytes in all).
   G1: K2 in its tile-row mode identical to its plain version and K3 in its
   tile-coordinate mode within K3's tolerance of its plain version, on
   seeded frames that are not cell-divisible (``TILE_SHAPES``: 1080x1920,
   timed beside its bounds, 264x480, 1001x1503 and a batch [2,57,41]), and
   the three with K1's float instance (``clahe_lab_rgb_tiles``) identical
   to the CPU's ``clahe_lab_rgb`` on a seeded float frame with .5 ties;
   F4's record (``f4_record``: the plain ``lab_u8_to_rgb`` rounded to bytes,
   card against CPU, over every (L, a, b) triple, printed); the route gate
   (``route_gate``: the card's ``clahe_lab_rgb`` against the CPU's on the
   photo at 1080x1920, 264x480 and 1001x1503 and on a uniform frame with .5
   ties, identical). The main path's Lab-CLAHE stage at 1088x1920 and at
   1080x1920 by operation (``clahe_stage_profile``, torch.profiler): it
   must run K2's scratch fill, K1, K2 and K3 (at 1080 rows K2 and K3 in
   their tile modes) once each and nothing else.
3. K7-K9 and K2 on a luma plane: on seeded u8 batches [8,1088,1920] (a
   directory chunk), [1,2160,3840] and a ragged [3,272,496], both K8 kernels
   (lab_fwd_u8_nhwc, clahe_apply_u8_nhwc) are held to their plain versions
   with K1/K3's tolerance, K7 (clahe_luma_apply_u8, on planar and on NHWC
   RGB) and K9 (clahe_luma_apply_u8_fused) bit-identical to theirs, K7 on
   NHWC equals K7 on planar, K2 on the luma plane is identical to its plain
   version (hist_subsample 1 and 2), and K9 equals K7; on a batch, the
   first and last image equal the kernels run on that image alone. Median
   times over 25 launches (K7 on NHWC, as both clahe_luma routes run it)
   beside the bounds (K7's and K9's by bytes or by their SASS instruction
   counts, whichever is larger), and K2's on the luma plane.
4. K4-K6 and K11: at the packed FAM shapes of the letterboxed frame,
   [1,544,960,128] (scale 1) and [1,136,240,128] (scale 2), at those of the
   unpadded 1080-row frame, [1,540,960,128] and [1,135,240,128], at a
   ragged [2,37,53,128], and at the directory's: [8|4,544,960,128],
   [8|4,136,240,128], [4,320,320,128] and [4,80,80,128]. Seeded inputs x >= 0
   and weights scaled as tests/test_fused_blocks.py scales them:
   fam_conv_fused (K4) and each of its three kernels (fam_conv_y and
   fam_conv_z on conv_pipelined, then fam_conv_out; each stage on the plain
   previous stage's output) within 2e-4, fam_tail_stats within 1e-5,
   fam_tail_apply_g1 within 1e-4 in both its instances (a quadrant-diagonal
   w, pack_pointwise of a seeded [1,1,32,32] as the model's folds are, and
   a dense random w), the quadrant-diagonal instance bit-identical to the
   dense one on the same w, fam_tail_apply within 1e-5 of the plain
   version (TF32 off); on a batch, the first and last image equal the
   kernel run on that image alone. Median times over 25 launches, beside
   the plain version's and the bound: K4 (whole and by stage), K5 and both
   K6 instances at the letterboxed shapes, per launch and summed per image
   (K4 against its 10.312 ms bound, K6 on the quadrant-diagonal w against
   its 0.1723 ms byte bound, on the dense w against its 0.2735 ms
   operations bound; each beside torch.einsum of K6's whole function on
   its w, the library time, and torch.matmul of the pre-scaled x by the
   dense w, cuBLAS on the product alone, as a yardstick), K11 (which only the unpadded frame runs) at the
   unpadded ones; one K4 call's launches by kernel.
5. The standard route through the CLI, ``--mode enhance --max_size 1920
   --no-packed_inference``, on a 1920x1080 PNG upscaled from
   ``data/convergence/lowlight_000.png``, untrained weights from seed 0: the
   three PNGs, K1 and K3 (float instances) and K2 launched once each, the enhanced image held to the
   port's CPU run stage by stage (``hold_to_cpu``): the net's outputs on the
   card within 1e-5 of the CPU's, Lab-CLAHE + quantisation of the card's net
   output on the card identical to the CPU's on it, and the PNG within a
   mean of 0.05 levels of the CPU run end to end.
6. The default route through the CLI (packed forward), same photo: the
   three PNGs, K1-K3 launched once (K1 and K3 in their float instances) and K4-K6 twice each, K6 in its
   quadrant-diagonal instance. The packed forward
   is held to the standard forward on the card (same weights and input:
   illumination 2e-5, reflectance and enhanced 2e-3, as
   tests/test_packed_inference.py), and the packed route on the card to the
   port's CPU packed route at ``--max_size 512`` (as in phase 5).
7. The headline command with no flags, ``--mode enhance --input_path
   photo``, on the same photo: no letterbox, so the frame stays 1080x1920,
   whose fusion does not fold (1080 is not a multiple of 16). The three
   PNGs; K4, K5 and K11 launched twice each, K6 never, K1 (float instance)
   and K2 and K3 in their tile modes once each (1080 is not a multiple of
   16 either, so Lab-CLAHE runs ``clahe_u8``'s semantics, as the JAX
   package's does at such shapes: G1). The packed forward is held to the
   standard one on the card at 1080x1920; Lab-CLAHE and quantisation of
   the card's net output at 1080x1920 on the card identical to the CPU's on
   it (``hold_stage_to_cpu``); and the card's flagless run to the port's
   CPU run on a 264x480 frame (also unfolded).
8. Directory enhance through the CLI, ``--max_size 1920 --batch_size 8``,
   on 12 photos at 1920x1080 (upscaled from ``lowlight_000..011``) and 4
   640x640 originals (``lowlight_012..015``): three chunks, 8 and 4 at
   1088x1920 and 4 at 640x640. Three modes, each with the counts at 0 just
   before: the net (K4-K6 6 launches each, K1-K3 3 each, K1 and K3 in their
   float instances), ``--classical_mode clahe`` (K8's two kernels and K2 3
   each, K1/K3 none) and ``--classical_mode clahe_luma`` (K2 and K7 3
   each); then the public fused luma entry
   (``clahe_luma_rgb_u8_planar(fuse_luma=True)``) on the same chunks (K2
   and K9 3 each), whose bytes equal the ``clahe_luma`` PNGs, and the public
   planar u8 Lab-CLAHE entry (``clahe_rgb_u8_planar_gather``) on them (K1,
   K2 and K3 in their u8 instances 3 each), whose bytes equal the ``clahe``
   PNGs.
   Each mode's 48 PNGs; the CLAHE modes' enhanced PNGs byte-identical to
   single-image runs on the card. The net's are read against single-image
   runs and held stage by stage on each chunk: the packed forward on the
   batch within PACKED_TOL of it on each image alone and of the standard
   forward on the same batch, and Lab-CLAHE + quantisation of the batch's
   net output identical to that stage on each image alone (see
   ``net_batch_holds``). Warm images/s over the directory with PNG writes
   and without (``save_outputs=False``), the packed and the standard net's
   ms per image at batch 8 (in turns), and the peak device memory of the
   net's directory run.
9. Single images through the CLI on the card, each with the counts at 0
   just before and checked just after: ``--classical_mode ssr``, ``msr``,
   ``msrcr`` (no kernel), ``--content_aware`` and ``--multi_scale`` (K4-K6
   twice each, K1-K3 never) at ``--max_size 512``, and ``--classical_mode
   clahe`` (K1-K3 once each, float instances) and ``clahe_luma`` (K2 and K7 once each) at
   ``--max_size 1920``. Each is held to the port's CPU run: ssr/msr/msrcr
   within 1e-4, ten times the CPU tests' 1e-5 (the card's cumulative sums,
   logs and exps round in other orders); clahe_luma byte-identical (K2 and
   K7 are exact); the enhancers and clahe at max 3 levels and a mean under
   0.05 levels. Each mode's warm
   device ms at 1088x1920.
10. Warm times, batch 1: the standard and the packed net, Lab-CLAHE, end to
   end per route at 1088x1920, the same for the flagless route at
   1080x1920, and the FAM kernels' device ms per image; the Lab-CLAHE
   launches over the phase (float instances only).
11. Device time by kernel (torch.profiler) over warm forwards of each route
   at 1088x1920, batch 1, the port's own kernels among them (K6 must show
   in the packed forward), and the device's busy share of the forwards'
   wall time (phase 21 does the same for the bf16 packed forward).
12. K10 (dec1_chain, four conv_pipelined launches: dec1_up, the 1x1;
   dec1_c1; dec1_c2, whose epilogue adds x1p; dec1_rc) against its plain
   version (the cuDNN chain), TF32 off, its weights packed once
   (pack_dec1_chain), on seeded inputs scaled as
   tests/test_fused_blocks.py:51-57 scales them, within its 1e-4: at
   [1,544,960] (the 1088x1920 frame's dec1), at [8,544,960] and [4,320,320]
   (the directory's chunks) and at a ragged [2,37,53]; one call launches
   each stage once; each stage within 1e-4 of its plain version on the
   plain previous stage's output; on a batch, the first and last image
   equal K10 on each alone. Median of 25 launches of K10 and of each stage
   at [1,544,960] beside the plain versions', the bounds and each stage's
   one F.conv2d (+ ReLU, + x1p for dec1_c2), held within 1e-4 of the
   stage's plain version.
13. The dec1-chain forward, ``PackedRetinex(model, NetCfg(dec1_chain=True))``,
   at 1088x1920 and at the unpadded 1080x1920, seed-0 weights: within 2e-4
   of the default packed forward and within PACKED_TOL of the standard one;
   K10 launched once per forward, each of its stages once (and never on any
   default route: every other phase's launch check expects 0). Warm net ms
   with and without it at 1088x1920, in turns, and their ratio.
14. ``--mode predict`` through the CLI with a ``.pth`` saved from the seed-0
   untrained net (``{"epoch": 0, "model_state_dict": ...}``): one photo at
   ``--max_size 1920`` (three PNGs, K4-K6 twice, K1-K3 never); the card's
   PNG held to the port's CPU run at ``--max_size 512`` (max 1 level, under
   1e-4 of the bytes off); the 16-image directory of phase 8 at
   ``--batch_size 8`` (48 PNGs, K4-K6 6 each), its PNGs against each image's
   own forward on the card (the bytes single-image predict writes; max 1
   level, as cuDNN picks algorithms by batch size); warm images/s with
   writes and the warm per-image latency; ``predict_single_image`` with the
   dec1-chain forward (K10 once, PNGs within 1 level of the default's).
15. ``--mode evaluate`` through the CLI over predict's directory, without
   references and with ``--test_dir`` naming phase 8's net outputs (the
   enhanced and illumination PNGs have same-named, same-sized references,
   the three-panel comparisons do not): one CSV row per image with the JAX
   package's columns, no kernel launched, images/s; ``evaluate_directory``
   on the card held to the same call with ``device="cpu"`` within rtol 1e-4
   on two photos' PNGs.
16. ``simple_enhance_main`` (pre-activation + ASPP net, untrained) on the
   photo at ``--max_size 1920``: three PNGs, K4-K6 twice and K1-K3 once (float instances);
   at ``--max_size 512`` held to the port's CPU run as in phase 5.

Phases 17-19 drive the standalone ops K12-K16, which no route of either
package reaches, through their public functions at the shapes where the JAX
package runs them (``scripts/perf_lab.py``), each phase with every count at
0 just before those calls and read just after; then each kernel against its
plain version there and at ragged shapes (TF32 off), and on a batch the
first and last image against the kernel on each alone (identical):

17. K13 ``conv2d_pallas`` and K15 ``conv2d_pallas_im2col`` (two wrappers
   of one function) at [2,544,960,128] 3x3 and 2x2, [2,272,480,256] 3x3 and
   a ragged [2,37,53,128] (3x2), and in bf16 at a ragged [2,37,53,20] whose
   Cin is no multiple of 8 (conv_direct's route); K14 ``conv2d_narrow`` at
   [2,1088,1920,32] for 32->32, 32->64, dilation 2 and 5x5 32->32, and at a ragged
   [2,37,53,24] (5x5 to 40, and 3x3 dilation 2 to 30) and [2,37,53,64]
   (5x5 dilation 2 to 128: in bf16 conv_wgmma's widest halo box, its
   weights in a ring of three B stages); each in f32 and
   bf16, inputs N(0,1) and kernels x 0.05 as the JAX tests scale them: f32
   within 1e-4, bf16 in f32 at rtol and atol 1e-2 (one output ulp). At
   perf_lab's shapes every bf16 call (K13, K15 and K14) must launch
   ``conv_wgmma``, every f32 K13/K15 call ``conv_pipelined`` and every f32
   K14 call ``conv_narrow`` (``conv_pallas.KERNEL_LAUNCHES``), whose
   instance (Cout tile, registers, spilled bytes, shared memory, stages,
   blocks per SM) is printed at each of its seven cases. Median ms
   over 25 launches of K13 and K15 at both 3x3 shapes and of K14 at its
   first, its dilation-2 and its 5x5 case, in f32 and bf16, beside the plain
   version's, the bound and ``F.conv2d`` on the channels-last view with the
   bias (then the ReLU where the case has one), which the port never calls;
   ``conv_wgmma``'s plan at each timed bf16 case (N, K chunk, dynamic
   shared memory, halo stages, resident or ringed weights).
18. K12 ``fam_dual_conv3`` (two launches: fam_dual_y, 128 -> 256 with
   ReLU, then fam_dual_out, the two half convolutions with groups = 2; f32
   on conv_pipelined, bf16 on conv_wgmma, asserted per call from
   ``fused_blocks.KERNEL_LAUNCHES``) at [2,544,960,128] (f32 and bf16),
   [1,544,960,128] and a ragged [2,37,53,128]: the whole and each stage
   (the second on the plain y) within f32 1e-4, bf16 as in phase 17;
   conv_wgmma's plan for each bf16 stage; K12 and each stage timed at
   [2,544,960,128] beside the plain versions', the bounds and each
   stage's one F.conv2d (+ ReLU; groups = 2 for fam_dual_out).
19. K16 ``clahe_lab_rgb_pallas`` at [1,1088,1920,3], [8,1088,1920,3]
   (perf_lab's, x ~ U(0, 0.6)), [1,2160,3840,3] and [2,96,128,3]: Lab
   within 1 level of the plain version on under 1e-4 of the bytes, the
   histograms those of the kernel's own L, the apply kernel and the whole
   op within 1 level of the plain version on under 1e-4 of the values (K1
   and K3's card tolerance), each plain version run on the card; the two
   kernels are held the same way to the plain versions run on the CPU on
   the same inputs, and the whole op's distance from the CPU's is printed
   beside that of the card's plain op (a Lab byte at a rounding tie of the
   CPU's pow, which no kernel here reproduces, moves the op there by
   several levels at a few pixels); the
   ValueError on [1,57,41,3]; both kernels timed at [1,1088,1920,3] and
   [8,1088,1920,3].
20. ``--mode train`` through the CLI at the JAX defaults on the 24 in-repo
   photos, which takes the packed step (``models/packed_train.py``; the
   log says so), a ``--resume``, and ``--no-packed_train`` (the standard
   step) resumed from the packed checkpoint; one step of each kind on the
   card against the CPU's; one packed step against one standard step on the
   card at [8,640,640,3] (losses rtol 1e-4 / atol 1e-5, parameters atol
   5e-4); warm packed and standard steps in turns (ms, images/s, peak
   memory, spread), each step by stage and its top device operations; and
   predict and enhance from the packed run's checkpoint held to the CPU's
   runs (``train_phase``); then bf16 training and ``--remat``: a bf16 step
   of each kind on the card against the port's bf16 CPU step
   (``amp_train_step_vs_cpu``), warm bf16 steps of both in turns
   (``amp_timing``), an f32 ``--remat`` step of each kind against the
   plain one (losses, BatchNorm statistics) with both steps' peak memory,
   the remat one lower, and warm remat steps of both in turns
   (``remat_phase``), and ``--mode train --use_amp --remat`` through the
   CLI (packed) for two steps with ``--mode predict --use_amp`` from its
   checkpoint (``amp_remat_cli``). No train step launches a kernel (K4-K6
   have no backward; the packed FAM is plain PyTorch).
21. bf16 inference (``amp_phase``): the bf16 instances of K4 (whole and by
   stage; z f32; ``fam_conv_out`` on the tensor cores), K5, K6 (both w
   layouts, both on the tensor cores: the quadrant-diagonal one on
   mma.sync, the dense one on wgmma, ``csrc/fam_tail_wgmma.cu``) and K11
   against their bf16 plain versions at the frame's FAM shapes, a ragged
   one and a directory chunk (one bf16 ulp, two for K4 whole,
   ``AMP_ULPS``), each image of a batch equal to the kernel on it alone,
   timed against bounds at 989 TFLOP/s with their share of the bound; K6's
   bf16 library time, torch.einsum of its function in bf16 on both w
   (``k6_library_phase``); K6's dense instance at Cout 4 and 36 and,
   unpacked on the quadrant-diagonal w, against the quadrant-diagonal
   instance, each within one bf16 ulp, an unpacked call timed beside a
   packed one, and driven as a caller drives the op, its launches counted
   from zero (``amp_dense_phase``); ``--use_amp`` enhance at
   ``--max_size 1920`` and with no flags (K11) and predict from phase 20's
   checkpoint through the CLI, with their launch counts (``BF16_LAUNCHES``;
   the f32 FAM counts 0), the PNGs against f32 from the same checkpoint
   (printed); the bf16 net on
   the card against the port's bf16 CPU run at 288x512 and 264x480
   (``AMP_NET_TOL``; Lab-CLAHE of its output identical; end to end
   printed); the bf16 and f32 nets' ms at batch 1 and 8, packed and
   standard, and end to end per photo; the bf16 packed forward's device
   time by kernel at batch 1 (``profile_phase``, as phase 11) with the
   share of the two tensor-core FAM kernels; then K10 in bf16 (four
   ``conv_wgmma`` launches, ``dec1_c2`` through its residual epilogue) at
   phase 12's shapes, each stage within one output ulp of its plain
   version and the chain within one ulp at its largest output
   (``amp_dec1_kernel_phase``, timed beside ``F.conv2d`` in bf16), and the
   bf16 dec1-chain forward with the trained weights against the bf16
   default forward and the port's bf16 CPU run (``AMP_NET_TOL``), K10's
   bf16 launches counted, warm ms in turns (``amp_dec1_forward_phase``).
22. Serving (``serving_phase``): ``infer/serving.py``'s artifacts exported
   on the card (``torch.export``, symbolic batch): enhance and predict for
   the full-width standard net at 1088x1920 with phase 20's trained
   checkpoint, enhance at 1080x1920 (K2 and K3 in their tile modes), and
   ``clahe`` and ``clahe_luma`` (hist_subsample 2) at 1088x1920; each
   graph's ``retinex_tpu_torch::`` operators listed and checked; all five
   loaded and served in one fresh ``python3`` process that imports only
   ``retinex_tpu_torch.infer.serving`` and asserts that no model, CLI or
   JAX module is loaded (``SERVER``), at batches 1 and 4 of letterboxed
   ``data/convergence`` photos, each call's launches counted from zero
   (``SERVING_ARTIFACTS``: ``LAB_CLAHE_ONCE``, none, ``LAB_CLAHE_TILES_ONCE``,
   ``LAB_CLAHE_ONCE``, K2 + K7); every served byte identical to the eager
   ``make_batch_pipeline`` (the standard net; the quantised forward for
   predict) on the same card; then the warm served and eager ms per image
   at batches 1 and 4 in turns (printed, not gated).
   ``python3 chip_smoke.py --phase 22`` runs the build and this phase
   alone, with the seed-0 weights.
23. Data parallelism on the one card (``data_parallel_phase``; NCCL takes
   one rank per GPU, so two ranks share the card over gloo): (a) directory
   enhance (the default packed net with Lab-CLAHE, ``clahe``,
   ``clahe_luma``) and predict (phase 20's checkpoint) over phase 8's 16
   photos at ``--max_size 1920 --batch_size 8``, the full-width net, on one
   card and on a two-shard mesh that repeats ``cuda:0``
   (``parallel/mesh.py``, ``infer/batch_driver.shard_batch_fn``): each
   kernel's launches counted per shard (twice the one-card run's), the
   classical modes' PNGs byte-identical to the one-card run's, the net
   routes' differing bytes and their largest difference printed and held
   to ``SHARD_PNG_BOUND`` (cuDNN's choice of algorithm by batch size moves
   a float across a .5 tie, as in phase 8's batch against single images);
   (b) ``--n_devices`` one above the visible cards raises with its message;
   (c) the packed train step at the CLI defaults ([8,640,640,3], the
   perceptual loss on, cuDNN's deterministic algorithms) in a world of one
   NCCL rank equals the plain step in this process bit for bit (losses,
   parameters, BatchNorm statistics; the plain step run twice shows it is
   reproducible); (d) the same step in 2 ranks on ``cuda:0`` over gloo,
   one rank per half of the batch, held to the one-card step by
   tests/test_parallel.py's bounds (loss rel 1e-4, parameters at most 2.1
   lr apart, their 0.99 quantile under 1e-4); (e)
   ``graft_entry.dryrun_multichip(2)`` on the card; (f) warm step times of
   the plain step, (c) and (d) (medians of 5 after a warm-up, each from a
   barrier to its loss on the host): two ranks on one card measure the
   collectives, not a speed-up. ``python3 chip_smoke.py --phase 23`` runs
   the build and this phase alone, with the seed-0 weights.
24. Spatial sharding and the host path (``spatial_phase``), on meshes of
   2, 4 and 8 shards that repeat ``cuda:0``: (a) ``make_spatial_clahe``
   in both modes at 2176x3840 (the JAX test's letterboxed 4K frame) and
   1088x1920, byte-identical to the one-card route, each call's launches
   counted (K1, K2, K3 float or K2, K7 once a slab; the applies at row0 >
   0 in ``SLAB_LAUNCHES``, n - 1 a call), wall ms beside one card's; at
   4K every slab's K3 (float, u8 NHWC = K8's apply, u8 planar) and K7 at
   its row0 held to its plain version with that row0 and to the whole
   frame's rows, the last slab's K3 float and K7 timed against their
   bounds beside the whole frame's launch (``slab_applies``); (b)
   ``make_spatial_forward`` at full width, the CLI's net and
   pre-activation + ASPP, in f32 (within ``SPATIAL_F32_TOL`` of the
   one-card standard forward) at both shapes and bf16 (within
   ``AMP_NET_TOL``) at 1088x1920, each largest difference, wall ms against one card's and peak
   memory printed; (c) ``--mode enhance --spatial_shard`` on the 1080p
   photo with the net (the one-device message) and with ``--classical_mode
   clahe``, the bytes of the runs without the flag; (d) the host stages
   before (serial PIL decode, PIL's level-1 writes one after another) and
   after (``data/native_loader.py``: 8 decode threads, ``encode_png``, one
   photo's three PNGs on three threads) on the 1080p photo and the 24
   ``data/convergence`` photos, with the files' sizes against PIL's; every
   file of ``tests/fixtures/host_formats`` (PNG colour types and depths,
   JPEG kinds, BMP, TIFF, WebP, GIF) decoded by ``decode_letterbox_batch``
   at both sizes of its ``expected.json`` to the SHA-256 there, the JAX
   native loader's bytes and gray fills (``host_format_digests``); the
   stage where the letterbox resizes, before (PIL + ``letterbox_np``'s f64
   resize on 8 threads) and after (the native loader's f32 resize), on
   the 24 photos at ``--image_size`` 256 and the 1080p photo at
   ``--max_size`` 1024, medians of 5 warm runs, at most a level apart
   (``host_resize_stage``); ``--mode enhance`` on phase 8's 16-photo
   directory at ``--max_size 1024 --batch_size 8`` on the packed route
   (K4-K6 6 launches each, K1-K3 3 each), whose launches the kernels line
   counts (``host_directory_run``).
   Meshes of one card are not scaling figures. ``python3 chip_smoke.py
   --phase 24`` runs the build and this phase alone.
25. A checkpoint written by the JAX package (``orbax_phase``): the
   committed Orbax directory ``tests/fixtures/orbax_jax/latest``
   (``ORBAX_FIXTURE``: create_train_state at the CLI defaults saved by the
   JAX package's save_checkpoint, every params kernel sign x 1/sqrt(fan_in))
   read by ``train/orbax.py`` (its zstd decoder, ``csrc/zstd_decode.cpp``,
   built with c++ first, the seconds printed), the read's ms printed (the
   first, then the median of 5, and ``load_params_for_inference``'s), and
   every leaf held bit for bit to ``orbax_fixture_tree``, a numpy
   regeneration without JAX; then ``--mode enhance --checkpoint <it>
   --max_size 1920`` on the default packed route (K1-K3 once, K4-K6 twice,
   held to the port's CPU run from the same directory by ``hold_to_cpu``)
   and ``--mode predict`` (K4-K6 twice); ``--mode train --resume <it>``
   for one epoch of two steps (8 photos at 128 px, batch 4: epoch, step and
   Adam's count checked, the weights within 10 lr of the checkpoint's, no
   kernel launched); ``export_serving --checkpoint <it>`` at 288x512 and
   one served call identical to the eager pipeline (K1-K3 once).
   ``python3 chip_smoke.py --phase 25`` runs the build and this phase alone.
26. The trainer writes the JAX package's Orbax checkpoints
   (``orbax_write_phase``): ``--mode train`` on 8 photos at 128 px, batch
   4, for 2 epochs into a fresh ``save_dir``, each ``save_checkpoint``
   timed (host clock) and the state it wrote captured, the directory's
   bytes printed; ``read_orbax(<save_dir>/latest)`` held leaf by leaf, bit
   for bit, to the state the trainer held at that save; ``--resume`` from
   it for one epoch of 2 steps, the restored state bit for bit what was
   written (the dropout generator and the loader from the side file), the
   losses finite (training on the card is not deterministic, so the
   continuation is not held to an uninterrupted run); ``--mode enhance
   --max_size 1920`` on the default packed route (K1-K3 once, K4-K6 twice,
   held to the port's CPU run by ``hold_to_cpu``) and ``--mode predict``
   (K4-K6 twice) from ``<save_dir>/best``. No orbax or jax is on the
   card's machine. ``python3 chip_smoke.py --phase 26`` runs the build and
   this phase alone.

The last lines are a ``{"kernels": [...]}`` JSON line, the nvidia-smi line,
and ``{"ok": true, "device": {...}}``. ``launches`` sums each kernel's
launches over the runs of phases 6, 7 and 8, each counted from zero: the
default route's two 1080p CLI runs and the three directory runs, plus the
fused-luma run (the only path that reaches K9) and the planar u8 Lab-CLAHE
entry's run (the only one that reaches K1's and K3's u8 planar instances,
lab_fwd_u8 and clahe_apply_u8; the main path runs their float instances,
lab_fwd_f32_nhwc and clahe_apply_f32_nhwc); for K10, over its path's
runs in phases 13 and 14 (the dec1-chain forwards and predict with it);
for K12-K16, over the calls at perf_lab's shapes in phases 17-19. The
served calls of phase 22 add theirs to K1-K3's float instances and tile
modes, K2's and K7's (``clahe_luma_apply_u8``); phase 23's sharded
directory runs (each counted from zero) add theirs to K1-K6's (the net
routes) and to K2's, K7's and K8's (the classical modes); phase 24's
spatial CLAHE calls and ``--spatial_shard`` CLI runs add theirs to K1-K3's
and K7's (and the CLI net run's to K4-K6's), and its (d) directory run at
``--max_size 1024`` (the host path resizing) its K1-K6 launches; phase 25's enhance and predict
runs and its served call add theirs to K1-K6's, and phase 26's enhance and
predict runs theirs.
K4 has an entry as a whole (``fam_conv_fused``) and one for each of its
three kernels (``fam_conv_y``, ``fam_conv_z``, ``fam_conv_out``), K10 as a
whole (``dec1_chain``) and one for each of its four (``dec1_up``,
``dec1_c1``, ``dec1_c2``, ``dec1_rc``). K6's
entry is its main-path instance (the quadrant-diagonal w, bytes-bound);
the dense instance is printed in phase 4. K2 and K3 have an entry for
their tile modes too (``clahe_tables_tiles``, ``clahe_apply_tiles_f32_nhwc``:
the flagless route's, timed at 1080x1920).
``ms``, ``plain_ms`` and ``bound_ms`` are per image for K1-K6, K10 and K11
(K1's, K3's, K7's and K9's bounds by bytes or by their SASS
instructions over the issue rate, PEAK_ISSUE_PER_S, whichever is larger,
K1's without its near-tie test;
K16's by bytes or by its functions' K1 and K3 counts, ``K16_FUNCTION``)
(summed over the kernel's launches on one 1088x1920 or 1080x1920 image),
per launch on a [8,1088,1920] directory chunk for K7-K9, per launch at the
first shape for K12-K15, in both dtypes (the entry's ``dtype``): the bf16
entries (``fam_dual_conv3_bf16``, ``conv2d_pallas_bf16``,
``conv2d_pallas_im2col_bf16``, ``conv2d_narrow_bf16``) name the
tensor-core kernel and count its launches; per launch at [1,1088,1920,3]
for K16's two kernels.
K4, K5, K6 and K11 also have bf16 entries (``fam_conv_fused_bf16``,
``fam_tail_stats_bf16``, ``fam_tail_apply_g1_bf16``,
``fam_tail_apply_bf16``; ``dtype`` bfloat16), timed in phase 21 per image
like their f32 entries, their launches those of phase 21's CLI drives;
K6's dense bf16 instance has one too (``fam_tail_apply_g1_dense_bf16``, the
wgmma kernel, on the dense w), timed the same way, its launches those of
phase 21's op drive (no route launches it);
so do K10's (``dec1_chain_bf16`` and its four stages, per image at
1088x1920 like the f32 K10), their launches those of phase 21's two bf16
dec1-chain forwards.
``library_ms`` is ``F.conv2d``'s time (+ ReLU where the kernel applies
one) for K13-K15 and each of K10's four stages (``dec1_c2`` adds x1p),
``torch.einsum``'s of K6's whole function (``tail_g1_einsum``, on the main
path's w) for K6, in bf16 for its bf16 entries (on the dense w for the
dense one), ``F.conv2d`` in bf16 (+ ReLU, + x1p) for K10's bf16
stages, and null elsewhere: no one call computes K4, K10 or K12 whole.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
# H100 SXM: HBM bandwidth and the f32 rate outside the tensor cores (an
# FMA counted as two operations), and the issue rate of one instruction per
# lane and clock that goes with it.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_ISSUE_PER_S = PEAK_F32_OPS_PER_S / 2
# bf16 on the tensor cores, dense.
PEAK_BF16_OPS_PER_S = 989e12
# Instructions a pixel issues in each instance of K1 and K3 and in the
# instances of K7 and K9 that phase 3 times, by the name of its wrapper:
# read in phase 1 from the SASS of the built libraries
# (sass_instructions_per_px, sass_loop_instructions_per_px); their bounds
# are these over PEAK_ISSUE_PER_S, or the bytes over PEAK_BYTES_PER_S,
# whichever is larger. K16's two kernels are entered from K16_FUNCTION.
INSTR_PER_PX: dict[str, float] = {}
# K1's and K3's instances: (kernel, Layout number in csrc/clahe_lab.cu, K3's
# ApplyMode: 0 cells, 1 tile coordinates) by wrapper.
K1_K3_INSTANCES = {
    "lab_fwd_u8": ("lab_fwd", 0, 0), "lab_fwd_u8_nhwc": ("lab_fwd", 1, 0), "lab_fwd_f32_nhwc": ("lab_fwd", 2, 0),
    "clahe_apply_u8": ("clahe_apply", 0, 0), "clahe_apply_u8_nhwc": ("clahe_apply", 1, 0),
    "clahe_apply_f32_nhwc": ("clahe_apply", 3, 0), "clahe_apply_tiles_f32_nhwc": ("clahe_apply", 3, 1),
}
# K2: one atomic per sampled pixel and ~20 operations per table entry.
K2_OPS_PER_ENTRY = 20
# K5 per packed pixel: 128 multiplies by ca, 4 x 31 adds, 4 x 31 maxima,
# 4 mean scalings.
K5_OPS_PER_PX = 128 + 4 * 31 + 4 * 31 + 4
# The instances whose pixel loop the SASS count reads: (source stem, a
# pattern of the mangled kernel name, pixels a thread covers per global
# store in the loop). K7 on NHWC (as both clahe_luma routes run it, and
# phase 3 times it) and K9 in their 8-pixel instances: three 8-byte stores
# per 8 pixels.
LOOP_INSTANCES = {
    "clahe_luma_apply_u8": ("clahe_luma", r"clahe_luma_apply_kernelILb0ELb1ELi8E", 8 / 3),
    "clahe_luma_apply_u8_fused": ("clahe_luma", r"clahe_luma_apply_kernelILb1ELb0ELi8E", 8 / 3),
}
# K16's kernels compute K1's function on f32 NHWC input (plus one shared
# atomic a pixel for the histogram, counted as K2's) and K3's blend and
# Lab -> sRGB to f32 NHWC: (the K1 or K3 instance, operations added a
# pixel). Their bounds take those counts, the operations the functions
# need. K16's own SASS is no such count: its pixel loops hold six and three
# powf, whose special-case paths a pixel does not run but a static count
# reads.
K16_FUNCTION = {"clahe_pallas_hist": ("lab_fwd_f32_nhwc", 1), "clahe_pallas_apply": ("clahe_apply_f32_nhwc", 0)}
LUMA_SHAPES = ((8, 1088, 1920), (1, 2160, 3840), (3, 272, 496))
# K1-K3's batches in the directory's net mode: the 1088x1920 chunks of 8 and
# 4, and the 640x640 chunk of 4.
CLAHE_DIR_SHAPES = ((8, 1088, 1920), (4, 1088, 1920), (4, 640, 640))
# One Lab-CLAHE call of a net or single-image clahe route: K1 and K3 in
# their float instances, K2.
LAB_CLAHE_ONCE = {"lab_fwd_f32_nhwc": 1, "clahe_tables": 1, "clahe_apply_f32_nhwc": 1}
# The same on a frame that is not cell-divisible (the flagless route's
# 1080x1920): K2 and K3 in their tile modes.
LAB_CLAHE_TILES_ONCE = {"lab_fwd_f32_nhwc": 1, "clahe_tables_tiles": 1, "clahe_apply_tiles_f32_nhwc": 1}
# K2's and K3's tile modes against their plain versions: the flagless
# frame (timed), the small flagless frame, a frame padded on both sides and
# a ragged batch.
TILE_SHAPES = ((1, 1080, 1920), (1, 264, 480), (1, 1001, 1503), (2, 57, 41))
REPLACES = {
    "lab_fwd_u8": "retinex_tpu/ops/clahe_gather.py:874",
    "lab_fwd_f32_nhwc": "retinex_tpu/ops/clahe_gather.py:874",
    "clahe_tables": "retinex_tpu/ops/clahe_gather.py:648",
    "clahe_apply_u8": "retinex_tpu/ops/clahe_gather.py:931",
    "clahe_apply_f32_nhwc": "retinex_tpu/ops/clahe_gather.py:931",
    "clahe_tables_tiles": "retinex_tpu/ops/clahe_gather.py:648",
    "clahe_apply_tiles_f32_nhwc": "retinex_tpu/ops/clahe_gather.py:931",
    "fam_conv_fused": "retinex_tpu/ops/fused_blocks.py:395",
    "fam_conv_y": "retinex_tpu/ops/fused_blocks.py:395",
    "fam_conv_z": "retinex_tpu/ops/fused_blocks.py:395",
    "fam_conv_out": "retinex_tpu/ops/fused_blocks.py:395",
    "fam_tail_stats": "retinex_tpu/ops/fused_blocks.py:321",
    "fam_tail_apply_g1": "retinex_tpu/ops/fused_blocks.py:517",
    "fam_tail_apply": "retinex_tpu/ops/fused_blocks.py:338",
    "lab_fwd_u8_nhwc": "retinex_tpu/ops/clahe_gather.py:326",
    "clahe_apply_u8_nhwc": "retinex_tpu/ops/clahe_gather.py:225",
    "clahe_luma_apply_u8": "retinex_tpu/ops/clahe_luma.py:92",
    "clahe_luma_apply_u8_fused": "retinex_tpu/ops/clahe_luma.py:158",
    "dec1_chain": "retinex_tpu/ops/fused_blocks.py:186",
    "dec1_up": "retinex_tpu/ops/fused_blocks.py:186",
    "dec1_c1": "retinex_tpu/ops/fused_blocks.py:186",
    "dec1_c2": "retinex_tpu/ops/fused_blocks.py:186",
    "dec1_rc": "retinex_tpu/ops/fused_blocks.py:186",
    "fam_dual_conv3": "retinex_tpu/ops/fused_blocks.py:96",
    "fam_dual_conv3_bf16": "retinex_tpu/ops/fused_blocks.py:96",
    "conv2d_pallas": "retinex_tpu/ops/conv_pallas.py:56",
    "conv2d_pallas_bf16": "retinex_tpu/ops/conv_pallas.py:56",
    "conv2d_narrow": "retinex_tpu/ops/conv_pallas.py:183",
    "conv2d_narrow_bf16": "retinex_tpu/ops/conv_pallas.py:183",
    "conv2d_pallas_im2col": "retinex_tpu/ops/conv_pallas.py:275",
    "conv2d_pallas_im2col_bf16": "retinex_tpu/ops/conv_pallas.py:275",
    "clahe_pallas_hist": "retinex_tpu/ops/clahe_pallas.py:111",
    "clahe_pallas_apply": "retinex_tpu/ops/clahe_pallas.py:137",
    "fam_conv_fused_bf16": "retinex_tpu/ops/fused_blocks.py:395",
    "fam_tail_stats_bf16": "retinex_tpu/ops/fused_blocks.py:321",
    "fam_tail_apply_g1_bf16": "retinex_tpu/ops/fused_blocks.py:517",
    "fam_tail_apply_bf16": "retinex_tpu/ops/fused_blocks.py:338",
    "fam_tail_apply_g1_dense_bf16": "retinex_tpu/ops/fused_blocks.py:517",
    "dec1_chain_bf16": "retinex_tpu/ops/fused_blocks.py:186",
    "dec1_up_bf16": "retinex_tpu/ops/fused_blocks.py:186",
    "dec1_c1_bf16": "retinex_tpu/ops/fused_blocks.py:186",
    "dec1_c2_bf16": "retinex_tpu/ops/fused_blocks.py:186",
    "dec1_rc_bf16": "retinex_tpu/ops/fused_blocks.py:186",
}
SOURCES = {
    "lab_fwd_u8": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "lab_fwd_f32_nhwc": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "clahe_tables": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "clahe_apply_u8": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "clahe_apply_f32_nhwc": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "clahe_tables_tiles": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "clahe_apply_tiles_f32_nhwc": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "fam_conv_fused": "retinex_tpu_torch/csrc/fam_fused.cu",
    "fam_conv_y": "retinex_tpu_torch/csrc/conv_pipelined.cu",
    "fam_conv_z": "retinex_tpu_torch/csrc/conv_pipelined.cu",
    "fam_conv_out": "retinex_tpu_torch/csrc/fam_fused.cu",
    "fam_tail_stats": "retinex_tpu_torch/csrc/fam_fused.cu",
    "fam_tail_apply_g1": "retinex_tpu_torch/csrc/fam_fused.cu",
    "fam_tail_apply": "retinex_tpu_torch/csrc/fam_fused.cu",
    "lab_fwd_u8_nhwc": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "clahe_apply_u8_nhwc": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "clahe_luma_apply_u8": "retinex_tpu_torch/csrc/clahe_luma.cu",
    "clahe_luma_apply_u8_fused": "retinex_tpu_torch/csrc/clahe_luma.cu",
    "dec1_chain": "retinex_tpu_torch/csrc/conv_pipelined.cu",
    "dec1_up": "retinex_tpu_torch/csrc/conv_pipelined.cu",
    "dec1_c1": "retinex_tpu_torch/csrc/conv_pipelined.cu",
    "dec1_c2": "retinex_tpu_torch/csrc/conv_pipelined.cu",
    "dec1_rc": "retinex_tpu_torch/csrc/conv_pipelined.cu",
    "fam_dual_conv3": "retinex_tpu_torch/csrc/conv_pipelined.cu",
    "fam_dual_conv3_bf16": "retinex_tpu_torch/csrc/conv_wgmma.cu",
    "conv2d_pallas": "retinex_tpu_torch/csrc/conv_pipelined.cu",
    "conv2d_pallas_bf16": "retinex_tpu_torch/csrc/conv_wgmma.cu",
    "conv2d_narrow": "retinex_tpu_torch/csrc/conv_narrow.cu",
    "conv2d_narrow_bf16": "retinex_tpu_torch/csrc/conv_wgmma.cu",
    "conv2d_pallas_im2col": "retinex_tpu_torch/csrc/conv_pipelined.cu",
    "conv2d_pallas_im2col_bf16": "retinex_tpu_torch/csrc/conv_wgmma.cu",
    "clahe_pallas_hist": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "clahe_pallas_apply": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "fam_conv_fused_bf16": "retinex_tpu_torch/csrc/fam_fused.cu",
    "fam_tail_stats_bf16": "retinex_tpu_torch/csrc/fam_fused.cu",
    "fam_tail_apply_g1_bf16": "retinex_tpu_torch/csrc/fam_fused.cu",
    "fam_tail_apply_bf16": "retinex_tpu_torch/csrc/fam_fused.cu",
    "fam_tail_apply_g1_dense_bf16": "retinex_tpu_torch/csrc/fam_tail_wgmma.cu",
    "dec1_chain_bf16": "retinex_tpu_torch/csrc/conv_wgmma.cu",
    "dec1_up_bf16": "retinex_tpu_torch/csrc/conv_wgmma.cu",
    "dec1_c1_bf16": "retinex_tpu_torch/csrc/conv_wgmma.cu",
    "dec1_c2_bf16": "retinex_tpu_torch/csrc/conv_wgmma.cu",
    "dec1_rc_bf16": "retinex_tpu_torch/csrc/conv_wgmma.cu",
}
# The packed FAM shapes (scale 1, scale 2) of the letterboxed 1088x1920 frame
# and of the unpadded 1080x1920 one.
FAM_SHAPES = ((1, 544, 960, 128), (1, 136, 240, 128))
FAM_SHAPES_1080 = ((1, 540, 960, 128), (1, 135, 240, 128))
FAM_RAGGED = (2, 37, 53, 128)
# The directory's net mode: the chunks of 8 and 4 at 1088x1920 (scale 1,
# scale 2) and the chunk of 4 at 640x640.
FAM_DIR_SHAPES = (
    (8, 544, 960, 128), (8, 136, 240, 128), (4, 544, 960, 128), (4, 136, 240, 128),
    (4, 320, 320, 128), (4, 80, 80, 128),
)
# K4 and each of its stages within K4's 2e-4 (tests/test_fused_blocks.py).
K4_STAGES = ("fam_conv_y", "fam_conv_z", "fam_conv_out")
# K6 twice: fam_tail_apply_g1 is the main path's instance (a quadrant-
# diagonal w, as pack_pointwise makes the model's fusion folds), which the
# kernels line carries; fam_tail_apply_g1_dense the dense instance (a dense
# random w), printed on phase 4's lines.
FAM_TOL = {"fam_conv_fused": 2e-4, **{k: 2e-4 for k in K4_STAGES}, "fam_tail_stats": 1e-5, "fam_tail_apply_g1": 1e-4,
           "fam_tail_apply_g1_dense": 1e-4, "fam_tail_apply": 1e-5}
FAM_KERNELS = tuple(FAM_TOL)
# Timed at the letterboxed frame's shapes; fam_tail_apply at the unpadded one's.
FAM_TIMED = FAM_KERNELS[:7]
# tests/test_packed_inference.py:40-42.
PACKED_TOL = {"enhanced": 2e-3, "reflectance": 2e-3, "illumination": 2e-5}
# The net's outputs on the card against the CPU's (same weights and input).
CPU_NET_TOL = 1e-5
# K10's shapes: the 1088x1920 frame's dec1, the directory's chunks (8 and 4
# at 1088x1920, 4 at 640x640) and a ragged one; its tolerance
# (tests/test_fused_blocks.py:66) and the NetCfg variants' (:75).
DEC1_SHAPES = ((1, 544, 960), (8, 544, 960), (4, 320, 320), (2, 37, 53))
DEC1_TOL = 1e-4
# K10's four conv_pipelined stages: (Cin, taps, residual), each 128 out.
K10_STAGES = {"dec1_up": (64, 1, False), "dec1_c1": (128, 9, False), "dec1_c2": (128, 9, True),
              "dec1_rc": (128, 9, False)}
NETCFG_TOL = 2e-4
# Phases 17-19. Tolerances: f32 as tests/test_conv_pallas.py:28 and
# tests/test_fused_blocks.py:47; bf16 one output ulp (2**-8 relative).
F32_TOL = 1e-4
BF16_TOL = 1e-2
# {kernel: [(x shape, (kh, kw, Cout), dilation, relu)]}: perf_lab's shapes
# (`conv`, `narrowpallas`), then ragged ones; CONV_TIMED cases are timed.
CONV_CASES = {
    "conv2d_pallas": [
        ((2, 544, 960, 128), (3, 3, 128), 1, True), ((2, 544, 960, 128), (2, 2, 128), 1, True),
        ((2, 272, 480, 256), (3, 3, 256), 1, True), ((2, 37, 53, 128), (3, 2, 128), 1, True),
        ((2, 37, 53, 20), (3, 3, 96), 1, True),
    ],
    "conv2d_pallas_im2col": [
        ((2, 544, 960, 128), (3, 3, 128), 1, False), ((2, 544, 960, 128), (2, 2, 128), 1, False),
        ((2, 272, 480, 256), (3, 3, 256), 1, False), ((2, 37, 53, 128), (3, 2, 128), 1, True),
        ((2, 37, 53, 20), (2, 3, 24), 1, False),
    ],
    "conv2d_narrow": [
        ((2, 1088, 1920, 32), (3, 3, 32), 1, True), ((2, 1088, 1920, 32), (3, 3, 64), 1, True),
        ((2, 1088, 1920, 32), (3, 3, 32), 2, False), ((2, 37, 53, 24), (5, 5, 40), 1, True),
        ((2, 37, 53, 24), (3, 3, 30), 2, False), ((2, 37, 53, 64), (5, 5, 128), 2, True),
        ((2, 1088, 1920, 32), (5, 5, 32), 1, True),
    ],
}
# (kernel, case index): both 3x3 shapes of K13/K15, K14's first, its
# dilation-2 and its 5x5 case at perf_lab's width; the first of each kernel
# goes into the kernels line.
CONV_TIMED = {("conv2d_pallas", 0), ("conv2d_pallas", 2), ("conv2d_pallas_im2col", 0),
              ("conv2d_pallas_im2col", 2), ("conv2d_narrow", 0), ("conv2d_narrow", 2), ("conv2d_narrow", 6)}
DUAL_SHAPES = ((2, 544, 960, 128), (1, 544, 960, 128), (2, 37, 53, 128))
# K12's two stages, each 256 out: (Cin, groups).
K12_STAGES = {"fam_dual_y": (128, 1), "fam_dual_out": (256, 2)}
# K16: the 1088x1920 frame, perf_lab's batch of 8, a 4K frame, the JAX test's.
K16_SHAPES = ((1, 1088, 1920, 3), (8, 1088, 1920, 3), (1, 2160, 3840, 3), (2, 96, 128, 3))


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sass_functions(text: str) -> dict[str, list[tuple[int, str, str]]]:
    """{mangled function name: its SASS instructions (address, opcode,
    operands) in order} of cuobjdump -sass output."""
    import re

    out: dict[str, list[tuple[int, str, str]]] = {}
    ins = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            ins = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);", line)
        if m and ins is not None:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def issued(ins) -> int:
    """Instructions that do the arithmetic: all but loads and stores,
    control flow and barriers, and address math (LEA, IMAD.WIDE)."""
    skip = ("LD", "ST", "ULDC", "ATOM", "RED", "BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "BAR", "NOP",
            "WARPSYNC", "YIELD", "BMOV", "LEA", "IMAD.WIDE", "SHFL")
    return sum(not op.startswith(skip) for _, op, _ in ins)


def row_loop(ins) -> list:
    """K3's row loop: the largest backward branch's body after the block's
    last barrier (the compiler may keep two versions of the loop, of which
    one runs)."""
    import re

    bar = max(a for a, op, _ in ins if op.startswith("BAR"))
    best = []
    for addr, op, rest in ins:
        m = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if m and bar < int(m.group(1), 16) < addr:
            body = [x for x in ins if int(m.group(1), 16) <= x[0] <= addr]
            best = max(best, body, key=len)
    return best


def cuobjdump_sass(lib: Path) -> str:
    """cuobjdump -sass of a built library."""
    import shutil

    tool = Path("/usr/local/cuda/bin/cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        raise RuntimeError("cuobjdump not found: it reads the kernels' instruction counts for their bounds")
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout


def sass_instructions_per_px(lib: Path) -> dict[str, float]:
    """Instructions a pixel issues in each instance of K1 and K3, from the
    built library's SASS (cuobjdump -sass), only ``issued`` opcodes (cbrtf
    and the IEEE divisions at every instruction they compile to, both sides
    of a branch counted): K1 has no loop, so its count at 4 pixels a thread
    less its count at 1, over 3, which cancels the per-thread work (K1's
    rare path, a call out of line, not counted); K3 its row loop's at 8
    pixels a thread, over 8, or at 4 over 4 for the tile-coordinate mode
    (the per-row work, a blend weight, is in it). Keyed by wrapper, as
    K1_K3_INSTANCES."""
    import re

    text = cuobjdump_sass(lib)
    fn = {}
    for name, ins in sass_functions(text).items():
        m = re.search(r"(lab_fwd|clahe_apply)_kernelILi(\d+)ELi(\d)E(?:Li(\d)E)?", name)
        if m:
            fn[(m.group(1), int(m.group(2)), int(m.group(3)), int(m.group(4) or 0))] = ins
    per_px = {}
    for wrapper, (kernel, layout, mode) in K1_K3_INSTANCES.items():
        if kernel == "lab_fwd":
            per_px[wrapper] = (issued(fn[(kernel, 4, layout, 0)]) - issued(fn[(kernel, 1, layout, 0)])) / 3
        else:
            vec = 8 if (kernel, 8, layout, mode) in fn else 4
            per_px[wrapper] = issued(row_loop(fn[(kernel, vec, layout, mode)])) / vec
    return per_px


def start_count_build(kernels, out: Path) -> subprocess.Popen:
    """Start nvcc on csrc/clahe_lab.cu with LAB_COUNT_WITHOUT_TIE_TEST into
    the cubin `out`: K1 without its near-tie test, whose SASS gives the
    operations K1's function needs (the bounds of K1, K8's forward half and
    K16's first kernel). Runs beside the libraries' build."""
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [kernels._nvcc(), *flags, "-cubin", "-DLAB_COUNT_WITHOUT_TIE_TEST", "-o", str(out),
           str(kernels.CSRC / "clahe_lab.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def inner_loop(ins) -> list:
    """The largest loop body (from a backward branch's target to the branch)
    that holds no other backward branch: a kernel's pixel loop."""
    import re

    loops = []
    for addr, op, rest in ins:
        m = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(a, b) for a, b in loops if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    a, b = max(inner, key=lambda ab: sum(ab[0] <= x[0] <= ab[1] for x in ins))
    return [x for x in ins if a <= x[0] <= b]


def sass_loop_instructions_per_px(libs) -> dict[str, float]:
    """Instructions a pixel issues in each of LOOP_INSTANCES, from the built
    libraries' SASS: ``issued`` opcodes of the kernel's pixel loop
    (``inner_loop``; both sides of a branch in it counted, the division's
    slow path, a call out of the loop, not), over the pixels one pass of the
    loop covers (its global stores times the pixels a store covers, so an
    unrolled loop counts right). Keyed by wrapper."""
    import re

    per_px = {}
    for wrapper, (stem, pattern, px_per_store) in LOOP_INSTANCES.items():
        fns = sass_functions(cuobjdump_sass(libs[stem].path))
        (ins,) = [v for k, v in fns.items() if re.search(pattern, k)]
        body = inner_loop(ins)
        stores = sum(op.startswith("STG") for _, op, _ in body)
        per_px[wrapper] = issued(body) / (stores * px_per_store)
    return per_px


def time_ms(torch, fn, n: int = 25) -> float:
    """Median device ms of one call of fn over n calls. A sleep kernel
    queued first keeps the device busy while the host enqueues all n calls,
    so each event interval holds device time only."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda._sleep(50_000_000)
    events[0].record()
    for i in range(n):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(n))


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def u8_diff(torch, a, b) -> tuple[int, float]:
    d = (a.to(torch.int16) - b.to(torch.int16)).abs()
    return int(d.max()), float((d > 0).float().mean())


def clahe_kernel_phase(
    torch, cg, b: int, h: int, w: int, seed: int, timed: bool = True, tile_counts: tuple = (8,)
) -> dict:
    """Hold K1-K3 to their plain versions on a seeded [b, 3, h, w] batch,
    K1 and K3 in their u8 planar and their float instances (K1's float
    input a seeded frame past [0, 1] with exact .5 ties, laid out as the
    nets' outputs are, and NHWC), K2 at each of `tile_counts` tiles a side;
    return per-kernel records at 8x8 tiles: the error, and with `timed` the
    times too (K2's printed at every tile count)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rgb = torch.randint(0, 256, (b, 3, h, w), dtype=torch.uint8, device="cuda", generator=g)
    base = torch.rand((b, 3, h, w), device="cuda", generator=g) * 1.2 - 0.1
    ties = torch.randint(0, 255, (base.view(-1)[::97].numel(),), device="cuda", generator=g)
    base.view(-1)[::97] = (ties.float() + 0.5) / 255.0
    x = base.permute(0, 2, 3, 1)  # float [b, h, w, 3] stored channels first
    tiles = 8
    n_px = h * w
    n_tiles = tiles * tiles
    tag = f"{b}x{h}x{w}" if b > 1 else f"{h}x{w}"

    def hold(name, got, want):
        torch.cuda.synchronize()
        err, frac = u8_diff(torch, got, want)
        print(f"  {tag} {name}: max {err} level(s), {frac:.2e} of bytes differ")
        if err > 1 or frac >= 1e-4:
            raise AssertionError(f"{name} disagrees with its plain version at {tag}")
        return err

    lab = cg.lab_fwd_u8(rgb)
    k1_max = hold("K1 lab_fwd_u8", lab, cg.lab_fwd_u8_plain(rgb))
    lab_f = cg.lab_fwd_f32_nhwc(x)
    k1f_max = hold("K1 lab_fwd_f32_nhwc (stored channels first)", lab_f, cg.lab_fwd_f32_nhwc_plain(x))
    if not torch.equal(cg.lab_fwd_f32_nhwc(x.contiguous()), lab_f):
        raise AssertionError(f"K1's float instance on NHWC memory differs from it on channels-first memory at {tag}")

    for t in tile_counts:
        for s in (1, 2):
            luts = cg.clahe_tables(lab, tiles_y=t, tiles_x=t, hist_subsample=s)
            luts_p = cg.clahe_tables_plain(lab, tiles_y=t, tiles_x=t, hist_subsample=s)
            torch.cuda.synchronize()
            if not torch.equal(luts, luts_p):
                raise AssertionError(f"K2 tables differ from the plain version at {tag}, {t}x{t} tiles, hist_subsample={s}")
            print(f"  {tag} K2 clahe_tables ({t}x{t} tiles, hist_subsample={s}): identical")
        if timed and t != tiles:
            print(f"  {tag} K2 clahe_tables at {t}x{t} tiles: {time_ms(torch, lambda: cg.clahe_tables(lab, tiles_y=t, tiles_x=t)):.4f} ms")
    luts = cg.clahe_tables(lab)

    out = cg.clahe_apply_u8(lab, luts)
    k3_max = hold("K3 clahe_apply_u8", out, cg.clahe_apply_u8_plain(lab, luts))
    out_f = cg.clahe_apply_f32_nhwc(lab, luts)
    k3f_max = hold(
        "K3 clahe_apply_f32_nhwc (x 255)", torch.round(out_f * 255.0).to(torch.uint8),
        torch.round(cg.clahe_apply_f32_nhwc_plain(lab, luts) * 255.0).to(torch.uint8),
    )
    if not torch.equal(out_f, cg.dequantise_nhwc(out)):
        raise AssertionError(f"K3's float instance is not its u8 instance / 255 at {tag}")
    for j in sorted({0, b - 1} if b > 1 else ()):
        lab1 = cg.lab_fwd_u8(rgb[j : j + 1])
        luts1 = cg.clahe_tables(lab1)
        alone = (lab1, luts1, cg.clahe_apply_u8(lab1, luts1), cg.lab_fwd_f32_nhwc(x[j : j + 1]),
                 cg.clahe_apply_f32_nhwc(lab1, luts1))
        if not all(torch.equal(a, t[j : j + 1]) for a, t in zip(alone, (lab, luts, out, lab_f, out_f))):
            raise AssertionError(f"K1-K3 at {tag}: image {j} of the batch differs from the kernels on it alone")
    if b > 1:
        print(f"  {tag} K1-K3 (both instances of K1 and K3): first and last image identical to the kernels on each "
              "alone")
    errs = {"lab_fwd_u8": k1_max, "lab_fwd_f32_nhwc": k1f_max, "clahe_tables": 0, "clahe_apply_u8": k3_max,
            "clahe_apply_f32_nhwc": k3f_max}
    if not timed:
        return {name: dict(max_abs_err=e) for name, e in errs.items()}

    px = b * n_px
    lut_bytes = b * n_tiles * 256
    apply_tables = 4 * cg.APPLY_TABLE_WORDS
    calls = {  # name: (kernel call, plain call, bytes moved)
        "lab_fwd_u8": (lambda: cg.lab_fwd_u8(rgb), lambda: cg.lab_fwd_u8_plain(rgb), 6 * px + 1024),
        "lab_fwd_f32_nhwc": (lambda: cg.lab_fwd_f32_nhwc(x), lambda: cg.lab_fwd_f32_nhwc_plain(x), 15 * px + 1024),
        "clahe_apply_u8": (lambda: cg.clahe_apply_u8(lab, luts), lambda: cg.clahe_apply_u8_plain(lab, luts),
                           6 * px + lut_bytes + apply_tables),
        "clahe_apply_f32_nhwc": (lambda: cg.clahe_apply_f32_nhwc(lab, luts),
                                 lambda: cg.clahe_apply_f32_nhwc_plain(lab, luts), 15 * px + lut_bytes + apply_tables),
    }
    recs = {
        name: dict(max_abs_err=errs[name], ms=time_ms(torch, fn), plain_ms=time_ms(torch, plain, n=5),
                   bound=bound(n_bytes, INSTR_PER_PX[name] * px, PEAK_ISSUE_PER_S))
        for name, (fn, plain, n_bytes) in calls.items()
    }
    recs["clahe_tables"] = dict(
        max_abs_err=0,
        ms=time_ms(torch, lambda: cg.clahe_tables(lab)),
        plain_ms=time_ms(torch, lambda: cg.clahe_tables_plain(lab), n=5),
        bound=bound(px + lut_bytes, px + K2_OPS_PER_ENTRY * lut_bytes),
    )
    for name, r in recs.items():
        print(
            f"  {tag} {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]}, {r['bound'][0] / r['ms']:.1%} of it)"
        )
    return recs


def k3_plan_sweep(torch, cg, kernels, h: int = 1088, w: int = 1920) -> None:
    """K3's launch plan (``clahe_gather.apply_plan``: pixels a thread, rows
    a block takes at once, rows of a band) against its neighbours on a
    seeded noise frame, in the u8 planar and the float instance: prints
    the plan's time and the five fastest plans. Every plan gives the same
    bytes (checked)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    lab = cg.lab_fwd_u8(torch.randint(0, 256, (1, 3, h, w), dtype=torch.uint8, device="cuda", generator=g))
    luts = cg.clahe_tables(lab)
    tables, stream = cg._apply_table_block(str(lab.device)), kernels.stream(lab)
    n_sm = torch.cuda.get_device_properties(lab.device).multi_processor_count
    instances = (("clahe_apply_u8", 0, cg.clahe_apply_u8), ("clahe_apply_f32_nhwc", 3, cg.clahe_apply_f32_nhwc))
    for name, layout, fn in instances:
        want = fn(lab, luts)
        out = torch.empty_like(want)
        vec = cg._apply_width(lab, w, 8, 4 if layout == 3 else 8)
        default = (vec,) + cg.apply_plan(h, w, 8, 1, vec, n_sm)[::-1]
        times = {}
        for vec, rows_par, rows in [default] + [(v, p, r) for v in (8, 4) for p in (1, 2, 4) for r in (2, 3, 4, 6, 9, 17)]:
            key = (vec, min(rows_par, rows), rows)
            if key in times:
                continue
            args = (lab.data_ptr(), luts.data_ptr(), tables.data_ptr(), out.data_ptr(), 1, h, w, 8, 8, layout, vec,
                    rows, key[1], 0, 16, stream)  # row0 0, cell_rows 16: the whole frame
            times[key] = time_ms(torch, lambda: kernels.launch("clahe_apply", *args))
            if not torch.equal(out, want):
                raise AssertionError(f"{name} with the plan {key} differs from its default plan")
        best = sorted(times.items(), key=lambda kv: kv[1])[:5]
        print(f"  {h}x{w} {name}, plans (pixels a thread, rows at once, band rows): the default {default} "
              f"{times[default]:.4f} ms; fastest " + ", ".join(f"{k} {t:.4f}" for k, t in best))


def cube_outputs(torch, cg) -> tuple:
    """K1 on every sRGB triple and K3 on every (L, a, b) triple: a planar
    [1, 3, 4096, 4096] u8 image that enumerates the 256^3 cube, taken as
    sRGB by K1 and as Lab by K3 with identity LUTs at 8x8 tiles (so the
    blend keeps L). Returns (cube, identity LUTs, K1's Lab, K3's sRGB); it
    calls only lab_fwd_u8 and clahe_apply_u8, so it runs on any version of
    the package."""
    v = torch.arange(256**3, device="cuda", dtype=torch.int32)
    cube = torch.stack([v >> 16, (v >> 8) & 255, v & 255]).to(torch.uint8).reshape(1, 3, 4096, 4096)
    luts = torch.arange(256, device="cuda", dtype=torch.uint8).expand(1, 8, 8, 256).contiguous()
    return cube, luts, cg.lab_fwd_u8(cube), cg.clahe_apply_u8(cube, luts)


def cube_phase(torch, cg) -> dict[str, int]:
    """Hold both instances of K1 and of K3 to their plain versions over the
    whole cube (``cube_outputs``; K1's float instance reads the cube / 255
    stored channels first), and each float instance to its u8 one; return
    the largest error of each."""
    cube, luts, lab, rgb = cube_outputs(torch, cg)
    x = (cube.float() / 255.0).permute(0, 2, 3, 1)
    holds = {
        "lab_fwd_u8": (lab, cg.lab_fwd_u8_plain(cube)),
        "lab_fwd_f32_nhwc": (cg.lab_fwd_f32_nhwc(x), cg.lab_fwd_f32_nhwc_plain(x)),
        "clahe_apply_u8": (rgb, cg.clahe_apply_u8_plain(cube, luts)),
        "clahe_apply_f32_nhwc": tuple(
            torch.round(o * 255.0).to(torch.uint8).permute(0, 3, 1, 2)
            for o in (cg.clahe_apply_f32_nhwc(cube, luts), cg.clahe_apply_f32_nhwc_plain(cube, luts))
        ),
    }
    errs = {}
    for name, (got, want) in holds.items():
        torch.cuda.synchronize()
        d = (got.to(torch.int16) - want.to(torch.int16)).abs()
        errs[name], n_diff = int(d.max()), int((d > 0).sum())
        print(f"  the whole cube, {name}: {n_diff} of {d.numel()} bytes differ from the plain version, max {errs[name]} level(s)")
        if errs[name] > 1 or n_diff >= 1e-4 * d.numel():
            raise AssertionError(f"{name} disagrees with its plain version over the cube")
    for name, (got, _), other in (("lab_fwd_f32_nhwc", holds["lab_fwd_f32_nhwc"], lab),
                                  ("clahe_apply_f32_nhwc", holds["clahe_apply_f32_nhwc"], rgb)):
        if not torch.equal(got, other):
            raise AssertionError(f"{name} over the cube differs from its u8 instance")
    print("  the whole cube: each float instance's bytes equal its u8 instance's")
    return errs


def tile_mode_phase(torch, cg, b: int, h: int, w: int, seed: int, timed: bool = False) -> dict:
    """Hold K2 in its tile-row mode and K3 in its tile-coordinate mode to
    their plain versions on a seeded [b, 3, h, w] u8 frame that is not
    cell-divisible (K2 identical, K3 within 1 level on under 1e-4 of the
    bytes, as K3 is held), and the two with K1's float instance
    (``clahe_lab_rgb_tiles``) to the CPU's plain route on a seeded float
    frame with exact .5 ties (identical); on a batch, the first and last
    image against the kernels on each alone. Returns records by kernel:
    the error, and with `timed` the times and bounds."""
    from retinex_tpu_torch.ops.clahe import clahe_lab_rgb, tile_dims

    g = torch.Generator(device="cuda").manual_seed(seed)
    rgb = torch.randint(0, 256, (b, 3, h, w), dtype=torch.uint8, device="cuda", generator=g)
    lab = cg.lab_fwd_u8(rgb)
    tag = f"{b}x{h}x{w}" if b > 1 else f"{h}x{w}"
    luts = cg.clahe_tables_tiles(lab)
    luts_p = cg.clahe_tables_tiles_plain(lab)
    torch.cuda.synchronize()
    if not torch.equal(luts, luts_p):
        raise AssertionError(f"K2's tile-row mode differs from its plain version at {tag}")
    out = cg.clahe_apply_tiles_f32_nhwc(lab, luts)
    want = cg.clahe_apply_tiles_f32_nhwc_plain(lab, luts)
    err, frac = u8_diff(torch, torch.round(out * 255.0).to(torch.uint8), torch.round(want * 255.0).to(torch.uint8))
    print(f"  {tag} K2 clahe_tables_tiles: identical; K3 clahe_apply_tiles_f32_nhwc (x 255): max {err} level(s), "
          f"{frac:.2e} of bytes differ")
    if err > 1 or frac >= 1e-4:
        raise AssertionError(f"K3's tile-coordinate mode disagrees with its plain version at {tag}")
    x = torch.rand((b, h, w, 3), device="cuda", generator=g)
    ties = torch.randint(0, 255, (x.view(-1)[::89].numel(),), device="cuda", generator=g)
    x.view(-1)[::89] = (ties.float() + 0.5) / 255.0
    route = cg.clahe_lab_rgb_tiles(x)
    n_diff = int((route.cpu() != clahe_lab_rgb(x.cpu())).sum())
    print(f"  {tag} K1 (float) -> K2 tile rows -> K3 tile coordinates against the CPU's clahe_lab_rgb: "
          f"{n_diff} values differ")
    if n_diff:
        raise AssertionError(f"the tile modes' route differs from the CPU's clahe_lab_rgb at {tag}")
    for j in sorted({0, b - 1} if b > 1 else ()):
        luts1 = cg.clahe_tables_tiles(lab[j : j + 1])
        if not (torch.equal(luts1, luts[j : j + 1]) and torch.equal(cg.clahe_apply_tiles_f32_nhwc(lab[j : j + 1], luts1), out[j : j + 1])):
            raise AssertionError(f"the tile modes at {tag}: image {j} of the batch differs from the kernels on it alone")
    recs = {"clahe_tables_tiles": dict(max_abs_err=0), "clahe_apply_tiles_f32_nhwc": dict(max_abs_err=err)}
    if not timed:
        return recs
    px = b * h * w
    lut_bytes = b * 64 * 256
    _, _, tile_h, tile_w = tile_dims(h, w, 8, 8)
    geom, bands, _ = cg.tile_geometry(h, w, 8, 8, b, cg._tiles_width(lab, w),
                                      torch.cuda.get_device_properties(0).multi_processor_count, str(lab.device))
    padded_px = b * 64 * tile_h * tile_w
    recs["clahe_tables_tiles"].update(
        ms=time_ms(torch, lambda: cg.clahe_tables_tiles(lab)),
        plain_ms=time_ms(torch, lambda: cg.clahe_tables_tiles_plain(lab), n=5),
        bound=bound(px + lut_bytes, padded_px + K2_OPS_PER_ENTRY * lut_bytes),
    )
    recs["clahe_apply_tiles_f32_nhwc"].update(
        ms=time_ms(torch, lambda: cg.clahe_apply_tiles_f32_nhwc(lab, luts)),
        plain_ms=time_ms(torch, lambda: cg.clahe_apply_tiles_f32_nhwc_plain(lab, luts), n=5),
        bound=bound(15 * px + lut_bytes + 4 * cg.APPLY_TABLE_WORDS + 4 * geom.numel(),
                    INSTR_PER_PX["clahe_apply_tiles_f32_nhwc"] * px, PEAK_ISSUE_PER_S),
    )
    for name, r in recs.items():
        print(f"  {tag} {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound {r['bound'][0]:.4f} ms by "
              f"{r['bound'][1]}, {r['bound'][0] / r['ms']:.1%} of it)")
    print(f"  {tag} K3's tile-coordinate plan: {bands} row bands")
    return recs


def f4_record(torch) -> int:
    """F4's record: the plain ``colorspace.lab_u8_to_rgb`` (the Lab -> sRGB
    half of the plain Lab-CLAHE route), rounded to bytes, on the card and on
    the CPU over every (L, a, b) triple; prints and returns how many bytes
    differ. It uses only the public function, so it reads any version of
    the package on sys.path."""
    from retinex_tpu_torch.ops.colorspace import lab_u8_to_rgb

    v = torch.arange(256**3, dtype=torch.int32)
    lab = torch.stack([v >> 16, (v >> 8) & 255, v & 255], dim=-1).float().reshape(4096, 4096, 3)
    card = torch.round(lab_u8_to_rgb(lab.cuda()) * 255.0).to(torch.uint8).cpu()
    cpu = torch.round(lab_u8_to_rgb(lab) * 255.0).to(torch.uint8)
    d = (card.to(torch.int16) - cpu.to(torch.int16)).abs()
    n = int((d > 0).sum())
    print(f"  F4's record: lab_u8_to_rgb rounded to bytes over every (L, a, b) triple, card against CPU: {n} of "
          f"{d.numel()} bytes differ, max {int(d.max())} level(s)")
    return n


def route_frames(torch) -> dict:
    """The frames of the Lab-CLAHE route gate, float NHWC [1, h, w, 3] on the
    CPU: the headline photo at 1080x1920 (data/convergence/lowlight_000.png
    upscaled as phase 7's photo is), the small flagless frame at 264x480, the
    photo at 1001x1503 (padded on both sides), and a seeded uniform frame at
    1080x1920 with exact .5 ties."""
    from PIL import Image

    frames = {}
    with Image.open(REPO / "data" / "convergence" / "lowlight_000.png") as im:
        for h, w in ((1080, 1920), (264, 480), (1001, 1503)):
            a = np.asarray(im.convert("RGB").resize((w, h), Image.BILINEAR), dtype=np.float32) / 255.0
            frames[f"photo {h}x{w}"] = torch.from_numpy(a)[None]
    g = torch.Generator().manual_seed(12)
    x = torch.rand((1, 1080, 1920, 3), generator=g)
    x.view(-1)[::89] = (torch.randint(0, 255, (x.view(-1)[::89].numel(),), generator=g).float() + 0.5) / 255.0
    frames["uniform 1080x1920 with .5 ties"] = x
    return frames


def route_gate(torch, strict: bool = True) -> dict[str, int]:
    """The card's ``clahe_lab_rgb`` against the CPU's on ``route_frames``:
    prints how many output values differ on each; with `strict`, raises
    unless none does. It uses only the public entry, so it reads any version
    of the package on sys.path."""
    from retinex_tpu_torch.ops.clahe import clahe_lab_rgb

    diffs = {}
    for name, x in route_frames(torch).items():
        card = clahe_lab_rgb(x.cuda()).cpu()
        cpu = clahe_lab_rgb(x)
        d = (torch.round(card * 255.0) - torch.round(cpu * 255.0)).abs()
        diffs[name] = n = int((card != cpu).sum())
        print(f"  clahe_lab_rgb card against CPU, {name}: {n} of {card.numel()} values differ, max "
              f"{float(d.max()):.0f} level(s)")
    if strict and any(diffs.values()):
        raise AssertionError(f"the card's Lab-CLAHE route differs from the CPU's: {diffs}")
    return diffs


def clahe_stage_profile(torch, h: int = 1088, w: int = 1920, n: int = 5) -> dict[str, tuple[int, float]]:
    """Device time of the main path's Lab-CLAHE stage by operation: n calls
    of ``clahe_lab_rgb`` (the public entry every net route calls) on a
    seeded float frame laid out as the nets' outputs are (a permuted NCHW
    tensor), under torch.profiler. Prints each device operation's launches
    and ms per call, the total, and the synchronized wall time per call;
    returns {operation: (launches per call, ms per call)}. It uses only the
    public entry, so it reads any version of the package on sys.path."""
    from torch.profiler import ProfilerActivity, profile

    from retinex_tpu_torch.ops.clahe import clahe_lab_rgb

    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand((1, 3, h, w), device="cuda", generator=g).permute(0, 2, 3, 1)
    for _ in range(3):
        clahe_lab_rgb(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            clahe_lab_rgb(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        raise AssertionError("the profiler recorded no device time in the Lab-CLAHE stage")
    # Launches per call rounded, so that an event the profiler drops does not
    # read as a missing launch; ms per call = ms per recorded launch x launches.
    rows = {e.key: (round(e.count / n), e.self_device_time_total / e.count / 1e3 * round(e.count / n)) for e in ops}
    total = sum(ms for _, ms in rows.values())
    print(f"  Lab-CLAHE stage at {h}x{w} (clahe_lab_rgb, {n} calls): {total:.4f} device ms of {wall_ms:.4f} wall ms "
          f"per call, by operation (launches, device ms per call):")
    for key, (count, ms) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        print(f"    {ms:9.4f}  x{count:<3d} {key[:110]}")
    return rows


def luma_kernel_phase(torch, cg, cl, shape: tuple, seed: int) -> dict:
    """Hold both K8 kernels, K7 and K9 (and K2 on a luma plane) to their
    plain versions on a seeded u8 batch [b, h, w]; return per-kernel records
    (median ms per launch over 25 launches, plain ms, bound)."""
    b, h, w = shape
    n_px = b * h * w
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device="cuda", generator=g)
    xp = x.permute(0, 3, 1, 2).contiguous()
    tag = "x".join(map(str, shape))

    def hold(name, got, want):
        torch.cuda.synchronize()
        err, frac = u8_diff(torch, got, want)
        print(f"  [{tag}] {name}: max {err} level(s), {frac:.2e} of bytes differ")
        if err > 1 or frac >= 1e-4:
            raise AssertionError(f"{name} disagrees with its plain version at {shape}")
        return err

    lab = cg.lab_fwd_u8_nhwc(x)
    e_fwd = hold("K8 lab_fwd_u8_nhwc", lab, cg.lab_fwd_u8_nhwc_plain(x))
    luts_lab = cg.clahe_tables(lab)
    e_apply = hold("K8 clahe_apply_u8_nhwc", cg.clahe_apply_u8_nhwc(lab, luts_lab), cg.clahe_apply_u8_nhwc_plain(lab, luts_lab))
    y = cl._luma_u8(xp)

    def exact(name, got, want):
        torch.cuda.synchronize()
        n = int((got != want).sum())
        print(f"  [{tag}] {name}: " + ("bit-identical to its plain version" if n == 0 else f"{n} bytes differ"))
        if n:
            raise AssertionError(f"{name} differs from its plain version at {shape}")
        return 0

    e_k7 = 0
    for s in (1, 2):
        luts = cg.clahe_tables(y, hist_subsample=s)
        luts_p = cg.clahe_tables_plain(y, hist_subsample=s)
        torch.cuda.synchronize()
        if not torch.equal(luts, luts_p):
            raise AssertionError(f"K2 on the luma plane differs from its plain version at {shape}, s={s}")
        k7 = cl.clahe_luma_apply_u8(xp, y, luts)
        exact(f"K7 clahe_luma_apply_u8 (hist_subsample={s}, K2 tables identical)", k7, cl.clahe_luma_apply_u8_plain(xp, y, luts))
        k7_nhwc = cl.clahe_luma_apply_u8(x, y, luts)
        exact(f"K7 clahe_luma_apply_u8 on NHWC (hist_subsample={s})", k7_nhwc, cl.clahe_luma_apply_u8_plain(x, y, luts))
        if not torch.equal(k7_nhwc, k7.permute(0, 2, 3, 1)):
            raise AssertionError(f"K7 on NHWC differs from K7 on planar at {shape}, s={s}")
        k9 = cl.clahe_luma_apply_u8_fused(xp, luts)
        exact(f"K9 clahe_luma_apply_u8_fused (hist_subsample={s})", k9, cl.clahe_luma_apply_u8_fused_plain(xp, luts))
        if not torch.equal(k9, k7):
            raise AssertionError(f"K9 differs from K7 at {shape}, s={s}")
        print(f"  [{tag}] K9 clahe_luma_apply_u8_fused (hist_subsample={s}): identical to K7")
    luts = cg.clahe_tables(y)
    k8 = cg.clahe_apply_u8_nhwc(lab, luts_lab)
    k7 = cl.clahe_luma_apply_u8(x, y, luts)
    for j in sorted({0, b - 1} if b > 1 else ()):
        lab1 = cg.lab_fwd_u8_nhwc(x[j : j + 1])
        y1 = cl._luma_u8(x[j : j + 1], dim=3)
        alone = (lab1, cg.clahe_apply_u8_nhwc(lab1, cg.clahe_tables(lab1)), cl.clahe_luma_apply_u8(x[j : j + 1], y1, cg.clahe_tables(y1)))
        if not all(torch.equal(a, t[j : j + 1]) for a, t in zip(alone, (lab, k8, k7))):
            raise AssertionError(f"K8/K7 at {shape}: image {j} of the batch differs from the kernels on it alone")
    if b > 1:
        print(f"  [{tag}] K8, K2, K7: first and last image identical to the kernels on each alone")
    table_bytes = b * 64 * 256
    geo_bytes = 4 * (2 * w + h + 256)  # K7's and K9's geometry table (clahe_luma.luma_geometry)
    recs = {
        "lab_fwd_u8_nhwc": dict(
            max_abs_err=e_fwd,
            ms=time_ms(torch, lambda: cg.lab_fwd_u8_nhwc(x)),
            plain_ms=time_ms(torch, lambda: cg.lab_fwd_u8_nhwc_plain(x), n=5),
            bound=bound(6 * n_px + 1024, INSTR_PER_PX['lab_fwd_u8_nhwc'] * n_px, PEAK_ISSUE_PER_S),
        ),
        "clahe_apply_u8_nhwc": dict(
            max_abs_err=e_apply,
            ms=time_ms(torch, lambda: cg.clahe_apply_u8_nhwc(lab, luts_lab)),
            plain_ms=time_ms(torch, lambda: cg.clahe_apply_u8_nhwc_plain(lab, luts_lab), n=5),
            bound=bound(6 * n_px + table_bytes + 4 * cg.APPLY_TABLE_WORDS, INSTR_PER_PX['clahe_apply_u8_nhwc'] * n_px, PEAK_ISSUE_PER_S),
        ),
        "clahe_luma_apply_u8": dict(  # on NHWC, as both clahe_luma routes run it
            max_abs_err=e_k7,
            ms=time_ms(torch, lambda: cl.clahe_luma_apply_u8(x, y, luts)),
            plain_ms=time_ms(torch, lambda: cl.clahe_luma_apply_u8_plain(x, y, luts), n=5),
            bound=bound(7 * n_px + table_bytes + geo_bytes, INSTR_PER_PX["clahe_luma_apply_u8"] * n_px, PEAK_ISSUE_PER_S),
        ),
        "clahe_luma_apply_u8_fused": dict(
            max_abs_err=e_k7,
            ms=time_ms(torch, lambda: cl.clahe_luma_apply_u8_fused(xp, luts)),
            plain_ms=time_ms(torch, lambda: cl.clahe_luma_apply_u8_fused_plain(xp, luts), n=5),
            bound=bound(6 * n_px + table_bytes + geo_bytes, INSTR_PER_PX["clahe_luma_apply_u8_fused"] * n_px,
                        PEAK_ISSUE_PER_S),
        ),
    }
    for name, r in recs.items():
        print(
            f"  [{tag}] {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]})"
        )
    print(f"  [{tag}] K7 on planar RGB: {time_ms(torch, lambda: cl.clahe_luma_apply_u8(xp, y, luts)):.4f} ms")
    k2_bound = bound(n_px + table_bytes, n_px + K2_OPS_PER_ENTRY * table_bytes)
    print(f"  [{tag}] K2 clahe_tables on the luma plane: {time_ms(torch, lambda: cg.clahe_tables(y)):.4f} ms "
          f"(bound {k2_bound[0]:.4f} ms by {k2_bound[1]})")
    return recs


def fam_inputs(torch, fb, shape, seed: int) -> dict:
    """Seeded K4-K6 inputs on the card, scaled as tests/test_fused_blocks.py
    scales them (x >= 0, the FAM input being post-ReLU); K4's weights packed
    once, as the packed forward packs them, and the inputs of K4's second
    and last stages (y, z) from the plain stages before them."""
    from retinex_tpu_torch.ops.s2d import pack_pointwise

    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w, c = shape

    def n(*s, scale=1.0):
        return torch.randn(s, generator=g, device="cuda") * scale

    x = n(b, h, w, c, scale=0.3).abs()
    w1, w2 = n(c, c, scale=0.05), n(c, c, scale=0.05)
    wf = [n(c, c, scale=0.05) for _ in range(4)]
    k32, k42 = n(3, 3, c, c, scale=0.05), n(3, 3, c, c, scale=0.05)
    d = dict(
        x=x,
        ka=(w1 @ wf[0]).contiguous(),
        kb=(w2 @ wf[1]).contiguous(),
        k1=n(3, 3, c, 2 * c, scale=0.05),
        b1=n(2 * c, scale=0.1),
        k32=torch.einsum("uvio,op->uvip", k32, wf[2]).contiguous(),
        k42=torch.einsum("uvio,op->uvip", k42, wf[3]).contiguous(),
        bias_total=n(c, scale=0.1),
        ca_vec=torch.sigmoid(n(b, c // 4)).repeat(1, 4).contiguous(),
        sa=torch.sigmoid(n(b, h, w, 4)),
        wg=n(c, c, scale=0.05),
    )
    block = np.random.default_rng(seed).standard_normal((1, 1, c // 4, c // 4)) * 0.1
    d["wd"] = torch.as_tensor(pack_pointwise(block)[0, 0]).cuda()
    d["wd_packed"], d["wg_packed"] = fb.pack_tail_g1(d["wd"]), fb.pack_tail_g1(d["wg"])
    if not d["wd_packed"].diag or d["wg_packed"].diag:
        raise AssertionError("pack_tail_g1 took the quadrant-diagonal w for dense or the dense w for diagonal")
    d["k2"] = fb.stack_second_convs(d["k32"], d["k42"])
    d["packed"] = fb.pack_fam_conv(*(d[k] for k in ("ka", "kb", "k1", "b1", "k32", "k42", "bias_total")))
    d["y"] = fb.fam_conv_y_plain(x, d["k1"], d["b1"])
    d["z"] = fb.fam_conv_z_plain(d["y"], d["k2"], d["bias_total"])
    return d


# The inputs that carry the batch (sliced image by image in the batch holds).
FAM_PER_IMAGE = ("x", "ca_vec", "sa", "y", "z")


def fam_calls(fb, d: dict) -> dict:
    """{kernel name: (kernel, plain version, arguments)} on the inputs `d`;
    K4 and its stages read the weights packed once (``d["packed"]``, made
    from the weights that the plain versions take)."""
    conv_args = [d[k] for k in ("x", "ka", "kb", "k1", "b1", "k32", "k42", "bias_total")]
    p = d["packed"]
    return {
        "fam_conv_fused": (lambda *a: fb.fam_conv_fused(*a, packed=p), fb.fam_conv_fused_plain, conv_args),
        "fam_conv_y": (lambda x, *_: fb.fam_conv_y(x, p), fb.fam_conv_y_plain, [d["x"], d["k1"], d["b1"]]),
        "fam_conv_z": (lambda y, *_: fb.fam_conv_z(y, p), fb.fam_conv_z_plain, [d["y"], d["k2"], d["bias_total"]]),
        "fam_conv_out": (
            lambda z, x, *_: fb.fam_conv_out(z, x, p), fb.fam_conv_out_plain, [d["z"], d["x"], d["ka"], d["kb"]],
        ),
        "fam_tail_stats": (fb.fam_tail_stats, fb.fam_tail_stats_plain, [d["x"], d["ca_vec"]]),
        "fam_tail_apply_g1": (
            lambda *a: fb.fam_tail_apply_g1(*a, packed=d["wd_packed"]), fb.fam_tail_apply_g1_plain,
            [d["x"], d["ca_vec"], d["sa"], d["wd"]],
        ),
        "fam_tail_apply_g1_dense": (
            lambda *a: fb.fam_tail_apply_g1(*a, packed=d["wg_packed"]), fb.fam_tail_apply_g1_plain,
            [d["x"], d["ca_vec"], d["sa"], d["wg"]],
        ),
        "fam_tail_apply": (fb.fam_tail_apply, fb.fam_tail_apply_plain, [d["x"], d["ca_vec"], d["sa"]]),
    }


def fam_bounds(shape) -> dict:
    """The bound of each FAM kernel at `shape`: K4 and its stages count
    their own inputs and outputs (K4 as a whole: x in, out written, the
    weights once; y is no input of the function) and their FLOP."""
    b, h, w, c = shape
    n_px = b * h * w
    conv_ops = 2 * n_px * 9 * c * 2 * c  # one 3x3 convolution, 128 <-> 256
    w3 = 4 * 9 * c * 2 * c  # one 3x3 kernel, f32
    weight_bytes = 4 * (2 * c * c + 2 * c + c) + 2 * w3
    return {
        "fam_conv_fused": bound(2 * 4 * n_px * c + weight_bytes, 2 * conv_ops + 2 * n_px * 2 * c * c),
        "fam_conv_y": bound(4 * n_px * 3 * c + w3 + 4 * 2 * c, conv_ops),
        "fam_conv_z": bound(4 * n_px * 3 * c + w3 + 4 * c, conv_ops),
        "fam_conv_out": bound(3 * 4 * n_px * c + 4 * 2 * c * c, 2 * n_px * 2 * c * c),
        "fam_tail_stats": bound(4 * n_px * c + 4 * b * c + 4 * n_px * 8, K5_OPS_PER_PX * n_px),
        # The main path's K6 does the four [32 x 32] quadrant products only:
        # bytes-bound. A dense w needs all 128 x 128: operations-bound.
        "fam_tail_apply_g1": bound(
            4 * n_px * (c + 4 + c) + 4 * (b * c + c * c // 4), n_px * (2 * c + 2 * c * c // 4)
        ),
        "fam_tail_apply_g1_dense": bound(
            4 * n_px * (c + 4 + c) + 4 * (b * c + c * c), n_px * (2 * c + 2 * c * c)
        ),
        "fam_tail_apply": bound(4 * n_px * (c + 4 + c) + 4 * b * c, n_px * 2 * c),
    }


def fam_kernel_phase(torch, fb, shape, seed: int, timed: tuple = ()) -> dict:
    """Hold K4 (whole and by stage), K5, K6 and K11 to their plain versions
    at `shape`, and on a batch each kernel's first and last image to the
    kernel run on that image alone (identical: nothing couples the images
    of a batch). Return records: the error, and for the kernels in `timed`
    the median ms over 25 launches, the plain version's ms and the bound."""
    d = fam_inputs(torch, fb, shape, seed)
    calls = fam_calls(fb, d)
    b = shape[0]
    bounds = fam_bounds(shape)
    recs = {}
    for name, (kernel, plain, args) in calls.items():
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not np.isfinite(err) or err > FAM_TOL[name]:
            raise AssertionError(f"{name} disagrees with its plain version at {shape}: max |diff| {err:.3e}")
        line = f"  {list(shape)} {name}: max |diff| {err:.3e} (tolerance {FAM_TOL[name]:g})"
        for j in sorted({0, b - 1} if b > 1 else ()):
            alone = fam_calls(fb, {k: v[j : j + 1].contiguous() if k in FAM_PER_IMAGE else v for k, v in d.items()})
            if not torch.equal(alone[name][0](*alone[name][2]), got[j : j + 1]):
                raise AssertionError(f"{name} at {shape}: image {j} of the batch differs from the kernel on it alone")
        if b > 1:
            line += "; first and last image identical to the kernel on each alone"
        if name == "fam_tail_apply_g1":
            as_dense = fb.fam_tail_apply_g1(*args)  # unpacked: the dense instance
            if not torch.equal(as_dense, got):
                raise AssertionError(f"K6's dense instance differs from its quadrant-diagonal one on the same w at {shape}")
            line += "; the dense instance on the same w gives the same bits"
        recs[name] = dict(max_abs_err=err)
        if name in timed:
            ms = time_ms(torch, lambda: kernel(*args))
            plain_ms = time_ms(torch, lambda: plain(*args), n=5)
            recs[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=bounds[name])
            line += (
                f"; {ms:.4f} ms per launch (plain {plain_ms:.3f} ms, bound {bounds[name][0]:.4f} ms by "
                f"{bounds[name][1]}, {bounds[name][0] / ms:.1%} of it), launches per image 2"
            )
        print(line)
        del got, want
    return recs


def tail_g1_einsum(torch, x, ca_vec, sa, w):
    """K6's function, (x * ca * sa of the quadrant) @ w, as one torch.einsum
    call: K6's library time. The port never calls it."""
    b, h, wd, c = x.shape
    q = c // 4
    return torch.einsum(
        "bpqc,bqc,bpq,qcd->bpd", x.view(b, h * wd, 4, q), ca_vec.view(b, 4, q), sa.view(b, h * wd, 4),
        w.view(4, q, -1),
    ).view(b, h, wd, -1)


# The bf16 einsum of K6's function against the plain version: w rounded to
# bf16 moves each product by up to 2**-9 of itself, so a few bf16 ulps.
K6_BF16_LIBRARY_ULPS = 4


def k6_library_phase(torch, fb, bf16: bool = False) -> dict:
    """K6's library time per 1088x1920 image (the letterboxed shapes'
    launches summed): ``tail_g1_einsum`` on the quadrant-diagonal w and on
    the dense w, each first held to the plain version: in f32 on
    ``fam_inputs`` within K6's tolerance, with, as a yardstick,
    torch.matmul of the pre-scaled x by the dense w (cuBLAS on the product
    alone); with `bf16` on ``amp_inputs``, every operand of the einsum in
    bf16 (ca and w rounded to it once, outside the timed call), within
    K6_BF16_LIBRARY_ULPS bf16 ulps. TF32 off."""
    ms = {"diag": 0.0, "dense": 0.0} | ({} if bf16 else {"matmul": 0.0})
    for i, shape in enumerate(FAM_SHAPES):
        d = (amp_inputs if bf16 else fam_inputs)(torch, fb, shape, seed=2 + i)
        args = [d["x"], d["ca_vec"], d["sa"]]
        lib_args = [d["x"], d["ca_vec"].to(torch.bfloat16), d["sa"]] if bf16 else args
        for key, w in (("diag", d["wd"]), ("dense", d["wg"])):
            lw = w.to(torch.bfloat16) if bf16 else w
            want = fb.fam_tail_apply_g1_plain(*args, w).float()
            diff = (tail_g1_einsum(torch, *lib_args, lw).float() - want).abs()
            err = float(diff.max())
            if bf16:
                u = K6_BF16_LIBRARY_ULPS
                ok = np.isfinite(err) and float((diff - u * AMP_ULP * want.abs()).max()) <= u * AMP_ATOL
            else:
                ok = np.isfinite(err) and err <= FAM_TOL["fam_tail_apply_g1"]
            if not ok:
                raise AssertionError(f"K6's einsum ({key} w, bf16 {bf16}) disagrees with the plain version at {shape}: "
                                     f"{err:.3e}")
            ms[key] += time_ms(torch, lambda lw=lw: tail_g1_einsum(torch, *lib_args, lw))
        if not bf16:
            xs = fb.fam_tail_apply_plain(*args).reshape(-1, d["x"].shape[-1])
            ms["matmul"] += time_ms(torch, lambda: torch.matmul(xs, d["wg"]))
            del xs
        del d
    return ms


def run_cli(torch, modules, args, entry=None) -> tuple[dict[str, int], float]:
    """Drive the CLI (``cli.main``, or `entry`) once with every launch count
    at 0 just before; return the counts just after and the seconds."""
    from retinex_tpu_torch import cli

    for m in modules:
        m.reset_launches()
    t0 = time.perf_counter()
    (entry or cli.main)(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return launch_counts(modules), seconds


def launch_counts(modules) -> dict[str, int]:
    """Launches per wrapper, and per kernel where a module counts those too
    (K4's three stages; conv_pallas's three kernels; the FAM kernels' bf16
    instances)."""
    return {
        k: v for m in modules
        for counts in (m.LAUNCHES, getattr(m, "KERNEL_LAUNCHES", {}), getattr(m, "BF16_LAUNCHES", {}))
        for k, v in counts.items()
    }


def check_launches(launches: dict[str, int], want: dict[str, int], what: str) -> None:
    """Every counted kernel launched exactly as `want` says (0 where unnamed);
    each K4 call launches each of its three stages once, each K10 call each
    of its four, and each K6 call the quadrant-diagonal instance (the
    model's fusion folds)."""
    want = {
        **want, **{k: want.get("fam_conv_fused", 0) for k in K4_STAGES},
        **{k: want.get("dec1_chain", 0) for k in K10_STAGES},
        "fam_tail_apply_g1_diag": want.get("fam_tail_apply_g1", 0),
    }
    expected = {k: want.get(k, 0) for k in launches}
    if launches != expected:
        raise AssertionError(f"{what} launched {launches}, expected {expected}")


def check_pngs(out_dir: Path, stem: str, shape: tuple) -> np.ndarray:
    from PIL import Image

    pngs = [out_dir / f"{stem}_{k}.png" for k in ("enhanced", "illumination", "comparison")]
    for p in pngs:
        if not p.is_file():
            raise AssertionError(f"missing output {p}")
    got = np.asarray(Image.open(pngs[0]).convert("RGB"))
    if got.shape != shape:
        raise AssertionError(f"enhanced PNG has shape {got.shape}, expected {shape}")
    return got


def hold_to_cpu(
    torch, got: np.ndarray, photo: Path, max_size: int | None, packed: bool, preact_aspp: bool = False,
    checkpoint: str = "", use_amp: bool = False,
) -> None:
    """The card's enhanced PNG against the port's CPU run on the same
    weights (seeded, or `checkpoint`'s) and input, stage by stage:

    1. the net's three outputs on the card against the CPU's, within
       CPU_NET_TOL;
    2. what follows the net (Lab-CLAHE, on K1-K3 on every frame shape,
       and quantisation) on the card's net output, run on the card against
       the CPU's plain versions on the same floats: byte-identical;
    3. the PNG against the CPU run end to end: mean under 0.05 levels.

    The end-to-end maximum is printed, not bounded: a net difference of one
    f32 ulp at a .5 tie moves Lab-CLAHE's u8 rounding by a level, which its
    mapping can spread to a few (ROADMAP Queue 3, F2).

    `use_amp`: the bf16 net (phase 21), its outputs within AMP_NET_TOL of
    the CPU's bf16 run; the end-to-end difference is printed, not bounded
    (a one-ulp bf16 flip moves the net's output by up to a level)."""
    import dataclasses

    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.adaptive_params import AdaptiveParameterAdjuster
    from retinex_tpu_torch.infer.enhance import enhance_single_image, load_image

    config = Config(mode="enhance", packed_inference=packed, device="cpu", use_preact=preact_aspp, use_aspp=preact_aspp,
                    checkpoint=checkpoint, use_amp=use_amp)
    cpu_apply = cli.build_apply_fn(config, torch.device("cpu"))
    t0 = time.perf_counter()
    enh_cpu, _, _ = enhance_single_image(
        cpu_apply, str(photo), "", max_size=max_size, save_outputs=False, device="cpu"
    )
    cpu_s = time.perf_counter() - t0
    if not np.isfinite(enh_cpu.numpy()).all():
        raise AssertionError("non-finite values in the CPU run")
    want = (np.clip(enh_cpu.numpy(), 0.0, 1.0) * 255).astype(np.uint8)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    route = ("bf16 " if use_amp else "") + ("packed" if packed else "standard")
    size = "with no --max_size" if max_size is None else f"at --max_size {max_size}"
    print(
        f"  {route} route {size}, card vs the CPU run ({cpu_s:.1f} s): max {int(d.max())} levels, "
        f"mean {float(d.mean()):.5f} levels (tolerance {'none, printed' if use_amp else 0.05}), "
        f"{float((d > 0).mean()):.2e} of bytes differ"
    )

    img, _ = load_image(str(photo), max_size)
    x = torch.from_numpy(img)[None]
    card_apply = cli.build_apply_fn(dataclasses.replace(config, device="cuda"), torch.device("cuda"))
    net_card = card_apply(x.cuda())
    net_cpu = cpu_apply(x)
    errs = {n: float((a.cpu().float() - b.float()).abs().max()) for n, a, b in zip(PACKED_TOL, net_card, net_cpu)}
    tols = AMP_NET_TOL if use_amp else dict.fromkeys(PACKED_TOL, CPU_NET_TOL)
    on_cpu = tuple(o.cpu() for o in net_card)
    post_card, post_cpu = (
        (np.clip(e[0].cpu().numpy(), 0.0, 1.0) * 255).astype(np.uint8)
        for e, _ in (
            AdaptiveParameterAdjuster().apply_adaptive_enhancement(lambda _t, o=outs: o, xx)
            for outs, xx in ((net_card, x.cuda()), (on_cpu, x))
        )
    )
    stage = int(np.abs(post_card.astype(np.int16) - post_cpu.astype(np.int16)).max())
    rerun = int(np.abs(post_card.astype(np.int16) - got.astype(np.int16)).max())
    print(
        f"  {route} route, the nets card vs CPU: max |diff| "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + " (tolerance " + ", ".join(f"{t:g}" for t in tols.values()) + "); Lab-CLAHE + quantisation of the card's "
        f"net output, card vs CPU: max {stage} levels (tolerance 0); the CLI's PNG vs this rerun on the card: max "
        f"{rerun} levels"
    )
    if any(errs[n] > tols[n] for n in errs):
        raise AssertionError(f"the card's net ({route} route) disagrees with the CPU's")
    if stage != 0:
        raise AssertionError(f"Lab-CLAHE on the card ({route} route) differs from the CPU's on the same net output")
    if not (use_amp or d.mean() < 0.05):
        raise AssertionError(f"the card's enhanced output ({route} route) disagrees with the CPU run")


def hold_stage_to_cpu(torch, photo: Path, max_size: int | None) -> None:
    """What follows the net (Lab-CLAHE, then quantisation), run on the card
    on the card's packed net output for the CLI's input at `max_size`,
    against the same on the CPU on the same floats: byte-identical (stage 2
    of ``hold_to_cpu``, without the CPU's net)."""
    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.adaptive_params import AdaptiveParameterAdjuster
    from retinex_tpu_torch.infer.enhance import load_image

    img, _ = load_image(str(photo), max_size)
    x = torch.from_numpy(img)[None]
    outs = cli.build_apply_fn(Config(mode="enhance"), torch.device("cuda"))(x.cuda())
    on_cpu = tuple(o.cpu() for o in outs)
    post_card, post_cpu = (
        (np.clip(e[0].cpu().numpy(), 0.0, 1.0) * 255).astype(np.uint8)
        for e, _ in (
            AdaptiveParameterAdjuster().apply_adaptive_enhancement(lambda _t, o=o: o, xx)
            for o, xx in ((outs, x.cuda()), (on_cpu, x))
        )
    )
    d = np.abs(post_card.astype(np.int16) - post_cpu.astype(np.int16))
    print(f"  Lab-CLAHE + quantisation of the card's net output at {tuple(img.shape[:2])}, card vs CPU: max "
          f"{int(d.max())} levels, {int((d > 0).sum())} bytes differ (tolerance 0)")
    if d.max() != 0:
        raise AssertionError(f"Lab-CLAHE on the card differs from the CPU's at {tuple(img.shape[:2])}")


def standard_phase(torch, modules, photo: Path, workdir: Path) -> dict[str, int]:
    """Phase 4: the --no-packed_inference route through the CLI."""
    out_dir = workdir / "out_standard"
    args = [
        "--mode", "enhance", "--input_path", str(photo), "--output_dir", str(out_dir),
        "--max_size", "1920", "--no-packed_inference", "--device", "cuda",
    ]
    launches, cold_s = run_cli(torch, modules, args)
    print(f"  CLI run (cold, includes model build): {cold_s:.3f} s; kernel launches {launches}")
    check_launches(launches, LAB_CLAHE_ONCE, "the standard route")
    got = check_pngs(out_dir, photo.stem, (1088, 1920, 3))
    hold_to_cpu(torch, got, photo, 1920, packed=False)
    return launches


def packed_phase(torch, modules, photo: Path, small: Path, workdir: Path) -> dict[str, int]:
    """Phase 5: the default (packed) route through the CLI."""
    out_dir = workdir / "out_packed"
    args = [
        "--mode", "enhance", "--input_path", str(photo), "--output_dir", str(out_dir),
        "--max_size", "1920", "--device", "cuda",
    ]
    launches, cold_s = run_cli(torch, modules, args)
    print(f"  CLI run (cold, includes model build): {cold_s:.3f} s; kernel launches {launches}")
    want = {**LAB_CLAHE_ONCE, "fam_conv_fused": 2, "fam_tail_stats": 2, "fam_tail_apply_g1": 2, "fam_tail_apply": 0}
    check_launches(launches, want, "the default route")
    check_pngs(out_dir, photo.stem, (1088, 1920, 3))

    hold_packed_to_standard(torch, photo, 1920)

    # The card against the port's CPU packed route, at a small letterbox.
    out_small = workdir / "out_packed_512"
    launches_small, _ = run_cli(torch, modules, [
        "--mode", "enhance", "--input_path", str(small), "--output_dir", str(out_small),
        "--max_size", "512", "--device", "cuda",
    ])
    check_launches(launches_small, {**want, "fam_tail_apply": 0}, "the default route at --max_size 512")
    got = check_pngs(out_small, small.stem, (288, 512, 3))
    hold_to_cpu(torch, got, small, 512, packed=True)
    return launches


def hold_packed_to_standard(torch, photo: Path, max_size: int | None) -> None:
    """The packed forward against the standard one, both on the card, on the
    CLI's input for `max_size`."""
    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.enhance import load_image

    img, _ = load_image(str(photo), max_size)
    x = torch.from_numpy(img).to("cuda")[None]
    std = cli.build_apply_fn(Config(mode="enhance", packed_inference=False), torch.device("cuda"))(x)
    pk = cli.build_apply_fn(Config(mode="enhance"), torch.device("cuda"))(x)
    torch.cuda.synchronize()
    for (name, tol), a, b in zip(PACKED_TOL.items(), pk, std):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"packed {name}: shape {tuple(a.shape)} vs {tuple(b.shape)}, or non-finite")
        err = float((a - b).abs().max())
        print(f"  packed vs standard forward on the card, {name} {tuple(a.shape)}: max |diff| {err:.3e} (tolerance {tol:g})")
        if err > tol:
            raise AssertionError(f"the packed forward's {name} disagrees with the standard forward")


def flagless_phase(torch, modules, photo: Path, small: Path, workdir: Path) -> dict[str, int]:
    """Phase 7: the headline command with no flags (no letterbox)."""
    want = {"fam_conv_fused": 2, "fam_tail_stats": 2, "fam_tail_apply_g1": 0, "fam_tail_apply": 2, **LAB_CLAHE_TILES_ONCE}
    out_dir = workdir / "out_flagless"
    args = ["--mode", "enhance", "--input_path", str(photo), "--output_dir", str(out_dir), "--device", "cuda"]
    launches, cold_s = run_cli(torch, modules, args)
    print(f"  CLI run (cold, includes model build): {cold_s:.3f} s; kernel launches {launches}")
    check_launches(launches, want, "the flagless route")
    check_pngs(out_dir, photo.stem, (1080, 1920, 3))
    hold_packed_to_standard(torch, photo, None)
    hold_stage_to_cpu(torch, photo, None)

    # The card against the port's CPU run, on a small frame that does not fold.
    out_small = workdir / "out_flagless_small"
    launches_small, _ = run_cli(torch, modules, [
        "--mode", "enhance", "--input_path", str(small), "--output_dir", str(out_small), "--device", "cuda",
    ])
    check_launches(launches_small, want, "the flagless route at 264x480")
    got = check_pngs(out_small, small.stem, (264, 480, 3))
    hold_to_cpu(torch, got, small, None, packed=True)
    return launches


DIR_MODES = {  # mode: (CLI flags, the kernels it launches and how often)
    "net": ([], {"lab_fwd_f32_nhwc": 3, "clahe_tables": 3, "clahe_apply_f32_nhwc": 3,
                 "fam_conv_fused": 6, "fam_tail_stats": 6, "fam_tail_apply_g1": 6}),
    "clahe": (["--classical_mode", "clahe"], {"lab_fwd_u8_nhwc": 3, "clahe_tables": 3, "clahe_apply_u8_nhwc": 3}),
    "clahe_luma": (["--classical_mode", "clahe_luma"], {"clahe_tables": 3, "clahe_luma_apply_u8": 3}),
}


def make_directory(src_dir: Path, workdir: Path) -> Path:
    """12 photos upscaled to 1920x1080 and 4 of the 640x640 originals."""
    from PIL import Image

    d = workdir / "photos"
    d.mkdir()
    for i in range(16):
        name = f"lowlight_{i:03d}.png"
        with Image.open(src_dir / name) as im:
            im = im.convert("RGB")
            (im.resize((1920, 1080), Image.BILINEAR) if i < 12 else im).save(d / name)
    return d


def directory_phase(torch, modules, photos: Path, workdir: Path) -> dict[str, int]:
    """Phase 8: directory enhance through the CLI in three modes, the fused
    luma entry on the same chunks, single-image holds and batch-8 times."""
    from PIL import Image

    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.batch_driver import bucket_by_canvas, decode_bucket
    from retinex_tpu_torch.infer.enhance import enhance_batch_images, enhance_single_image
    from retinex_tpu_torch.ops.clahe_gather import clahe_rgb_u8_planar_gather
    from retinex_tpu_torch.ops.clahe_luma import clahe_luma_rgb_u8_planar

    files = sorted(str(p) for p in photos.iterdir())
    total: dict[str, int] = {}
    apply = cli.build_apply_fn(Config(mode="enhance"), torch.device("cuda"))
    for mode, (flags, want) in DIR_MODES.items():
        out_dir = workdir / f"dir_{mode}"
        torch.cuda.reset_peak_memory_stats()
        launches, cold_s = run_cli(torch, modules, [
            "--mode", "enhance", "--input_path", str(photos), "--output_dir", str(out_dir),
            "--max_size", "1920", "--batch_size", "8", "--num_workers", "8", "--device", "cuda", *flags,
        ])
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        print(f"  {mode}: CLI run (cold) {cold_s:.3f} s, peak device memory {peak_gb:.3f} GiB; launches {launches}")
        check_launches(launches, want, f"the directory run in {mode} mode")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        if len(list(out_dir.iterdir())) != 3 * len(files):
            raise AssertionError(f"{mode}: {len(list(out_dir.iterdir()))} PNGs, expected {3 * len(files)}")

        # The batch's enhanced PNGs against single-image runs on the card:
        # the CLAHE modes byte for byte; the net's are read here and held
        # stage by stage in net_batch_holds.
        worst, frac = 0, 0.0
        knobs = dict(classical_mode=None if mode == "net" else mode, save_outputs=False, device="cuda", max_size=1920)
        for f in files:
            enh, _, _ = enhance_single_image(apply if mode == "net" else None, f, "", **knobs)
            single = np.clip(enh.cpu().numpy(), 0.0, 1.0) * 255
            got = np.asarray(Image.open(out_dir / f"{Path(f).stem}_enhanced.png").convert("RGB")).astype(np.int16)
            d = np.abs(got - single.astype(np.uint8).astype(np.int16))
            worst, frac = max(worst, int(d.max())), max(frac, float((d > 0).mean()))
        print(f"  {mode}: batch vs single-image runs on the card: max {worst} level(s), at most {frac:.2e} of an image's bytes differ")
        if mode != "net" and worst != 0:
            raise AssertionError(f"{mode}: the batch's PNGs differ from the single-image runs")
        if mode == "net":
            net_batch_holds(torch, apply, files, out_dir)

        # Warm images/s over the directory, with and without the PNG writes.
        for save in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enhance_batch_images(
                apply if mode == "net" else None, str(photos), str(workdir / f"dir_{mode}_warm"), max_size=1920,
                classical_mode=knobs["classical_mode"], batch_size=8, num_workers=8, save_outputs=save, device="cuda",
            )
            sec = time.perf_counter() - t0
            what = "with PNG writes" if save else "without PNG writes"
            print(f"  {mode}: warm directory, {what}: {sec:.3f} s for {len(files)} images, {len(files) / sec:.3f} images/s")

    # The fused luma entry (K9) on the same chunks: bytes equal clahe_luma's.
    for m in modules:
        m.reset_launches()
    for (target, out_h, out_w), paths in bucket_by_canvas(files, 1920).items():
        for i in range(0, len(paths), 8):
            chunk = paths[i : i + 8]
            x = torch.from_numpy(decode_bucket(chunk, target, out_h, out_w)).to("cuda")
            out = clahe_luma_rgb_u8_planar(x.permute(0, 3, 1, 2).contiguous(), fuse_luma=True)
            out = out.permute(0, 2, 3, 1).cpu().numpy()
            for j, f in enumerate(chunk):
                want = np.asarray(Image.open(workdir / "dir_clahe_luma" / f"{Path(f).stem}_enhanced.png").convert("RGB"))
                if not np.array_equal(out[j], want):
                    raise AssertionError(f"the fused luma entry differs from the clahe_luma directory run on {f}")
    fused = launch_counts(modules)
    check_launches(fused, {"clahe_tables": 3, "clahe_luma_apply_u8_fused": 3}, "the fused luma entry")
    print(f"  fused luma entry on the 3 chunks: launches {fused}; bytes equal the clahe_luma PNGs")
    total = {k: total[k] + v for k, v in fused.items()}

    # The planar u8 entry (K1, K2, K3 in their u8 instances) on the same
    # chunks: bytes equal the clahe mode's PNGs (K8 runs K1's and K3's bodies).
    for m in modules:
        m.reset_launches()
    for (target, out_h, out_w), paths in bucket_by_canvas(files, 1920).items():
        for i in range(0, len(paths), 8):
            chunk = paths[i : i + 8]
            x = torch.from_numpy(decode_bucket(chunk, target, out_h, out_w)).to("cuda")
            out = clahe_rgb_u8_planar_gather(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1).cpu().numpy()
            for j, f in enumerate(chunk):
                want = np.asarray(Image.open(workdir / "dir_clahe" / f"{Path(f).stem}_enhanced.png").convert("RGB"))
                if not np.array_equal(out[j], want):
                    raise AssertionError(f"the planar u8 entry differs from the clahe directory run on {f}")
    planar = launch_counts(modules)
    check_launches(planar, {"lab_fwd_u8": 3, "clahe_tables": 3, "clahe_apply_u8": 3}, "the planar u8 entry")
    print(f"  planar u8 Lab-CLAHE entry on the 3 chunks: launches {planar}; bytes equal the clahe PNGs")
    total = {k: total[k] + v for k, v in planar.items()}

    # The packed and the standard net at batch 8 on the first chunk, warm,
    # in turns: whether packing pays at batch 8.
    (target, out_h, out_w), paths = next(iter(bucket_by_canvas(files, 1920).items()))
    x8 = torch.from_numpy(decode_bucket(paths[:8], target, out_h, out_w)).to("cuda").float() / 255.0
    nets = {"packed": apply, "standard": cli.build_apply_fn(Config(mode="enhance", packed_inference=False), torch.device("cuda"))}
    times = {name: [] for name in nets}
    for i in range(8):
        for name in list(nets)[i % 2 :] + list(nets)[: i % 2]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nets[name](x8)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    med = {name: statistics.median(t[2:]) / 8 for name, t in times.items()}  # the first two runs warm up
    print(f"  packed net at batch 8, {out_h}x{out_w}: {med['packed']:.3f} ms per image (warm median); standard net "
          f"{med['standard']:.3f} ms per image; packed / standard {med['packed'] / med['standard']:.4f}")
    return total


def net_batch_holds(torch, apply, files: list[str], png_dir: Path) -> None:
    """The net's directory route against single images, stage by stage, on
    each chunk of the directory (``--max_size 1920 --batch_size 8``):

    1. the packed forward on the batch against the packed forward on each
       image alone, and against the standard forward (plain cuDNN, no FAM
       kernel) on the same batch, within PACKED_TOL;
    2. what follows the net (Lab-CLAHE on K1-K3, quantisation) on the
       batch's own net output against the same stage on each image alone:
       byte-identical.

    So the PNGs of a batch and of single images differ only where the net's
    floats do. K1-K6 on a batch equal the kernels on each image alone (phases
    2 and 4); the standard forward's batch-vs-single readings printed here
    show what cuDNN's choice of algorithm by batch size does without them."""
    from PIL import Image

    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.adaptive_params import AdaptiveParameterAdjuster
    from retinex_tpu_torch.infer.batch_driver import bucket_by_canvas, decode_bucket
    from retinex_tpu_torch.infer.enhance import make_batch_pipeline

    standard = cli.build_apply_fn(Config(mode="enhance", packed_inference=False), torch.device("cuda"))
    names = tuple(PACKED_TOL)
    worst = {k: {n: 0.0 for n in names} for k in ("packed", "standard", "packed vs standard")}
    png_worst = 0
    seen = []

    def packed_seen(t):  # the packed forward, keeping what it returned
        seen.append(apply(t))
        return seen[-1]

    for (target, out_h, out_w), paths in bucket_by_canvas(files, 1920).items():
        for i in range(0, len(paths), 8):
            chunk = paths[i : i + 8]
            x_u8 = torch.from_numpy(decode_bucket(chunk, target, out_h, out_w)).to("cuda")
            x = x_u8.float() / 255.0
            seen.clear()
            batch_u8, _ = make_batch_pipeline(packed_seen)(x_u8)
            packed_b = seen[-1]
            std_b = standard(x)
            for n, a, s in zip(names, packed_b, std_b):
                worst["packed vs standard"][n] = max(worst["packed vs standard"][n], float((a - s).abs().max()))
            for j, f in enumerate(chunk):
                xj = x[j : j + 1]
                for key, fn, batch_out in (("packed", apply, packed_b), ("standard", standard, std_b)):
                    for n, a, b in zip(names, fn(xj), batch_out):
                        worst[key][n] = max(worst[key][n], float((a[0] - b[j]).abs().max()))
                own = tuple(o[j : j + 1] for o in packed_b)
                enh_j, _ = AdaptiveParameterAdjuster().apply_adaptive_enhancement(lambda _t: own, xj)
                alone = (np.clip(enh_j[0].cpu().numpy(), 0.0, 1.0) * 255).astype(np.uint8)
                if not np.array_equal(alone, batch_u8[j].cpu().numpy()):
                    raise AssertionError(f"net: Lab-CLAHE on the batch's net output differs from it on image {j} alone")
                png = np.asarray(Image.open(png_dir / f"{Path(f).stem}_enhanced.png").convert("RGB"))
                png_worst = max(png_worst, int(np.abs(png.astype(np.int16) - alone.astype(np.int16)).max()))
    what = {
        "packed": "packed forward, batch vs each image alone",
        "standard": "standard forward (cuDNN only), batch vs each image alone",
        "packed vs standard": "packed vs standard forward on the same batch",
    }
    for key, errs in worst.items():
        print(f"  net, {what[key]}: max |diff| " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    print(
        "  net: Lab-CLAHE + quantisation on the batch's net output identical to it on each image alone; "
        f"the CLI's PNGs vs this rerun: max {png_worst} level(s)"
    )
    for key in ("packed", "packed vs standard"):
        for n, tol in PACKED_TOL.items():
            if worst[key][n] > tol:
                raise AssertionError(f"net, {what[key]}, {n}: max |diff| {worst[key][n]:.3e} > {tol:g}")


FAM_TWICE = {"fam_conv_fused": 2, "fam_tail_stats": 2, "fam_tail_apply_g1": 2}
SINGLE_ROUTES = {  # route: (CLI flags, --max_size, the kernels it launches and how often)
    "ssr": (["--classical_mode", "ssr"], 512, {}),
    "msr": (["--classical_mode", "msr"], 512, {}),
    "msrcr": (["--classical_mode", "msrcr"], 512, {}),
    "content_aware": (["--content_aware"], 512, FAM_TWICE),
    "multi_scale": (["--multi_scale"], 512, FAM_TWICE),
    "clahe": (["--classical_mode", "clahe"], 1920, LAB_CLAHE_ONCE),
    "clahe_luma": (["--classical_mode", "clahe_luma"], 1920, {"clahe_tables": 1, "clahe_luma_apply_u8": 1}),
}


def single_routes_phase(torch, modules, photo: Path, small: Path, workdir: Path) -> None:
    """Phase 9: the other single-image routes through the CLI on the card,
    each with its launch counts, held to the port's CPU run."""
    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.enhance import enhance_single_image

    cpu_apply = cli.build_apply_fn(Config(mode="enhance", device="cpu"), torch.device("cpu"))
    card_apply = cli.build_apply_fn(Config(mode="enhance"), torch.device("cuda"))
    for route, (flags, max_size, want) in SINGLE_ROUTES.items():
        image = small if max_size == 512 else photo
        out_dir = workdir / f"single_{route}"
        launches, cold_s = run_cli(torch, modules, [
            "--mode", "enhance", "--input_path", str(image), "--output_dir", str(out_dir),
            "--max_size", str(max_size), "--device", "cuda", *flags,
        ])
        check_launches(launches, want, f"the single-image {route} route")
        got = check_pngs(out_dir, image.stem, (288, 512, 3) if max_size == 512 else (1088, 1920, 3))
        classical = flags[0] == "--classical_mode"
        knobs = dict(classical_mode=flags[1]) if classical else {f"enable_{route}": True}
        enh_cpu, _, _ = enhance_single_image(
            None if classical else cpu_apply, str(image), "", max_size=max_size, save_outputs=False, device="cpu", **knobs
        )
        enh_card, _, _ = enhance_single_image(
            None if classical else card_apply, str(image), "", max_size=max_size, save_outputs=False, device="cuda", **knobs
        )
        if not np.isfinite(enh_cpu.numpy()).all() or not torch.isfinite(enh_card).all():
            raise AssertionError(f"{route}: non-finite output")
        err = float((enh_card.cpu() - enh_cpu).abs().max())
        d = np.abs(got.astype(np.int16) - (np.clip(enh_cpu.numpy(), 0.0, 1.0) * 255).astype(np.uint8).astype(np.int16))
        device_ms = [enhance_single_image(
            None if classical else card_apply, str(photo), "", max_size=1920, save_outputs=False, device="cuda", **knobs
        )[2] * 1e3 for _ in range(3)]
        print(
            f"  {route}: CLI {cold_s:.3f} s (cold), launches {launches}; card vs CPU at {got.shape[0]}x{got.shape[1]}: "
            f"max |diff| {err:.3e}, PNG max {int(d.max())} levels, mean {float(d.mean()):.5f}; "
            f"warm device ms at 1088x1920 {statistics.median(device_ms[1:]):.3f}"
        )
        if route == "clahe_luma" and d.max() != 0:  # K2 and K7 are exact against their plain versions
            raise AssertionError("clahe_luma: the card's PNG differs from the CPU run")
        if route in ("ssr", "msr", "msrcr") and err > 1e-4:
            raise AssertionError(f"{route}: the card disagrees with the CPU run")
        if route not in ("ssr", "msr", "msrcr") and (d.max() > 3 or d.mean() >= 0.05):
            raise AssertionError(f"{route}: the card's enhanced output disagrees with the CPU run")


def warm_phase(torch, modules, photo: Path, workdir: Path) -> dict[str, dict[str, float]]:
    """Phase 10: warm per-image times of the standard and the packed route at
    --max_size 1920 and of the flagless route, in turns; Lab-CLAHE's
    launches over the phase (K1's float instance twice a turn on every
    route, K2 and K3 in their float instances on the 1088x1920 routes and in
    their tile modes on the flagless one; the u8 planar instances never);
    each route's host share, its end to end less its net and Lab-CLAHE
    medians."""
    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.enhance import enhance_single_image, load_image
    from retinex_tpu_torch.ops.clahe import clahe_lab_rgb

    standard = cli.build_apply_fn(Config(mode="enhance", packed_inference=False), torch.device("cuda"))
    packed = cli.build_apply_fn(Config(mode="enhance"), torch.device("cuda"))
    routes = {  # name: (apply, --max_size)
        "standard at 1088x1920": (standard, 1920),
        "packed at 1088x1920": (packed, 1920),
        "flagless packed at 1080x1920": (packed, None),
    }
    imgs = {m: load_image(str(photo), m)[0] for m in (1920, None)}
    names = list(routes)
    times = {r: {"net": [], "clahe": [], "e2e": []} for r in routes}
    for m in modules:
        m.reset_launches()
    for i in range(6):
        for route in names[i % 3:] + names[: i % 3]:
            fn, max_size = routes[route]
            x = torch.from_numpy(imgs[max_size]).to("cuda")[None]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enh, _, _ = fn(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            clahe_lab_rgb(torch.clamp(enh, 0.0, 1.0))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            enhance_single_image(fn, str(photo), str(workdir / f"out_warm_{i}"), max_size=max_size, device="cuda")
            t3 = time.perf_counter()
            times[route]["net"].append((t1 - t0) * 1e3)
            times[route]["clahe"].append((t2 - t1) * 1e3)
            times[route]["e2e"].append((t3 - t2) * 1e3)
    counts = launch_counts(modules)
    lab_clahe = {k: counts[k] for k in ("lab_fwd_u8", "lab_fwd_f32_nhwc", "clahe_tables", "clahe_apply_u8",
                                        "clahe_apply_f32_nhwc", "clahe_tables_tiles", "clahe_apply_tiles_f32_nhwc")}
    turns = 6 * 2  # six turns, two Lab-CLAHE calls a route each
    want = {"lab_fwd_u8": 0, "lab_fwd_f32_nhwc": 3 * turns, "clahe_tables": 2 * turns, "clahe_apply_u8": 0,
            "clahe_apply_f32_nhwc": 2 * turns, "clahe_tables_tiles": turns, "clahe_apply_tiles_f32_nhwc": turns}
    if lab_clahe != want:
        raise AssertionError(f"the warm runs launched {lab_clahe}, expected {want}: the float instances on every "
                             "route, K2 and K3 in their tile modes on the flagless one")
    print(f"  Lab-CLAHE launches over the warm runs: {lab_clahe}")
    med = {r: {k: statistics.median(v[1:]) for k, v in t.items()} for r, t in times.items()}  # first run warms up
    for route, m in med.items():
        print(
            f"  warm per image, {route}: net {m['net']:.3f} ms, Lab-CLAHE {m['clahe']:.3f} ms, "
            f"end to end (decode to 3 PNGs written) {m['e2e']:.3f} ms, of which host (end to end minus net and "
            f"Lab-CLAHE) {m['e2e'] - m['net'] - m['clahe']:.3f} ms"
        )
    print(f"  packed net / standard net at 1088x1920: {med[names[1]]['net'] / med[names[0]]['net']:.4f}")
    return med


# The two bf16 FAM kernels that run on the tensor cores (fam_conv_out's and
# the quadrant-diagonal K6's), by the profiler's kernel names: phase 21
# prints their share of the bf16 packed forward.
TENSOR_CORE_FAM = ("fam_conv_out_mma_kernel", "fam_tail_apply_g1_mma_kernel")


def profile_phase(torch, photo: Path, amp: bool = False, checkpoint: str | None = None) -> None:
    """Phase 11: device time by kernel over 3 warm forwards of each route
    (torch.profiler) at batch 1, and the device's busy share of the
    forwards' wall time. With `amp` (phase 21) the bf16 packed forward
    alone, from `checkpoint`, and the share of its device time that the
    two tensor-core FAM kernels (``TENSOR_CORE_FAM``) take."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.enhance import load_image

    img, _ = load_image(str(photo), 1920)
    x = torch.from_numpy(img).to("cuda")[None]
    n = 3
    for packed in (True,) if amp else (False, True):
        cfg = Config(mode="enhance", packed_inference=packed, use_amp=amp)
        fn = cli.build_apply_fn(cfg if checkpoint is None else dataclasses.replace(cfg, checkpoint=checkpoint),
                                torch.device("cuda"))
        for _ in range(2):
            fn(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            raise AssertionError("the profiler recorded no device time")
        device_ms = sum(e.self_device_time_total for e in kernels) / n / 1e3
        route = ("bf16 " if amp else "") + ("packed" if packed else "standard")
        print(
            f"  {route} forward: {device_ms:.3f} device ms of {wall_ms:.3f} wall ms per forward "
            f"(device busy {device_ms / wall_ms:.3f}); top kernels, device ms per forward:"
        )
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.self_device_time_total / n / 1e3:9.3f}  x{e.count // n:<4d} {e.key[:90]}")
        own = [e for e in kernels if any(k in e.key for k in ("fam_", "conv_pipelined", "conv_wgmma"))]
        if packed and not any("fam_tail_apply_g1" in e.key for e in own):
            raise AssertionError("the packed forward's profile shows no K6 launch")
        print(f"  the port's kernels in the {route} forward, device ms per forward:{'' if own else ' none'}")
        for e in sorted(own, key=lambda e: -e.self_device_time_total):
            print(f"    {e.self_device_time_total / n / 1e3:9.4f}  x{e.count // n:<4d} {e.key[:90]}")
        if amp:
            tc = {k: sum(e.self_device_time_total for e in own if k in e.key) / n / 1e3 for k in TENSOR_CORE_FAM}
            if not all(tc.values()):
                raise AssertionError(f"the bf16 packed forward's profile lacks a tensor-core FAM kernel: {tc}")
            print("  of which the tensor-core FAM kernels: " + ", ".join(f"{k} {v:.4f} ms" for k, v in tc.items())
                  + f", together {sum(tc.values()):.4f} ms, {sum(tc.values()) / device_ms:.1%} of the device time")


def conv_library(torch, x, k, b, relu: bool = True, residual=None, groups: int = 1):
    """One F.conv2d call (+ ReLU, + residual) computing a stage of K10 or
    K12 on NHWC x with HWIO k ('SAME' padding), the layouts made once
    outside the returned call, whose result is a channels-last NCHW view."""
    import torch.nn.functional as F

    xc = x.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
    wl = k.to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bl, pad = b.to(x.dtype), k.shape[0] // 2
    rc = None if residual is None else residual.permute(0, 3, 1, 2)

    def call():
        out = F.conv2d(xc, wl, bl, padding=pad, groups=groups)
        out = torch.relu(out) if relu else out
        return out if rc is None else out + rc

    return call


def dec1_inputs(torch, shape, seed: int) -> list:
    """Seeded K10 arguments on the card, scaled as
    tests/test_fused_blocks.py:51-57 scales them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w = shape

    def n(*s, scale=1.0):
        return torch.randn(s, generator=g, device="cuda") * scale

    args = [n(b, h, w, 64, scale=0.3), n(b, h, w, 128, scale=0.3).abs(), n(1, 1, 64, 128, scale=0.1), n(128, scale=0.1)]
    for _ in range(3):
        args += [n(3, 3, 128, 128, scale=0.05), n(128, scale=0.1)]
    return args


def dec1_kernel_phase(torch, fb, shape, seed: int, timed: bool = False) -> dict:
    """Phase 12: hold K10 (its weights packed once) to its plain version at
    `shape` ([b, h, w] of d2), one call's launches by stage, each stage to
    its plain version on the plain previous stage's output, and on a batch
    its first and last image to K10 on each alone; with `timed`, the median
    ms over 25 launches of K10 and of each stage, the plain versions' and
    the bounds. Returns {kernel or stage: record}."""
    args = dec1_inputs(torch, shape, seed)
    d2, x1p, *weights = args
    k_up, b_up, k_c1, b_c1, k_c2, b_c2, k_rc, b_rc = weights
    b, h, w = shape
    p = fb.pack_dec1_chain(*weights)
    fb.reset_launches()
    got = fb.dec1_chain(*args, packed=p)
    torch.cuda.synchronize()
    ran = {k: v for k, v in fb.KERNEL_LAUNCHES.items() if v}
    if ran != {k: 1 for k in K10_STAGES} or fb.LAUNCHES["dec1_chain"] != 1:
        raise AssertionError(f"one dec1_chain call at {shape} launched {ran}, expected each of {list(K10_STAGES)} once")
    err = float((got - fb.dec1_chain_plain(*args)).abs().max())
    if not np.isfinite(err) or err > DEC1_TOL:
        raise AssertionError(f"dec1_chain disagrees with its plain version at {shape}: max |diff| {err:.3e}")
    line = f"  {list(shape)} dec1_chain: max |diff| {err:.3e} (tolerance {DEC1_TOL:g}); one call: {ran}"
    y1 = fb.dec1_up_plain(d2, k_up, b_up)
    y2 = fb.dec1_conv_plain(y1, k_c1, b_c1)
    y3 = fb.dec1_conv_plain(y2, k_c2, b_c2, x1p)
    calls = {
        "dec1_up": (lambda: fb.dec1_up(d2, p), lambda: fb.dec1_up_plain(d2, k_up, b_up)),
        "dec1_c1": (lambda: fb.dec1_c1(y1, p), lambda: fb.dec1_conv_plain(y1, k_c1, b_c1)),
        "dec1_c2": (lambda: fb.dec1_c2(y2, x1p, p), lambda: fb.dec1_conv_plain(y2, k_c2, b_c2, x1p)),
        "dec1_rc": (lambda: fb.dec1_rc(y3, p), lambda: fb.dec1_conv_plain(y3, k_rc, b_rc)),
    }
    rec = {"dec1_chain": dict(max_abs_err=err)}
    for name, (kernel, plain) in calls.items():
        e = float((kernel() - plain()).abs().max())
        if not np.isfinite(e) or e > DEC1_TOL:
            raise AssertionError(f"{name} disagrees with its plain version at {shape}: max |diff| {e:.3e}")
        rec[name] = dict(max_abs_err=e)
    line += "; by stage " + ", ".join(f"{n} {r['max_abs_err']:.2e}" for n, r in rec.items() if n != "dec1_chain")
    for j in sorted({0, b - 1} if b > 1 else ()):
        alone = fb.dec1_chain(d2[j : j + 1].contiguous(), x1p[j : j + 1].contiguous(), *weights, packed=p)
        if not torch.equal(alone, got[j : j + 1]):
            raise AssertionError(f"dec1_chain at {shape}: image {j} of the batch differs from K10 on it alone")
    if b > 1:
        line += "; first and last image identical to K10 on each alone"
    if timed:
        n_px = b * h * w
        weight_bytes = 4 * (64 * 128 + 3 * 9 * 128 * 128 + 4 * 128)
        rec["dec1_chain"].update(
            ms=time_ms(torch, lambda: fb.dec1_chain(*args, packed=p)),
            plain_ms=time_ms(torch, lambda: fb.dec1_chain_plain(*args), n=5),
            bound=bound(4 * n_px * (64 + 128 + 128) + weight_bytes, 2 * n_px * (64 * 128 + 27 * 128 * 128)),
        )
        libs = {
            "dec1_up": conv_library(torch, d2, k_up, b_up, relu=False),
            "dec1_c1": conv_library(torch, y1, k_c1, b_c1),
            "dec1_c2": conv_library(torch, y2, k_c2, b_c2, residual=x1p),
            "dec1_rc": conv_library(torch, y3, k_rc, b_rc),
        }
        for name, (kernel, plain) in calls.items():
            cin, taps, residual = K10_STAGES[name]
            n_bytes = 4 * n_px * (cin + 128 + 128 * residual) + 4 * (taps * cin * 128 + 128)
            lib_err = float((libs[name]().permute(0, 2, 3, 1) - plain()).abs().max())
            if not np.isfinite(lib_err) or lib_err > DEC1_TOL:
                raise AssertionError(f"F.conv2d for {name} disagrees with its plain version: max |diff| {lib_err:.3e}")
            rec[name].update(ms=time_ms(torch, kernel), plain_ms=time_ms(torch, plain, n=5),
                             library_ms=time_ms(torch, libs[name]), bound=bound(n_bytes, 2 * n_px * taps * cin * 128))
        k10 = rec["dec1_chain"]
        line += (
            f"; {k10['ms']:.4f} ms (plain, the cuDNN chain, {k10['plain_ms']:.3f} ms, bound {k10['bound'][0]:.4f} ms by "
            f"{k10['bound'][1]}, {k10['bound'][0] / k10['ms']:.1%} of it), launches per image 1 with "
            f"NetCfg(dec1_chain=True); by stage "
            + ", ".join(f"{n} {rec[n]['ms']:.4f} (plain {rec[n]['plain_ms']:.3f}, F.conv2d {rec[n]['library_ms']:.4f}, "
                        f"bound {rec[n]['bound'][0]:.4f} by {rec[n]['bound'][1]})" for n in K10_STAGES)
            + f", sum {sum(rec[n]['ms'] for n in K10_STAGES):.4f}"
        )
    print(line)
    return rec


def dec1_forward_phase(torch, modules, photo: Path) -> dict[str, int]:
    """Phase 13: the dec1-chain forward against the default packed forward
    and the standard one, K10's launches, and warm net ms with and without
    it. Returns the launches of K10 and of each of its stages there."""
    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.enhance import load_image
    from retinex_tpu_torch.models.packed_inference import NetCfg, PackedRetinex

    model = cli.build_model(Config(mode="enhance"), torch.device("cuda"))
    default, fused = PackedRetinex(model), PackedRetinex(model, NetCfg(dec1_chain=True))
    k10 = dict.fromkeys(("dec1_chain", *K10_STAGES), 0)
    xs = {}
    for max_size in (1920, None):
        img, _ = load_image(str(photo), max_size)
        x = xs[max_size] = torch.from_numpy(img).to("cuda")[None]
        with torch.inference_mode():
            std, base = model(x), default(x)
            for m in modules:
                m.reset_launches()
            got = fused(x)
            torch.cuda.synchronize()
        launches = launch_counts(modules)
        fam = FAM_TWICE if max_size == 1920 else {"fam_conv_fused": 2, "fam_tail_stats": 2, "fam_tail_apply": 2}
        check_launches(launches, {**fam, "dec1_chain": 1}, f"the dec1-chain forward at {tuple(x.shape[1:3])}")
        k10 = {k: v + launches[k] for k, v in k10.items()}
        for (name, tol), a, b, s in zip(PACKED_TOL.items(), got, base, std):
            if a.shape != b.shape or not torch.isfinite(a).all():
                raise AssertionError(f"dec1-chain {name}: shape {tuple(a.shape)} vs {tuple(b.shape)}, or non-finite")
            e_def, e_std = float((a - b).abs().max()), float((a - s).abs().max())
            print(
                f"  dec1-chain forward {tuple(x.shape[1:3])}, {name}: max |diff| {e_def:.3e} against the default "
                f"packed forward (tolerance {NETCFG_TOL:g}), {e_std:.3e} against the standard one ({tol:g})"
            )
            if e_def > NETCFG_TOL or e_std > tol:
                raise AssertionError(f"the dec1-chain forward's {name} disagrees with the default or standard forward")
        print(f"  K10 launches in the dec1-chain forward at {tuple(x.shape[1:3])}: {launches['dec1_chain']}")

    med = in_turns(torch, {"default": default, "dec1_chain": fused}, xs[1920])
    print(
        f"  warm packed net at 1088x1920, batch 1: default (dec1 on cuDNN) {med['default']:.3f} ms, "
        f"NetCfg(dec1_chain=True) (K10) {med['dec1_chain']:.3f} ms, ratio {med['dec1_chain'] / med['default']:.4f}"
    )
    return k10


def in_turns(torch, fns: dict, x, rounds: int = 8) -> dict[str, float]:
    """Each forward of `fns` on `x`, in turns (the order flipped every
    round), host clock between synchronises: the median ms of each after
    the first two rounds."""
    times = {k: [] for k in fns}
    with torch.inference_mode():
        for i in range(rounds):
            for name in (list(fns) if i % 2 else list(fns)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[name](x)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v[2:]) for k, v in times.items()}


def png_u8(path: Path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB")).astype(np.int16)


def predict_phase(torch, modules, photo: Path, small: Path, photos: Path, workdir: Path) -> tuple[dict, Path]:
    """Phase 14: --mode predict through the CLI on a file and a directory,
    card against CPU, batch against single images, warm throughput, and
    predict_single_image on the dec1-chain forward. Returns the launches
    of K10 and of each of its stages there, and the directory's output."""
    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.batch_driver import bucket_by_canvas, decode_bucket
    from retinex_tpu_torch.infer.enhance import _quant
    from retinex_tpu_torch.infer.predict import predict_batch, predict_single_image
    from retinex_tpu_torch.models.packed_inference import NetCfg, PackedRetinex
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

    ckpt = workdir / "seed0.pth"
    torch.save({"epoch": 0, "model_state_dict": cli.init_untrained(MultiScaleUPRetinex(False, False), 0).state_dict()}, ckpt)
    base = ["--mode", "predict", "--checkpoint", str(ckpt), "--device", "cuda"]
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    out1 = workdir / "pred_single"
    launches, cold_s = run_cli(torch, modules, [*base, "--input_path", str(photo), "--output_dir", str(out1), "--max_size", "1920"])
    print(f"  one photo, --max_size 1920: CLI run (cold) {cold_s:.3f} s; kernel launches {launches}")
    check_launches(launches, FAM_TWICE, "predict on one photo")
    check_pngs(out1, photo.stem, (1088, 1920, 3))

    # The card against the port's CPU run, at --max_size 512.
    out_s = workdir / "pred_512"
    launches, _ = run_cli(torch, modules, [*base, "--input_path", str(small), "--output_dir", str(out_s), "--max_size", "512"])
    check_launches(launches, FAM_TWICE, "predict at --max_size 512")
    check_pngs(out_s, small.stem, (288, 512, 3))
    cpu_apply = cli.build_apply_fn(Config(mode="predict", checkpoint=str(ckpt), device="cpu"), cpu, require_checkpoint=True)
    predict_single_image(cpu_apply, str(small), str(workdir / "pred_512_cpu"), max_size=512, device="cpu")
    for kind in ("enhanced", "illumination"):
        d = np.abs(png_u8(out_s / f"{small.stem}_{kind}.png") - png_u8(workdir / "pred_512_cpu" / f"{small.stem}_{kind}.png"))
        print(f"  predict at --max_size 512, {kind}, card vs CPU: max {int(d.max())} level(s), {float((d > 0).mean()):.2e} of bytes differ")
        if d.max() > 1 or (d > 0).mean() >= 1e-4:
            raise AssertionError(f"predict's {kind} PNG on the card disagrees with the CPU run")

    # The directory at --batch_size 8.
    out_d = workdir / "pred_dir"
    files = sorted(str(p) for p in photos.iterdir())
    launches, cold_s = run_cli(torch, modules, [
        *base, "--input_path", str(photos), "--output_dir", str(out_d), "--max_size", "1920", "--batch_size", "8",
        "--num_workers", "8",
    ])
    print(f"  directory, --batch_size 8: CLI run (cold) {cold_s:.3f} s; kernel launches {launches}")
    check_launches(launches, {k: 6 for k in FAM_TWICE}, "predict on the directory")
    if len(list(out_d.iterdir())) != 3 * len(files):
        raise AssertionError(f"predict: {len(list(out_d.iterdir()))} PNGs, expected {3 * len(files)}")

    # Batch against single images: each image's own forward on the card,
    # quantised as predict_single_image's PNG writer truncates.
    card_apply = cli.build_apply_fn(Config(mode="predict", checkpoint=str(ckpt)), cuda, require_checkpoint=True)
    worst, frac = 0, 0.0
    for (target, _h, _w), paths in bucket_by_canvas(files, 1920).items():
        x = torch.from_numpy(decode_bucket(paths, target, _h, _w)).to("cuda").float() / 255.0
        for j, f in enumerate(paths):
            enh, _, illu = card_apply(x[j : j + 1])
            for kind, t in (("enhanced", enh), ("illumination", illu.expand(-1, -1, -1, 3))):
                d = np.abs(png_u8(out_d / f"{Path(f).stem}_{kind}.png") - _quant(t[0]).cpu().numpy().astype(np.int16))
                worst, frac = max(worst, int(d.max())), max(frac, float((d > 0).mean()))
    print(f"  predict, batch vs each image's own forward on the card: max {worst} level(s), at most {frac:.2e} of an image's bytes differ")
    if worst > 1:
        raise AssertionError("predict: the batch's PNGs differ from single images by more than one level")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predict_batch(card_apply, str(photos), str(workdir / "pred_dir_warm"), max_size=1920, batch_size=8, num_workers=8, device="cuda")
    sec = time.perf_counter() - t0
    lat = []
    for i in range(3):
        t1 = time.perf_counter()
        predict_single_image(card_apply, str(photo), str(workdir / f"pred_warm_{i}"), max_size=1920, device="cuda")
        lat.append((time.perf_counter() - t1) * 1e3)
    print(
        f"  predict, warm: directory with PNG writes {sec:.3f} s for {len(files)} images, {len(files) / sec:.3f} images/s; "
        f"one photo (decode to 3 PNGs written) {statistics.median(lat):.3f} ms"
    )

    # predict_single_image on the dec1-chain forward.
    model = cli.build_model(Config(mode="predict", checkpoint=str(ckpt)), cuda, require_checkpoint=True)
    fused = PackedRetinex(model, NetCfg(dec1_chain=True))

    def dec1_apply(batch):
        with torch.inference_mode():
            return fused(batch)

    for m in modules:
        m.reset_launches()
    predict_single_image(dec1_apply, str(photo), str(workdir / "pred_dec1"), max_size=1920, device="cuda")
    launches = launch_counts(modules)
    check_launches(launches, {**FAM_TWICE, "dec1_chain": 1}, "predict on the dec1-chain forward")
    for kind in ("enhanced", "illumination"):
        d = np.abs(png_u8(workdir / "pred_dec1" / f"{photo.stem}_{kind}.png") - png_u8(out1 / f"{photo.stem}_{kind}.png"))
        print(f"  predict on the dec1-chain forward vs the default, {kind}: max {int(d.max())} level(s), {float((d > 0).mean()):.2e} of bytes differ")
        if d.max() > 1:
            raise AssertionError(f"predict on the dec1-chain forward: {kind} PNG more than one level from the default's")
    return {k: launches[k] for k in ("dec1_chain", *K10_STAGES)}, out_d


def evaluate_phase(torch, modules, pred_dir: Path, ref_dir: Path, workdir: Path) -> None:
    """Phase 15: --mode evaluate through the CLI without and with
    references (the second run, over the files the first has read, gives
    the warm images/s), and card against CPU on two photos' PNGs."""
    import csv
    import shutil

    from retinex_tpu_torch.infer.evaluate import NO_REF_KEYS, REF_KEYS, evaluate_directory

    pngs = sorted(p.name for p in pred_dir.iterdir())
    with_refs = sorted(n for n in pngs if (ref_dir / n).is_file() and not n.endswith("_comparison.png"))
    for test_dir, keys in ((workdir / "no_references", NO_REF_KEYS), (ref_dir, NO_REF_KEYS + REF_KEYS)):
        out = workdir / f"eval_{test_dir.name}"
        launches, cold_s = run_cli(torch, modules, [
            "--mode", "evaluate", "--input_path", str(pred_dir), "--test_dir", str(test_dir), "--output_dir", str(out),
            "--batch_size", "16", "--device", "cuda",
        ])
        check_launches(launches, {}, "evaluate")
        with open(out / "metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        if [r["image"] for r in rows] != pngs or list(rows[0]) != ["image", *keys]:
            raise AssertionError(f"evaluate: metrics.csv rows or columns wrong ({len(rows)} rows, {list(rows[0])})")
        scored = sorted(r["image"] for r in rows if r.get("psnr"))
        if scored != (with_refs if test_dir == ref_dir else []):
            raise AssertionError(f"evaluate: PSNR for {len(scored)} images, expected {len(with_refs)}")
        if not all(np.isfinite(float(r[k])) for r in rows for k in NO_REF_KEYS):
            raise AssertionError("evaluate: non-finite metric")
        print(
            f"  evaluate --test_dir {test_dir.name}: CLI run {cold_s:.3f} s for {len(rows)} images, "
            f"{len(rows) / cold_s:.3f} images/s, {len(scored)} with references; launches none"
        )

    sub = workdir / "eval_subset"
    sub.mkdir()
    for n in pngs:
        if n.startswith(("lowlight_011_", "lowlight_012_")):
            shutil.copy(pred_dir / n, sub / n)
    card = evaluate_directory(str(sub), reference_dir=str(ref_dir), device="cuda")
    cpu = evaluate_directory(str(sub), reference_dir=str(ref_dir), device="cpu")
    worst = 0.0
    for a, b in zip(card, cpu):
        if list(a) != list(b) or a["image"] != b["image"]:
            raise AssertionError("evaluate: the card's rows differ from the CPU's in keys or order")
        for k in a:
            if k != "image":
                worst = max(worst, abs(a[k] - b[k]) / max(abs(b[k]), 1e-12))
    print(f"  evaluate on {len(card)} PNGs, card vs CPU: max relative difference {worst:.3e} (tolerance 1e-4)")
    if worst > 1e-4:
        raise AssertionError("evaluate: the card's metrics disagree with the CPU's")


def simple_enhance_phase(torch, modules, photo: Path, small: Path, workdir: Path) -> None:
    """Phase 16: simple_enhance_main (pre-activation + ASPP) on the card."""
    from retinex_tpu_torch import cli

    want = {**FAM_TWICE, **LAB_CLAHE_ONCE}
    out = workdir / "simple"
    launches, cold_s = run_cli(
        torch, modules, ["--input", str(photo), "--output", str(out), "--max_size", "1920", "--device", "cuda"],
        entry=cli.simple_enhance_main,
    )
    print(f"  simple_enhance_main at --max_size 1920: CLI run (cold) {cold_s:.3f} s; kernel launches {launches}")
    check_launches(launches, want, "simple_enhance_main")
    check_pngs(out, photo.stem, (1088, 1920, 3))
    out_s = workdir / "simple_512"
    launches, _ = run_cli(
        torch, modules, ["--input", str(small), "--output", str(out_s), "--max_size", "512", "--device", "cuda"],
        entry=cli.simple_enhance_main,
    )
    check_launches(launches, want, "simple_enhance_main at --max_size 512")
    got = check_pngs(out_s, small.stem, (288, 512, 3))
    hold_to_cpu(torch, got, small, 512, packed=True, preact_aspp=True)


def _close(torch, got, want, what: str) -> float:
    """max |got - want| in f32; raise past F32_TOL (f32) or BF16_TOL as
    rtol and atol (bf16)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} against {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if got.dtype == torch.bfloat16:
        ok = bool(((g - w).abs() <= BF16_TOL + BF16_TOL * w.abs()).all())
    else:
        ok = err <= F32_TOL
    if not (np.isfinite(err) and ok):
        raise AssertionError(f"{what} disagrees with its plain version: max |diff| {err:.3e}")
    return err


def _batch_holds(torch, fn, x, got, what: str) -> str:
    """The first and last image of a batch equal `fn` on each alone."""
    b = x.shape[0]
    for j in sorted({0, b - 1} if b > 1 else ()):
        if not torch.equal(fn(x[j : j + 1].contiguous()), got[j : j + 1]):
            raise AssertionError(f"{what}: image {j} of the batch differs from the kernel on it alone")
    return "; first and last image identical to the kernel on each alone" if b > 1 else ""


def conv_inputs(torch, shape, kernel: tuple, dtype, seed: int):
    """Seeded x ~ N(0,1) in `dtype`, an HWIO kernel x 0.05 and a bias ~ N(0,1)
    (f32), as tests/test_conv_pallas.py scales them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kh, kw, cout = kernel
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    k = torch.randn((kh, kw, shape[3], cout), generator=g, device="cuda") * 0.05
    return x, k, torch.randn(cout, generator=g, device="cuda")


def conv_route(name: str, dtype, torch) -> str:
    """The kernel that must serve `name` at perf_lab's shapes."""
    if dtype == torch.bfloat16:
        return "conv_wgmma"
    return "conv_narrow" if name == "conv2d_narrow" else "conv_pipelined"


def conv_phase(torch, cp, kernels) -> tuple[dict, dict]:
    """Phase 17: K13, K15 and K14 through their public functions at
    perf_lab's shapes (counts from 0; each call's kernel read from
    KERNEL_LAUNCHES), then each case against its plain version and batch
    against single images; timings at the CONV_TIMED cases. Returns
    (launches by (kernel, dtype), records by (kernel, dtype))."""
    import torch.nn.functional as F

    fns = {"conv2d_pallas": (cp.conv2d_pallas, cp.conv2d_pallas_plain),
           "conv2d_pallas_im2col": (cp.conv2d_pallas_im2col, cp.conv2d_pallas_plain),
           "conv2d_narrow": (cp.conv2d_narrow, cp.conv2d_narrow_plain)}
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(name, i, c, dt) for name, cs in CONV_CASES.items() for i, c in enumerate(cs) for dt in dtypes]

    def call(name, case, dt, seed, plain=False):
        shape, kern, dil, relu = case
        x, k, b = conv_inputs(torch, shape, kern, dt, seed)
        kw = {"dilation": dil} if name == "conv2d_narrow" else {}
        fn = fns[name][1 if plain else 0]
        return x, k, b, kw, (lambda v: fn(v, k, b, relu, **kw))

    cp.reset_launches()
    launches: dict = {}
    for seed, (name, i, case, dt) in enumerate(cases):
        if case[0][1] > 100:  # perf_lab's shapes, not the ragged ones
            x, *_, kernel = call(name, case, dt, seed)
            before = dict(cp.KERNEL_LAUNCHES)
            kernel(x)
            ran = {k: v - before[k] for k, v in cp.KERNEL_LAUNCHES.items() if v != before[k]}
            want = conv_route(name, dt, torch)
            if ran != {want: 1}:
                raise AssertionError(f"{name} {list(case[0])} {dt}: launched {ran}, expected {want} once")
            launches[(name, dt)] = launches.get((name, dt), 0) + 1
    torch.cuda.synchronize()
    if sum(launches.values()) != sum(cp.LAUNCHES.values()) or any(
        cp.LAUNCHES[n] != sum(v for (m, _), v in launches.items() if m == n) for n in cp.LAUNCHES
    ):
        raise AssertionError(f"per-wrapper counts {cp.LAUNCHES} disagree with the calls made {launches}")
    print(f"  public functions at perf_lab's shapes, f32 and bf16: launches {dict(cp.LAUNCHES)}, "
          f"by kernel {dict(cp.KERNEL_LAUNCHES)}")
    print(f"  dynamic shared memory per block: conv_pipelined {kernels.query('conv_pipelined_smem', 3, 3)} B (3x3); "
          "conv_wgmma by timed case below")

    recs: dict = {}
    for seed, (name, i, case, dt) in enumerate(cases):
        shape, (kh, kw_, cout), dil, relu = case
        x, k, b, kw, kernel = call(name, case, dt, seed)
        plain = call(name, case, dt, seed, plain=True)[-1]
        cp.reset_launches()
        got = kernel(x)
        served = next(n for n, v in cp.KERNEL_LAUNCHES.items() if v)
        err = _close(torch, got, plain(x), f"{name} {list(shape)} {kh}x{kw_}->{cout} {dt}")
        tag = f"  {name} {list(shape)} {kh}x{kw_} -> {cout}" + (f" dil {dil}" if dil > 1 else "") + f" {str(dt)[6:]}"
        line = tag + f" ({served}): max |diff| {err:.3e}" + _batch_holds(torch, kernel, x, got, name)
        if served == "conv_narrow":  # the instance: its registers, spills and shared memory
            plan = cp.narrow_plan(cout, kh, dil)
            line += (f"; conv_narrow Cout tile {plan['cot']}, {plan['registers']} registers, {plan['local_bytes']} "
                     f"B local (spills), {plan['smem']} B of dynamic shared memory, {plan['stages']} stages, "
                     f"{plan['blocks_per_sm']} blocks per SM")
        rec = recs.setdefault((name, dt), {"max_abs_err": 0.0, "kernel": conv_route(name, dt, torch)})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if (name, i) in CONV_TIMED:
            n_px = shape[0] * shape[1] * shape[2]
            el = x.element_size()
            n_bytes = n_px * (shape[3] + cout) * el + k.numel() * el + 4 * cout
            n_ops = 2 * n_px * kh * kw_ * shape[3] * cout
            bd = bound(n_bytes, n_ops, PEAK_BF16_OPS_PER_S if dt == torch.bfloat16 else PEAK_F32_OPS_PER_S)
            xc = x.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
            wl = k.to(dt).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bl = b.to(dt)
            pad = (kh // 2) * dil

            def library():
                out = F.conv2d(xc, wl, bl, padding=pad, dilation=dil)
                return torch.relu(out) if relu else out

            lib_err = float((library().permute(0, 2, 3, 1).float() - got.float()).abs().max())
            if served == "conv_wgmma":
                plan = cp.wgmma_plan(shape[3], cout, kh, kw_, dil)
                weights = f"in a ring of {plan['ring']}" if plan["ring"] else "resident"
                line += (f"; conv_wgmma N {plan['n_tile']}, K chunk {plan['chunk']}, {plan['smem']} B of dynamic "
                         f"shared memory, {plan['halo_stages']} halo stages, weights {weights}")

            t = dict(ms=time_ms(torch, lambda: kernel(x)), plain_ms=time_ms(torch, lambda: plain(x), n=5),
                     library_ms=time_ms(torch, library), bound=bd)
            if "ms" not in rec:
                rec.update(t, shape=list(shape))
            line += (
                f"; {t['ms']:.4f} ms (plain {t['plain_ms']:.3f} ms, F.conv2d {t['library_ms']:.4f} ms, "
                f"|kernel - F.conv2d| {lib_err:.2e}, bound {bd[0]:.4f} ms by {bd[1]}, "
                f"{bd[0] / t['ms']:.1%} of it)"
            )
        print(line)
        del x, got
    return launches, recs


def dual_phase(torch, fb, cp) -> tuple[dict, dict]:
    """Phase 18: K12 at perf_lab's shape in f32 and bf16 (counts from 0;
    each call's stage kernels read from KERNEL_LAUNCHES: conv_pipelined in
    f32, conv_wgmma in bf16), then against its plain version at DUAL_SHAPES,
    each stage against its plain version (the second on the plain y), batch
    against single images; timings of K12 and its stages at the first shape,
    conv_wgmma's plan for each bf16 stage. Returns (launches by dtype,
    records by dtype)."""

    def inputs(shape, dt, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)

        def n(*s, scale=1.0):
            return torch.randn(s, generator=g, device="cuda") * scale

        x = n(*shape, scale=0.2).to(dt)  # perf_lab's scaling
        return x, [n(3, 3, 128, 256, scale=0.05), n(256), n(3, 3, 128, 128, scale=0.05), n(128),
                   n(3, 3, 128, 128, scale=0.05), n(128)]

    dtypes = (torch.float32, torch.bfloat16)
    kernel = {torch.float32: "pipelined", torch.bfloat16: "wgmma"}
    fb.reset_launches()
    launches = {}
    for seed, dt in enumerate(dtypes):
        x, w = inputs(DUAL_SHAPES[0], dt, seed)
        before, calls = dict(fb.KERNEL_LAUNCHES), fb.LAUNCHES["fam_dual_conv3"]
        fb.fam_dual_conv3(x, *w)
        launches[dt] = fb.LAUNCHES["fam_dual_conv3"] - calls
        ran = {k: v - before[k] for k, v in fb.KERNEL_LAUNCHES.items() if v != before[k]}
        want = {f"{s}_{kernel[dt]}": 1 for s in K12_STAGES}
        if launches[dt] != 1 or ran != want:
            raise AssertionError(f"fam_dual_conv3 {dt}: {launches[dt]} call(s) launched {ran}, expected 1 and {want}")
    torch.cuda.synchronize()
    if fb.LAUNCHES["fam_dual_conv3"] != 2:
        raise AssertionError(f"fam_dual_conv3 counted {fb.LAUNCHES['fam_dual_conv3']} calls, expected 2")
    print(f"  fam_dual_conv3 at perf_lab's [2,544,960,128], f32 and bf16: launches {fb.LAUNCHES['fam_dual_conv3']}, "
          f"by stage kernel { {k: v for k, v in fb.KERNEL_LAUNCHES.items() if v} }")
    for name, (cin, groups) in K12_STAGES.items():
        plan = cp.wgmma_plan(cin, 256, 3, 3, 1, groups)
        print(f"  conv_wgmma plan for {name} (bf16, {cin} -> 256, groups {groups}): {plan}")
    recs: dict = {}
    for i, shape in enumerate(DUAL_SHAPES):
        for seed, dt in enumerate(dtypes):
            x, w = inputs(shape, dt, 10 * i + seed)
            k2, b2 = fb.stack_dual_convs(*w[2:])
            got = fb.fam_dual_conv3(x, *w)
            err = _close(torch, got, fb.fam_dual_conv3_plain(x, *w), f"fam_dual_conv3 {list(shape)} {dt}")
            y = fb.fam_dual_y_plain(x, w[0], w[1])
            calls = {
                "fam_dual_y": (lambda: fb.fam_dual_y(x, w[0], w[1]), lambda: fb.fam_dual_y_plain(x, w[0], w[1])),
                "fam_dual_out": (lambda: fb.fam_dual_out(y, k2, b2), lambda: fb.fam_dual_out_plain(y, k2, b2)),
            }
            stage_err = {n: _close(torch, kern(), plain(), f"{n} {list(shape)} {dt}") for n, (kern, plain) in calls.items()}
            line = f"  fam_dual_conv3 {list(shape)} {str(dt)[6:]}: max |diff| {err:.3e}; by stage " + ", ".join(
                f"{n} {e:.3e}" for n, e in stage_err.items())
            line += _batch_holds(torch, lambda v: fb.fam_dual_conv3(v, *w), x, got, "fam_dual_conv3")
            rec = recs.setdefault(dt, {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if i == 0:
                n_px = shape[0] * shape[1] * shape[2]
                el = x.element_size()
                n_bytes = n_px * 384 * el + (9 * 128 * 256 + 2 * 9 * 128 * 128) * el + 4 * 512
                peak = PEAK_BF16_OPS_PER_S if dt == torch.bfloat16 else PEAK_F32_OPS_PER_S
                rec.update(
                    ms=time_ms(torch, lambda: fb.fam_dual_conv3(x, *w)),
                    plain_ms=time_ms(torch, lambda: fb.fam_dual_conv3_plain(x, *w), n=5),
                    bound=bound(n_bytes, 2 * n_px * 9 * 128 * 512, peak),
                )
                # One F.conv2d (+ ReLU) for each stage; their difference
                # from the plain versions is printed, not held.
                libs = {"fam_dual_y": conv_library(torch, x, w[0], w[1]),
                        "fam_dual_out": conv_library(torch, y, k2, b2, relu=False, groups=2)}
                stages = {}
                for n, (kern, plain) in calls.items():
                    cin = K12_STAGES[n][0]
                    stage_bytes = n_px * (cin + 256) * el + 9 * 128 * 256 * el + 4 * 256
                    lib_err = float((libs[n]().permute(0, 2, 3, 1).float() - plain().float()).abs().max())
                    stages[n] = (time_ms(torch, kern), time_ms(torch, plain, n=5), time_ms(torch, libs[n]), lib_err,
                                 bound(stage_bytes, 2 * n_px * 9 * 128 * 256, peak))
                line += (
                    f"; {rec['ms']:.4f} ms (plain, the cuDNN chain, {rec['plain_ms']:.3f} ms, bound "
                    f"{rec['bound'][0]:.4f} ms by {rec['bound'][1]}, {rec['bound'][0] / rec['ms']:.1%} of it); by stage "
                    + ", ".join(f"{n} {t:.4f} (plain {pl:.3f}, F.conv2d {lib:.4f} with |F.conv2d - plain| {le:.2e}, "
                                f"bound {bd[0]:.4f} by {bd[1]})" for n, (t, pl, lib, le, bd) in stages.items())
                    + f", sum {sum(st[0] for st in stages.values()):.4f}"
                )
            print(line)
            del x, got, y
    return launches, recs


def k16_phase(torch, kp) -> tuple[dict, dict]:
    """Phase 19: K16 at perf_lab's [8,1088,1920,3] and the 1088x1920 frame
    (counts from 0), then each kernel and the op against the plain versions
    at K16_SHAPES; the ValueError; timings at the first two shapes."""

    def image(shape, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.rand(shape, generator=g, device="cuda") * 0.6

    kp.reset_launches()
    for seed, shape in enumerate(K16_SHAPES[:2]):
        kp.clahe_lab_rgb_pallas(image(shape, seed))
    torch.cuda.synchronize()
    launches = dict(kp.LAUNCHES)
    print(f"  clahe_lab_rgb_pallas at [1|8,1088,1920,3]: launches {launches}")
    try:
        kp.clahe_lab_rgb_pallas(torch.zeros((1, 57, 41, 3), device="cuda"))
    except ValueError as e:
        print(f"  [1,57,41,3]: ValueError ({e})")
    else:
        raise AssertionError("clahe_lab_rgb_pallas took a [1,57,41,3] image")

    recs = {"clahe_pallas_hist": {"max_abs_err": 0}, "clahe_pallas_apply": {"max_abs_err": 0}}

    def held(what, shape, got, want) -> tuple[int, float]:
        e, frac = u8_diff(torch, got.cpu(), want.cpu())
        if e > 1 or frac >= 1e-4:
            raise AssertionError(f"{what} disagrees with its plain version at {shape}: max {e} level(s) on {frac:.2e}")
        return e, frac

    def u8(rgb):
        return torch.round(rgb * 255).to(torch.uint8)

    for seed, shape in enumerate(K16_SHAPES):
        b, h, w, _ = shape
        tag = "x".join(map(str, shape))
        x = image(shape, seed)
        lab, hist = kp.clahe_pallas_hist(x)
        torch.cuda.synchronize()
        if not torch.equal(hist, kp.l_histograms(lab, 8, 8)):
            raise AssertionError(f"clahe_pallas_hist: histograms not those of its L at {shape}")
        luts = kp._luts(hist, 2.0, h, w, 8, 8)
        out = kp.clahe_pallas_apply(lab, luts)
        full = kp.clahe_lab_rgb_pallas(x)
        if not torch.equal(full, out):
            raise AssertionError(f"clahe_lab_rgb_pallas differs from its two kernels at {shape}")
        errs, plain_op = {}, {}
        for side, dev in (("card", "cuda"), ("CPU", "cpu")):
            xs, labs, lutss = x.to(dev), lab.to(dev), luts.to(dev)
            plain_op[side] = u8(kp.clahe_lab_rgb_pallas_plain(xs)).cpu()
            errs[side] = (
                held(f"clahe_pallas_hist ({side})", shape, lab, kp.clahe_pallas_hist_plain(xs)[0]),
                held(f"clahe_pallas_apply ({side})", shape, u8(out), u8(kp.clahe_pallas_apply_plain(labs, lutss))),
                u8_diff(torch, u8(full).cpu(), plain_op[side]),
            )
        if errs["card"][2][0] > 1 or errs["card"][2][1] >= 1e-4:
            raise AssertionError(f"clahe_lab_rgb_pallas disagrees with its plain version on the card at {shape}")
        line = f"  [{tag}] K16, histograms those of the kernel's L;"
        for side, ((e_lab, f_lab), (e_apply, f_apply), (e_op, f_op)) in errs.items():
            line += (f" against the {side}'s plain versions: Lab max {e_lab} level(s) on {f_lab:.2e} of bytes, "
                     f"apply max {e_apply} on {f_apply:.2e}, the op max {e_op} on {f_op:.2e} of values;")
            recs["clahe_pallas_hist"]["max_abs_err"] = max(recs["clahe_pallas_hist"]["max_abs_err"], e_lab)
            recs["clahe_pallas_apply"]["max_abs_err"] = max(recs["clahe_pallas_apply"]["max_abs_err"], e_apply)
        e_pp, f_pp = u8_diff(torch, plain_op["card"], plain_op["CPU"])
        line += f" the card's plain op against the CPU's max {e_pp} on {f_pp:.2e};"
        line = line[:-1] + _batch_holds(torch, kp.clahe_lab_rgb_pallas, x, full, "clahe_lab_rgb_pallas")
        if seed < 2:
            n_px, tables = b * h * w, b * 64 * 256
            timed = {
                "clahe_pallas_hist": dict(
                    ms=time_ms(torch, lambda: kp.clahe_pallas_hist(x)),
                    plain_ms=time_ms(torch, lambda: kp.clahe_pallas_hist_plain(x), n=5),
                    bound=bound(15 * n_px + 4 * tables, INSTR_PER_PX["clahe_pallas_hist"] * n_px, PEAK_ISSUE_PER_S),
                ),
                "clahe_pallas_apply": dict(
                    ms=time_ms(torch, lambda: kp.clahe_pallas_apply(lab, luts)),
                    plain_ms=time_ms(torch, lambda: kp.clahe_pallas_apply_plain(lab, luts), n=5),
                    bound=bound(15 * n_px + tables, INSTR_PER_PX["clahe_pallas_apply"] * n_px, PEAK_ISSUE_PER_S),
                ),
            }
            for name, r in timed.items():
                line += f"; {name} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]})"
                if seed == 0:
                    recs[name].update(r)
        print(line)
    return launches, recs


def main_path_phases(torch, cg, cl, fb, cp, kp, kernels) -> tuple[dict, dict]:
    """Phases 2-16: the main path's kernels against their plain versions and
    every route through its entry points. Returns (records, launches) by
    kernel."""
    from PIL import Image

    print("phase 2: K1-K3 against their plain versions")
    recs = clahe_kernel_phase(torch, cg, 1, 1088, 1920, seed=0, tile_counts=(4, 8, 16))
    clahe_kernel_phase(torch, cg, 1, 2160, 3840, seed=1)
    held = [clahe_kernel_phase(torch, cg, b, h, w, seed=20 + i, timed=False) for i, (b, h, w) in enumerate(CLAHE_DIR_SHAPES)]
    held.append({name: dict(max_abs_err=e) for name, e in cube_phase(torch, cg).items()})
    for r in held:
        for name, rr in r.items():
            recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], rr["max_abs_err"])
    k3_plan_sweep(torch, cg, kernels)
    print("  G1: K2 and K3 in their tile modes on frames that are not cell-divisible; F4")
    tile = [tile_mode_phase(torch, cg, b, h, w, seed=50 + i, timed=i == 0) for i, (b, h, w) in enumerate(TILE_SHAPES)]
    for name in tile[0]:
        recs[name] = dict(tile[0][name], max_abs_err=max(r[name]["max_abs_err"] for r in tile))
    f4_record(torch)
    route_gate(torch)
    ours = ("lab_fwd_kernel<", "clahe_tables_kernel<", "clahe_apply_kernel<", "FillFunctor<int>")
    for h, once in ((1088, LAB_CLAHE_ONCE), (1080, LAB_CLAHE_TILES_ONCE)):
        cg.reset_launches()
        stage = clahe_stage_profile(torch, h=h)
        calls = {k: v for k, v in cg.LAUNCHES.items() if v}
        if len(stage) != 4 or not all(any(o in k for k in stage) for o in ours) or calls != {k: 8 for k in once}:
            raise AssertionError(f"the Lab-CLAHE stage at {h}x1920 ran {sorted(stage)} with launches {calls}, expected "
                                 f"the scratch fill and {sorted(once)} once a call (8 calls) and nothing else")

    print("phase 3: K7-K9 (and K2 on a luma plane) against their plain versions")
    luma = [luma_kernel_phase(torch, cg, cl, shape, seed=10 + i) for i, shape in enumerate(LUMA_SHAPES)]
    for name, r in luma[0].items():  # the directory chunk [8,1088,1920]
        recs[name] = dict(r, max_abs_err=max(rr[name]["max_abs_err"] for rr in luma))

    print("phase 4: K4 (whole and its three stages), K5, K6 and K11 against their plain versions")
    fam = [fam_kernel_phase(torch, fb, s, seed=2 + i, timed=FAM_TIMED) for i, s in enumerate(FAM_SHAPES)]
    fam_1080 = [
        fam_kernel_phase(torch, fb, s, seed=5 + i, timed=("fam_tail_apply",)) for i, s in enumerate(FAM_SHAPES_1080)
    ]
    held = [fam_kernel_phase(torch, fb, FAM_RAGGED, seed=4)]
    held += [fam_kernel_phase(torch, fb, s, seed=30 + i) for i, s in enumerate(FAM_DIR_SHAPES)]
    for name in FAM_KERNELS:
        per = [r[name] for r in (fam if name in FAM_TIMED else fam_1080)]
        recs[name] = dict(
            max_abs_err=max(r[name]["max_abs_err"] for r in fam + fam_1080 + held),
            ms=sum(r["ms"] for r in per),
            plain_ms=sum(r["plain_ms"] for r in per),
            bound=(sum(r["bound"][0] for r in per), per[0]["bound"][1]),
        )
    k4 = recs["fam_conv_fused"]
    stages = ", ".join(f"{n} {recs[n]['ms']:.4f} (bound {recs[n]['bound'][0]:.4f})" for n in K4_STAGES)
    print(
        f"  K4 device ms per image at 1088x1920 (scale-1 + scale-2 launches): {k4['ms']:.4f} against its bound "
        f"{k4['bound'][0]:.4f} ({k4['bound'][0] / k4['ms']:.1%} of it) and its plain (cuDNN) version's "
        f"{k4['plain_ms']:.4f}; by stage: {stages}, sum {sum(recs[n]['ms'] for n in K4_STAGES):.4f}"
    )
    fb.reset_launches()
    fb.fam_conv_fused(*fam_calls(fb, fam_inputs(torch, fb, FAM_SHAPES[1], seed=3))["fam_conv_fused"][2])
    torch.cuda.synchronize()
    print(f"  one fam_conv_fused call: launches {fb.LAUNCHES['fam_conv_fused']}, by kernel {dict(fb.KERNEL_LAUNCHES)}")
    if dict(fb.KERNEL_LAUNCHES) != {k: int(k in K4_STAGES) for k in fb.KERNEL_LAUNCHES}:
        raise AssertionError(f"a K4 call launched {dict(fb.KERNEL_LAUNCHES)}, expected each of its stages once")
    k6, k6d = recs["fam_tail_apply_g1"], recs.pop("fam_tail_apply_g1_dense")
    lib = k6_library_phase(torch, fb)
    k6["library_ms"], k6d["library_ms"] = lib["diag"], lib["dense"]
    print(
        f"  K6 device ms per image at 1088x1920 (scale-1 + scale-2 launches): quadrant-diagonal w (the main path's) "
        f"{k6['ms']:.4f} against its bound {k6['bound'][0]:.4f} by {k6['bound'][1]} "
        f"({k6['bound'][0] / k6['ms']:.1%} of it), plain {k6['plain_ms']:.4f}, torch.einsum {lib['diag']:.4f}; "
        f"dense w {k6d['ms']:.4f} against {k6d['bound'][0]:.4f} by {k6d['bound'][1]} "
        f"({k6d['bound'][0] / k6d['ms']:.1%}), plain {k6d['plain_ms']:.4f}, torch.einsum {lib['dense']:.4f}; "
        f"yardstick: torch.matmul of the pre-scaled x by the dense w (cuBLAS on the product alone) {lib['matmul']:.4f}"
    )
    fam_ms = sum(recs[n]["ms"] for n in ("fam_conv_fused", "fam_tail_stats", "fam_tail_apply_g1"))
    print(f"  K4-K6 device ms per image at 1088x1920 (scale-1 + scale-2 launches): {fam_ms:.4f}")
    print(f"  K11 device ms per image at 1080x1920: {recs['fam_tail_apply']['ms']:.4f}")

    modules = (cg, cl, fb, cp, kp)
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        src = REPO / "data" / "convergence" / "lowlight_000.png"
        photo = workdir / "photo1080.png"
        small = workdir / "photo512.png"
        small_flagless = workdir / "photo480.png"
        with Image.open(src) as im:
            im.convert("RGB").resize((1920, 1080), Image.BILINEAR).save(photo)
            im.convert("RGB").resize((512, 288), Image.BILINEAR).save(small)
            im.convert("RGB").resize((480, 264), Image.BILINEAR).save(small_flagless)

        print("phase 5: the standard route through the CLI (--no-packed_inference)")
        standard_phase(torch, modules, photo, workdir)
        print("phase 6: the default (packed) route through the CLI")
        launches = packed_phase(torch, modules, photo, small, workdir)
        print("phase 7: the headline command with no flags (1080x1920, not letterboxed)")
        flagless = flagless_phase(torch, modules, photo, small_flagless, workdir)
        print("phase 8: directory enhance through the CLI, --max_size 1920 --batch_size 8")
        directory = directory_phase(torch, modules, make_directory(REPO / "data" / "convergence", workdir), workdir)
        launches = {k: v + flagless[k] + directory[k] for k, v in launches.items()}
        print("phase 9: ssr, msr, msrcr, --content_aware, --multi_scale, clahe and clahe_luma on one image")
        single_routes_phase(torch, modules, photo, small, workdir)
        print("phase 10: warm times")
        warm_phase(torch, modules, photo, workdir)
        print("phase 11: device time by kernel")
        profile_phase(torch, photo)

        print("phase 12: K10 (dec1_chain) against its plain version")
        dec1 = [dec1_kernel_phase(torch, fb, s, seed=40 + i, timed=i == 0) for i, s in enumerate(DEC1_SHAPES)]
        for name in ("dec1_chain", *K10_STAGES):
            recs[name] = dict(dec1[0][name], max_abs_err=max(r[name]["max_abs_err"] for r in dec1))
        print("phase 13: the dec1-chain forward, PackedRetinex(model, NetCfg(dec1_chain=True))")
        k10 = dec1_forward_phase(torch, modules, photo)
        print("phase 14: --mode predict through the CLI")
        k10_predict, pred_dir = predict_phase(torch, modules, photo, small, workdir / "photos", workdir)
        launches.update({name: n + k10_predict[name] for name, n in k10.items()})
        print("phase 15: --mode evaluate through the CLI")
        evaluate_phase(torch, modules, pred_dir, workdir / "dir_net", workdir)
        print("phase 16: simple_enhance_main (pre-activation + ASPP)")
        simple_enhance_phase(torch, modules, photo, small, workdir)

    return recs, launches


# The training phase (20): the CLI's train mode at the JAX defaults (the
# packed step, and the standard one with --no-packed_train), each step card
# against CPU, packed against standard, inference from the trained
# checkpoint, step times.
TRAIN_ARGS = ["--image_size", "640", "--batch_size", "8", "--save_freq", "1", "--log_every", "1"]
# The card's step against the CPU's (tests/test_torch_train_step.py's tolerances).
TRAIN_HOLD_SHAPE = (2, 128, 128, 3)
TRAIN_LR = 1e-4
# The packed step against the standard step on the card, one step from the
# same weights and batch (tests/test_packed_train.py's tolerances for two
# formulations of one step): losses rtol 1e-4 / atol 1e-5, parameters after
# the step atol 5e-4.
PACKED_LOSS_TOL = (1e-4, 1e-5)
PACKED_PARAM_ATOL = 5e-4
STEP_NAME = {False: "standard", True: "packed"}
PACKED_LOG = "packed_train: the s2d-packed train step"


def _leaf_scale(want: dict) -> float:
    """The floor of a leaf's scale: 1e-3 of the tree's largest magnitude."""
    return 1e-3 * max(float(v.abs().max()) for v in want.values())


def _hold_tree(got: dict, want: dict, rel: float, what: str) -> str:
    """Every leaf within `rel` of its largest magnitude (floored); returns
    the worst ratio of difference to tolerance and its leaf, printable."""
    floor, worst = _leaf_scale(want), (0.0, "")
    for k, w in want.items():
        tol = rel * max(float(w.abs().max()), floor)
        d = float((got[k].cpu() - w).abs().max())
        worst = max(worst, (d / tol, k))
        if d > tol:
            raise AssertionError(f"{what} {k}: card vs CPU {d:.3e} > {tol:.3e}")
    return f"{worst[0]:.3f} ({worst[1]})"


def _hold_params(got: dict, want: dict, eff_got: dict, eff_want: dict) -> float:
    """Parameters after a first Adam step: each side moves a parameter by
    lr * g / (|g| + 1e-8) of its own clipped, decayed gradient g (Adam's
    first moment / 0.1, held to the other side's above), so the two may
    part by lr times the difference of those two updates (up to 2 lr where
    g is near 0 and its sign parts), plus 1e-3 lr and 1e-6 |p| of
    rounding. Returns the largest difference in units of lr."""
    worst = 0.0
    for k, w in want.items():
        g, gg, gw = got[k].cpu(), eff_got[k].cpu(), eff_want[k]
        allowed = TRAIN_LR * ((gg / (gg.abs() + 1e-8) - gw / (gw.abs() + 1e-8)).abs() + 1e-3) + 1e-6 * w.abs()
        d = (g - w).abs()
        worst = max(worst, float(d.max()) / TRAIN_LR)
        if bool((d > allowed).any()):
            i = int((d - allowed).flatten().argmax())
            raise AssertionError(f"parameter {k}: {int((d > allowed).sum())} elements off the CPU's step (worst: "
                                 f"{float(d.flatten()[i]):.3e} > {float(allowed.flatten()[i]):.3e})")
    return worst


def _stats(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}


@contextlib.contextmanager
def no_kernel(modules, what: str):
    """Every launch count at 0 just before and still 0 just after: a train
    step runs no hand-written kernel (K4-K6 have no backward; the packed
    step's FAM is plain PyTorch, as the JAX package's is XLA)."""
    for m in modules:
        m.reset_launches()
    yield
    check_launches(launch_counts(modules), {}, what)


def new_state(torch, device, dtype=None, remat: bool = False):
    """A train state of the default net (seed-0 weights) on `device`."""
    from retinex_tpu_torch.models.init import init_untrained
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
    from retinex_tpu_torch.train.train_state import create_train_state

    net = MultiScaleUPRetinex(False, False, dtype=dtype or torch.float32, remat=remat)
    return create_train_state(init_untrained(net, 0).to(device), lambda s: TRAIN_LR)


def train_step_vs_cpu(torch, modules, packed: bool) -> None:
    """One train step of the default net (seed-0 weights, default VGG,
    perceptual loss on), standard or packed, on the card against the same
    step on the CPU, same batch, TF32 off: the losses, BatchNorm
    statistics, Adam's moments and the parameters. The card launches no
    hand-written kernel."""
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.train.train_state import train_step
    from retinex_tpu_torch.train.trainer import build_criterion

    x = np.random.default_rng(13).random(TRAIN_HOLD_SHAPE, dtype=np.float32) * 0.6
    runs = {}
    for dev in ("cpu", "cuda"):
        d = torch.device(dev)
        state = new_state(torch, d)
        t0 = time.perf_counter()
        with no_kernel(modules, f"the {STEP_NAME[packed]} train step on {dev}"):
            losses = train_step(state, build_criterion(Config(), d), torch.from_numpy(x).to(d), packed)
            losses = {k: float(v) for k, v in losses.items()}
        runs[dev] = (state, losses, time.perf_counter() - t0)
    (cpu, l_cpu, s_cpu), (card, l_card, _) = runs["cpu"], runs["cuda"]
    for k, v in l_cpu.items():
        if abs(l_card[k] - v) > 1e-5 + 1e-4 * abs(v):
            raise AssertionError(f"{STEP_NAME[packed]} train step, loss {k}: card {l_card[k]} vs CPU {v}")
    stats_cpu, stats_card = _stats(cpu.model), _stats(card.model)
    d_stats = max(float((stats_card[k].cpu() - v).abs().max()) for k, v in stats_cpu.items())
    if d_stats > 1e-4:
        raise AssertionError(f"{STEP_NAME[packed]} train step: BatchNorm statistics card vs CPU {d_stats:.3e} > 1e-4")
    mu_w = _hold_tree(card.optimizer.mu, cpu.optimizer.mu, 1e-2, "Adam mu")
    nu_w = _hold_tree(card.optimizer.nu, cpu.optimizer.nu, 2e-2, "Adam nu")
    eff = lambda st: {k: v / 0.1 for k, v in st.optimizer.mu.items()}  # noqa: E731
    params_cpu = dict(cpu.model.named_parameters())
    worst = _hold_params({k: p.detach() for k, p in card.model.named_parameters()},
                         {k: p.detach() for k, p in params_cpu.items()}, eff(card), eff(cpu))
    print(
        f"  one {STEP_NAME[packed]} train step at {list(TRAIN_HOLD_SHAPE)}, card vs CPU ({s_cpu:.1f} s on the CPU): "
        f"losses within rtol 1e-4 / atol 1e-5 (total {l_card['total']:.6f} vs {l_cpu['total']:.6f}), BatchNorm "
        f"statistics {d_stats:.2e} (atol 1e-4), Adam mu and nu at {mu_w} and {nu_w} of their tolerances, "
        f"parameters within Adam's first update of each side's gradient (largest difference {worst:.3f} lr); no "
        "kernel launched"
    )


def packed_vs_standard(torch, modules, x) -> None:
    """One packed and one standard f32 step on the card from the same
    seed-0 weights and batch `x` ([8,640,640,3], perceptual loss on): the
    losses and the parameters after the step by PACKED_LOSS_TOL and
    PACKED_PARAM_ATOL; the BatchNorm statistics' and Adam moments' largest
    differences printed."""
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.train.train_state import train_step
    from retinex_tpu_torch.train.trainer import build_criterion

    cuda = torch.device("cuda")
    crit = build_criterion(Config(), cuda)
    runs = {}
    for packed in (False, True):
        state = new_state(torch, cuda)
        with no_kernel(modules, f"the {STEP_NAME[packed]} train step at [8,640,640,3]"):
            runs[packed] = (state, {k: float(v) for k, v in train_step(state, crit, x, packed).items()})
    (std, l_std), (pk, l_pk) = runs[False], runs[True]
    rtol, atol = PACKED_LOSS_TOL
    for k, v in l_std.items():
        if abs(l_pk[k] - v) > atol + rtol * abs(v):
            raise AssertionError(f"packed vs standard step, loss {k}: {l_pk[k]} vs {v}")
    p_std = {k: p.detach() for k, p in std.model.named_parameters()}
    d_par = max(float((p.detach() - p_std[k]).abs().max()) for k, p in pk.model.named_parameters())
    if d_par > PACKED_PARAM_ATOL:
        raise AssertionError(f"packed vs standard step: parameters {d_par:.3e} apart > {PACKED_PARAM_ATOL}")
    s_std, s_pk = _stats(std.model), _stats(pk.model)
    d_stats = max(float((s_pk[k] - v).abs().max()) for k, v in s_std.items())
    floor = _leaf_scale(std.optimizer.mu)
    d_mu = max(float((pk.optimizer.mu[k] - v).abs().max()) / max(float(v.abs().max()), floor)
               for k, v in std.optimizer.mu.items())
    print(
        f"  packed vs standard f32 step on the card at [8,640,640,3] (same weights and batch): losses within rtol "
        f"1e-4 / atol 1e-5 (total {l_pk['total']:.6f} vs {l_std['total']:.6f}), parameters {d_par:.3e} apart (atol "
        f"{PACKED_PARAM_ATOL:g}); BatchNorm statistics {d_stats:.3e} apart, Adam mu's worst leaf {d_mu:.3e} of its "
        "largest (printed)"
    )
    del runs, std, pk
    torch.cuda.empty_cache()


def train_batch(torch, train_dir: Path):
    """The first augmented [8,640,640,3] batch of the training set, on the card."""
    from retinex_tpu_torch.data.augment import augment_batch
    from retinex_tpu_torch.data.dataset import get_train_loader

    cuda = torch.device("cuda")
    with iter(get_train_loader(str(train_dir), batch_size=8, image_size=640, drop_last=True)) as it:
        host = next(it)
    return augment_batch(torch.from_numpy(host).to(cuda), torch.Generator(device=cuda).manual_seed(1))


def step_turns(torch, runs: dict, crit, x, rounds: int = 6) -> dict:
    """Train steps of each run (name -> (state, packed)) on `x`: one first
    step each alone from the peak counter's reset (its peak device memory),
    then `rounds` rounds in turns (the order flipped every round), host
    clock between synchronises. name -> (median ms of the rounds, their ms,
    the peak bytes, the first step's ms)."""
    from retinex_tpu_torch.train.train_state import train_step

    def one(name) -> float:
        state, packed = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(train_step(state, crit, x, packed)["total"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    peaks, first = {}, {}
    for name in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first[name] = one(name)
        peaks[name] = torch.cuda.max_memory_allocated()
    times = {k: [] for k in runs}
    for i in range(rounds):
        for name in (list(runs) if i % 2 else list(runs)[::-1]):
            times[name].append(one(name))
    return {k: (statistics.median(v), v, peaks[k], first[k]) for k, v in times.items()}


def print_turns(res: dict, what: str, card: str) -> None:
    for name, (ms, all_ms, peak, first) in res.items():
        print(
            f"  warm {what} train step, {name}, at [8,640,640,3] (perceptual loss on; {card}): {ms:.3f} ms (median of "
            f"{len(all_ms)} in turns, spread {min(all_ms):.1f}-{max(all_ms):.1f}: {', '.join(f'{t:.1f}' for t in all_ms)}; "
            f"first {first:.1f}), {8e3 / ms:.3f} images/s; peak device memory {peak / 2**30:.3f} GiB"
        )
    (a, *_), (b, *_) = res["packed"], res["standard"]
    print(f"  {what}: packed / standard step time {a / b:.3f}, peak memory "
          f"{res['packed'][2] / res['standard'][2]:.3f}")


def step_stages(torch, state, crit, x, packed: bool) -> None:
    """The step by stage (net forward, losses with VGG19, backward,
    optimizer; host clock around each, synchronised; median of 3)."""
    from retinex_tpu_torch.models.packed_train import packed_train_apply

    stages = {}
    for _ in range(3):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        model = state.model.train()
        enh, refl, illu = packed_train_apply(model, x) if packed else model(x)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        total, _, new_ls = crit(x, enh, illu, refl, state.loss_state)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        names = list(state.optimizer.params)
        grads = dict(zip(names, torch.autograd.grad(total, [state.optimizer.params[k] for k in names])))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        state.optimizer.step(grads)
        state.loss_state = new_ls
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for name, a, b in zip(("net forward", "losses (VGG19 included)", "backward", "optimizer"), marks, marks[1:]):
            stages.setdefault(name, []).append((b - a) * 1e3)
    print(f"  the {STEP_NAME[packed]} f32 step by stage (host clock around each, synchronised; median of 3): "
          + ", ".join(f"{k} {statistics.median(v):.3f} ms" for k, v in stages.items()))


def step_profile(torch, state, crit, x, packed: bool, what: str = "f32") -> None:
    """One warm step under torch.profiler: device and wall ms, the device's
    busy share, the device time of layout copies (cuDNN's NHWC/NCHW
    transposes; PyTorch's copy kernels, which s2d, d2s and the permutes
    run), the top operations by device time."""
    from torch.profiler import ProfilerActivity, profile

    from retinex_tpu_torch.train.train_state import train_step

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, crit, x, packed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise AssertionError("the profiler recorded no device time in the train step")
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    transposes = sum(e.self_device_time_total for e in device if "ToNchw" in e.key or "ToNhwc" in e.key) / 1e3
    copies = sum(e.self_device_time_total for e in device if "copy" in e.key) / 1e3
    print(f"  one warm {STEP_NAME[packed]} {what} step under torch.profiler: {device_ms:.3f} device ms of {wall_ms:.3f} "
          f"wall ms (device busy {device_ms / wall_ms:.3f}); layout copies {transposes:.3f} device ms in cuDNN's "
          f"transposes, {copies:.3f} in PyTorch's copy kernels; top device operations (self device ms, calls):")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f}  x{e.count:<5d} {e.key[:100]}")


def train_timing(torch, modules, x, card: str) -> None:
    """Warm f32 train steps at the CLI's defaults ([8,640,640,3],
    perceptual loss on), packed and standard in turns (ms, images/s, peak
    device memory, the spread); each step by stage and under torch.profiler
    (top device operations). No kernel launched."""
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.train.trainer import build_criterion

    cuda = torch.device("cuda")
    crit = build_criterion(Config(), cuda)
    runs = {STEP_NAME[p]: (new_state(torch, cuda), p) for p in (True, False)}
    with no_kernel(modules, "f32 train steps"):
        print_turns(step_turns(torch, runs, crit, x), "f32", card)
        for name, (state, packed) in runs.items():
            step_stages(torch, state, crit, x, packed)
            step_profile(torch, state, crit, x, packed)
    del runs
    torch.cuda.empty_cache()


def train_phase(torch, modules, workdir: Path) -> str:
    """Phase 20: training through the CLI at the JAX defaults on the 24
    in-repo photos (the packed step, its log saying so), a resume, and the
    standard step (``--no-packed_train``) resumed from the packed
    checkpoint; each step on the card against the CPU's, packed against
    standard on the card, warm steps of both in turns, and predict and the
    default enhance from the packed run's checkpoint held to the CPU's runs
    from it; then bf16 training and --remat: the card's bf16 steps against
    the CPU's, warm bf16 steps, the remat steps against the plain ones with
    their peaks, and the CLI's --use_amp --remat training with predict from
    its checkpoint. No train step launches a kernel. Returns the trained
    (f32) checkpoint's path (in `workdir`, beside the f32 runs' outputs)."""
    import shutil

    from retinex_tpu_torch.train.orbax import read_orbax

    train_dir = REPO / "data" / "convergence"
    if len(list(train_dir.glob("lowlight_*.png"))) != 24:
        raise AssertionError(f"expected the 24 photos of {train_dir}")
    card = gpu_line()
    save = workdir / "train"
    base = ["--mode", "train", "--train_dir", str(train_dir), "--device", "cuda", *TRAIN_ARGS]
    launches, sec, log = run_cli_logged(torch, modules, [*base, "--save_dir", str(save), "--num_epochs", "2"])
    check_launches(launches, {}, "training")  # the training path runs no hand-written kernel
    if PACKED_LOG not in log:
        raise AssertionError("--mode train at the CLI defaults did not take the packed step")
    first = read_orbax(str(save / "latest"))
    launches, sec2, log = run_cli_logged(torch, modules, [*base, "--save_dir", str(save), "--num_epochs", "3",
                                                          "--resume", str(save / "latest")])
    check_launches(launches, {}, "training, resumed")
    if PACKED_LOG not in log:
        raise AssertionError("the resumed run did not take the packed step")
    last, best = read_orbax(str(save / "latest")), read_orbax(str(save / "best"))
    if tuple(int(t[k]) for t in (first, last) for k in ("step", "epoch")) != (6, 1, 9, 2):
        raise AssertionError(f"steps/epochs {first['step']}/{first['epoch']} -> {last['step']}/{last['epoch']}, "
                             "expected 6/1 -> 9/2")
    logs = list((save / "logs").glob("*/metrics.jsonl"))
    vis = list((save / "visualizations").glob("epoch_*.png"))
    if not ((save / "results.csv").is_file() and logs and len(vis) == 12):
        raise AssertionError(f"training outputs missing: results.csv, {len(logs)} metrics.jsonl, {len(vis)} PNGs")
    bad = [p for p, v in _tree_leaves(last["params"]).items() if not np.isfinite(v).all()]
    if bad:
        raise AssertionError(f"non-finite weights after training: {bad[:3]}")
    # The standard step through the CLI, resumed from the packed run's checkpoint.
    save_std = workdir / "train_standard"
    shutil.copytree(save, save_std)
    launches, sec3, log = run_cli_logged(torch, modules, [*base, "--save_dir", str(save_std), "--num_epochs", "4",
                                                          "--no-packed_train", "--resume", str(save_std / "latest")])
    check_launches(launches, {}, "standard training, resumed from the packed checkpoint")
    std_last = read_orbax(str(save_std / "latest"))
    if "packed_train" in log or (int(std_last["step"]), int(std_last["epoch"])) != (12, 3):
        raise AssertionError(f"--no-packed_train: step {std_last['step']} epoch {std_last['epoch']} (expected 12/3), "
                             "or the log names the packed step")
    print(f"  --mode train (the packed step, logged), 24 photos at 640 px, batch 8, 2 epochs (3 steps each): "
          f"{sec:.1f} s; --resume to epoch 3: {sec2:.1f} s; step {first['step']} -> {last['step']}, best loss "
          f"{float(best['best_loss']):.6f} (epoch {best['epoch']}); {len(logs)} metrics.jsonl, results.csv, {len(vis)} "
          f"visualisations; --no-packed_train resumed from it to epoch 4 (the standard step): {sec3:.1f} s, step "
          f"{std_last['step']}; no kernel launched")

    for packed in (False, True):
        train_step_vs_cpu(torch, modules, packed)
    x = train_batch(torch, train_dir)
    packed_vs_standard(torch, modules, x)
    train_timing(torch, modules, x, card)
    trained_inference(torch, modules, str(save / "best"), workdir)
    print("  bf16 training (--use_amp) and --remat")
    for packed in (False, True):
        amp_train_step_vs_cpu(torch, modules, packed)
    amp_timing(torch, modules, x, card)
    remat_phase(torch, modules, x, card)
    amp_remat_cli(torch, modules, workdir)
    return str(save / "best")


class _Tee(io.TextIOBase):
    """Standard output that also keeps what passes through it."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, s: str) -> int:
        self.out.write(s)
        return self.kept.write(s)

    def flush(self) -> None:
        self.out.flush()


def run_cli_logged(torch, modules, args) -> tuple[dict[str, int], float, str]:
    """``run_cli``, returning what the CLI printed too."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        launches, seconds = run_cli(torch, modules, args)
    return launches, seconds, tee.kept.getvalue()


def trained_inference(torch, modules, ckpt: str, workdir: Path) -> None:
    """Predict and the default enhance from the trained checkpoint `ckpt`
    on the 1080p photo (K4-K6, and K1-K3 for enhance) and at --max_size
    512 held to the port's CPU runs from the same checkpoint: predict
    within 1 level on under 1e-4 of the bytes, enhance by ``hold_to_cpu``."""
    from PIL import Image

    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.predict import predict_single_image

    src = REPO / "data" / "convergence" / "lowlight_000.png"
    photo, small = workdir / "photo1080.png", workdir / "photo512.png"
    with Image.open(src) as im:
        im.convert("RGB").resize((1920, 1080), Image.BILINEAR).save(photo)
        im.convert("RGB").resize((512, 288), Image.BILINEAR).save(small)
    for mode, want in (("predict", FAM_TWICE), ("enhance", {**LAB_CLAHE_ONCE, **FAM_TWICE})):
        out = workdir / f"{mode}_1920"
        launches, _ = run_cli(torch, modules, ["--mode", mode, "--checkpoint", ckpt, "--input_path", str(photo),
                                               "--output_dir", str(out), "--max_size", "1920", "--device", "cuda"])
        check_launches(launches, want, f"{mode} from the trained checkpoint")
        check_pngs(out, photo.stem, (1088, 1920, 3))
    out = workdir / "predict_512"
    launches, _ = run_cli(torch, modules, ["--mode", "predict", "--checkpoint", ckpt, "--input_path", str(small),
                                           "--output_dir", str(out), "--max_size", "512", "--device", "cuda"])
    check_launches(launches, FAM_TWICE, "predict at --max_size 512 from the trained checkpoint")
    check_pngs(out, small.stem, (288, 512, 3))
    cpu_apply = cli.build_apply_fn(Config(mode="predict", checkpoint=ckpt, device="cpu"), torch.device("cpu"),
                                   require_checkpoint=True)
    predict_single_image(cpu_apply, str(small), str(workdir / "predict_512_cpu"), max_size=512, device="cpu")
    for kind in ("enhanced", "illumination"):
        d = np.abs(png_u8(out / f"{small.stem}_{kind}.png") - png_u8(workdir / "predict_512_cpu" / f"{small.stem}_{kind}.png"))
        print(f"  predict from the trained checkpoint at --max_size 512, {kind}, card vs CPU: max {int(d.max())} "
              f"level(s), {float((d > 0).mean()):.2e} of bytes differ")
        if d.max() > 1 or (d > 0).mean() >= 1e-4:
            raise AssertionError(f"predict's {kind} PNG from the trained checkpoint disagrees with the CPU run")
    out = workdir / "enhance_512"
    launches, _ = run_cli(torch, modules, ["--mode", "enhance", "--checkpoint", ckpt, "--input_path", str(small),
                                           "--output_dir", str(out), "--max_size", "512", "--device", "cuda"])
    check_launches(launches, {**LAB_CLAHE_ONCE, **FAM_TWICE}, "enhance at --max_size 512 from the trained checkpoint")
    got = check_pngs(out, small.stem, (288, 512, 3))
    hold_to_cpu(torch, got, small, 512, packed=True, checkpoint=ckpt)


# Phase 20's bf16 training and --remat. The card's bf16 step against the
# port's bf16 CPU step (tests/test_torch_amp_train.py's rules: losses two
# bf16 ulps, BatchNorm statistics 4e-3; Adam's moments within three times
# the CPU bf16 step's distance from the CPU f32 step, plus 2e-3 of the
# largest: bf16 rounding noise, which grows through the backward); the
# remat step against the plain one (tests/test_remat.py's: total rtol 1e-6,
# BatchNorm statistics 5e-6).
AMP_TRAIN_LOSS_RTOL = 2.0**-6
AMP_TRAIN_STATS_ATOL = 4e-3
AMP_TRAIN_NOISE = (3.0, 2e-3)


def _hold_noise(got: dict, want: dict, ref: dict, what: str) -> float:
    """Each leaf of the card's bf16 `got` within AMP_TRAIN_NOISE's factor
    times the CPU bf16 `want`'s distance from the CPU f32 `ref`, plus its
    floor of ref's largest magnitude; returns the worst ratio to that."""
    factor, floor = AMP_TRAIN_NOISE
    top, worst = max(float(v.abs().max()) for v in ref.values()), 0.0
    for k, w in want.items():
        tol = factor * float((w - ref[k]).abs().max()) + floor * top
        d = float((got[k].cpu() - w).abs().max())
        worst = max(worst, d / tol)
        if d > tol:
            raise AssertionError(f"{what} {k}: card vs CPU {d:.3e} > {tol:.3e}")
    return worst


def amp_train_step_vs_cpu(torch, modules, packed: bool) -> None:
    """One bf16 train step (``--use_amp``: the net and VGG19 in bf16,
    parameters and Adam f32), standard or packed, of the default net on the
    card against the same step on the CPU, same batch and seed-0 weights,
    perceptual loss on; the CPU's f32 step of the same kind is the
    reference of the noise rule. No kernel launched."""
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.train.train_state import train_step
    from retinex_tpu_torch.train.trainer import build_criterion

    x = np.random.default_rng(13).random(TRAIN_HOLD_SHAPE, dtype=np.float32) * 0.6
    runs = {}
    for dev, amp in (("cpu", False), ("cpu", True), ("cuda", True)):
        d = torch.device(dev)
        state = new_state(torch, d, torch.bfloat16 if amp else torch.float32)
        with no_kernel(modules, f"the {STEP_NAME[packed]} bf16 train step"):
            losses = train_step(state, build_criterion(Config(use_amp=amp), d), torch.from_numpy(x).to(d), packed)
            runs[(dev, amp)] = (state, {k: float(v) for k, v in losses.items()})
    (ref, _), (cpu, l_cpu), (card, l_card) = runs[("cpu", False)], runs[("cpu", True)], runs[("cuda", True)]
    what = f"{STEP_NAME[packed]} bf16 train step"
    for k, v in l_cpu.items():
        if abs(l_card[k] - v) > 1e-5 + AMP_TRAIN_LOSS_RTOL * abs(v):
            raise AssertionError(f"{what}, loss {k}: card {l_card[k]} vs CPU {v}")
    stats_cpu, stats_card = _stats(cpu.model), _stats(card.model)
    d_stats = max(float((stats_card[k].cpu() - v).abs().max()) for k, v in stats_cpu.items())
    if d_stats > AMP_TRAIN_STATS_ATOL:
        raise AssertionError(f"{what}: BatchNorm statistics card vs CPU {d_stats:.3e} > {AMP_TRAIN_STATS_ATOL}")
    mu_w = _hold_noise(card.optimizer.mu, cpu.optimizer.mu, ref.optimizer.mu, f"{what} Adam mu")
    nu_w = _hold_noise(card.optimizer.nu, cpu.optimizer.nu, ref.optimizer.nu, f"{what} Adam nu")
    eff = lambda st: {k: v / 0.1 for k, v in st.optimizer.mu.items()}  # noqa: E731
    worst = _hold_params({k: p.detach() for k, p in card.model.named_parameters()},
                         {k: p.detach() for k, p in cpu.model.named_parameters()}, eff(card), eff(cpu))
    if any(p.dtype != torch.float32 for p in card.model.parameters()):
        raise AssertionError("bf16 training changed the parameters' dtype")
    print(
        f"  one {what} at {list(TRAIN_HOLD_SHAPE)}, card vs CPU: losses within rtol 2**-6 (total "
        f"{l_card['total']:.6f} vs {l_cpu['total']:.6f}), BatchNorm statistics {d_stats:.2e} (atol "
        f"{AMP_TRAIN_STATS_ATOL:g}), Adam mu and nu at {mu_w:.3f} and {nu_w:.3f} of the noise rule's tolerance, "
        f"parameters within Adam's first update of each side's gradient (largest difference {worst:.3f} lr); no "
        "kernel launched"
    )


def amp_timing(torch, modules, x, card: str) -> None:
    """Warm bf16 train steps (``--use_amp``) at [8,640,640,3], packed and
    standard in turns: ms, images/s, peak device memory, the spread; each
    under torch.profiler."""
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.train.trainer import build_criterion

    cuda = torch.device("cuda")
    crit = build_criterion(Config(use_amp=True), cuda)
    runs = {STEP_NAME[p]: (new_state(torch, cuda, torch.bfloat16), p) for p in (True, False)}
    with no_kernel(modules, "bf16 train steps"):
        print_turns(step_turns(torch, runs, crit, x), "bf16", card)
        for state, packed in runs.values():
            step_profile(torch, state, crit, x, packed, "bf16")
    del runs
    torch.cuda.empty_cache()


def remat_phase(torch, modules, x, card: str) -> None:
    """At [8,640,640,3] in f32, for the standard and the packed step: one
    step with --remat against the plain step from the same weights and
    batch (losses, BatchNorm statistics) and each step's peak memory (the
    remat step's must be lower: its blocks' or stages' activations are
    recomputed, not kept); then warm remat steps, packed and standard in
    turns."""
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.train.train_state import train_step
    from retinex_tpu_torch.train.trainer import build_criterion

    cuda = torch.device("cuda")
    crit = build_criterion(Config(), cuda)
    for packed in (False, True):
        one = {}
        for remat in (False, True):
            st = new_state(torch, cuda, remat=remat)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with no_kernel(modules, f"the {STEP_NAME[packed]} step, remat {remat}"):
                losses = {k: float(v) for k, v in train_step(st, crit, x, packed).items()}
            torch.cuda.synchronize()
            one[remat] = (losses, _stats(st.model), torch.cuda.max_memory_allocated())
            del st
        (l_plain, s_plain, p_plain), (l_remat, s_remat, p_remat) = one[False], one[True]
        name = STEP_NAME[packed]
        if abs(l_remat["total"] - l_plain["total"]) > 1e-6 * abs(l_plain["total"]):
            raise AssertionError(f"the {name} --remat step's total {l_remat['total']} differs from the plain "
                                 f"{l_plain['total']}")
        d_stats = max(float((s_remat[k] - v).abs().max()) for k, v in s_plain.items())
        if d_stats > 5e-6:
            raise AssertionError(f"the {name} --remat step's BatchNorm statistics differ from the plain step's by "
                                 f"{d_stats:.3e}")
        if not p_remat < p_plain:
            raise AssertionError(f"--remat did not lower the {name} step's peak memory: {p_remat} against {p_plain}")
        print(
            f"  f32 {name} train step with --remat at [8,640,640,3]: total loss {l_remat['total']:.6f} (plain "
            f"{l_plain['total']:.6f}, rtol 1e-6), BatchNorm statistics within {d_stats:.2e} (atol 5e-6); peak device "
            f"memory of one step {p_remat / 2**30:.3f} GiB with --remat against {p_plain / 2**30:.3f} GiB without "
            f"({p_remat / p_plain:.3f})"
        )
    runs = {STEP_NAME[p]: (new_state(torch, cuda, remat=True), p) for p in (True, False)}
    with no_kernel(modules, "remat train steps"):
        print_turns(step_turns(torch, runs, crit, x), "f32 --remat", card)
    del runs
    torch.cuda.empty_cache()


def amp_remat_cli(torch, modules, workdir: Path) -> None:
    """``--mode train --use_amp --remat`` through the CLI (the packed step,
    logged): two steps (16 of the photos, batch 8, one epoch at 640 px), no
    kernel launched; its checkpoint f32 in the plain format; ``--mode
    predict --use_amp`` from it on the 1080p photo (the bf16 FAM kernels,
    twice each)."""
    import shutil

    from retinex_tpu_torch.train.orbax import read_orbax

    photos = workdir / "train16"
    photos.mkdir()
    for i in range(16):
        shutil.copy(REPO / "data" / "convergence" / f"lowlight_{i:03d}.png", photos)
    save = workdir / "train_amp_remat"
    launches, sec, log = run_cli_logged(torch, modules, [
        "--mode", "train", "--use_amp", "--remat", "--train_dir", str(photos), "--save_dir", str(save),
        "--device", "cuda", "--num_epochs", "1", *TRAIN_ARGS])
    check_launches(launches, {}, "bf16 training with --remat")
    if PACKED_LOG not in log:
        raise AssertionError("--mode train --use_amp --remat did not take the packed step")
    ckpt = read_orbax(str(save / "latest"))
    floats = [v for key in ("params", "batch_stats") for v in _tree_leaves(ckpt[key]).values()]
    floats += [v for key in ("mu", "nu") for v in _tree_leaves(ckpt["opt_state"][2][key]).values()]
    if int(ckpt["step"]) != 2 or any(v.dtype != np.float32 for v in floats):
        raise AssertionError(f"bf16 --remat training: step {ckpt['step']} (expected 2), or a parameter not f32")
    if not all(np.isfinite(v).all() for v in floats):
        raise AssertionError("non-finite weights after bf16 --remat training")
    out = workdir / "predict_amp_remat"
    photo = workdir / "photo1080.png"
    got, psec = run_cli(torch, modules, ["--mode", "predict", "--use_amp", "--checkpoint", str(save / "best"),
                                         "--input_path", str(photo), "--output_dir", str(out), "--max_size", "1920",
                                         "--device", "cuda"])
    check_launches(got, amp_want(AMP_FAM_TWICE), "predict --use_amp from the bf16 --remat checkpoint")
    check_pngs(out, photo.stem, (1088, 1920, 3))
    print(f"  --mode train --use_amp --remat (the packed step, logged), 16 photos at 640 px, batch 8, one epoch (2 "
          f"steps): {sec:.1f} s, no kernel launched, checkpoint f32 at step 2; predict --use_amp from it at "
          f"--max_size 1920: {psec:.2f} s, bf16 FAM kernels twice each")


# Phase 21: bf16 inference. The FAM kernels' bf16 instances against their
# bf16 plain versions on the card: one bf16 ulp (2**-7 relative at most),
# or 2**-10 where the output is a small difference of larger terms
# (tests/test_torch_amp_kernels.py); K4's z stage, f32, within K4's 2e-4.
# K4 whole rounds twice (y, then the output): a y that rounds the other way
# (conv_wgmma sums in another order than cuDNN) moves the output's f32 sum,
# so two ulps (seen: two ulps at 0.8 on the [8,136,240,128] chunk, chip
# call 8, PR 14).
AMP_ULP = 2.0**-7
AMP_ATOL = 2.0**-10
AMP_ULPS = {"fam_conv_fused": 2}
AMP_Z_TOL = 2e-4
# The bf16 net on the card against the port's bf16 CPU run, by output: the
# card's cuDNN and cuBLAS sum in other orders than the CPU's f32 emulation,
# so bf16 values flip by an ulp now and then and the flips add up through
# the net (as the port's CPU run against the JAX package's,
# tests/test_torch_amp_net.py: 5.4e-3, 7.0e-3 and one illumination ulp).
AMP_NET_TOL = {"enhanced": 2e-2, "reflectance": 3e-2, "illumination": 2.0**-7}
# The bf16 kernels of the kernels line, by the f32 kernel's name.
AMP_KERNELS = ("fam_conv_fused", "fam_tail_stats", "fam_tail_apply_g1", "fam_tail_apply")
AMP_FAM_TWICE = {"fam_conv_fused_bf16": 2, "fam_tail_stats_bf16": 2, "fam_tail_apply_g1_bf16": 2}
AMP_FAM_1080 = {"fam_conv_fused_bf16": 2, "fam_tail_stats_bf16": 2, "fam_tail_apply_bf16": 2}


def amp_want(want: dict[str, int]) -> dict[str, int]:
    """`want` with the bf16 K4's and K10's stages and K6's diagonal
    instance, as ``check_launches`` adds them for the f32 kernels."""
    k4, k10 = want.get("fam_conv_fused_bf16", 0), want.get("dec1_chain_bf16", 0)
    return {**want, **{f"{k}_bf16": k4 for k in K4_STAGES}, **{f"{k}_bf16": k10 for k in K10_STAGES},
            "fam_tail_apply_g1_diag_bf16": want.get("fam_tail_apply_g1_bf16", 0)}


# K10 in bf16 (NetCfg(dec1_chain=True) with --use_amp): its four stages on
# conv_wgmma, each held to its plain version on the plain previous stage's
# output at BF16_TOL (one output ulp, as phases 17-19 hold conv_wgmma); the
# chain whole within one bf16 ulp at its largest output (as
# tests/test_torch_dec1_chain_bf16.py holds the plain version to the JAX
# kernel). K10 rounds three intermediates (y1, y2, y3): one that rounds the
# other way moves the next sums by its ulp times the weights, which near 0
# is more than the output's own ulp, so K4's elementwise two-ulp rule
# (AMP_ULPS) fails on a few values (on an H100: 60 of 4,177,920 at
# [1,544,960], by up to 4.4e-3 on values under 0.01); the count past that
# rule is printed. At the shapes of phase 12.
K10_BF16 = tuple(f"{k}_bf16" for k in ("dec1_chain", *K10_STAGES))


def ulp_at_largest(want) -> float:
    """One bf16 ulp at the largest magnitude of `want`."""
    return 2.0 ** (int(np.floor(np.log2(float(want.float().abs().max())))) - 7)


def amp_dec1_kernel_phase(torch, fb, shape, seed: int, timed: bool = False) -> dict:
    """K10's bf16 instance at `shape` ([b, h, w] of d2): d2 and x1p rounded
    to bf16, the f32 weights of phase 12 packed once for bf16; one call's
    launches (each stage once, BF16_LAUNCHES), the chain against its plain
    version, each stage on the plain previous stage's output, and on a
    batch its first and last image to K10 on each alone. With `timed`, the
    median ms over 25 launches of the chain and of each stage, the plain
    versions' and each stage's one F.conv2d in bf16 (+ ReLU, + x1p; its
    difference from the plain version printed: it adds the bias and the
    residual in bf16, after rounding), and the bounds at 989 TFLOP/s.
    Returns {kernels-line name: record}."""
    bf = torch.bfloat16
    d2, x1p, *weights = dec1_inputs(torch, shape, seed)
    d2, x1p = d2.to(bf), x1p.to(bf)
    k_up, b_up, k_c1, b_c1, k_c2, b_c2, k_rc, b_rc = weights
    b, h, w = shape
    p = fb.pack_dec1_chain(*weights, dtype=bf)
    fb.reset_launches()
    got = fb.dec1_chain(d2, x1p, *weights, packed=p)
    torch.cuda.synchronize()
    ran = {k: v for counts in (fb.LAUNCHES, fb.KERNEL_LAUNCHES, fb.BF16_LAUNCHES) for k, v in counts.items() if v}
    if ran != dict.fromkeys(K10_BF16, 1):
        raise AssertionError(f"one bf16 dec1_chain call at {shape} launched {ran}, expected each of {K10_BF16} once")
    want = fb.dec1_chain_plain(d2, x1p, *weights)
    if got.dtype != bf or want.dtype != bf:
        raise AssertionError(f"bf16 dec1_chain at {shape}: dtypes {got.dtype} and {want.dtype}")
    diff = (got.float() - want.float()).abs()
    err, tol = float(diff.max()), ulp_at_largest(want)
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"bf16 dec1_chain disagrees with its plain version at {shape}: max |diff| {err:.3e} > "
                             f"{tol:g}")
    past = int((diff > 2 * (AMP_ULP * want.float().abs() + AMP_ATOL)).sum())
    line = (f"  {list(shape)} bf16 dec1_chain: max |diff| {err:.3e} (tolerance one ulp at its largest output "
            f"{float(want.float().abs().max()):.3f}, {tol:g}; {past} of {diff.numel()} values past K4's "
            f"elementwise two-ulp rule); one call: {ran}")
    y1 = fb.dec1_up_plain(d2, k_up, b_up)
    y2 = fb.dec1_conv_plain(y1, k_c1, b_c1)
    y3 = fb.dec1_conv_plain(y2, k_c2, b_c2, x1p)
    calls = {
        "dec1_up": (lambda: fb.dec1_up(d2, p), lambda: fb.dec1_up_plain(d2, k_up, b_up)),
        "dec1_c1": (lambda: fb.dec1_c1(y1, p), lambda: fb.dec1_conv_plain(y1, k_c1, b_c1)),
        "dec1_c2": (lambda: fb.dec1_c2(y2, x1p, p), lambda: fb.dec1_conv_plain(y2, k_c2, b_c2, x1p)),
        "dec1_rc": (lambda: fb.dec1_rc(y3, p), lambda: fb.dec1_conv_plain(y3, k_rc, b_rc)),
    }
    rec = {"dec1_chain_bf16": dict(max_abs_err=err, dtype="bfloat16")}
    for name, (kernel, plain) in calls.items():
        e = _close(torch, kernel(), plain(), f"bf16 {name} at {shape}")
        rec[f"{name}_bf16"] = dict(max_abs_err=e, dtype="bfloat16")
    line += "; by stage (BF16_TOL) " + ", ".join(f"{n} {rec[f'{n}_bf16']['max_abs_err']:.2e}" for n in K10_STAGES)
    for j in sorted({0, b - 1} if b > 1 else ()):
        alone = fb.dec1_chain(d2[j : j + 1].contiguous(), x1p[j : j + 1].contiguous(), *weights, packed=p)
        if not torch.equal(alone, got[j : j + 1]):
            raise AssertionError(f"bf16 dec1_chain at {shape}: image {j} of the batch differs from K10 on it alone")
    if b > 1:
        line += "; first and last image identical to K10 on each alone"
    if timed:
        n_px = b * h * w
        pk = PEAK_BF16_OPS_PER_S
        weight_bytes = 2 * (64 * 128 + 3 * 9 * 128 * 128) + 4 * 4 * 128
        k10 = rec["dec1_chain_bf16"]
        k10.update(
            ms=time_ms(torch, lambda: fb.dec1_chain(d2, x1p, *weights, packed=p)),
            plain_ms=time_ms(torch, lambda: fb.dec1_chain_plain(d2, x1p, *weights), n=5),
            bound=bound(2 * n_px * (64 + 128 + 128) + weight_bytes, 2 * n_px * (64 * 128 + 27 * 128 * 128), pk),
            library_ms=None,
        )
        libs = {
            "dec1_up": conv_library(torch, d2, k_up, b_up, relu=False),
            "dec1_c1": conv_library(torch, y1, k_c1, b_c1),
            "dec1_c2": conv_library(torch, y2, k_c2, b_c2, residual=x1p),
            "dec1_rc": conv_library(torch, y3, k_rc, b_rc),
        }
        lib_errs = []
        for name, (kernel, plain) in calls.items():
            cin, taps, residual = K10_STAGES[name]
            n_bytes = 2 * n_px * (cin + 128 + 128 * residual) + 2 * taps * cin * 128 + 4 * 128
            lib_errs.append(float((libs[name]().permute(0, 2, 3, 1).float() - plain().float()).abs().max()))
            rec[f"{name}_bf16"].update(ms=time_ms(torch, kernel), plain_ms=time_ms(torch, plain, n=5),
                                       library_ms=time_ms(torch, libs[name]),
                                       bound=bound(n_bytes, 2 * n_px * taps * cin * 128, pk))
        line += (
            f"; {k10['ms']:.4f} ms (plain {k10['plain_ms']:.3f} ms, bound {k10['bound'][0]:.4f} ms by "
            f"{k10['bound'][1]}, {k10['bound'][0] / k10['ms']:.1%} of it); by stage "
            + ", ".join(f"{n} {rec[f'{n}_bf16']['ms']:.4f} (plain {rec[f'{n}_bf16']['plain_ms']:.3f}, F.conv2d bf16 "
                        f"{rec[f'{n}_bf16']['library_ms']:.4f}, bound {rec[f'{n}_bf16']['bound'][0]:.4f} by "
                        f"{rec[f'{n}_bf16']['bound'][1]})" for n in K10_STAGES)
            + f", sum {sum(rec[f'{n}_bf16']['ms'] for n in K10_STAGES):.4f}; F.conv2d in bf16 against the plain "
            "versions (bias and residual added in bf16): " + ", ".join(f"{e:.2e}" for e in lib_errs)
        )
    print(line)
    return rec


def amp_dec1_forward_phase(torch, modules, ckpt: str, photo: Path, small: Path) -> dict[str, int]:
    """The bf16 dec1-chain forward, ``PackedRetinex(bf16 model,
    NetCfg(dec1_chain=True))`` with the trained checkpoint's weights: at
    1088x1920 and 1080x1920 against the bf16 default packed forward (the
    dec1 chain as cuDNN convolutions whose residual add rounds in bf16)
    within AMP_NET_TOL, K10's bf16 launches counted from zero around each
    forward; on the 288x512 frame the card's forward against the port's
    bf16 CPU run within AMP_NET_TOL; warm net ms with and without it at
    1088x1920, in turns. Returns the launches of K10's bf16 entries over
    the two frame-size forwards."""
    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.enhance import load_image
    from retinex_tpu_torch.models.packed_inference import NetCfg, PackedRetinex

    models = {dev: cli.build_model(Config(mode="enhance", checkpoint=ckpt, use_amp=True), torch.device(dev))
              for dev in ("cuda", "cpu")}
    default, fused = PackedRetinex(models["cuda"]), PackedRetinex(models["cuda"], NetCfg(dec1_chain=True))
    k10 = dict.fromkeys(K10_BF16, 0)
    xs = {}
    for max_size in (1920, None):
        img, _ = load_image(str(photo), max_size)
        x = xs[max_size] = torch.from_numpy(img).to("cuda")[None]
        with torch.inference_mode():
            base = default(x)
            for m in modules:
                m.reset_launches()
            got = fused(x)
            torch.cuda.synchronize()
        launches = launch_counts(modules)
        fam = AMP_FAM_TWICE if max_size == 1920 else AMP_FAM_1080
        check_launches(launches, amp_want({**fam, "dec1_chain_bf16": 1}),
                       f"the bf16 dec1-chain forward at {tuple(x.shape[1:3])}")
        k10 = {k: v + launches[k] for k, v in k10.items()}
        for (name, tol), a, b in zip(AMP_NET_TOL.items(), got, base):
            if a.shape != b.shape or a.dtype != b.dtype or not torch.isfinite(a).all():
                raise AssertionError(f"bf16 dec1-chain {name}: {a.dtype} {tuple(a.shape)} vs {b.dtype} "
                                     f"{tuple(b.shape)}, or non-finite")
            d = (a.float() - b.float()).abs()
            print(f"  bf16 dec1-chain forward {tuple(x.shape[1:3])}, {name} ({a.dtype}): max |diff| "
                  f"{float(d.max()):.3e}, mean {float(d.mean()):.3e} against the bf16 default packed forward "
                  f"(tolerance {tol:g})")
            if float(d.max()) > tol:
                raise AssertionError(f"the bf16 dec1-chain forward's {name} disagrees with the bf16 default forward")
        print(f"  K10 bf16 launches in the bf16 dec1-chain forward at {tuple(x.shape[1:3])}: "
              + ", ".join(f"{k} {launches[k]}" for k in K10_BF16))

    img, _ = load_image(str(small), 512)
    x = torch.from_numpy(img)[None]
    with torch.inference_mode():
        card = fused(x.cuda())
        cpu = PackedRetinex(models["cpu"], NetCfg(dec1_chain=True))(x)
    errs = {n: float((a.cpu().float() - b.float()).abs().max()) for n, a, b in zip(AMP_NET_TOL, card, cpu)}
    print(f"  bf16 dec1-chain forward at {tuple(x.shape[1:3])}, card vs the port's bf16 CPU run: max |diff| "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + " (tolerance " + ", ".join(f"{t:g}" for t in AMP_NET_TOL.values()) + ")")
    if any(errs[n] > AMP_NET_TOL[n] for n in errs):
        raise AssertionError("the card's bf16 dec1-chain forward disagrees with the port's bf16 CPU run")

    med = in_turns(torch, {"default": default, "dec1_chain": fused}, xs[1920])
    print(
        f"  warm bf16 packed net at 1088x1920, batch 1: default (dec1 on cuDNN) {med['default']:.3f} ms, "
        f"NetCfg(dec1_chain=True) (K10 in bf16) {med['dec1_chain']:.3f} ms, ratio "
        f"{med['dec1_chain'] / med['default']:.4f}"
    )
    return k10


def amp_inputs(torch, fb, shape, seed: int) -> dict:
    """``fam_inputs`` in bf16: x and sa rounded to bf16, ca_vec of bf16
    values kept f32 (the kernels take it so), the f32 weights packed for the
    bf16 instance, y and z from the bf16 plain stages (z f32)."""
    d = fam_inputs(torch, fb, shape, seed)
    bf = torch.bfloat16
    d["x"], d["sa"] = d["x"].to(bf), d["sa"].to(bf)
    d["ca_vec"] = d["ca_vec"].to(bf).float()
    d["packed"] = fb.pack_fam_conv(*(d[k] for k in ("ka", "kb", "k1", "b1", "k32", "k42", "bias_total")), dtype=bf)
    d["y"] = fb.fam_conv_y_plain(d["x"], d["k1"], d["b1"])
    d["z"] = fb.fam_conv_z_plain(d["y"], d["k2"], d["bias_total"])
    return d


def amp_bounds(shape) -> dict:
    """The bound of each bf16 FAM kernel at `shape`: its bf16 (z: f32)
    inputs and outputs read and written once, the weights once (bf16 where
    the kernel reads them so), its operations at the bf16 peak."""
    b, h, w, c = shape
    n_px = b * h * w
    conv_ops = 2 * n_px * 9 * c * 2 * c
    w3 = 2 * 9 * c * 2 * c  # one 3x3 kernel, bf16
    pk = PEAK_BF16_OPS_PER_S
    return {
        "fam_conv_fused": bound(2 * 2 * n_px * c + 2 * 2 * c * c + 2 * w3 + 4 * 3 * c,
                                2 * conv_ops + 2 * n_px * 2 * c * c, pk),
        "fam_conv_y": bound(n_px * (2 * c + 2 * 2 * c) + w3 + 4 * 2 * c, conv_ops, pk),
        "fam_conv_z": bound(n_px * (2 * 2 * c + 4 * c) + w3 + 4 * c, conv_ops, pk),
        "fam_conv_out": bound(n_px * (4 * c + 2 * c + 2 * c) + 2 * 2 * c * c, 2 * n_px * 2 * c * c, pk),
        "fam_tail_stats": bound(n_px * (2 * c + 2 * 8) + 4 * b * c, K5_OPS_PER_PX * n_px, pk),
        "fam_tail_apply_g1": bound(n_px * (2 * c + 2 * 4 + 2 * c) + 4 * (b * c + c * c // 4),
                                   n_px * (2 * c + 2 * c * c // 4), pk),
        "fam_tail_apply_g1_dense": bound(n_px * (2 * c + 2 * 4 + 2 * c) + 4 * (b * c + c * c),
                                         n_px * (2 * c + 2 * c * c), pk),
        "fam_tail_apply": bound(n_px * (2 * c + 2 * 4 + 2 * c) + 4 * b * c, n_px * 2 * c, pk),
    }


def amp_kernel_phase(torch, fb, shape, seed: int, timed: tuple = ()) -> dict:
    """Hold the bf16 instances of K4 (whole and by stage), K5, K6 (both w
    layouts) and K11 to their bf16 plain versions on the card at `shape`
    (one ulp; K4's z f32 and within AMP_Z_TOL), and on a batch each
    kernel's first and last image to the kernel on that image alone. Return
    records: the error (max |diff|, and in ulps beyond AMP_ATOL), and for
    the kernels in `timed` the median ms, the plain version's ms, the bound."""
    d = amp_inputs(torch, fb, shape, seed)
    calls = fam_calls(fb, d)
    b = shape[0]
    bounds = amp_bounds(shape)
    recs = {}
    for name, (kernel, plain, args) in calls.items():
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.dtype != (torch.float32 if name == "fam_conv_z" else torch.bfloat16):
            raise AssertionError(f"bf16 {name} at {shape}: dtypes {got.dtype} and {want.dtype}")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if name == "fam_conv_z":
            ok, rule = err <= AMP_Z_TOL, f"f32, tolerance {AMP_Z_TOL:g}"
        else:
            ulps = AMP_ULPS.get(name, 1)
            over = float((diff - ulps * AMP_ULP * want.float().abs()).max())
            ok, rule = np.isfinite(err) and over <= ulps * AMP_ATOL, f"{ulps} bf16 ulp(s), or {ulps} x 2**-10"
        if not ok:
            raise AssertionError(f"bf16 {name} disagrees with its bf16 plain version at {shape}: max |diff| {err:.3e}")
        line = f"  {list(shape)} bf16 {name}: max |diff| {err:.3e} ({rule})"
        for j in sorted({0, b - 1} if b > 1 else ()):
            alone = fam_calls(fb, {k: v[j : j + 1].contiguous() if k in FAM_PER_IMAGE else v for k, v in d.items()})
            if not torch.equal(alone[name][0](*alone[name][2]), got[j : j + 1]):
                raise AssertionError(f"bf16 {name} at {shape}: image {j} differs from the kernel on it alone")
        if b > 1:
            line += "; first and last image identical to the kernel on each alone"
        recs[name] = dict(max_abs_err=err)
        if name in timed:
            ms = time_ms(torch, lambda: kernel(*args))
            plain_ms = time_ms(torch, lambda: plain(*args), n=5)
            recs[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=bounds[name])
            line += (
                f"; {ms:.4f} ms per launch (plain {plain_ms:.3f} ms, bound {bounds[name][0]:.4f} ms by "
                f"{bounds[name][1]}, {bounds[name][0] / ms:.1%} of it)"
            )
        print(line)
        del got, want
    return recs


# K6's dense bf16 instance (fam_tail_apply_g1_wgmma_kernel) beyond
# amp_kernel_phase's dense w at Cout 128: the wgmma's other widths (Cout 4,
# N 32; Cout 36, N 64 with 8-byte stores) at these shapes.
AMP_DENSE_COUTS = (4, 36)
AMP_DENSE_SHAPES = (FAM_RAGGED, FAM_SHAPES[1])


def amp_dense_phase(torch, fb) -> int:
    """Hold K6's dense bf16 instance (csrc/fam_tail_wgmma.cu) within one
    bf16 ulp of its bf16 plain version at Cout 4 and 36
    (``AMP_DENSE_SHAPES``), a packed and an unpacked call identical; and,
    unpacked on the quadrant-diagonal w of ``amp_inputs`` (so this kernel),
    within one ulp of the plain version and of the quadrant-diagonal
    instance at FAM_SHAPES and FAM_RAGGED; time the unpacked call (w split
    into the kernel's B on each call) beside the packed one at
    FAM_SHAPES[0]. Then drive the op as a caller does, every count at 0 just
    before: one packed call on a dense w at each of FAM_SHAPES, each
    launching this kernel and nothing else, held to the plain version.
    Returns that drive's launches of the kernel."""

    def held(got, want, what: str) -> float:
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if got.dtype != torch.bfloat16 or not np.isfinite(err) or float((diff - AMP_ULP * want.float().abs()).max()) > AMP_ATOL:
            raise AssertionError(f"bf16 K6 dense (wgmma) {what}: max |diff| {err:.3e}, beyond one bf16 ulp")
        return err

    for i, shape in enumerate((*FAM_SHAPES, FAM_RAGGED)):
        d = amp_inputs(torch, fb, shape, seed=80 + i)
        args = [d["x"], d["ca_vec"], d["sa"]]
        line = f"  {list(shape)} bf16 K6 dense (wgmma):"
        if shape in AMP_DENSE_SHAPES:
            for cout in AMP_DENSE_COUTS:
                w = d["wg"][:, :cout].contiguous()
                got = fb.fam_tail_apply_g1(*args, w, packed=fb.pack_tail_g1(w))
                err = held(got, fb.fam_tail_apply_g1_plain(*args, w), f"at Cout {cout}, {shape}")
                if not torch.equal(got, fb.fam_tail_apply_g1(*args, w)):
                    raise AssertionError(f"bf16 K6 dense at Cout {cout}, {shape}: packed and unpacked calls differ")
                line += f" Cout {cout} max |diff| {err:.3e} (packed = unpacked);"
        diag = fb.fam_tail_apply_g1(*args, d["wd"], packed=d["wd_packed"])
        as_dense = fb.fam_tail_apply_g1(*args, d["wd"])
        err = held(as_dense, fb.fam_tail_apply_g1_plain(*args, d["wd"]), f"on the diagonal w at {shape}")
        err_diag = held(as_dense, diag, f"against the quadrant-diagonal instance at {shape}")
        line += (f" on the quadrant-diagonal w, unpacked, max |diff| {err:.3e} from the plain version, {err_diag:.3e} "
                 f"from the quadrant-diagonal instance (one bf16 ulp)")
        if i == 0:
            packed_ms = time_ms(torch, lambda: fb.fam_tail_apply_g1(*args, d["wg"], packed=d["wg_packed"]))
            unpacked_ms = time_ms(torch, lambda: fb.fam_tail_apply_g1(*args, d["wg"]))
            line += (f"; device ms a call at Cout 128: packed {packed_ms:.4f}, unpacked {unpacked_ms:.4f} (w split "
                     f"into the kernel's B on each call)")
        print(line)
        del d, args, diag, as_dense

    ds = [amp_inputs(torch, fb, s, seed=84 + i) for i, s in enumerate(FAM_SHAPES)]
    fb.reset_launches()
    outs = [fb.fam_tail_apply_g1(d["x"], d["ca_vec"], d["sa"], d["wg"], packed=d["wg_packed"]) for d in ds]
    torch.cuda.synchronize()
    ran = {k: v for counts in (fb.LAUNCHES, fb.KERNEL_LAUNCHES, fb.BF16_LAUNCHES) for k, v in counts.items() if v}
    if ran != {"fam_tail_apply_g1_bf16": len(ds), "fam_tail_apply_g1_dense_bf16": len(ds)}:
        raise AssertionError(f"the bf16 dense K6 drive launched {ran}, expected fam_tail_apply_g1_dense_bf16 once a call")
    for d, out in zip(ds, outs):
        held(out, fb.fam_tail_apply_g1_plain(d["x"], d["ca_vec"], d["sa"], d["wg"]), "in the op drive")
    print(f"  bf16 K6 dense op drive (a packed call at each of {[list(s) for s in FAM_SHAPES]}, counts from zero): {ran}")
    return ran["fam_tail_apply_g1_dense_bf16"]


def amp_net_times(torch, ckpt: str, photo: Path) -> None:
    """Warm net ms per image, bf16 beside f32, packed and standard, at
    batch 1 and 8 on the 1088x1920 frame (the trained checkpoint's
    weights), medians of host-clock runs ended by a synchronise; and end to
    end per photo (decode to the three PNGs written), bf16 beside f32."""
    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.enhance import enhance_single_image, load_image

    img = torch.from_numpy(load_image(str(photo), 1920)[0]).cuda()
    fns = {
        (amp, packed): cli.build_apply_fn(Config(mode="enhance", checkpoint=ckpt, use_amp=amp, packed_inference=packed),
                                          torch.device("cuda"))
        for amp in (False, True) for packed in (True, False)
    }
    for batch, reps in ((1, 5), (8, 3)):
        x = img[None].expand(batch, -1, -1, -1).contiguous()
        ms = {}
        for key, fn in fns.items():
            runs = []
            for _ in range(reps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(x)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3 / batch)
            ms[key] = statistics.median(runs[1:])
        print(f"  warm net ms per image at [{batch},1088,1920,3]: packed f32 {ms[(False, True)]:.3f}, bf16 "
              f"{ms[(True, True)]:.3f} ({ms[(False, True)] / ms[(True, True)]:.2f}x); standard f32 "
              f"{ms[(False, False)]:.3f}, bf16 {ms[(True, False)]:.3f} ({ms[(False, False)] / ms[(True, False)]:.2f}x)")
        del x
    e2e = {}
    for amp in (False, True):
        runs = []
        for i in range(4):
            t0 = time.perf_counter()
            enhance_single_image(fns[(amp, True)], str(photo), str(photo.parent / f"amp_e2e_{amp}_{i}"), max_size=1920,
                                 device="cuda")
            runs.append((time.perf_counter() - t0) * 1e3)
        e2e[amp] = statistics.median(runs[1:])
    print(f"  end to end per photo (decode to three PNGs written), packed at --max_size 1920: f32 {e2e[False]:.1f} ms, "
          f"bf16 {e2e[True]:.1f} ms")


def amp_phase(torch, modules, ckpt: str, workdir: Path) -> tuple[dict, dict]:
    """Phase 21: the bf16 instances of K4-K6 and K11 against their bf16
    plain versions (timed at the frame's shapes); --use_amp enhance on the
    photo at --max_size 1920 and with no flags (K11), and predict, through
    the CLI with their launch counts; the bf16 net held to the port's bf16
    CPU run stage by stage; bf16 against f32 on the same photo (printed);
    the nets' and the kernels' times; then K10 in bf16, whole and by stage,
    against its plain version (``amp_dec1_kernel_phase``) and the bf16
    dec1-chain forward (``amp_dec1_forward_phase``). Returns (records,
    launches) of the four bf16 FAM kernels and K10's five bf16 entries, by
    their kernels-line names."""
    from PIL import Image

    cg, cl, fb, cp, kp = modules
    recs: dict = {}
    fam = [amp_kernel_phase(torch, fb, s, seed=60 + i, timed=FAM_TIMED) for i, s in enumerate(FAM_SHAPES)]
    fam_1080 = [amp_kernel_phase(torch, fb, s, seed=62 + i, timed=("fam_tail_apply",)) for i, s in enumerate(FAM_SHAPES_1080)]
    held = [amp_kernel_phase(torch, fb, FAM_RAGGED, seed=64), amp_kernel_phase(torch, fb, FAM_DIR_SHAPES[1], seed=65)]
    for name in FAM_KERNELS:
        per = [r[name] for r in (fam if name in FAM_TIMED else fam_1080)]
        recs[name] = dict(
            max_abs_err=max(r[name]["max_abs_err"] for r in fam + fam_1080 + held),
            ms=sum(r["ms"] for r in per), plain_ms=sum(r["plain_ms"] for r in per),
            bound=(sum(r["bound"][0] for r in per), per[0]["bound"][1]), dtype="bfloat16",
        )
    lib = k6_library_phase(torch, fb, bf16=True)
    recs["fam_tail_apply_g1"]["library_ms"], recs["fam_tail_apply_g1_dense"]["library_ms"] = lib["diag"], lib["dense"]
    dense_launches = amp_dense_phase(torch, fb)
    stages = ", ".join(f"{n} {recs[n]['ms']:.4f} (bound {recs[n]['bound'][0]:.4f}, "
                       f"{recs[n]['bound'][0] / recs[n]['ms']:.1%})" for n in K4_STAGES)
    k4 = recs["fam_conv_fused"]
    print(f"  bf16 K4 device ms per image at 1088x1920 (scale-1 + scale-2 launches): {k4['ms']:.4f} against its bound "
          f"{k4['bound'][0]:.4f} ({k4['bound'][0] / k4['ms']:.1%} of it), plain {k4['plain_ms']:.4f}; by stage: "
          f"{stages}")
    for name in ("fam_tail_stats", "fam_tail_apply_g1", "fam_tail_apply_g1_dense", "fam_tail_apply"):
        r = recs[name]
        where = "1080x1920" if name == "fam_tail_apply" else "1088x1920"
        lib_ms = f", torch.einsum in bf16 {r['library_ms']:.4f}" if "library_ms" in r else ""
        print(f"  bf16 {name} device ms per image at {where}: {r['ms']:.4f} against its bound {r['bound'][0]:.4f} by "
              f"{r['bound'][1]} ({r['bound'][0] / r['ms']:.1%}), plain {r['plain_ms']:.4f}{lib_ms}")

    src = REPO / "data" / "convergence" / "lowlight_000.png"
    photo, small, small_flagless = workdir / "photo1080.png", workdir / "photo512.png", workdir / "photo480.png"
    with Image.open(src) as im:
        im.convert("RGB").resize((480, 264), Image.BILINEAR).save(small_flagless)
    launches = dict.fromkeys(AMP_KERNELS, 0)
    drives = [  # (what, CLI arguments, launches wanted, the enhanced PNG's shape)
        ("enhance --use_amp at --max_size 1920", ["--mode", "enhance", "--input_path", str(photo), "--max_size", "1920"],
         {**LAB_CLAHE_ONCE, **AMP_FAM_TWICE}, (1088, 1920, 3)),
        ("enhance --use_amp with no flags", ["--mode", "enhance", "--input_path", str(photo)],
         {**LAB_CLAHE_TILES_ONCE, **AMP_FAM_1080}, (1080, 1920, 3)),
        ("predict --use_amp from the trained checkpoint at --max_size 1920",
         ["--mode", "predict", "--input_path", str(photo), "--max_size", "1920"], AMP_FAM_TWICE, (1088, 1920, 3)),
    ]
    for i, (what, args, want, shape) in enumerate(drives):
        out = workdir / f"amp_{i}"
        got, sec = run_cli(torch, modules, [*args, "--checkpoint", ckpt, "--use_amp", "--output_dir", str(out),
                                            "--device", "cuda"])
        check_launches(got, amp_want(want), what)
        for name in AMP_KERNELS:
            launches[name] += got[f"{name}_bf16"]
        png = check_pngs(out, photo.stem, shape)
        print(f"  {what}: {sec:.2f} s (cold); bf16 launches "
              + ", ".join(f"{k} {v}" for k, v in got.items() if k.endswith("_bf16") and v))
        if i != 1:  # against the f32 run of the same checkpoint (phase 20), printed
            ref = png_u8(workdir / f"{args[1]}_1920" / f"{photo.stem}_enhanced.png")
            d = np.abs(png.astype(np.int16) - ref.astype(np.int16))
            print(f"    its enhanced PNG against f32 from the same checkpoint (what --use_amp costs): max {int(d.max())} "
                  f"levels, mean {float(d.mean()):.4f}, {float((d > 0).mean()):.2e} of bytes differ")
    for name in AMP_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"the bf16 {name} was never launched by the --use_amp drives")

    # The bf16 net on the card against the port's bf16 CPU run, stage by stage.
    for frame, max_size in ((small, 512), (small_flagless, None)):
        out = workdir / f"amp_small_{frame.stem}"
        _, _ = run_cli(torch, modules, ["--mode", "enhance", "--input_path", str(frame), "--checkpoint", ckpt,
                                        "--use_amp", "--output_dir", str(out), "--device", "cuda"]
                       + ([] if max_size is None else ["--max_size", str(max_size)]))
        got = check_pngs(out, frame.stem, (288, 512, 3) if max_size else (264, 480, 3))
        hold_to_cpu(torch, got, frame, max_size, packed=True, checkpoint=ckpt, use_amp=True)
    amp_net_times(torch, ckpt, photo)
    profile_phase(torch, photo, amp=True, checkpoint=ckpt)

    print("  K10 in bf16 (NetCfg(dec1_chain=True) with --use_amp): four conv_wgmma launches")
    for name, (cin, taps, _) in K10_STAGES.items():
        k = 3 if taps == 9 else 1
        print(f"  bf16 {name}: conv_wgmma plan {cp.wgmma_plan(cin, 128, k, k)}")
    dec1 = [amp_dec1_kernel_phase(torch, fb, s, seed=70 + i, timed=i == 0) for i, s in enumerate(DEC1_SHAPES)]
    for name in K10_BF16:
        recs[name] = dict(dec1[0][name], max_abs_err=max(r[name]["max_abs_err"] for r in dec1))
    dec1_launches = amp_dec1_forward_phase(torch, modules, ckpt, photo, small)
    out = {f"{k}_bf16": recs[k] for k in (*AMP_KERNELS, "fam_tail_apply_g1_dense")} | {k: recs[k] for k in K10_BF16}
    return out, {f"{k}_bf16": v for k, v in launches.items()} | dec1_launches | {
        "fam_tail_apply_g1_dense_bf16": dense_launches}


# Phase 22: serving (retinex_tpu_torch/infer/serving.py). Each artifact is
# exported on the card for a canvas (the full-width standard net, the
# classical modes), then loaded and served in one fresh process that imports
# only the serving module (``SERVER``), and held byte for byte to the eager
# pipeline in this process: (the export's pipeline, canvas, the kernel
# launches of one served call).
SERVING_BATCHES = (1, 4)
LUMA_ONCE = {"clahe_tables": 1, "clahe_luma_apply_u8": 1}
SERVING_ARTIFACTS = {
    "enhance": ("enhance", (1088, 1920), LAB_CLAHE_ONCE),
    "predict": ("predict", (1088, 1920), {}),
    "enhance_tiles": ("enhance", (1080, 1920), LAB_CLAHE_TILES_ONCE),
    "clahe": (("clahe", 1), (1088, 1920), LAB_CLAHE_ONCE),
    "clahe_luma": (("clahe_luma", 2), (1088, 1920), LUMA_ONCE),
}
# The serving process: argv[1] is a JSON {name: {"artifact", "inputs",
# "out"}}; each artifact is loaded, each batch of its inputs (.npz by batch
# size) served on the card with every launch count at 0 just before and read
# just after, the outputs saved to "out" (.npz, "<batch>_<output>"). Prints
# {"counts": {name: [counts per batch]}, "modules": [...]} as its last line.
SERVER = r"""
import json, sys
import numpy as np, torch
from retinex_tpu_torch.infer import serving

jobs, counts = json.loads(sys.argv[1]), {}
for name, job in jobs.items():
    served = serving.load_enhancer(job["artifact"])
    from retinex_tpu_torch.ops import clahe_gather, clahe_luma

    outs, counts[name] = {}, []
    for batch, x in sorted(np.load(job["inputs"]).items(), key=lambda kv: int(kv[0])):
        xb = torch.from_numpy(x).cuda()
        for m in (clahe_gather, clahe_luma):
            m.reset_launches()
        out = served(xb)
        torch.cuda.synchronize()
        counts[name].append({k: v for m in (clahe_gather, clahe_luma) for k, v in m.LAUNCHES.items() if v})
        for i, o in enumerate(out if isinstance(out, tuple) else (out,)):
            outs[f"{batch}_{i}"] = o.cpu().numpy()
    np.savez(job["out"], **outs)
loaded = sorted(m for m in sys.modules if m.startswith(("retinex_tpu", "jax")))
assert not [m for m in loaded if m.startswith(("retinex_tpu_torch.models", "retinex_tpu_torch.cli", "jax"))
            or m == "retinex_tpu" or m.startswith("retinex_tpu.")], loaded
print(json.dumps({"counts": counts, "modules": loaded}))
"""


def serving_inputs(h: int, w: int) -> dict[int, np.ndarray]:
    """u8 batches of 1 and 4 data/convergence photos on an h x w canvas: each
    photo resized to 1920x1080, as phase 8's, then letterboxed to 1920 (to
    1088x1920) where the canvas asks for it."""
    from PIL import Image

    from retinex_tpu_torch.ops.letterbox import letterbox_np, plan_letterbox

    frames = []
    for i in range(max(SERVING_BATCHES)):
        with Image.open(REPO / "data" / "convergence" / f"lowlight_{i:03d}.png") as im:
            rgb = np.asarray(im.convert("RGB").resize((1920, 1080), Image.BILINEAR))
        if (h, w) != rgb.shape[:2]:
            rgb = letterbox_np(rgb, plan_letterbox(1080, 1920, 1920, auto=True, scaleup=False))
        if rgb.shape[:2] != (h, w):
            raise AssertionError(f"letterboxed to {rgb.shape[:2]}, expected {(h, w)}")
        frames.append(rgb)
    return {b: np.stack(frames[:b]) for b in SERVING_BATCHES}


def serving_graph_ops(serving, blob: bytes) -> list[str]:
    """The port's operators that an artifact's exported graph calls."""
    graph = serving.load_program(blob).graph
    return sorted({str(n.target).split(".")[1] for n in graph.nodes
                   if n.op == "call_function" and str(n.target).startswith("retinex_tpu_torch.")})


def serving_phase(torch, ckpt: str | None, workdir: Path) -> dict[str, int]:
    """Phase 22: the serving artifacts exported on the card (the full-width
    standard net from `ckpt`, or from seed 0 without one), each graph's
    operators checked, served in a fresh process that never imports the
    model code (``SERVER``), its bytes identical to the eager pipeline's
    here (``make_batch_pipeline`` on the standard net, the quantised forward
    for predict) and its launches per served call as
    ``SERVING_ARTIFACTS`` says; then the warm served and eager ms per image
    in turns. Returns the served calls' launches by kernel."""
    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer import serving
    from retinex_tpu_torch.infer.enhance import _quant, make_batch_pipeline

    cuda = torch.device("cuda")
    model = cli.build_model(Config(mode="enhance", checkpoint=ckpt or ""), cuda, require_checkpoint=bool(ckpt))

    def standard(batch):
        return model(batch)

    def predict(batch_u8):
        enh, _refl, illu = model(batch_u8.to(torch.float32) / 255.0)
        return _quant(enh), _quant(illu)

    eager = {
        "enhance": make_batch_pipeline(standard), "predict": predict,
        ("clahe", 1): lambda b: make_batch_pipeline(None, "clahe")(b)[:1],
        ("clahe_luma", 2): lambda b: make_batch_pipeline(None, "clahe_luma", hist_subsample=2)(b)[:1],
    }
    wants = {
        "enhance": ["clahe_apply_f32_nhwc", "clahe_tables", "lab_fwd_f32_nhwc"], "predict": [],
        "enhance_tiles": ["clahe_apply_tiles_f32_nhwc", "clahe_tables_tiles", "lab_fwd_f32_nhwc"],
        "clahe": ["clahe_apply_f32_nhwc", "clahe_tables", "lab_fwd_f32_nhwc"],
        "clahe_luma": ["clahe_luma_apply_u8", "clahe_tables"],
    }
    inputs = {canvas: serving_inputs(*canvas) for canvas in {c for _, c, _ in SERVING_ARTIFACTS.values()}}
    jobs, blobs = {}, {}
    for name, (pipeline, (h, w), _) in SERVING_ARTIFACTS.items():
        path = workdir / f"serving_{name}.pt2"
        t0 = time.perf_counter()
        if isinstance(pipeline, tuple):
            blob = serving.export_classical(pipeline[0], h, w, path=str(path), device=cuda, hist_subsample=pipeline[1])
        else:
            blob = serving.export_enhancer(model, h, w, path=str(path), device=cuda, pipeline=pipeline)
        ops = serving_graph_ops(serving, blob)
        print(f"  {name} artifact at {h}x{w}: {len(blob) / 1e6:.2f} MB, exported in {time.perf_counter() - t0:.1f} s, "
              f"its graph calls {ops}")
        if ops != wants[name]:
            raise AssertionError(f"the {name} artifact's graph calls {ops}, expected {wants[name]}")
        np.savez(workdir / f"serving_in_{h}.npz", **{str(b): x for b, x in inputs[(h, w)].items()})
        jobs[name] = {"artifact": str(path), "inputs": str(workdir / f"serving_in_{h}.npz"),
                      "out": str(workdir / f"serving_out_{name}.npz")}
        blobs[name] = blob
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SERVER, json.dumps(jobs)], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the serving process failed ({proc.returncode}):\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-8000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"  the serving process ({time.perf_counter() - t0:.1f} s) loaded {len(report['modules'])} modules of the "
          f"port, none of retinex_tpu_torch.models, the CLI or JAX: {report['modules']}")

    launches: dict[str, int] = {}
    with torch.inference_mode():
        for name, (pipeline, (h, w), once) in SERVING_ARTIFACTS.items():
            served = np.load(jobs[name]["out"])
            for batch, counts in zip(SERVING_BATCHES, report["counts"][name]):
                if counts != once:
                    raise AssertionError(f"a served {name} call at batch {batch} launched {counts}, expected {once}")
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
                x = torch.from_numpy(inputs[(h, w)][batch]).to(cuda)
                want = eager[pipeline](x)
                for i, (kind, wo) in enumerate(zip(("enhanced", "illumination"), want)):
                    got, wo = served[f"{batch}_{i}"].astype(np.int16), wo.cpu().numpy().astype(np.int16)
                    d = np.abs(got - wo)
                    if got.shape != wo.shape or d.max() > 0:
                        raise AssertionError(
                            f"served {name} {kind} at [{batch},{h},{w},3] differs from the eager pipeline: shape "
                            f"{got.shape} against {wo.shape}, max {int(d.max())} level(s) on {int((d > 0).sum())} "
                            f"bytes ({float((d > 0).mean()):.2e})")
            kinds = "enhanced and illumination" if len(want) == 2 else "enhanced"
            print(f"  served {name} at batches {SERVING_BATCHES}: {kinds} identical to the eager pipeline's; "
                  f"launches a call {once or 'none'}")

    card = gpu_line()
    for name in ("enhance", "clahe", "clahe_luma"):
        pipeline, (h, w), _ = SERVING_ARTIFACTS[name]
        loaded = serving.load_enhancer(blobs[name])
        for batch in SERVING_BATCHES:
            x = torch.from_numpy(inputs[(h, w)][batch]).to(cuda)
            ms = in_turns(torch, {"served": loaded, "eager": eager[pipeline]}, x)
            print(f"  warm ms per image, {name} at [{batch},{h},{w},3]: served {ms['served'] / batch:.3f}, eager "
                  f"{ms['eager'] / batch:.3f} ({ms['served'] / ms['eager']:.4f}x), in turns; {card}")
    return launches


# Sharded against one card, the net routes' PNGs: at most this many levels
# apart, on at most this share of the bytes (a .5 tie that the net's float
# crosses and Lab-CLAHE spreads; phase 8's batch against single images:
# 5 levels on 1.63e-06 of an image's bytes, PR 19).
SHARD_PNG_BOUND = (8, 1e-4)
DP_ROUTES = {  # route: (classical mode, the one-card directory run's launches)
    "net": (None, DIR_MODES["net"][1]),
    "clahe": ("clahe", DIR_MODES["clahe"][1]),
    "clahe_luma": ("clahe_luma", DIR_MODES["clahe_luma"][1]),
    "predict": (None, {"fam_conv_fused": 6, "fam_tail_stats": 6, "fam_tail_apply_g1": 6}),
}


def dp_directory_run(torch, route: str, ckpt: str, photos: Path, out: Path, mesh) -> None:
    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.enhance import enhance_batch_images
    from retinex_tpu_torch.infer.predict import predict_batch

    cuda = torch.device("cuda")
    mode, _ = DP_ROUTES[route]
    knobs = dict(max_size=1920, batch_size=8, num_workers=8, device="cuda", mesh=mesh)
    if route == "predict":
        apply = cli.build_apply_fn(Config(mode="predict", checkpoint=ckpt), cuda, require_checkpoint=True, mesh=mesh)
        predict_batch(apply, str(photos), str(out), **knobs)
    else:
        apply = None if mode else cli.build_apply_fn(Config(mode="enhance", checkpoint=ckpt), cuda, mesh=mesh)
        enhance_batch_images(apply, str(photos), str(out), classical_mode=mode, **knobs)


def dp_sharded_inference(torch, modules, ckpt: str, workdir: Path) -> dict[str, int]:
    """Phase 23 (a) and (b): the directory routes on one card and on a
    two-shard mesh of ``cuda:0``; returns the sharded runs' launches."""
    from PIL import Image

    from retinex_tpu_torch import cli
    from retinex_tpu_torch.parallel.mesh import Mesh

    photos = make_directory(REPO / "data" / "convergence", workdir)
    mesh = Mesh((torch.device("cuda", 0),) * 2)
    total: dict[str, int] = {}
    for route, (mode, want) in DP_ROUTES.items():
        dirs, secs = {}, {}
        for label, m in (("one", None), ("sharded", mesh)):
            dirs[label] = workdir / f"dp_{route}_{label}"
            for mod in modules:
                mod.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                dp_directory_run(torch, route, ckpt, photos, dirs[label], m)
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t0
            launches = launch_counts(modules)
            check_launches(launches, want if m is None else {k: 2 * v for k, v in want.items()},
                           f"{route} on {'one card' if m is None else 'two shards'}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        names = sorted(p.name for p in dirs["one"].iterdir())
        if names != sorted(p.name for p in dirs["sharded"].iterdir()) or len(names) != 48:
            raise AssertionError(f"{route}: the sharded run wrote other files than the one-card run")
        n_diff, n_bytes, worst = 0, 0, 0
        for name in names:
            if name.endswith("_comparison.png"):
                continue
            a, b = (np.asarray(Image.open(dirs[k] / name)).astype(np.int16) for k in ("one", "sharded"))
            d = np.abs(a - b)
            n_diff, n_bytes, worst = n_diff + int((d > 0).sum()), n_bytes + d.size, max(worst, int(d.max()))
        print(f"  (a) {route}: two shards of cuda:0 vs one card: {n_diff} of {n_bytes} bytes differ, max {worst} "
              f"level(s); launches per shard {{{', '.join(f'{k}: {v // 2}' for k, v in launches.items() if v)}}} "
              f"x2; {secs['one']:.3f} s on one card, {secs['sharded']:.3f} s sharded (cold)")
        if mode and n_diff:
            raise AssertionError(f"{route}: the sharded PNGs differ from the one-card run's")
        if worst > SHARD_PNG_BOUND[0] or n_diff > SHARD_PNG_BOUND[1] * n_bytes:
            raise AssertionError(f"{route}: sharded vs one card beyond {SHARD_PNG_BOUND}")

    n = torch.cuda.device_count() + 1
    try:
        cli.main(["--mode", "enhance", "--input_path", str(photos), "--output_dir", str(workdir / "dp_raise"),
                  "--classical_mode", "clahe", "--n_devices", str(n), "--device", "cuda"])
    except ValueError as e:
        if "asked for" not in str(e):
            raise
        print(f"  (b) --n_devices {n}: raises ValueError: {e}")
    else:
        raise AssertionError(f"--n_devices {n} ran on {n - 1} visible card(s)")
    return total


def dp_steps(torch, card: str) -> None:
    """Phase 23 (c), (d) and (f): the packed step at the CLI defaults, plain,
    in a world of one NCCL rank and in two gloo ranks on ``cuda:0``."""
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.losses.total import LossConfig
    from retinex_tpu_torch.train.data_parallel import StepSpec, one_step, sharded_steps

    lr = Config().lr
    spec = StepSpec(packed=True, lr=lr, loss=LossConfig(use_perceptual_loss=True), timed=6, deterministic=True)
    batch = train_batch(torch, REPO / "data" / "convergence").cpu().numpy()
    plain = one_step(spec, batch, "cuda")
    again = one_step(dataclasses.replace(spec, timed=0), batch, "cuda")
    torch.cuda.empty_cache()

    def same(a: dict, b: dict) -> bool:
        return a["loss"] == b["loss"] and all(
            torch.equal(a[key][k], b[key][k]) for key in ("params", "stats") for k in a[key]
        )

    print(f"  (c) the plain step ([8,640,640,3], packed, perceptual loss on, deterministic cuDNN) run twice: "
          f"{'bit-identical' if same(plain, again) else 'DIFFERENT'}; total loss {plain['loss']['total']!r}")
    if not same(plain, again):
        raise AssertionError("the plain step is not reproducible on this card")
    nccl = sharded_steps(1, [spec], batch, device="cuda", backend="nccl")[0]
    if not same(nccl, plain):
        raise AssertionError(f"a world of one NCCL rank differs from the plain step: {nccl['loss']} vs {plain['loss']}")
    print(f"  (c) backend nccl, a world of 1: losses, parameters and BatchNorm statistics equal the plain step's "
          f"bit for bit")
    gloo = sharded_steps(2, [spec], batch, device="cuda:0", backend="gloo")[0]
    rel = abs(gloo["loss"]["total"] - plain["loss"]["total"]) / abs(plain["loss"]["total"])
    diffs = np.concatenate([(gloo["params"][k] - v).abs().reshape(-1).numpy() for k, v in plain["params"].items()])
    stats = max(float((gloo["stats"][k] - v).abs().max()) for k, v in plain["stats"].items())
    q99 = float(np.quantile(diffs, 0.99))
    print(f"  (d) backend gloo, 2 ranks on cuda:0 (4 rows each): total loss {gloo['loss']['total']!r} vs "
          f"{plain['loss']['total']!r} (rel {rel:.3e}); parameters max {diffs.max():.3e} apart "
          f"({diffs.max() / lr:.3f} lr), 0.99 quantile {q99:.3e}; BatchNorm statistics max {stats:.3e} apart")
    if rel > 1e-4 or diffs.max() > 2.1 * lr or q99 >= 1e-4:
        raise AssertionError("the 2-rank step is outside tests/test_parallel.py's bounds")
    print(f"  (f) warm step, median of 5 ({card}): plain {plain['ms']:.3f} ms, NCCL world of 1 {nccl['ms']:.3f} ms, "
          f"2 gloo ranks on one card {gloo['ms']:.3f} ms (the two ranks share the card: this measures the "
          f"collectives, not a speed-up)")


def data_parallel_phase(torch, modules, ckpt: str, workdir: Path) -> dict[str, int]:
    """Phase 23 (the module docstring); returns (a)'s sharded launches."""
    from retinex_tpu_torch.graft_entry import dryrun_multichip

    card = gpu_line()
    t0 = time.perf_counter()
    launches = dp_sharded_inference(torch, modules, ckpt, workdir)
    dp_steps(torch, card)
    print("  (e) graft_entry.dryrun_multichip(2) on the card:")
    dryrun_multichip(2)
    print(f"  phase 23 took {time.perf_counter() - t0:.1f} s")
    return launches


# Phase 24: spatial sharding (parallel/spatial.py) on meshes that repeat
# cuda:0, and the host path (data/native_loader.py). The spatial CLAHE at
# the JAX test's letterboxed 4K frame and at 1088x1920; the spatial forward
# at full width, the CLI's net and pre-activation + ASPP, at both shapes.
SPATIAL_MESHES = (2, 4, 8)
SPATIAL_SHAPES = ((2176, 3840), (1088, 1920))
SPATIAL_NETS = {"cli": (False, False), "preact_aspp": (True, True)}
# The spatial forward against one card in f32: the means' summation order
# (tests/test_spatial_sharding.py's bound for the JAX package's GSPMD forward).
SPATIAL_F32_TOL = 2e-6
# One Lab-CLAHE or luma-CLAHE call on n slabs: each kernel once a slab.
SPATIAL_CLAHE_ONCE = {
    "clahe": {"lab_fwd_f32_nhwc": 1, "clahe_tables": 1, "clahe_apply_f32_nhwc": 1},
    "clahe_luma": {"clahe_tables": 1, "clahe_luma_apply_u8": 1},
}


def wall_ms(torch, fn, n: int = 3) -> float:
    """Median wall ms of fn() to its results on the card, over n calls after one."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def slab_applies(torch, cg, cl, x, n: int, card: str) -> dict:
    """Phase 24 (a): each slab's apply (K3 in its three cell-mode instances,
    K8's apply half among them, and K7 on NHWC) at its row0 against its
    plain version with that row0 and against the whole frame's launch; the
    last slab's K3 float instance and K7 timed against their bounds, beside
    the whole frame's launch."""
    b, h, w, _ = x.shape
    rows, ncy = h // n, 16 // n
    lab = cg.lab_fwd_f32_nhwc(x)
    luts = cg.clahe_tables(lab)
    xq = torch.clamp(torch.round(torch.clamp(x, 0.0, 1.0) * 255.0), 0, 255).to(torch.uint8).contiguous()
    y = cl._luma_u8(xq, dim=3)
    luts_y = cg.clahe_tables(y)
    whole = {"f32": cg.clahe_apply_f32_nhwc(lab, luts), "nhwc": cg.clahe_apply_u8_nhwc(lab, luts),
             "u8": cg.clahe_apply_u8(lab, luts), "k7": cl.clahe_luma_apply_u8(xq, y, luts_y)}
    worst = {"clahe_apply_f32_nhwc": 0, "clahe_luma_apply_u8": 0}
    for i in range(n):
        r, row0 = slice(i * rows, (i + 1) * rows), i * ncy
        ls, xs, ys = lab[:, :, r].contiguous(), xq[:, r].contiguous(), y[:, r].contiguous()
        got = {"f32": cg.clahe_apply_f32_nhwc(ls, luts, row0, ncy), "nhwc": cg.clahe_apply_u8_nhwc(ls, luts, row0, ncy),
               "u8": cg.clahe_apply_u8(ls, luts, row0, ncy), "k7": cl.clahe_luma_apply_u8(xs, ys, luts_y, row0, ncy)}
        plain = {"f32": cg.clahe_apply_f32_nhwc_plain(ls, luts, row0, ncy),
                 "nhwc": cg.clahe_apply_u8_nhwc_plain(ls, luts, row0, ncy),
                 "u8": cg.clahe_apply_u8_plain(ls, luts, row0, ncy),
                 "k7": cl.clahe_luma_apply_u8_plain(xs, ys, luts_y, row0, ncy)}
        for k in got:
            a = torch.round(got[k] * 255.0).to(torch.uint8) if k == "f32" else got[k]
            p = torch.round(plain[k] * 255.0).to(torch.uint8) if k == "f32" else plain[k]
            err, frac = u8_diff(torch, a, p)
            if err > (0 if k == "k7" else 1) or frac >= 1e-4:
                raise AssertionError(f"{k} on slab {i} of {n} (row0 {row0}) disagrees with its plain version")
            whole_rows = whole[k][:, :, r] if k == "u8" else whole[k][:, r]
            if not torch.equal(got[k], whole_rows):
                raise AssertionError(f"{k} on slab {i} of {n} (row0 {row0}) differs from the whole frame's rows")
            name = "clahe_luma_apply_u8" if k == "k7" else "clahe_apply_f32_nhwc"
            worst[name] = max(worst[name], err)
    px, lut_bytes = b * rows * w, b * 64 * 256
    last = ((n - 1) * rows, (n - 1) * ncy)
    ls = lab[:, :, last[0]:].contiguous()
    xs, ys = xq[:, last[0]:].contiguous(), y[:, last[0]:].contiguous()
    k3_ms = time_ms(torch, lambda: cg.clahe_apply_f32_nhwc(ls, luts, last[1], ncy))
    k7_ms = time_ms(torch, lambda: cl.clahe_luma_apply_u8(xs, ys, luts_y, last[1], ncy))
    k3_bound = bound(15 * px + lut_bytes + 4 * cg.APPLY_TABLE_WORDS, INSTR_PER_PX["clahe_apply_f32_nhwc"] * px,
                     PEAK_ISSUE_PER_S)
    k7_bound = bound(7 * px + lut_bytes + 4 * (2 * w + rows + 256), INSTR_PER_PX["clahe_luma_apply_u8"] * px,
                     PEAK_ISSUE_PER_S)
    k3_whole = time_ms(torch, lambda: cg.clahe_apply_f32_nhwc(lab, luts))
    k7_whole = time_ms(torch, lambda: cl.clahe_luma_apply_u8(xq, y, luts_y))
    print(f"  (a) {h}x{w} on {n} slabs: every slab's K3 (f32 NHWC, u8 NHWC = K8's apply, u8 planar) and K7 at its row0 "
          f"equal their plain versions (K3 within {worst['clahe_apply_f32_nhwc']} level(s), K7 exact) and the whole "
          f"frame's rows; the last slab ({rows} rows, row0 {last[1]}) on {card}: K3 clahe_apply_f32_nhwc "
          f"{k3_ms:.4f} ms (bound {k3_bound[0]:.4f} by {k3_bound[1]}, {k3_bound[0] / k3_ms:.1%}), K7 "
          f"clahe_luma_apply_u8 {k7_ms:.4f} ms (bound {k7_bound[0]:.4f} by {k7_bound[1]}, {k7_bound[0] / k7_ms:.1%}); "
          f"the whole frame's launch: K3 {k3_whole:.4f} ms, K7 {k7_whole:.4f} ms")
    return worst


def spatial_clahe_phase(torch, cg, cl, card: str) -> dict[str, int]:
    """Phase 24 (a): ``make_spatial_clahe`` in both modes on meshes of 2, 4
    and 8 shards of ``cuda:0`` at SPATIAL_SHAPES, each byte-identical to the
    one-card route, every slab's kernels counted (K3 and K7 on slabs with
    row0 > 0 in ``SLAB_LAUNCHES``); returns the sharded calls' launches."""
    from retinex_tpu_torch.ops.clahe import clahe_lab_rgb
    from retinex_tpu_torch.ops.clahe_luma import clahe_luma_rgb
    from retinex_tpu_torch.parallel.mesh import Mesh
    from retinex_tpu_torch.parallel.spatial import gather_rows, make_spatial_clahe, shard_rows

    cuda0 = torch.device("cuda", 0)
    total: dict[str, int] = {}
    for h, w in SPATIAL_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(h)
        x = torch.rand((1, h, w, 3), device="cuda", generator=g) * 0.45  # dark: CLAHE moves its pixels
        for mode, route in (("clahe", clahe_lab_rgb), ("clahe_luma", clahe_luma_rgb)):
            one = route(x)
            one_ms = wall_ms(torch, lambda: route(x))
            line = []
            for n in SPATIAL_MESHES:
                mesh = Mesh((cuda0,) * n)
                fn = make_spatial_clahe(mesh, mode)
                slabs = shard_rows(x, mesh)
                for m in (cg, cl):
                    m.reset_launches()
                got = fn(slabs)
                torch.cuda.synchronize()
                launches = launch_counts((cg, cl))
                slab = {**cg.SLAB_LAUNCHES, **cl.SLAB_LAUNCHES}
                check_launches(launches, {k: n * v for k, v in SPATIAL_CLAHE_ONCE[mode].items()},
                               f"spatial {mode} on {n} slabs")
                apply = "clahe_apply_f32_nhwc" if mode == "clahe" else "clahe_luma_apply_u8"
                if slab[apply] != n - 1 or sum(slab.values()) != n - 1:
                    raise AssertionError(f"spatial {mode} on {n} slabs: row0 > 0 launches {slab}, expected {apply} {n - 1}")
                total = {k: total.get(k, 0) + v for k, v in launches.items()}
                if not torch.equal(gather_rows(got, cuda0), one):
                    raise AssertionError(f"spatial {mode} at {h}x{w} on {n} slabs differs from the one-card route")
                ms = wall_ms(torch, lambda: fn(slabs))
                line.append(f"{n} slabs {ms:.3f} ms (launches {', '.join(f'{k} {v}' for k, v in launches.items() if v)}; "
                            f"row0 > 0: {apply} {slab[apply]})")
            print(f"  (a) spatial {mode} at {h}x{w}: byte-identical to one card ({one_ms:.3f} ms wall) on "
                  + "; ".join(line) + " (slabs of one card: not a scaling figure)")
        if (h, w) == SPATIAL_SHAPES[0]:
            for n in SPATIAL_MESHES:
                slab_applies(torch, cg, cl, x, n, card)
    return total


def spatial_forward_phase(torch) -> None:
    """Phase 24 (b): ``make_spatial_forward`` at full width on meshes of 2,
    4 and 8 shards of ``cuda:0`` against the one-card standard forward: f32
    within SPATIAL_F32_TOL at both shapes, bf16 (--use_amp) within
    AMP_NET_TOL at 1088x1920; each
    largest difference, the wall time beside one card's and the peak
    memory printed."""
    from retinex_tpu_torch.models.init import init_untrained
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
    from retinex_tpu_torch.parallel.mesh import Mesh
    from retinex_tpu_torch.parallel.spatial import gather_rows, make_spatial_forward, shard_rows

    cuda0 = torch.device("cuda", 0)
    gib = 2.0**30
    for dtype in (torch.float32, torch.bfloat16):
        for cfg, flags in SPATIAL_NETS.items():
            model = init_untrained(MultiScaleUPRetinex(*flags, dtype=dtype), 0).eval().to(cuda0)
            # bf16 at 1088x1920 only: the phase's time (4K's bf16 runs add ~20 s).
            for h, w in SPATIAL_SHAPES[::-1] if dtype == torch.float32 else SPATIAL_SHAPES[1:]:
                g = torch.Generator(device="cuda").manual_seed(w)
                x = torch.rand((1, h, w, 3), device="cuda", generator=g) * 0.85 + 0.05

                def one_card():
                    with torch.inference_mode():
                        return model(x)

                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                one = one_card()
                torch.cuda.synchronize()
                peak_one = torch.cuda.max_memory_allocated() / gib
                one_ms = wall_ms(torch, one_card)
                parts = []
                for n in SPATIAL_MESHES:
                    mesh = Mesh((cuda0,) * n)
                    fwd = make_spatial_forward(model, mesh)
                    slabs = shard_rows(x, mesh)
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    out = fwd(slabs)
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated() / gib
                    diffs = {}
                    for name, a, b in zip(("enhanced", "reflectance", "illumination"), out, one):
                        a = gather_rows(a, cuda0)
                        if not bool(torch.isfinite(a).all()):
                            raise AssertionError(f"spatial forward ({cfg}, {dtype}) at {h}x{w} on {n}: {name} not finite")
                        diffs[name] = float((a.float() - b.float()).abs().max())
                        tol = SPATIAL_F32_TOL if dtype == torch.float32 else AMP_NET_TOL[name]
                        if diffs[name] > tol:
                            raise AssertionError(f"spatial forward ({cfg}, {dtype}) at {h}x{w} on {n} slabs: {name} "
                                                 f"{diffs[name]:.3e} from one card, beyond {tol}")
                    del out
                    ms = wall_ms(torch, lambda: fwd(slabs))
                    parts.append(f"{n} slabs: max diff " + "/".join(f"{v:.3e}" for v in diffs.values())
                                 + f", {ms:.3f} ms ({ms / one_ms:.3f}x), peak {peak:.2f} GiB")
                print(f"  (b) spatial forward, {cfg} net, {str(dtype)[6:]}, {h}x{w} (enhanced/reflectance/illumination "
                      f"vs one card, {one_ms:.3f} ms, peak {peak_one:.2f} GiB): " + "; ".join(parts)
                      + " (slabs of one card: not a scaling figure)")
            del model
            torch.cuda.empty_cache()


def spatial_cli_phase(torch, modules, workdir: Path) -> dict[str, int]:
    """Phase 24 (c): ``--mode enhance --spatial_shard`` on the 1080p photo
    with the net and with ``--classical_mode clahe`` on this one card: the
    one-device message where the net runs, and the bytes of the run without
    the flag. Returns the flagged runs' launches."""
    from PIL import Image

    photo = workdir / "spatial_photo1080.png"
    with Image.open(REPO / "data" / "convergence" / "lowlight_000.png") as im:
        im.convert("RGB").resize((1920, 1080), Image.BILINEAR).save(photo)
    total: dict[str, int] = {}
    for label, extra in (("net", []), ("clahe", ["--classical_mode", "clahe"])):
        outs = {}
        for flagged in (False, True):
            out = workdir / f"spatial_cli_{label}_{flagged}"
            args = ["--mode", "enhance", "--input_path", str(photo), "--output_dir", str(out), "--max_size", "1920",
                    *extra, *(["--spatial_shard"] if flagged else [])]
            launches, _sec, printed = run_cli_logged(torch, modules, args)
            outs[flagged] = out
        if label == "net" and "Spatial sharding requested but only one device is visible; ignoring" not in printed:
            raise AssertionError("--spatial_shard on one card did not say that it is ignored")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        for k in ("enhanced", "illumination", "comparison"):
            a, b = (np.asarray(Image.open(outs[f] / f"{photo.stem}_{k}.png")) for f in (False, True))
            if not np.array_equal(a, b):
                raise AssertionError(f"--spatial_shard on one card changed {label}'s {k} PNG")
        print(f"  (c) --spatial_shard, {label}, on this one card: " + ("the one-device message, " if label == "net" else "")
              + f"the bytes of the run without the flag; launches {', '.join(f'{k} {v}' for k, v in launches.items() if v)}")
    return total


HOST_FORMATS = REPO / "tests" / "fixtures" / "host_formats"


def host_format_digests(card: str) -> None:
    """Phase 24 (d): ``decode_letterbox_batch`` on every file of
    tests/fixtures/host_formats at each size of its expected.json, which holds
    the SHA-256 of the JAX native loader's batch (written on a CPU with the
    JAX package, tests/test_torch_native_loader.py); the files it does not
    decode are gray-filled here too, with its warning. This machine's PIL and
    its libjpeg and zlib give those bytes, or the phase fails."""
    import hashlib
    import warnings

    import PIL

    from retinex_tpu_torch.data.native_loader import decode_letterbox_batch

    expected = json.loads((HOST_FORMATS / "expected.json").read_text())
    failed = []
    for case, want in sorted(expected["cases"].items()):
        for label, size in expected["sizes"].items():
            with warnings.catch_warnings(record=True) as record:
                warnings.simplefilter("always")
                batch = decode_letterbox_batch([str(HOST_FORMATS / want["file"])], size, num_threads=1)
            warned = [str(w.message) for w in record if "images failed to decode" in str(w.message)]
            if hashlib.sha256(batch.tobytes()).hexdigest() != want[label] or bool(warned) == want["decodes"]:
                raise AssertionError(f"{case} at {size} ({label}): not the JAX native loader's bytes or warning")
        if not want["decodes"]:
            failed.append(case)
    n = len(expected["cases"]) * len(expected["sizes"])
    print(f"  (d) formats: {n} batches ({len(expected['cases'])} files x sizes {sorted(expected['sizes'].values())}) "
          f"byte for byte the JAX native loader's (expected.json's SHA-256), PIL {PIL.__version__}; gray-filled "
          f"with its warning: {', '.join(failed)} [{card}]")


def host_resize_stage(files: list[str], photo: Path, card: str) -> None:
    """Phase 24 (d): the host stage where the letterbox resizes, before (PIL
    decode, then ops/letterbox.letterbox_np's f64 resize, on 8 threads) and
    after (decode_letterbox_batch, the C++ loader's f32 resize): the 24
    photos at --image_size 256 (the training loader's call, scaleup) and
    the 1080p photo at --max_size 1024 (the directory driver's canvas);
    medians of 5 warm runs; then the resize alone on the decoded 1080p frame.
    The two differ by at most a level (ROADMAP Queue 3)."""
    from concurrent.futures import ThreadPoolExecutor

    from retinex_tpu_torch.data.dataset import decode_image
    from retinex_tpu_torch.data.native_loader import (
        decode_letterbox_batch,
        decode_letterbox_batch_canvas,
        resize_bilinear_u8,
    )
    from retinex_tpu_torch.ops.letterbox import _resize_bilinear_np_u8, letterbox_np, plan_letterbox

    def median_ms(fn, n: int = 5) -> float:
        fn()  # warm
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    pool = ThreadPoolExecutor(max_workers=8)

    def f64_path(paths, target, auto):
        def one(p):
            rgb = decode_image(p)
            return letterbox_np(rgb, plan_letterbox(rgb.shape[0], rgb.shape[1], target, auto=auto, scaleup=not auto))
        return np.stack(list(pool.map(one, paths)))

    plan = plan_letterbox(1080, 1920, 1024, auto=True, scaleup=False)
    for label, paths, target, auto, after in (
        ("24 photos at --image_size 256", files, 256, False,
         lambda: decode_letterbox_batch(files, 256, auto_pad=False, scaleup=True, num_threads=8)),
        ("the 1080p photo at --max_size 1024", [str(photo)], 1024, True,
         lambda: decode_letterbox_batch_canvas([str(photo)], 1024, plan.out_h, plan.out_w, num_threads=8)),
    ):
        old, new = f64_path(paths, target, auto), after()
        d = np.abs(old.astype(np.int16) - new.astype(np.int16))
        if old.shape != new.shape or d.max() > 1:
            raise AssertionError(f"{label}: the f32 resize is {d.max()} levels from the f64 one")
        b_ms, a_ms = median_ms(lambda: f64_path(paths, target, auto)), median_ms(after)
        print(f"  (d) decode + letterbox, {label} (to {new.shape[1]}x{new.shape[2]}), 8 threads, median of 5 warm: "
              f"before (PIL + letterbox_np, f64) {b_ms:.2f} ms, after (the native loader's f32 resize) {a_ms:.2f} ms; "
              f"{int((d > 0).sum())} of {d.size} bytes a level apart [{card}]")
    pool.shutdown()
    rgb = decode_image(str(photo))
    b_ms = median_ms(lambda: _resize_bilinear_np_u8(rgb, plan.resize_h, plan.resize_w))
    a_ms = median_ms(lambda: resize_bilinear_u8(rgb, plan.resize_h, plan.resize_w))
    print(f"  (d) the resize alone, 1080x1920 to {plan.resize_h}x{plan.resize_w}, one thread, median of 5 warm: "
          f"f64 {b_ms:.2f} ms, f32 {a_ms:.2f} ms [{card}]")


def host_directory_run(torch, modules, workdir: Path, card: str) -> dict[str, int]:
    """Phase 24 (d): ``--mode enhance`` on phase 8's 16-photo directory at
    ``--max_size 1024 --batch_size 8``, the default packed route, where every
    1080p photo is resized by the host path: 576x1024 chunks of 8 and 4 and
    a 640x640 chunk of 4, so K4-K6 6 launches each and K1-K3 3 each (float
    instances). Returns its launches, which the kernels line counts."""
    from PIL import Image

    photos = workdir / "photos"
    if not photos.is_dir():  # phase 24 alone
        make_directory(REPO / "data" / "convergence", workdir)
    out = workdir / "host_dir_1024"
    launches, cold_s = run_cli(torch, modules, [
        "--mode", "enhance", "--input_path", str(photos), "--output_dir", str(out), "--max_size", "1024",
        "--batch_size", "8", "--device", "cuda",
    ])
    check_launches(launches, DIR_MODES["net"][1], "the directory run at --max_size 1024")
    files = sorted(photos.iterdir())
    if len(list(out.iterdir())) != 3 * len(files):
        raise AssertionError(f"--max_size 1024: {len(list(out.iterdir()))} PNGs, expected {3 * len(files)}")
    for f in files:
        got = np.asarray(Image.open(out / f"{f.stem}_enhanced.png").convert("RGB"))
        if got.shape != ((576, 1024, 3) if int(f.stem[-3:]) < 12 else (640, 640, 3)):
            raise AssertionError(f"{f.name}: enhanced PNG of shape {got.shape}")
    print(f"  (d) --mode enhance on the 16-photo directory at --max_size 1024 --batch_size 8 (packed route): "
          f"48 PNGs, cold CLI run {cold_s:.3f} s; launches {', '.join(f'{k} {v}' for k, v in launches.items() if v)} "
          f"(in the kernels line) [{card}]")
    return launches


def host_path_phase(torch, modules, workdir: Path, card: str) -> dict[str, int]:
    """Phase 24 (d): the host stages before (PIL on one thread, PIL's level-1
    writes) and after (data/native_loader.py: decode on a thread pool,
    the level-1 SUB zlib writer, one photo's three PNGs on three threads),
    on the 1088x1920 letterboxed photo and on the 24 data/convergence
    photos; file sizes beside PIL's. Every file decodes to the same pixels.
    Then the format fixtures held to the JAX native loader's digests, the
    resizing stage before and after, and the directory run at --max_size
    1024, whose launches it returns."""
    host_format_digests(card)
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from retinex_tpu_torch.data.dataset import decode_image, list_image_files
    from retinex_tpu_torch.data.native_loader import decode_letterbox_batch_canvas, encode_png
    from retinex_tpu_torch.infer.batch_driver import bucket_by_canvas
    from retinex_tpu_torch.ops.letterbox import letterbox_np, plan_letterbox
    from retinex_tpu_torch.utils.viz import create_comparison

    def best_ms(fn, n: int = 5) -> float:
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def serial(paths, target):
        out = []
        for p in paths:
            rgb = decode_image(p)
            out.append(letterbox_np(rgb, plan_letterbox(rgb.shape[0], rgb.shape[1], target, auto=True, scaleup=False)))
        return np.stack(out)

    def pil_write(a, path):
        Image.fromarray(a).save(path, compress_level=1)

    photo = workdir / "spatial_photo1080.png"
    files = list_image_files(str(REPO / "data" / "convergence"), recursive=False)
    for label, paths, max_size in (("the 1080p photo", [str(photo)], 1920), ("24 data/convergence photos", files, None)):
        for (target, oh, ow), chunk in bucket_by_canvas(paths, max_size).items():
            before = serial(chunk, target)
            after = decode_letterbox_batch_canvas(chunk, target, oh, ow, num_threads=8)
            if not np.array_equal(before, after):
                raise AssertionError(f"the threaded decode of {label} differs from the serial one")
            b_ms = best_ms(lambda: serial(chunk, target), 3)
            a_ms = best_ms(lambda: decode_letterbox_batch_canvas(chunk, target, oh, ow, num_threads=8), 3)
            print(f"  (d) decode + letterbox, {label} ({len(chunk)} to {oh}x{ow}): serial PIL {b_ms:.2f} ms, 8 threads "
                  f"{a_ms:.2f} ms ({b_ms / a_ms:.2f}x); identical bytes")
    img = serial([str(photo)], 1920)[0]
    enh = np.asarray(Image.open(workdir / "spatial_cli_net_False" / "spatial_photo1080_enhanced.png"))
    illu = np.asarray(Image.open(workdir / "spatial_cli_net_False" / "spatial_photo1080_illumination.png"))
    comp = create_comparison(img.astype(np.float32) / 255.0, enh.astype(np.float32) / 255.0)
    arrays = {"enhanced": enh, "illumination": illu, "comparison": comp}
    sizes = []
    for name, a in arrays.items():
        pb, pa = workdir / f"pil_{name}.png", workdir / f"zlib_{name}.png"
        b_ms, a_ms = best_ms(lambda: pil_write(a, pb)), best_ms(lambda: encode_png(a, str(pa)))
        for path in (pb, pa):
            if not np.array_equal(np.asarray(Image.open(path)), a):
                raise AssertionError(f"{path.name} does not decode to the array written")
        sizes.append(f"{name} {pa.stat().st_size} B (PIL {pb.stat().st_size} B)")
        print(f"  (d) encode {name} {a.shape[1]}x{a.shape[0]}: PIL level 1 {b_ms:.2f} ms, encode_png {a_ms:.2f} ms "
              f"({b_ms / a_ms:.2f}x)")
    pool = ThreadPoolExecutor(max_workers=3)
    three_before = best_ms(lambda: [pil_write(a, workdir / f"pil_{k}.png") for k, a in arrays.items()])
    three_after = best_ms(lambda: [f.result() for f in [pool.submit(encode_png, a, str(workdir / f"zlib_{k}.png"))
                                                         for k, a in arrays.items()]])
    pool.shutdown()
    print(f"  (d) one photo's three PNGs: PIL one after another {three_before:.2f} ms, encode_png on 3 threads "
          f"{three_after:.2f} ms ({three_before / three_after:.2f}x); sizes: " + ", ".join(sizes))
    batch = serial(files, 640)
    with ThreadPoolExecutor(max_workers=8) as pool:
        dir_before = best_ms(lambda: list(pool.map(lambda i: pil_write(batch[i], workdir / f"d_pil_{i}.png"),
                                                   range(len(files)))), 3)
        dir_after = best_ms(lambda: list(pool.map(lambda i: encode_png(batch[i], str(workdir / f"d_zlib_{i}.png")),
                                                  range(len(files)))), 3)
    print(f"  (d) 24 photos' PNGs (640x640) on 8 threads: PIL {dir_before:.2f} ms, encode_png {dir_after:.2f} ms "
          f"({dir_before / dir_after:.2f}x)")
    host_resize_stage(files, photo, card)
    return host_directory_run(torch, modules, workdir, card)


def spatial_phase(torch, modules, workdir: Path) -> dict[str, int]:
    """Phase 24 (the module docstring); returns the launches of (a)'s
    sharded calls and of (c)'s and (d)'s CLI runs."""
    cg, cl = modules[0], modules[1]
    card = gpu_line()
    t0 = time.perf_counter()
    if not {"clahe_apply_f32_nhwc", "clahe_luma_apply_u8"} <= INSTR_PER_PX.keys():  # phase 24 alone
        from retinex_tpu_torch.ops import _kernels

        libs = _kernels.build()
        INSTR_PER_PX.update(sass_instructions_per_px(libs["clahe_lab"].path))
        INSTR_PER_PX.update(sass_loop_instructions_per_px(libs))
    launches = spatial_clahe_phase(torch, cg, cl, card)
    spatial_forward_phase(torch)
    cli = spatial_cli_phase(torch, modules, workdir)
    host = host_path_phase(torch, modules, workdir, card)
    print(f"  phase 24 took {time.perf_counter() - t0:.1f} s")
    return {k: launches.get(k, 0) + cli.get(k, 0) + host.get(k, 0) for k in set(launches) | set(cli) | set(host)}


# Phase 25: a checkpoint written by the JAX package. The fixture is that
# package's own save_checkpoint (an Orbax directory) of create_train_state
# at the CLI defaults (the net without pre-activation or ASPP, PRNGKey(0)),
# every params kernel set to sign x 1/sqrt(fan_in) so that it compresses to
# under 2 MB; tests/test_torch_orbax.py writes it with the JAX package
# (``write_orbax_fixture``) and holds it to the regeneration below.
ORBAX_FIXTURE = REPO / "tests" / "fixtures" / "orbax_jax" / "latest"
ORBAX_FIXTURE_SEED = 22
ORBAX_FIXTURE_EPOCH = 4
ORBAX_FIXTURE_BEST_LOSS = 0.75
# create_train_state's dropout key at PRNGKey(0): split(PRNGKey(0))[1]'s data.
ORBAX_DROPOUT_KEY = (928981903, 3453687069)
# The resumed run: 8 photos at batch 4, one epoch of two steps.
ORBAX_TRAIN_ARGS = ["--image_size", "128", "--batch_size", "4", "--save_freq", "1", "--log_every", "1"]


def _tree_map(tree: dict, fn, path: tuple = ()) -> dict:
    return {k: _tree_map(v, fn, (*path, k)) if isinstance(v, dict) else fn((*path, k), v) for k, v in tree.items()}


def _tree_leaves(tree: dict, path: tuple = ()) -> dict:
    """{key path: leaf} of nested dicts."""
    out = {}
    for k, v in tree.items():
        out.update(_tree_leaves(v, (*path, k)) if isinstance(v, dict) else {(*path, k): v})
    return out


def orbax_fixture_tree() -> dict:
    """The fixture's whole tree regenerated with numpy, no JAX, as
    ``read_orbax`` returns it: the params' kernels sign x 1/sqrt(fan_in)
    (fan_in the product of all but the last of the HWIO dimensions, the
    value rounded to f32 once), the signs drawn by
    default_rng(ORBAX_FIXTURE_SEED) as integers in {0, 1} over the kernels
    in sorted path order; every other leaf as the JAX init leaves it: conv
    biases, BatchNorm shifts and means 0, BatchNorm scales and variances 1;
    ``make_optimizer``'s state at step 0 (clip and decay empty, Adam's zero
    moments and count, the schedule's count); the DWA carry zeros; the
    dropout key; step, epoch and best loss. The leaves' names and shapes
    come from the port's net (``convert.state_dict_to_variables``)."""
    import math

    from retinex_tpu_torch.models.convert import state_dict_to_variables
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

    like = state_dict_to_variables(MultiScaleUPRetinex(False, False).state_dict(), use_aspp=False)
    rng = np.random.default_rng(ORBAX_FIXTURE_SEED)
    shapes = {p: v.shape for p, v in _tree_leaves(like["params"]).items()}
    signed = {}
    for p in sorted(k for k in shapes if k[-1] == "kernel"):
        s = np.float32(1.0 / math.sqrt(math.prod(shapes[p][:-1])))
        signed[p] = np.where(rng.integers(0, 2, shapes[p]) == 1, s, -s).astype(np.float32)
    params = _tree_map(like["params"], lambda p, v: signed[p] if p[-1] == "kernel" else (
        np.ones if p[-1] == "scale" else np.zeros)(v.shape, np.float32))
    stats = _tree_map(like["batch_stats"], lambda p, v: (np.ones if p[-1] == "var" else np.zeros)(v.shape, np.float32))

    def zeros():
        return _tree_map(params, lambda p, v: np.zeros(v.shape, np.float32))

    count = np.zeros((), np.int32)
    return {
        "params": params, "batch_stats": stats,
        "opt_state": [None, None, {"count": count, "mu": zeros(), "nu": zeros()}, {"count": count.copy()}],
        "loss_prev": np.zeros(7, np.float32), "loss_prev2": np.zeros(7, np.float32),
        "loss_step": np.zeros((), np.int32), "dropout_rng": np.array(ORBAX_DROPOUT_KEY, np.uint32), "step": 0,
        "epoch": np.asarray(ORBAX_FIXTURE_EPOCH, np.int64), "best_loss": np.asarray(ORBAX_FIXTURE_BEST_LOSS, np.float64),
    }


def same_tree(got, want, path: str = "") -> int:
    """Raise where `got` and `want` differ in structure, dtype, shape or any
    bit; return the number of leaves."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            raise AssertionError(f"{path or 'the tree'}: keys {sorted(got) if isinstance(got, dict) else got} "
                                 f"against {sorted(want)}")
        return sum(same_tree(got[k], want[k], f"{path}/{k}") for k in want)
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{path}: {got!r} against a list of {len(want)}")
        return sum(same_tree(g, w, f"{path}[{i}]") for i, (g, w) in enumerate(zip(got, want)))
    if want is None or isinstance(want, (int, float)):
        if type(got) is not type(want) or got != want:
            raise AssertionError(f"{path}: {got!r} against {want!r}")
        return 1
    if got.dtype != want.dtype or got.shape != want.shape or got.tobytes() != want.tobytes():
        raise AssertionError(f"{path}: {got.dtype}{got.shape} differs from {want.dtype}{want.shape}")
    return 1


def orbax_phase(torch, modules, workdir: Path) -> dict[str, int]:
    """Phase 25 (the module docstring); returns the launches of its enhance
    and predict runs and its served call."""
    import shutil
    import statistics as st

    from PIL import Image

    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer import serving
    from retinex_tpu_torch.infer.enhance import make_batch_pipeline
    from retinex_tpu_torch.models.convert import variables_to_state_dict
    from retinex_tpu_torch.ops import _kernels
    from retinex_tpu_torch.scripts import export_serving
    from retinex_tpu_torch.train.checkpoint import load_params_for_inference
    from retinex_tpu_torch.train.orbax import read_orbax

    card = gpu_line()
    fixture = str(ORBAX_FIXTURE)
    size = sum(p.stat().st_size for p in ORBAX_FIXTURE.rglob("*") if p.is_file())
    t0 = time.perf_counter()
    _kernels.host_library("zstd_decode")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = read_orbax(fixture)
    first_ms = (time.perf_counter() - t0) * 1e3
    reads, params_reads = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        read_orbax(fixture)
        reads.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        load_params_for_inference(fixture)
        params_reads.append((time.perf_counter() - t0) * 1e3)
    n = same_tree(tree, orbax_fixture_tree())
    print(f"  the fixture ({size / 1e6:.3f} MB on disk): zstd decoder built with c++ (on its first use) in {build_s:.2f} s; read_orbax "
          f"{first_ms:.1f} ms the first time, median {st.median(reads):.1f} ms of 5 (files in the page cache); "
          f"load_params_for_inference median {st.median(params_reads):.1f} ms; all {n} leaves bit for bit equal "
          f"to the numpy regeneration; {card}")

    src = REPO / "data" / "convergence" / "lowlight_000.png"
    photo = workdir / "orbax_photo1080.png"
    with Image.open(src) as im:
        im.convert("RGB").resize((1920, 1080), Image.BILINEAR).save(photo)
    launches: dict[str, int] = {}
    for mode, want in (("enhance", {**LAB_CLAHE_ONCE, **FAM_TWICE}), ("predict", FAM_TWICE)):
        out = workdir / f"orbax_{mode}"
        got_launches, sec = run_cli(torch, modules, ["--mode", mode, "--checkpoint", fixture, "--input_path",
                                                     str(photo), "--output_dir", str(out), "--max_size", "1920",
                                                     "--device", "cuda"])
        check_launches(got_launches, want, f"--mode {mode} from the JAX checkpoint")
        got = check_pngs(out, photo.stem, (1088, 1920, 3))
        print(f"  --mode {mode} --checkpoint <the JAX checkpoint> --max_size 1920: {sec:.2f} s, launches "
              f"{ {k: v for k, v in got_launches.items() if v} }")
        for k, v in got_launches.items():
            launches[k] = launches.get(k, 0) + v
        if mode == "enhance":
            hold_to_cpu(torch, got, photo, 1920, packed=True, checkpoint=fixture)

    train_dir = workdir / "orbax_train"
    train_dir.mkdir()
    for i in range(8):
        shutil.copy(REPO / "data" / "convergence" / f"lowlight_{i:03d}.png", train_dir)
    save = workdir / "orbax_resumed"
    got_launches, sec, log = run_cli_logged(torch, modules, [
        "--mode", "train", "--train_dir", str(train_dir), "--save_dir", str(save), "--device", "cuda",
        *ORBAX_TRAIN_ARGS, "--num_epochs", str(ORBAX_FIXTURE_EPOCH + 2), "--resume", fixture])
    check_launches(got_launches, {}, "training resumed from the JAX checkpoint")
    last = read_orbax(str(save / "latest"))
    trained = variables_to_state_dict(last, False, False)
    start = cli.build_model(Config(checkpoint=fixture), torch.device("cpu")).state_dict()
    moved = max(float((trained[k] - v).abs().max()) for k, v in start.items() if k.endswith(".weight"))
    count = int(last["opt_state"][2]["count"])
    if f"Resumed from {fixture} at epoch {ORBAX_FIXTURE_EPOCH + 1}" not in log or (
            int(last["step"]), int(last["epoch"]), count) != (2, ORBAX_FIXTURE_EPOCH + 1, 2):
        raise AssertionError(f"the resumed run: step {last['step']}, epoch {last['epoch']}, Adam count {count}; "
                             f"expected 2, {ORBAX_FIXTURE_EPOCH + 1}, 2")
    if not 0 < moved <= 10 * 1e-4:  # two Adam steps at lr 1e-4 from the fixture's weights
        raise AssertionError(f"the resumed run's weights moved {moved:.3e} from the JAX checkpoint's")
    print(f"  --mode train --resume <the JAX checkpoint>: {sec:.1f} s, epoch {ORBAX_FIXTURE_EPOCH + 1}, step "
          f"{last['step']} (2 steps of 4 photos at 128 px), the weights {moved:.3e} at most from the checkpoint's; "
          "no kernel launched")

    h, w = 288, 512
    art = workdir / "orbax_enhancer.pt2"
    t0 = time.perf_counter()
    export_serving.main(["--checkpoint", fixture, "--height", str(h), "--width", str(w), "--out", str(art),
                         "--device", "cuda"])
    export_s = time.perf_counter() - t0
    with Image.open(src) as im:
        x = torch.from_numpy(np.asarray(im.convert("RGB").resize((w, h), Image.BILINEAR))[None].copy()).cuda()
    served = serving.load_enhancer(str(art))
    for m in modules:
        m.reset_launches()
    with torch.inference_mode():
        got = served(x)
        torch.cuda.synchronize()
        call_launches = launch_counts(modules)
        model = cli.build_model(Config(mode="enhance", checkpoint=fixture), torch.device("cuda"))
        want = make_batch_pipeline(model)(x)
    check_launches(call_launches, LAB_CLAHE_ONCE, "the served call of the JAX checkpoint's artifact")
    for kind, g, wo in zip(("enhanced", "illumination"), got, want):
        if g.shape != wo.shape or not torch.equal(g, wo):
            raise AssertionError(f"the served {kind} differs from the eager pipeline's on the JAX checkpoint")
    for k, v in call_launches.items():
        launches[k] = launches.get(k, 0) + v
    print(f"  export_serving --checkpoint <the JAX checkpoint> at {h}x{w}: {export_s:.1f} s; one served call "
          "identical to the eager pipeline (enhanced and illumination), launches "
          f"{ {k: v for k, v in call_launches.items() if v} }")
    return launches


# Phase 26: a checkpoint written on the card, in the JAX package's layout.
# The resumed run: the same 8 photos at 128 px and batch 4 as phase 25's.
ORBAX_WRITE_EPOCHS = 2


def orbax_write_phase(torch, modules, workdir: Path) -> dict[str, int]:
    """Phase 26 (the module docstring); returns the launches of its enhance
    and predict runs."""
    import copy
    import shutil

    from PIL import Image

    from retinex_tpu_torch.ops import _kernels
    from retinex_tpu_torch.train import checkpoint as ckpt_mod
    from retinex_tpu_torch.train import trainer
    from retinex_tpu_torch.train.orbax import read_orbax

    card = gpu_line()
    t0 = time.perf_counter()
    _kernels.host_library("zstd_decode")  # its CRC-32C frames the store; built once, not in the saves' times
    build_s = time.perf_counter() - t0
    train_dir = workdir / "orbax_write_train"
    train_dir.mkdir()
    for i in range(8):
        shutil.copy(REPO / "data" / "convergence" / f"lowlight_{i:03d}.png", train_dir)
    save = workdir / "orbax_written"
    base = ["--mode", "train", "--train_dir", str(train_dir), "--save_dir", str(save), "--device", "cuda",
            *ORBAX_TRAIN_ARGS]
    real_save, real_load = trainer.save_checkpoint, trainer.load_checkpoint
    saves, loads = [], []

    def timed_save(state, save_dir, epoch, best_loss, is_best, extra=None):
        held = copy.deepcopy(ckpt_mod.state_to_tree(state, epoch, best_loss))  # a copy, the state goes on
        t0 = time.perf_counter()
        n = real_save(state, save_dir, epoch, best_loss, is_best, extra)
        saves.append(dict(ms=(time.perf_counter() - t0) * 1e3, bytes=n, tree=held, is_best=is_best))
        return n

    def captured_load(state, path):
        out = real_load(state, path)
        loads.append(dict(tree=copy.deepcopy(ckpt_mod.state_to_tree(out[0], out[1] - 1, out[2])),
                          gen=out[0].dropout_gen.get_state().clone(), extra=out[3]))
        return out

    trainer.save_checkpoint, trainer.load_checkpoint = timed_save, captured_load
    try:
        got, sec, _ = run_cli_logged(torch, modules, [*base, "--num_epochs", str(ORBAX_WRITE_EPOCHS)])
        check_launches(got, {}, "training into Orbax directories")
        latest = str(save / "latest")
        on_disk = sum(p.stat().st_size for p in (save / "latest").rglob("*") if p.is_file())
        t0 = time.perf_counter()
        tree = read_orbax(latest)
        read_ms = (time.perf_counter() - t0) * 1e3
        n = same_tree(tree, saves[-1]["tree"])
        if len(saves) != ORBAX_WRITE_EPOCHS or on_disk != saves[-1]["bytes"] or int(tree["step"]) != 4:
            raise AssertionError(f"{len(saves)} saves, {on_disk} bytes on disk against {saves[-1]['bytes']} written, "
                                 f"step {tree['step']}; expected {ORBAX_WRITE_EPOCHS} saves and step 4")
        side = torch.load(save / "latest" / ckpt_mod.SIDE_FILE, map_location="cpu", weights_only=True)
        ms = [r["ms"] for r in saves]
        print(f"  --mode train, 8 photos at 128 px, batch 4, {ORBAX_WRITE_EPOCHS} epochs into Orbax directories: "
              f"{sec:.1f} s, no kernel launched; save_checkpoint (latest and, when best, best) {', '.join(f'{m:.1f}' for m in ms)} "
              f"ms (host clock, files in the page cache), {on_disk} bytes in <save_dir>/latest; read_orbax of it "
              f"{read_ms:.1f} ms, all {n} leaves bit for bit the state the trainer held at the save; the zstd "
              f"library (its CRC-32C) ready in {build_s:.2f} s before; {card}")

        got, sec2, log = run_cli_logged(torch, modules, [*base, "--num_epochs", str(ORBAX_WRITE_EPOCHS + 1),
                                                         "--resume", latest])
        check_launches(got, {}, "training resumed from the card's Orbax directory")
        (loaded,) = loads
        n = same_tree(loaded["tree"], tree)
        if not (torch.equal(loaded["gen"], side["dropout_rng"]) and loaded["extra"].keys() == side["extra"].keys()):
            raise AssertionError("the resumed run's dropout generator or extra differs from the side file's")
        if f"Resumed from {latest} at epoch {ORBAX_WRITE_EPOCHS}" not in log:
            raise AssertionError("the resumed run did not say where it resumed")
        after = read_orbax(latest)
        with open(save / "results.csv") as f:
            rows = list(csv.DictReader(f))
        losses = [float(v) for r in rows for k, v in r.items() if k != "epoch"]
        if int(after["step"]) != 6 or not losses or not np.isfinite(losses).all():
            raise AssertionError(f"the resumed run: step {after['step']} (expected 6), losses {losses}")
        print(f"  --resume <save_dir>/latest for one epoch of 2 steps: {sec2:.1f} s; the restored state all {n} leaves "
              f"bit for bit what was written, the dropout generator's and the loader's state from {ckpt_mod.SIDE_FILE}; "
              f"step 6, losses finite; no kernel launched")
    finally:
        trainer.save_checkpoint, trainer.load_checkpoint = real_save, real_load

    best = str(save / "best")
    photo = workdir / "orbax_write_photo1080.png"
    with Image.open(REPO / "data" / "convergence" / "lowlight_000.png") as im:
        im.convert("RGB").resize((1920, 1080), Image.BILINEAR).save(photo)
    launches: dict[str, int] = {}
    for mode, want in (("enhance", {**LAB_CLAHE_ONCE, **FAM_TWICE}), ("predict", FAM_TWICE)):
        out = workdir / f"orbax_write_{mode}"
        got_launches, sec = run_cli(torch, modules, ["--mode", mode, "--checkpoint", best, "--input_path", str(photo),
                                                     "--output_dir", str(out), "--max_size", "1920", "--device", "cuda"])
        check_launches(got_launches, want, f"--mode {mode} from the card's Orbax checkpoint")
        got = check_pngs(out, photo.stem, (1088, 1920, 3))
        print(f"  --mode {mode} --checkpoint <save_dir>/best --max_size 1920: {sec:.2f} s, launches "
              f"{ {k: v for k, v in got_launches.items() if v} }")
        for k, v in got_launches.items():
            launches[k] = launches.get(k, 0) + v
        if mode == "enhance":
            hold_to_cpu(torch, got, photo, 1920, packed=True, checkpoint=best)
    return launches


def seed0_checkpoint(torch, workdir: Path) -> str:
    """The CLI's untrained weights (seed 0) as a ``.pth``, for predict."""
    from retinex_tpu_torch.cli import init_untrained
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

    path = workdir / "seed0.pth"
    torch.save({"epoch": 0, "model_state_dict": init_untrained(MultiScaleUPRetinex(False, False), 0).state_dict()}, path)
    return str(path)


def serving_alone(torch, kernels, line: str) -> int:
    """``chip_smoke.py --phase 22``, ``23``, ``24``, ``25`` or ``26``: the
    build and that phase alone (22 and 23 with the seed-0 weights)."""
    import argparse

    parser = argparse.ArgumentParser(description="the build and one phase alone")
    parser.add_argument("--phase", type=int, choices=(22, 23, 24, 25, 26), required=True)
    phase = parser.parse_args().phase
    for stem, built in kernels.build().items():
        print(f"  {built.path.name}: built in {built.seconds:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        if phase == 22:
            print("phase 22 alone: serving with the seed-0 weights")
            launches = serving_phase(torch, None, Path(tmp))
            print(f"  launches of the served calls: {launches}")
        elif phase == 23:
            from retinex_tpu_torch.ops import clahe_gather, clahe_luma, clahe_pallas, conv_pallas, fused_blocks

            print("phase 23 alone: data parallelism with the seed-0 weights")
            modules = (clahe_gather, clahe_luma, fused_blocks, conv_pallas, clahe_pallas)
            launches = data_parallel_phase(torch, modules, seed0_checkpoint(torch, Path(tmp)), Path(tmp))
            print(f"  launches of the sharded runs: {launches}")
        elif phase == 25:
            from retinex_tpu_torch.ops import clahe_gather, clahe_luma, clahe_pallas, conv_pallas, fused_blocks

            print("phase 25 alone: the JAX package's checkpoint")
            modules = (clahe_gather, clahe_luma, fused_blocks, conv_pallas, clahe_pallas)
            launches = orbax_phase(torch, modules, Path(tmp))
            print(f"  launches of the enhance and predict runs and the served call: {launches}")
        elif phase == 26:
            from retinex_tpu_torch.ops import clahe_gather, clahe_luma, clahe_pallas, conv_pallas, fused_blocks

            print("phase 26 alone: the trainer writes the JAX package's Orbax checkpoints")
            modules = (clahe_gather, clahe_luma, fused_blocks, conv_pallas, clahe_pallas)
            launches = orbax_write_phase(torch, modules, Path(tmp))
            print(f"  launches of the enhance and predict runs: {launches}")
        else:
            from retinex_tpu_torch.ops import clahe_gather, clahe_luma, clahe_pallas, conv_pallas, fused_blocks

            print("phase 24 alone: spatial sharding and the host path")
            modules = (clahe_gather, clahe_luma, fused_blocks, conv_pallas, clahe_pallas)
            launches = spatial_phase(torch, modules, Path(tmp))
            print(f"  launches of the sharded calls and the CLI runs ((c) and (d)): {launches}")
    print(line)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    print(json.dumps({"ok": True, "phases": [phase], "device": device}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from retinex_tpu_torch.ops import _kernels
    from retinex_tpu_torch.ops import clahe_gather as cg
    from retinex_tpu_torch.ops import clahe_luma as cl
    from retinex_tpu_torch.ops import clahe_pallas as kp
    from retinex_tpu_torch.ops import conv_pallas as cp
    from retinex_tpu_torch.ops import fused_blocks as fb

    line = gpu_line()
    print(f"device: {line}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False  # as the CLI sets it

    if len(sys.argv) > 1:
        return serving_alone(torch, _kernels, line)

    print("phase 1: build")
    count_dir = tempfile.TemporaryDirectory()
    count_cubin = Path(count_dir.name) / "clahe_lab_without_tie_test.cubin"
    count_build = start_count_build(_kernels, count_cubin)
    libs = _kernels.build()
    report, _ = count_build.communicate()
    if count_build.returncode != 0:
        raise RuntimeError(f"nvcc failed on clahe_lab.cu without the tie test:\n{report}")
    for stem, built in libs.items():
        print(f"  {built.path.name}: built in {built.seconds:.2f} s")
        for ln in built.report.splitlines():
            # The new kernels' whole report: each entry, its registers, stack and spills.
            entry = "Compiling entry" in ln and stem in (
                "conv_wgmma", "conv_pipelined", "conv_narrow", "fam_fused", "fam_tail_wgmma",
            )
            if entry or "registers" in ln or "spill" in ln or "error" in ln.lower() or "warning" in ln.lower():
                print(f"  ptxas ({stem}): {ln.strip()}")

    INSTR_PER_PX.update(sass_instructions_per_px(libs["clahe_lab"].path))
    INSTR_PER_PX.update(sass_loop_instructions_per_px(libs))
    print("  K1, K3, K7 and K9: instructions issued per pixel (SASS, without loads, stores, control flow and "
          "address math): " + ", ".join(f"{k} {v:.2f}" for k, v in INSTR_PER_PX.items()))
    # K1's bounds count the function without the near-tie test, which the
    # exact rounding adds (its cost shows in the kernels' share of bound).
    without = {k: v for k, v in sass_instructions_per_px(count_cubin).items() if k.startswith("lab_fwd")}
    count_dir.cleanup()
    print("  K1 without its near-tie test, the count its bounds take: "
          + ", ".join(f"{k} {v:.2f} (with it {INSTR_PER_PX[k]:.2f})" for k, v in without.items()))
    INSTR_PER_PX.update(without)
    for name, (instance, extra) in K16_FUNCTION.items():
        INSTR_PER_PX[name] = INSTR_PER_PX[instance] + extra
        print(f"  K16 {name}: {INSTR_PER_PX[name]:.2f} operations a pixel for its bound ({instance}'s + {extra})")

    recs, launches = main_path_phases(torch, cg, cl, fb, cp, kp, _kernels)

    print("phase 17: K13, K15 and K14 (conv2d_pallas, conv2d_pallas_im2col, conv2d_narrow)")
    conv_launches, conv = conv_phase(torch, cp, _kernels)
    print("phase 18: K12 (fam_dual_conv3)")
    dual_launches, dual = dual_phase(torch, fb, cp)
    print("phase 19: K16 (clahe_lab_rgb_pallas)")
    k16_launches, k16 = k16_phase(torch, kp)
    launches.update(fam_dual_conv3=dual_launches[torch.float32], fam_dual_conv3_bf16=dual_launches[torch.bfloat16],
                    **k16_launches)
    # The kernels line carries the f32 runs, as for K1-K11, and for K12-K15,
    # whose bf16 runs have a kernel of their own, the bf16 runs too.
    for name in CONV_CASES:
        for dt, key in ((torch.float32, name), (torch.bfloat16, f"{name}_bf16")):
            if key in SOURCES:
                recs[key] = dict(conv[(name, dt)], dtype=str(dt)[6:])
                launches[key] = conv_launches[(name, dt)]
    recs["fam_dual_conv3"] = dict(dual[torch.float32], dtype="float32")
    recs["fam_dual_conv3_bf16"] = dict(dual[torch.bfloat16], dtype="bfloat16")
    recs.update(k16)
    print("phase 20: training (--mode train at the JAX defaults: the packed step; --no-packed_train), a resume, the "
          "card's steps against the CPU's, packed against standard, inference from the trained checkpoint")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = train_phase(torch, (cg, cl, fb, cp, kp), Path(tmp))
        print("phase 21: bf16 inference (--use_amp with enhance and predict): K4-K6 and K11 in bf16; K10 in bf16 "
              "(NetCfg(dec1_chain=True))")
        amp_recs, amp_launches = amp_phase(torch, (cg, cl, fb, cp, kp), ckpt, Path(tmp))
        print("phase 22: serving: torch.export artifacts exported on the card, served in a process without the model "
              "code, identical to the eager pipeline")
        serving_launches = serving_phase(torch, ckpt, Path(tmp))
        print("phase 23: data parallelism: sharded directory runs on a two-shard mesh of cuda:0, --n_devices beyond the "
              "card, the train step in a world of one NCCL rank and in two gloo ranks, dryrun_multichip(2)")
        dp_launches = data_parallel_phase(torch, (cg, cl, fb, cp, kp), ckpt, Path(tmp))
        print("phase 24: spatial sharding: the spatial CLAHE and forward on meshes of 2, 4 and 8 shards of cuda:0 "
              "against one card, --spatial_shard through the CLI; the host path's stages before and after")
        sp_launches = spatial_phase(torch, (cg, cl, fb, cp, kp), Path(tmp))
        print("phase 25: the JAX package's checkpoint (tests/fixtures/orbax_jax/latest, Orbax) read without JAX, "
              "then --checkpoint with enhance, predict and export_serving and --resume with train")
        ox_launches = orbax_phase(torch, (cg, cl, fb, cp, kp), Path(tmp))
        print("phase 26: the trainer writes the JAX package's Orbax checkpoints: --mode train into directories, "
              "read back, --resume, then enhance and predict from <save_dir>/best")
        ow_launches = orbax_write_phase(torch, (cg, cl, fb, cp, kp), Path(tmp))
    recs.update(amp_recs)
    launches.update(amp_launches)
    for name, n in [*serving_launches.items(), *dp_launches.items(), *sp_launches.items(), *ox_launches.items(),
                    *ow_launches.items()]:
        launches[name] += n

    for name in recs:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the paths this script drives")
    kernels = []
    for name, r in recs.items():
        entry = {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": r.get("library_ms"),
        }
        if "dtype" in r:
            entry["dtype"] = r["dtype"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
