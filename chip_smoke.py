#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pram_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds:

1. env          torch/CUDA versions and the card's name and power limit.
2. build        one nvcc call over ``pram_tpu_torch/csrc/*.cu`` (cached by hash).
3. setup        SegNetViT (descriptor_dim 128, nc113, 15 layers) and GML (9
                layers, d=256) in bf16 from ``weights/segnetvit_synthetic.msgpack``
                and ``weights/gml_synthetic.msgpack``, the synthetic scene of
                bench.py's recall guard and 32 rendered queries of 512 keypoints.
4. kernels      the first slice's kernels (self-attention and residual MLP at
                SegNetViT's shapes, RANSAC scoring and GN polish at the PnP
                shapes) against their plain versions on the card; RANSAC
                scoring also at AdaGML's 8 x 512 x 4096, matching
                refinement's 32 x 512 x 10240 and 32 x 1024 x 10240 and a
                tail (32 x 1000 x 10000), each a call, the kernel, its
                bound and its issue floor (SASS instructions a pair by
                cuobjdump), and the polish at 32 x 10240.
5. slice        the first slice on the card: recognition -> mutual-NN matching
                -> RANSAC PnP (seg_k=1, 128 hypotheses, gn_iters=5,
                lo_rounds=1, no refinement), with every kernel's launch count
                reset just before and read just after; then the same batch on
                the CPU through the plain versions, compared.
6. gml kernels  the second slice's kernels against their plain versions at
                GML's shapes, on the matcher inputs of phase 5's batch:
                self-attention with splits (512, 1024), cross-attention,
                the residual MLP over 1536 tokens, Sinkhorn over [512, 1024]
                and the refinement NN over 2048 points; kernels 1 and 5's
                projection pass alone (csrc/proj_bf16.cu), its scratch
                against the plain projection, timed beside cuBLAS's
                F.linear of the same projection and the SDPA yardsticks.
7. gml slice    the second slice, bench.py's GML recall guard without the
                extractor: recognition -> GML matching -> RANSAC PnP ->
                projection refinement -> RANSAC PnP, counted the same way
                (every kernel, 1 to 7, must have launched), timed, and
                compared with the same batch on the CPU.
8. image setup  the image slice's RenderedGuard in bf16: SFD2, SegNetViT and
                GML from weights/*_rendered.msgpack, the map built on the
                card by the port's extractor from 12 reference views
                rendered on the host.
9. extract kernels
                the third slice's kernels against their plain versions at
                its shapes, 32 x 480 x 640: the SFD2 stem (kernel 8) on the
                32 noisy query images in bf16 and f32, and NMS (kernel 9)
                on the model's score maps of those images in bf16 and f32;
                the stem's cuDNN yardstick; two launches of the stem
                bit-equal in both types, its kernel's device time by
                torch.profiler beside the call's, and its registers and
                spills as ptxas reported them (none may spill).
10. image slice the main path, bench.py's image recall guard: 32 noisy
                rendered queries (seed 11) -> SFD2 extraction -> SegNetViT
                -> GML -> RANSAC PnP -> projection refinement, through
                RenderedGuard.recall, counted (every kernel, 1 to 9, must
                have launched), recall@5cm/5deg required to be 1.0; then
                timed (a batch, and extraction split into its stages), and
                the extraction A/B check, kernel path vs plain path on 4
                views, in bf16 and in f32.
11. aachen setup
                the AdaGML slice at scripts/bench_aachen.py's operating point:
                AdaGML (9 layers, d=256) in bf16 from
                weights/adagml_aachen.msgpack, the Aachen-shaped scene (512
                landmarks of 40 points, 24 reference frames of 2048
                keypoints, 4096 refinement points, 1024 x 768) and 32
                queries of 4096 keypoints (seed 11) in 4 batches of 8,
                routed by ground-truth logits over 513 classes. The scene
                is also written as phase 26's cli.inference layout, and the
                CPU side of that CLI comparison starts here, in a child
                process at niceness 19 that takes the cores the next
                phases leave idle.
12. aachen kernels
                kernels 10-12 against their plain versions at the slice's
                shapes, on layer-0 activations of batch 0 with padded,
                pruned and fully masked tokens: packed self-attention with
                statistics at 4096 and 2048 tokens (kernel 10), packed
                cross-attention with statistics at 4096 x 2048 (kernel 11),
                and the blocked self-attention at GML's splits (512, 1024)
                (kernel 12); SDPA yardsticks; two launches of each bit-equal
                and the messages bit-equal without the statistics; 10 and
                11's bounds both ways (messages alone against the call
                without statistics and SDPA, and with the statistics'
                second QK against the timed call) and their exponentials
                over EXP_PER_S beside as a second ceiling.
13. aachen slice
                AdaGML matching (batched early exit) -> RANSAC PnP ->
                projection refinement -> RANSAC PnP on the 32 queries,
                counted (kernels 10, 11, 2, 3, 4, 7 must launch; 1, 5, 6
                must not), recall@25cm/2deg >= 31/32, match precision and
                median errors; timed (5 batches, matcher by CUDA events);
                the matcher A/B on batch 0 (kernel path vs plain path in
                bf16 by match agreement, and in f32 by masks and stop
                layers), early exit vs the unrolled module, and the first 2
                queries on the card against the card machine's CPU.
14. train setup the recognition-training slice at scripts/bench_train.py's
                operating point: SegNetViT (15 layers, d=256, nc113) in f32
                master parameters from weights/segnetvit_rendered.msgpack,
                the frozen SFD2 in bf16 from weights/sfd2_rendered.msgpack,
                and one batch made from --seed with numpy (32 images of
                480 x 640, 512 keypoints each, 113 classes, some padded
                tokens), kept on the card across the steps.
15. train kernels
                kernels 13-15 (the backward kernels) against their plain
                versions on the card: self-attention backward (13) and the
                residual MLP backward (15) on SegNetViT layer 0's inputs of
                the batch, with the layer's real output cotangent; 13 also
                at GML's splits (512, 1024) and the cross-attention backward
                (14) on GML layer 0's activations of phase 6, with padded
                and fully masked tokens; two launches of 13 and 14
                bit-equal; the backward passes' registers and spills as
                ptxas reported them at the build (none may spill); the
                SDPA-backward yardsticks (for 13 at GML's splits one call
                a side); 13's and 14's launches timed by torch.profiler;
                15 two launches bit-equal, its three launches (token pass,
                weight-gradient pass, reduction) by torch.profiler beside
                the call, and its registers and spills.
16. train slice the gradient A/B at the loaded weights: one step's f32
                master gradients by the kernel path and the plain path in
                bf16 (and the plain path in f32 as the reference of both),
                per tensor and as a whole; then the augmented step (jitter,
                frozen SFD2, mid_features sampled at the keypoints, bf16
                recognition forward and backward over f32 masters, AdamW)
                through Trainer's step on the fixed batch: 20 steps counted
                (kernels 8, 1, 2, 13, 15 exactly 1, 15, 15, 15, 15 times a
                step; no other), the loss finite and falling; steps/s
                (median of 3 runs of 8) with the stages by CUDA events; the
                A/B again after the steps, reported.
17. int8 setup  the int8 image slice's RenderedGuard in bf16 (bench.py's
                default, BENCH_INT8=1 with PRAM_INT8_CONV, PRAM_INT8_MLP and
                PRAM_INT8_PROJ on): the int8 SFD2 calibrated on the 4
                calibration views from the bf16 weights, SegNetViT and GML
                with int8 projections and MLPs, the map built on the card
                through the int8 extractor.
18. int8 kernels
                kernels 16-19 against their plain versions on the card, on
                the real inputs of one uncounted int8 pipeline pass of the
                32 noisy queries: the int8 MLP (16) at 32 x 512 and 32 x 1536
                tokens, the int8 self-attention (17) at 32 x 512 and at
                GML's splits, the cross-attention one at 32 x (512 + 1024),
                two launches of each bit-equal, one call of each counted
                (the s8 pass and the message pass; no rotate launch), and
                their s8 projection pass (csrc/proj_int8.cu) alone against
                project_int8_plain (equal but for one-bf16-step ties, the
                share printed; two launches bit-equal), timed beside its
                bound, torch._int_mm of the same s8 operands and F.linear
                of the same bf16 projection, and each form's launches by
                torch.profiler; the int8 conv (18, csrc/conv_tile.cuh's
                wgmma tile; ptxas's registers and spills of both conv
                sources checked) on each of the extractor's 14 int8 3x3
                layers with both tails, two launches bit-equal, each
                layer's time printed beside its bound and cuDNN's bf16
                convolution of the same shape; the conv pair (19) on the
                float extractor's conv3a + conv3b at 32 x 120 x 160, two
                launches bit-equal, its two launches' device time by
                torch.profiler; the yardsticks (SDPA, cuDNN).
19. int8 slice  RenderedGuard.recall on the 32 noisy queries through the
                int8 path, counted: kernels 16, 17 (self, cross), 17's s8
                pass and 18 exactly 33, 24, 9, 33 and 14 launches (12 at
                the TPU kernel's gates, conv2a and convPa_3 with the XLA
                route's tail), 1, 2 and 5 none, 3, 4, 6-9 as on the float
                image slice; recall@5cm/5deg 1.0; timed by stage.
20. int8 A/B    the int8 extractor's kernel path against its plain path on
                4 views (the extraction A/B bounds in bf16), and against the
                float extractor (descriptor cosine >= 0.99).

21. matching    refinement by matching on the GML slice's 32 queries (the
                scene's 4 covisible frames), auto refinement (trust 64, then
                none trusted) and the adaptive step at seg_k 10, each
                counted (kernels 3, 4, 6, 7 exactly as the path needs them)
                and its recall held; then refine_matching_core at the
                configs' 20 covisible frames (a 24-frame scene, 640 GML
                problems, 10240 correspondences a query) counted, timed by
                stage (matcher, noise draw, P3P, kernels 3 and 4), its
                recall and match precision, and 2 queries on the card
                against the card machine's CPU with the card's triplets.

22. cli         both serving CLIs through main(argv) on the card, their inputs
                written to a temporary directory in the reference layout:
                cli.inference on the GML slice's scene (a compressed COLMAP
                model, its frames holding their packed tables' points, 112
                declared clusters for SegNetViT's nc113 head) and its 32
                queries' feature caches, read back equal to the map in
                memory, counted (kernels 1, 2, 5, 6 and 3, 4, 7 at one
                SegNetViT, one GML and two PnPs; no other), recall@5cm/5deg
                at most one query below the GML slice's, its report, stage
                times and steady_fps, again at --batch 8; then
                cli.online_localization on 32 rendered 480 x 640 frames
                along a path with two jumps, written as PNG, against the
                rendered map built on the card and read back equal,
                counted (kernels 8, 9 and SegNetViT every frame, GML and two
                PnPs every tracking step and relocalization), every frame
                within 5 cm / 5 deg, tracked frames present, and the frame
                after the first jump (whose view shares no map point with
                the last one) falling back from a failed tracking step to
                relocalization, its mean feat / rec / loc / total ms; and each CLI
                with --device cpu on the first 4 queries / frames against
                the card's flags.

23. gml_train   cli.train_synthetic_gml.main on the card at full width: GML (9
                layers, d 256) from the flax-like init, 600 Adam steps of 8 x
                (512 + 1024) tokens in bf16 over f32 masters on the bench
                scene's pool of 64 batches, then the validation on 32 queries.
                Before the first step, on the pool's first batch: the step-0
                gradient A/Bs (the backward kernels 13-15 against their plain
                versions on the kernel forward, each tensor within 3%, and a
                planted 5% fault in kernel 14's dqk failing that bound; the
                kernel path and plain path in bf16 against the plain path in
                f32) and SinkhornPlan (kernel 6 forward, the
                plain iterations differentiated) against plain autograd on the
                batch's similarity and loss. The loop counted apart from the
                validation: kernels 1 and 5, 13 and 14 nine times a step, 2
                and 15 eighteen, 6 once, no other; the validation one GML and
                two PnPs. The loss finite and its mean over the last 50 steps
                below the first 50's; recall@5cm/5deg >= 31/32; steps/s; a
                step's stages by CUDA events and its kernels by torch.profiler
                on a copy of the trained model; kernel 14 on the inputs the
                path gave it, against its plain version and its bound.
24. train_cli   cli.train.main on the card at configs/config_train_7scenes_sfd2
                .yaml's operating point (SegNetViT 15 layers, batch 32, 512
                tokens, bf16 over f32 masters), 2 epochs of 5 its, on 48 views
                of the GML slice's scene written in the reference layout (a
                COLMAP model, the training list, 256-d descriptors in the
                feature caches, 112 declared clusters); then a resume from the
                first epoch's checkpoint that ends at the same iteration. Each
                run counted (kernels 1, 2, 13, 15 fifteen times a step, no
                other); its checkpoints, the best copy and finite losses.

                Phase 22 also runs cli.online_localization on the first 4
                frames at --max_keypoints 1000, off every kernel's tile
                (phase 27 reports it): counted, every frame within 5 cm /
                5 deg.

25. aachen_front
                path A, scripts/bench_aachen.py:242-280's front end through
                the port's entry points: 8 rendered views of 768 x 1024
                (focal 500, the principal point at the centre) -> SFD2 from
                weights/sfd2_rendered.msgpack, int8 (calibrated on 2 such
                views, the bench's default) and float, top-4096 keypoints
                -> SegNetViT nc513 (15 layers, its seeded flax-like init)
                over 8 x 4096 tokens -> the AdaGML slice's Localizer on the
                Aachen scene; counted (kernels 8, 9, 1 and 2 at the front,
                18 on the int8 run, 10, 11, 2, 3, 4, 7 in localization);
                queries/s; each extractor's kernel path against its plain
                path; int8 against float on all 4096 keypoints (the bound
                min cosine >= 0.99 recorded, not met by the method; the
                kernel path's spread held to the plain path's); SegNetViT's
                kernel path against its plain path, both against the plain
                path in f32 (argmax agreement >= 0.99 recorded, not met by
                bf16 on a seeded head); kernels 1, 2, 8, 9 and 18 at these
                shapes against their plain versions, timed beside their
                bounds; the first 2 views on the card and on the card
                machine's CPU in bf16, routed by the ground truth to the
                image slice's rendered map of the same world: extraction
                within AB_BF16, the same success flags, and the CPU's
                localization of the card's features within 5 mm / 0.1 deg
                of the card's, at least one view localized on both sides
                (the CPU end to end from its own features recorded).
26. aachen_gml  path B: GML (9 layers, weights/gml_synthetic.msgpack) on the
                AdaGML slice's 32 queries of 4096 keypoints against frames of
                2048, routed by ground truth, counted (kernels 1, 5, 2, 3, 4,
                7 and kernel 6's wide instance), recall@25cm/2deg at most
                one query below the plain path's on the same RANSAC seeds;
                kernels 1 (splits 4096 + 2048), 5, 2 and 6 wide at these
                shapes against their plain versions, timed beside their
                bounds, 6 wide also entry by entry (WIDE_RTOL / WIDE_ATOL,
                which the plain Sinkhorn in bf16 must fail) and at 80
                problems with its peak memory and two calls bit-equal; 2
                queries on the card and on the CPU; then cli.inference at
                configs/config_train_aachen_sfd2.yaml (seg_k 10: 80 GML
                problems a batch of 8) on the Aachen scene written as a
                compressed model with 512 clusters and its 32 queries'
                4096-keypoint caches, counted, and its first 4 queries one
                at a time on the card and with --device cpu (the child
                started in phase 11), the same success flags.
27. shapes      every padded wrapper, forward and backward, at token
                counts off its tile against its plain version on the card,
                one counted launch a call: kernels 1 and 17 (self) at 1000,
                1000 + 1024 and 4000 + 2000 tokens, 10 and 12 in bf16 and f32
                there, 5, 17 (cross) and 11 at 1000 x 1024 and 4000 x 2000, 2
                and 16 at 1000 and 12008 tokens, both projection passes at
                1000, 7 at 1000 queries x 2000 points (no padded point
                chosen), 13 and 14 at 2 x (1000 + 600) and 15 at 1000 rows
                (within the on-tile card tests' 2% / 1%), and 15 on rows of
                zeros alone (exactly zero weight gradients); AdaGML at 4000 x
                2000 tokens in f32 with its masks and stop layers equal to
                its plain path's.

28. superpoint the second model family's path at full width, its models from
                their seeded inits: the rendered world's map built on the card
                by SuperPoint (12 reference views, 2048 keypoints of 256-d
                descriptors each, 4096 refinement points a landmark), 32
                noisy 480 x 640 queries at the superpoint-n4096 config (4096
                keypoints, conf_th 0.005, NMS radius 3, border 4) in 4
                batches of 8 -> SegNet (9 layers, d 256, the scene's class
                count) on their 256-d cDa tokens -> GM (9 layer pairs, d 256,
                20 Sinkhorn iterations) and, again, the mutual-NN matcher,
                routed by ground-truth logits -> Localizer with projection
                refinement; each matcher's run counted (kernel 9 at R = 3,
                kernel 7's 256-d instance and kernels 3, 4 a batch; kernel 6
                for GM), its recall and queries/s recorded; kernel 9 at R =
                3 bit-equal to simple_nms on the 32 score maps in bf16 and
                f32, kernel 7 at 256-d and kernel 6 on GM's plan against
                their plain versions on the path's inputs, each timed beside
                its bound; extraction A/B; the first 4 queries of each
                matcher on the card machine's CPU with the card's triplets.
29. segnet_gm_cli
                cli.inference with network segnet (9 layers, nc113) and
                matching_method gm (the JAX CLI's GMConfig()) on phase 22's
                offline layout, counted, and its first 4 queries on the card
                and with --device cpu; cli.extract_features'
                superpoint-n4096 extractor on 4 PNG frames (counted; f32 on
                the card against the CPU on 2), build_compressor(64) on
                SFD2 descriptors and RetNet on SFD2 mid_features, card bf16
                against CPU f32.

30. mapping     map building at a real mapping run's size: 64 reference views of the
                image slice's world at 480 x 640 rendered on the host, SFD2
                in bf16 on the card (kernels 8 and 9) at 2048 keypoints a
                view written as an npy feature directory, each view paired
                with its 8 nearest by camera centre (a retrieval file read
                back through maps/parsers.py), every pair matched by mutual
                NN on the card, triangulated with the known poses through
                mapping/triangulate.py:triangulate_model (points, track
                length, the distance of each point to the rendered surface
                under its first observation, also on tracks of 3+ views, on
                tracks the ground truth confirms and by triangulation
                angle), then cli.build_map's main with
                KMeans and with Birch on the card (stages by a synchronized
                StageTimer), and again with --device cpu: KMeans labels equal
                on >= 99.9% of points, Birch labels equal, the chosen track
                descriptor equal on >= 99.9% (where not, the two medians
                within 1e-5), VRFs equal on segments whose members agree,
                the compressed model's points equal wherever every
                segment's first VRF agrees; the KMeans map loaded by
                load_scene_map localizes phase 10's 32 noisy queries (SFD2,
                routing by the ground truth over the map's labels, GML,
                RANSAC PnP, projection refinement) with kernels 1-9 each
                launched, recall@5cm/5deg >= 31/32, queries/s; KMeans at 10^6
                points x 512 clusters x 50 iterations and best_of over 65536
                tracks of up to 64 views of 128-d, by host clock, CUDA events
                and peak device memory.
31. hloc        the hloc file pipeline through the CLIs' main(argv) on phase
                30's world: its 64 reference views and 32 queries written as
                PNGs, cli.extract_features (SFD2 bf16, the sfd2 config's 4096
                keypoints, one image at a time) into feats.h5, the 8 nearest
                views a view, cli.match_features with GML (batches of 8 pairs
                padded to 4096 a side) into matches.h5, cli.triangulate
                against the known poses, cli.build_map --features feats.h5
                with KMeans; every dataset written read back by io/h5.py
                equal; the queries on the built map through Localizer (as
                phase 30, recall@5cm/5deg >= 31/32) and through
                engine/hloc_localizer.py:run_localizer with each query's 10
                nearest reference views by camera centre (recall@0.25m/2deg
                >= 31/32, queries/s); kernels 1, 5, 2 and 6's wide instance
                at the pair matcher's first batch against their plain
                versions; run_localizer with mutual NN on the first 4 queries,
                card against CPU on the card's triplets (equal flags, poses
                within 5 mm / 0.1 deg); stage seconds, every kernel counted
                over the path.
32. runtime     the runtime remainder: (a) the JPEG fixtures of
                tests/jpeg_fixtures/ decoded by io/jpeg.py equal to the
                digests of cv2.imread's arrays, and a decode's host ms at
                640 x 480 and 1024 x 768; (b) phase 22's 32 online frames
                written as JPEG by write_jpeg (q95, 4:2:0) through
                cli.online_localization.main with --viewer_port 0 at
                --max_keypoints 512, held to phase 22's gates (32/32 within
                5 cm / 5 deg, frame 11 falling back to relocalization, the
                launches of every frame), and at 1024, the CLI's default,
                held to the JAX CLI's outcome on the same frames (frames
                11-15 lost, every other within 5 cm / 5 deg, frame 11
                falling back); at both the viewer's /map parsed and /state
                holding 32 updates whose last is the CLI's last result;
                decode and frame ms beside phase 22's PNG run, the viewer's
                update ms; (c)
                scripts/reconstruct_scene_torch.sh in a subprocess on phase
                30's 64 reference views written as JPEG: exit 0, its h5 files
                read back, its KMeans map localizing the 32 queries (written
                as JPEG, decoded by the port) at recall@5cm/5deg >= 31/32 with
                kernels 1-9 launched; (d) cli.train (SegNetViT 15 layers) at
                1000 tokens a view and a batch of 6, and two GML matcher steps
                at 4 x (500 + 1000) tokens: kernels 13, 14 and 15 off their
                tiles, counted, the losses finite.

Prints the kernel table as one JSON line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Each
kernel's row carries ``launches_cli``, its launches on phase 22's two paths,
``launches_gml_train`` and ``launches_train_cli``, phases 23's and 24's
(kernel 14's ``launches`` are phase 23's), ``launches_aachen_front`` (int8,
float), ``launches_aachen_gml``, ``launches_aachen_cli``, ``launches_shapes``
and ``launches_online_1000``, and where the kernel ran there, its figures at
path A's and path B's shapes (``aachen_front``, ``aachen_gml``);
``launches_superpoint`` (phase 28, by matcher), ``launches_segnet_gm_cli``
(phase 29), ``launches_mapping`` (phase 30's localization), ``launches_runtime``
(phase 32's counted runs: the two online runs, the script's map localized,
the training steps; the script's own CLIs run in a subprocess and are not
counted) and ``launches_hloc`` (phase 31's path), with kernels 1, 2, 5 and 6 wide's figures at the pair matcher's shapes (``hloc``), and for kernels 9, 7
and 6 their figures on the SuperPoint
path (``superpoint``: R = 3, 256-d, GM's plan). The row
``sinkhorn_wide`` is kernel 6's wide instance, its launches path B's. Any failed
check raises, so the script exits non-zero and prints no result. It needs a
CUDA device and the repository beside it.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

T0 = time.perf_counter()
PHASES = {}

# card peaks (NVIDIA H100 SXM data sheet, dense): bytes/s and ops/s
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
INT8_TENSOR_OPS = 1979e12
F32_FLOPS = 67e12
# exponentials: 16 a clock on each of the 132 SMs (the SFU's ex2) at the
# 1.98 GHz boost clock; a second ceiling of the attention kernels at head dim 64
EXP_PER_S = 132 * 16 * 1.98e9

# tolerances of kernel vs plain version (reasons in PERF.md)
# attention / MLP: |kernel - plain| <= TOL * max|plain|. Both outputs are bf16
# (relative step 2^-8); the kernel rounds the softmax probabilities (attention)
# and sums its products in another order than the plain version, so a few
# elements land one or two bf16 steps apart. 2% of the output's scale is
# about five steps and still fails any wrong index, mask or missing term.
ATTN_TOL = 0.02
MLP_TOL = 0.02
# the projection pass of kernels 1 and 5 vs its plain version: the f32 sums
# of 256 products in another order round to the same bf16 value but for a
# few elements, which land one bf16 step apart (2^-7 of the value at most);
# on the rotated columns such a step in either element of the pair carries
# through the rotation, which rounds once more: |got - ref| <= 2^-7 (|ref| +
# |y0| + |y1|), y the pair before the rotary. Near zero the sums' own f32
# rounding decides: 2^-13 of the output's scale on top. >= 99% equal.
PROJ_STEP = 2.0**-7
PROJ_FLOOR = 2.0**-13
PROJ_EQUAL_SHARE = 0.99
SCORE_MAX_DIFF = 2  # points at the gate edge flip with f32 summation/FMA order
# kernel 3's shapes (problems, poses, points) beside GML's: AdaGML's,
# matching refinement's at C = 20 frames of 512 keypoints with 128 and 256
# hypotheses, and a tail (K not a multiple of 128, N of the 256-point chunk)
SCORE_SHAPES = (("adagml", (8, 512, 4096)), ("matching_128", (32, 512, 10240)),
                ("matching_256", (32, 1024, 10240)), ("tail", (32, 1000, 10000)))
POLISH_POSE_ATOL = 2e-3  # R entries and t (scene units) after 20 GN steps in f32
POLISH_COUNT_DIFF = 2
# Sinkhorn: plan entries (<= 1) of the real block within 1e-4; the dustbin row
# and column within 0.3%: their scaling factors sit near a degenerate fixed
# point that amplifies f32 summation order (pram_tpu/ops/sinkhorn_pallas.py)
SINKHORN_ATOL = 1e-4
SINKHORN_DUSTBIN_RTOL = 3e-3
# refinement NN: f32 similarity sums in another order flip near-ties of the
# nearest point and of the 0.995 ratio test, so indices and keep flags are
# held by agreement rate. d1 = sqrt(2 - 2 sim + 1e-6) has slope -1/d1 in sim,
# and a rendered keypoint carries its map point's exact descriptor, so d1 is
# ~1e-3 there and the sums' ~1e-7 noise in sim moves it by ~1e-4: d1 within 1e-3
REFINE_AGREE = 0.99
REFINE_D1_ATOL = 1e-3
# card vs CPU on a slice: same consensus, so poses agree far inside 5 cm / 5 deg
SLICE_T_TOL, SLICE_R_TOL_DEG = 0.005, 0.1
# stem: in bf16 both sides round conv1a's output to bf16, and an f32 sum in
# another order moves a value across a bf16 rounding boundary now and then
# (one step, 2^-8 relative), which conv1b carries on: 2% of the output's
# scale, as for the attention kernels. In f32 only the summation order
# differs: rtol = atol = 1e-4 (TF32 off).
STEM_TOL = 0.02
STEM_F32_TOL = 1e-4
# extraction A/B, kernel path vs plain path: in bf16 the stem's rounding
# differences move a few near-threshold or near-tied maxima; in f32 the two
# paths differ by summation order only
AB_BF16 = (0.95, 0.99)  # keypoint-set agreement, descriptor cosine min
AB_F32 = (0.99, 0.999)
# kernels 10-11's statistics: both sides sum the same normalized f32 weights;
# the logits they come from are summed in another order (and from bf16
# weights rounded against another running max in the messages), so 1e-3 of
# the statistics' scale
STATS_TOL = 1e-3
# AdaGML matcher, kernel path vs plain path in bf16: a token whose confidence
# sits at a pooling threshold can flip with the rounding, so the outcome is
# held, as scripts/bench_aachen.py holds the fused JAX path to its XLA path
# (0.9985 there): matches agree on >= 99% of the valid query keypoints
ADA_AB_AGREE = 0.99
# early exit vs the unrolled module: the same operations up to the all-stop
# point, so plans within tests/test_adagml_fused.py's rtol / atol
ADA_EXIT_RTOL, ADA_EXIT_ATOL = 5e-4, 5e-5
ADA_RECALL_MIN = 31 / 32  # recall@25cm/2deg on the 32 Aachen queries
# backward kernels 13-15 vs their plain versions: the bf16 outputs (dqkv,
# dqk, dv, dx, dpm) as the forward kernels, 2% of scale: both sides round
# p and dlogit (dh in the MLP) to bf16 before their products, and an f32 sum
# in another order moves a value across a rounding boundary now and then.
# The f32 reductions (dcos, dsin, the bias and weight gradients) sum the
# same rounded products in another order: 1% of scale (PERF.md)
BWD_TOL = 0.02
BWD_F32_TOL = 0.01
# gradient A/B of one training step, kernel path vs plain path in bf16: each
# f32 master gradient within 3% of its scale (the JAX package's bf16
# backward is held to 3e-2 in tests/test_train_vjp.py and measured 0.9-1.0%
# on its chip, ROUND_NOTES.md)
GRAD_AB_TOL = 0.03
TRAIN_STEPS = 20
# int8 kernels vs their plain versions: the integer sums are exact on both
# sides and the quantizers divide alike; the MLP's and the attention's f32
# statistics are summed in another order (a GELU output or a softmax
# weight one bf16 step apart), so 2% of scale as for their bf16 twins; the
# conv kernel's tails round each operation as the plain version does, so
# its outputs are equal but for rare FMA-free rounding ties: >= 99.9% equal
INT8_TOL = 0.02
CONV_EQUAL_SHARE = 0.999
INT8_FLOAT_COS = 0.99  # int8 extractor vs float extractor, descriptor cosine min


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def phase(name: str, t_start: float) -> None:
    PHASES[name] = round(time.perf_counter() - t_start, 3)
    log(f"phase {name} done in {PHASES[name]} s")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_name(key: str) -> str:
    """A profiler key's kernel name without its return type, namespaces,
    template arguments and parameters, e.g. ``token_kernel``."""
    if "::" not in key:
        return key[:32]
    head = key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()
    return head[-1].split("::")[-1] if head else key[:32]


def launch_ms(torch, fn, n: int = 10, tries: int = 3, want=None) -> dict:
    """Device ms a launch of each kernel that ``fn`` launches, by
    torch.profiler over ``n`` calls after one warm-up: free of the host's
    time, which bounds a call timed by events when its wrapper's host work
    outlasts its kernels. The mean is over the launches the profiler saw:
    on the H100 its sessions have seen 5 to 9 of a kernel's 10 launches,
    and one saw none. A session that saw no device time, or no kernel whose
    name ``want`` accepts, is made again up to ``tries`` times; ``{}`` if
    none did."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        by_launch = {kernel_name(e.key): round(e.device_time_total / e.count / 1e3, 4)
                     for e in prof.key_averages() if e.device_time_total > 0 and e.count}
        if by_launch and (want is None or any(want(k) for k in by_launch)):
            return by_launch
        log(f"torch.profiler session {attempt} of {tries} over {n} calls saw {sorted(by_launch)}")
    return {}


def log_ptxas(build, sources) -> list:
    """Log the registers and spills ptxas reported for every kernel of
    ``sources`` when the library was built; returns the reports."""
    reports = []
    for src in sources:
        report = build.ptxas_report(src)
        require(len(report) > 0, f"no ptxas report of {src}")
        for k in report:
            log(f"ptxas {src} {k['kernel']}: {k['registers']} registers at launch, spilled "
                f"{k['spill_stores']} bytes stored / {k['spill_loads']} loaded"
                + "".join(f"; {note}" for note in k["notes"]))
            reports.append((src, k))
    return reports


def f32_vectors(args: tuple) -> tuple:
    """``args`` with every 1-D tensor cast to contiguous f32, which the
    residual-MLP wrappers then pass on as they are: a call launches the
    tile and nothing else on the card."""
    return tuple(a.float().contiguous() if getattr(a, "ndim", 0) == 1 else a for a in args)


def mlp_device_ms(torch, wrapper, args: tuple, kwargs: dict | None = None) -> tuple:
    """Device ms a launch of the residual-MLP tile (kernels 2 and 16), one
    a call, and how it was timed: by launch_ms, the kernel alone, or,
    where no profiler session saw it, by events around calls that launch
    the tile alone (its f32 vectors cast beforehand), which holds the
    host's time too wherever that outlasts the kernel."""
    kwargs = kwargs or {}

    def is_tile(name):
        return "mlptile" in name or "mlp_kernel" in name

    by_launch = launch_ms(torch, lambda: wrapper(*args, **kwargs), want=is_tile)
    found = [v for k, v in by_launch.items() if is_tile(k)]
    if found:
        require(len(found) == 1, f"no single residual-MLP tile launch among {sorted(by_launch)}")
        return found[0], "torch.profiler"
    bare = f32_vectors(args)
    return cuda_ms(torch, lambda: wrapper(*bare, **kwargs), iters=50), "events, the tile alone"


def bound_ms(n_bytes: float, ops: float, peak_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_mixed_ms(n_bytes: float, int8_ops: float, bf16_ops: float):
    """bound_ms for work whose products are partly int8 and partly bf16: the
    operations take int8_ops / the int8 peak + bf16_ops / the bf16 peak."""
    return bound_ms(n_bytes, int8_ops * BF16_TENSOR_FLOPS / INT8_TENSOR_OPS + bf16_ops, BF16_TENSOR_FLOPS)


def attention_bounds(name: str, k: dict) -> dict:
    """The bound of an attention kernel with AdaGML's statistics both ways,
    logged against its times: the messages alone (QK and PV, held against
    the call without statistics and the SDPA yardstick ``k["lib"]``) and the
    messages with the statistics' second QK product (against the timed
    call, ``k["ms"]``), with the exponentials over ``EXP_PER_S`` beside as a
    second ceiling. Returns the kernel-table keys: bound_ms / bound_by with
    the statistics, and the others."""
    msg_ms, msg_by = bound_ms(k["bytes"], k["ops"], BF16_TENSOR_FLOPS)
    all_ms, all_by = bound_ms(k["bytes"], k["ops"] + k["stats_ops"], BF16_TENSOR_FLOPS)
    exp_ms = k["exps"] / EXP_PER_S * 1e3
    log(f"{name}: messages {k['no_stats_ms']:.4f} ms against their bound {msg_ms:.4f} ms ({msg_by}, "
        f"{k['ops'] / 1e9:.1f} GFLOP) and SDPA {k['lib']:.4f} ms; with statistics {k['ms']:.4f} ms against "
        f"{all_ms:.4f} ms ({all_by}, {(k['ops'] + k['stats_ops']) / 1e9:.1f} GFLOP); exponentials "
        f"{k['exps'] / 1e9:.3f} G, {exp_ms:.4f} ms at {EXP_PER_S / 1e12:.2f} T/s")
    return dict(bound_ms=all_ms, bound_by=all_by, bound_messages_ms=msg_ms, exp_ms=exp_ms,
                no_stats_ms=k["no_stats_ms"])


def polish_bound(P: int, N: int, cfg) -> dict:
    """bound_ms / bound_by of kernel 4 on P problems of N points: its inputs
    read once and outputs written once; ~150 f32 operations a point a GN
    step and ~50 a count, as many counts and steps as the JAX kernel runs."""
    n_gn = (cfg.lo_rounds + 3) * cfg.gn_iters
    n_count = 2 * (cfg.lo_rounds + 3) + 1
    g_bytes = P * N * (12 + 8 + 1 + 1) + P * (12 + 12 + 12 + 4) * 4
    bnd, by = bound_ms(g_bytes, float(P * N * (150 * n_gn + 50 * n_count)), F32_FLOPS)
    return dict(bound_ms=bnd, bound_by=by)


def refine_bound(B: int, N: int, P: int, D: int = 128) -> dict:
    """bound_ms / bound_by of kernel 7 on B problems of N queries and P
    points of D-d descriptors: the bf16 similarities on the tensor cores
    against the bytes of the inputs and outputs."""
    r_bytes = B * (N * (D * 2 + 8 + 1) + P * (D * 2 + 8 + 1) + N * (4 + 4 + 1))
    bnd, by = bound_ms(r_bytes, 2.0 * B * N * P * D, BF16_TENSOR_FLOPS)
    return dict(bound_ms=bnd, bound_by=by)


# f32 operations a (pose, point) pair of kernel 3 by camera. Pinhole: the
# camera-frame point (9 fmas, 18), the depth guard (compare, select: 2), one
# reciprocal (1), du and dv (an fma each: 4), the squared norm (3), the two
# gates, their AND and the count's add (4): 32. With distortion add x and
# y (2), xy (1), r^2 (3), the radial polynomial (2 fmas: 4) and the two
# distorted coordinates (8 each): 58.
SCORE_OPS = {"pinhole": 32.0, "distorted": 58.0}


def score_kinds(cam) -> dict:
    """Kernel 3's problems by camera, as the kernel tells them apart (any of
    k1, k2, p1, p2 nonzero): ``{"pinhole": n, "distorted": m}``."""
    d = int((cam[:, 4:] != 0).any(-1).sum())
    return {"pinhole": cam.shape[0] - d, "distorted": d}


def score_bound(cam, K: int, N: int) -> dict:
    """bound_ms / bound_by of kernel 3 on the problems of ``cam`` with K
    poses and N points each: poses, flags and counts once, points once,
    SCORE_OPS f32 operations a pair by each problem's camera."""
    P = cam.shape[0]
    s_bytes = P * K * (12 * 4 + 1 + 4) + P * N * (12 + 8 + 1) + P * 8 * 4
    ops = sum(SCORE_OPS[c] * n for c, n in score_kinds(cam).items()) * K * N
    bnd, by = bound_ms(s_bytes, ops, F32_FLOPS)
    return dict(bound_ms=bnd, bound_by=by)


def score_issue_ms(cam, K: int, N: int, sass: dict):
    """Kernel 3's issue floor: the SASS instructions a (pose, point) pair of
    each problem's camera (``score_sass_per_pair``) over 132 SMs x 128 lanes
    at the 1.98 GHz boost clock; None without a SASS count."""
    if not sass:
        return None
    pairs = sum(sass[c] * n for c, n in score_kinds(cam).items()) * K * N
    return pairs / (132 * 128 * 1.98e9) * 1e3


def score_case(torch, gen, P: int, K: int, N: int, distorted: bool = False, in_view: bool = True):
    """Kernel 3's inputs, on the CPU: P problems of N points (30% outliers,
    10% masked) seen by a pinhole camera (or one with radial and tangential
    distortion), K hypotheses within ~3 deg / 5 cm of the truth, 20% of
    them invalid; returns (cam, R, t, valid, xyz, uv, mask). The points lie
    in the camera's view (inside the 640 x 480 image, 2-8 m deep), as
    observed points do; with ``in_view`` False they are drawn around the
    camera's axis, some outside the image, where a distortion polynomial
    folds them back into it with errors of f32 rounding times its slope
    (1e8 at x = 250)."""
    from pram_tpu_torch.geometry import pnp as gpnp
    from pram_tpu_torch.geometry.camera import Camera, project
    from pram_tpu_torch.geometry.rotations import so3_exp

    dist = [0.01, -0.005, 0.001, -0.0005] if distorted else [0.0] * 4
    cam = torch.tensor([500.0, 500.0, 320.0, 240.0] + dist).repeat(P, 1)
    R_gt = so3_exp(torch.randn(P, 3, generator=gen) * 0.2)
    t_gt = torch.randn(P, 3, generator=gen) * 0.3 + torch.tensor([0.0, 0.0, 5.0])
    if in_view:
        z = 2.0 + 6.0 * torch.rand(P, N, 1, generator=gen)
        xy = (torch.rand(P, N, 2, generator=gen) - 0.5) * torch.tensor([0.64 * 2, 0.48 * 2])
        xc = torch.cat([xy * z, z], -1)
        xyz = torch.einsum("pji,pnj->pni", R_gt, xc - t_gt[:, None])  # R^T (xc - t)
    else:
        xyz = torch.randn(P, N, 3, generator=gen) * 2.0
    uv, _ = project(Camera(cam, None), R_gt, t_gt, xyz)
    uv = uv + torch.randn(P, N, 2, generator=gen) * 0.3
    outl = torch.rand(P, N, generator=gen) < 0.3
    uv[outl] = torch.rand(int(outl.sum()), 2, generator=gen) * torch.tensor([640.0, 480.0])
    mask = torch.rand(P, N, generator=gen) > 0.1
    R_h = so3_exp(torch.randn(P, K, 3, generator=gen) * 0.05) @ R_gt[:, None]
    t_h = t_gt[:, None] + torch.randn(P, K, 3, generator=gen) * 0.05
    valid = torch.rand(P, K, generator=gen) > 0.2
    return cam, R_h, t_h, valid, xyz, uv, mask


def score_plain_by_poses(pnp, args, poses: int = 128):
    """ransac_score_plain over ``poses`` hypotheses at a time (its [P, K, N]
    intermediates would take tens of GB at 32 x 1024 x 10240)."""
    import torch

    cam, R, t, valid, xyz, uv, mask, th = args
    return torch.cat([pnp.ransac_score_plain(cam, R[:, i:i + poses], t[:, i:i + poses],
                                             valid[:, i:i + poses], xyz, uv, mask, th)
                      for i in range(0, R.shape[1], poses)], dim=1)


def score_sass_per_pair(build) -> dict:
    """SASS instructions a (pose, point) pair in kernel 3's two point loops,
    by ``cuobjdump -sass`` of the built library: each loop scores two
    points for four poses a pass (eight reciprocals), so a loop's
    instructions over 8. ``{"pinhole": x, "distorted": y}``; ``{}`` where
    cuobjdump is missing."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(build.library_path())], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    fn = next(f for f in sass.split("Function : ")[1:] if "ransac_score_kernel" in f.split("\n")[0])
    ins = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
    loops = []
    for a, op in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", op)
        if m and int(m.group(1), 16) < a:
            body = [o for x, o in ins if int(m.group(1), 16) <= x <= a]
            if sum("MUFU.RCP" in o for o in body) == 8 and not any("BAR" in o for o in body):
                loops.append(len(body) / 8)
    require(len(loops) == 2, f"kernel 3's two point loops not found in its SASS ({loops})")
    return {"pinhole": min(loops), "distorted": max(loops)}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_s(fn, n: int = 5) -> float:
    """Median host seconds of ``n`` calls after one warm-up; ``fn`` ends in
    a synchronize."""
    fn()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return sorted(times)[n // 2]


def check_scaled(name: str, got, ref, tol: float) -> float:
    """Require |got - ref| <= tol * max|ref|; returns the max abs error."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    log(f"{name}: max abs err {err:.3e}, relative to max|ref| {scale:.3e}: "
        f"{err / scale:.2e} (tol {tol})")
    require(err <= tol * scale, f"{name} kernel disagrees with its plain version")
    return err


def check_projection(name: str, got, ref, pre=None, rot_cols: int = 0) -> float:
    """Require the projection pass within PROJ_STEP of its plain version
    (see above; ``pre`` the unrotated projection of the first ``rot_cols``
    columns) and equal on PROJ_EQUAL_SHARE of the elements; returns the max
    abs error."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    bound = ref.abs() * PROJ_STEP + ref.abs().max() * PROJ_FLOOR
    if rot_cols:
        pair = pre[..., :rot_cols].float().abs().unflatten(-1, (-1, 2)).sum(-1)
        bound[..., :rot_cols] += pair.repeat_interleave(2, -1) * PROJ_STEP
    equal = (diff == 0).float().mean().item()
    err = diff.max().item()
    log(f"{name}: {equal:.6f} of the elements equal (min {PROJ_EQUAL_SHARE}), max abs err {err:.3e}, "
        f"max err / bound {(diff / bound).max().item():.3f} (one bf16 step)")
    require(equal >= PROJ_EQUAL_SHARE and bool((diff <= bound).all()),
            f"{name} kernel disagrees with its plain version")
    return err


def ptxas_summary(build, source: str) -> dict:
    """{kernel: [registers, spilled bytes stored + loaded, stack frame
    bytes]} of csrc/<source>."""
    return {k["kernel"]: [k["registers"], k["spill_stores"] + k["spill_loads"], k["stack"]]
            for k in build.ptxas_report(source)}


def require_no_spills(build, sources) -> None:
    """log_ptxas, and fail on a spill."""
    for src, k in log_ptxas(build, sources):
        require(k["spill_stores"] == 0 and k["spill_loads"] == 0, f"{src} {k['kernel']} spills registers")


def mlp_chain(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, eps=1e-6):
    """Kernel 2's yardstick, timed and never called by the port: the eager
    library chain of the same function in bf16 (three F.linear,
    F.layer_norm, F.gelu)."""
    import torch
    import torch.nn.functional as F

    dt = x.dtype
    pm = F.linear(msg, wp, bp.to(dt))
    h = F.linear(torch.cat([x, pm], -1), w0, b0.to(dt))
    y = F.gelu(F.layer_norm(h, (h.shape[-1],), ln_w.to(dt), ln_b.to(dt), eps))
    return x + F.linear(y, w3, b3.to(dt))


def mlp_int8_chain(quant, x, msg, wpq, wps, bp, w0xq, w0pq, w0s, b0, ln_w, ln_b, w3q, w3s, b3, eps=1e-6):
    """Kernel 16's yardstick, timed and never called by the port: the same
    function eagerly, its three products by torch._int_mm on the per-row
    quantized activations (quant.quant_rows), w0's x and proj(msg) halves
    given apart (contiguous), the tails as in the plain version."""
    import torch
    import torch.nn.functional as F

    def q8(a):
        q, rs = quant.quant_rows(a.reshape(-1, a.shape[-1]))
        return q.to(torch.int8), rs

    x2, dt = x.reshape(-1, x.shape[-1]), x.dtype
    mq, mrs = q8(msg)
    pm = ((torch._int_mm(mq, wpq.t()).float() * mrs) * wps + bp.float()).to(dt)
    xq, xrs = q8(x2)
    pq, prs = q8(pm)
    h = (torch._int_mm(xq, w0xq.t()).float() * xrs + torch._int_mm(pq, w0pq.t()).float() * prs) * w0s + b0.float()
    yq, yrs = q8(F.gelu(F.layer_norm(h, (h.shape[-1],), ln_w.float(), ln_b.float(), eps)))
    return (x2 + ((torch._int_mm(yq, w3q.t()).float() * yrs) * w3s + b3.float()).to(dt)).reshape(x.shape)


def mlp_bound(tokens: int, int8: bool):
    """Kernels 2 and 16's bound at `tokens`: x, msg and y once, the weights
    (bf16, or s8 with their f32 scales) and f32 vectors once, 0.92 M
    operations a token."""
    w_elems = 256 * 256 + 512 * 512 + 256 * 512
    if int8:
        return bound_ms(3 * tokens * 256 * 2 + w_elems + (256 * 2 + 512 * 4 + 256 * 2) * 4,
                        2.0 * tokens * w_elems, INT8_TENSOR_OPS)
    return bound_ms(3 * tokens * 256 * 2 + w_elems * 2 + (256 + 512 * 3 + 256) * 4,
                    2.0 * tokens * w_elems, BF16_TENSOR_FLOPS)


# ---- the serving CLIs' inputs on disk: the reference's landmark and dataset
# layout (pram_tpu_torch/maps/loader.py, data/scenes.py), written with the
# port's COLMAP and YAML writers, numpy, and stdlib PNG and JPEG writers


def write_yaml(path, obj) -> None:
    """Block YAML that pram_tpu_torch/core/config.py reads (the port's
    ``utils/common.py:yaml_lines``, as ``save_args_yaml`` writes it)."""
    from pram_tpu_torch.utils.common import yaml_lines

    Path(path).write_text("\n".join(yaml_lines(obj)) + "\n")


def uint8_image(np, img):
    """A float view in [0, 1] -> uint8, rounded to the nearest level."""
    return np.clip(np.round(np.asarray(img) * 255.0), 0, 255).astype(np.uint8)


def write_png(path, img) -> None:
    """uint8 [H, W] or [H, W, 3] -> an 8-bit gray / RGB PNG, every row with
    the Sub filter (type 1)."""
    import struct
    import zlib

    import numpy as np

    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int16)
    sub = rows.copy()
    sub[:, ch:] -= rows[:, :-ch]
    raw = np.concatenate([np.ones((h, 1), np.uint8), (sub & 0xFF).astype(np.uint8)], axis=1)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2}[ch], 0, 0, 0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                           + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


# the JPEG standard's example tables (ITU T.81 Annex K), quantization in
# zig-zag order at quality 50, Huffman as (counts by length, symbols)
JPEG_QUANT = (
    bytes((16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40, 26, 24, 22, 22, 24, 49, 35, 37,
           29, 40, 58, 51, 61, 60, 57, 51, 56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87,
           95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101, 103, 99)),
    bytes((17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66) + (99,) * 50),
)
JPEG_HUFFMAN = {  # (class, id): luminance 0, chrominance 1
    (0, 0): ("00010501010101010100000000000000", "000102030405060708090a0b"),
    (0, 1): ("00030101010101010101010000000000", "000102030405060708090a0b"),
    (1, 0): ("0002010303020403050504040000017d",
             "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25"
             "262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a8384"
             "85868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5"
             "d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (1, 1): ("00020102040403040705040400010277",
             "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f117181"
             "91a262728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82"
             "838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3"
             "d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}
JPEG_ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
               20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
               59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)


def jpeg_bytes(img, quality: int = 95) -> bytes:
    """A baseline JFIF stream of uint8 RGB ``[H, W, 3]`` (4:2:0) or gray
    ``[H, W]``: the standard's tables scaled to ``quality`` as libjpeg scales
    them, a float DCT, and every Huffman code packed with numpy (test
    tooling: the card's machine has no image library)."""
    import struct

    import numpy as np

    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    quant = [np.clip((np.frombuffer(q, np.uint8).astype(np.int64) * scale + 50) // 100, 1, 255)
             for q in JPEG_QUANT]
    zz = np.array(JPEG_ZIGZAG)
    f = img.astype(np.float64)
    if img.ndim == 2:
        planes, samp, mcu = [f], [(1, 1)], 8
    else:
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
        samp, mcu = [(2, 2), (1, 1), (1, 1)], 16
    mh, mw = -(-h // mcu), -(-w // mcu)
    u = np.arange(8)
    dct = np.sqrt(np.where(u == 0, 1.0, 2.0) / 8.0)[:, None] * np.cos((2 * u[None] + 1) * u[:, None] * np.pi / 16)
    blocks = []  # per component: [mh, mw, v * h blocks, 64] zig-zag coefficients
    for ci, (p, (sh, sv)) in enumerate(zip(planes, samp)):
        p = np.pad(p, ((0, mh * mcu - h), (0, mw * mcu - w)), mode="edge")
        if sh == 1 and mcu == 16:
            p = p.reshape(mh * 8, 2, mw * 8, 2).mean(axis=(1, 3))
        bl = (p - 128.0).reshape(mh, sv, 8, mw, sh, 8).transpose(0, 3, 1, 4, 2, 5)
        coef = np.einsum("ux,...xy,vy->...uv", dct, bl, dct).reshape(mh, mw, sv * sh, 64)[..., zz]
        q = quant[min(ci, 1)][None, None, None]
        blocks.append(np.round(coef / q).astype(np.int64))
    # blocks in coding order, each with its component
    per_mcu = [b.shape[2] for b in blocks]
    order = np.concatenate([b.reshape(mh * mw, -1, 64) for b in blocks], axis=1).reshape(-1, 64)
    comp = np.tile(np.repeat(np.arange(len(blocks)), per_mcu), mh * mw)
    n = order.shape[0]

    def table(cls, tid):
        counts, symbols = (bytes.fromhex(x) for x in JPEG_HUFFMAN[(cls, tid)])
        codes, lengths, code, k = np.zeros(256, np.int64), np.zeros(256, np.int64), 0, 0
        for bits in range(1, 17):
            for _ in range(counts[bits - 1]):
                codes[symbols[k]], lengths[symbols[k]] = code, bits
                code, k = code + 1, k + 1
            code <<= 1
        return counts, symbols, codes, lengths

    tabs = {key: table(*key) for key in JPEG_HUFFMAN}
    tid = np.minimum(comp, 1)

    def size_of(v):
        a = np.abs(v)
        return np.where(a == 0, 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1)

    def bits_of(v, s):
        return np.where(v < 0, v + (1 << s) - 1, v)

    dc = order[:, 0]
    diff = dc.copy()
    for c in range(len(blocks)):  # each component predicts from its previous block
        sel = np.flatnonzero(comp == c)
        diff[sel[1:]] = dc[sel[1:]] - dc[sel[:-1]]
    s = size_of(diff)
    dc_code = np.choose(tid, [tabs[(0, t)][2][s] for t in (0, 1)])
    dc_len = np.choose(tid, [tabs[(0, t)][3][s] for t in (0, 1)])
    pieces = [(np.arange(n), np.zeros(n, np.int64), (dc_code << s) | bits_of(diff, s), dc_len + s)]
    blk, k = np.nonzero(order[:, 1:])
    k = k + 1
    v = order[blk, k]
    first = np.r_[True, blk[1:] != blk[:-1]]
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    s = size_of(v)
    t = tid[blk]
    rs = (run % 16) * 16 + s
    code = np.choose(t, [tabs[(1, x)][2][rs] for x in (0, 1)])
    ln = np.choose(t, [tabs[(1, x)][3][rs] for x in (0, 1)])
    pieces.append((blk, 2 * k, (code << s) | bits_of(v, s), ln + s))
    zrl = run // 16
    if zrl.any():
        zb = np.repeat(np.arange(len(blk)), zrl)
        zt = t[zb]
        pieces.append((blk[zb], 2 * k[zb] - 1, np.choose(zt, [np.full(len(zb), tabs[(1, x)][2][0xF0]) for x in (0, 1)]),
                       np.choose(zt, [np.full(len(zb), tabs[(1, x)][3][0xF0]) for x in (0, 1)])))
    last = np.zeros(n, np.int64)
    np.maximum.at(last, blk, k)
    eob = np.flatnonzero(last < 63)
    et = tid[eob]
    pieces.append((eob, np.full(len(eob), 200), np.choose(et, [np.full(len(eob), tabs[(1, x)][2][0]) for x in (0, 1)]),
                   np.choose(et, [np.full(len(eob), tabs[(1, x)][3][0]) for x in (0, 1)])))
    blk_i, sub, codes, lens = (np.concatenate(x) for x in zip(*pieces))
    sort = np.lexsort((sub, blk_i))
    codes, lens = codes[sort], lens[sort]
    start = np.cumsum(lens) - lens
    total = int(lens.sum())
    idx = np.repeat(np.arange(len(lens)), lens)
    bits = (codes[idx] >> (lens[idx] - 1 - (np.arange(total) - start[idx]))) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    data = np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()

    def seg(marker, body):
        return bytes((0xFF, marker)) + struct.pack(">H", len(body) + 2) + body

    ids = range(1, len(blocks) + 1)
    out = [b"\xff\xd8", seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    out += [seg(0xDB, bytes([t]) + bytes(quant[t].astype(np.uint8))) for t in range(min(len(blocks), 2))]
    out.append(seg(0xC0, struct.pack(">BHHB", 8, h, w, len(blocks))
                   + b"".join(bytes((i, sh * 16 + sv, min(i - 1, 1))) for i, (sh, sv) in zip(ids, samp))))
    for (cls, t), (counts, symbols, _, _) in tabs.items():
        if t < min(len(blocks), 2):
            out.append(seg(0xC4, bytes([cls * 16 + t]) + counts + symbols))
    out.append(seg(0xDA, bytes([len(blocks)]) + b"".join(bytes((i, min(i - 1, 1) * 17)) for i in ids)
                   + b"\x00\x3f\x00"))
    return b"".join(out) + data + b"\xff\xd9"


def write_jpeg(path, img, quality: int = 95) -> None:
    """uint8 RGB ``[H, W, 3]`` or gray ``[H, W]`` -> a baseline JPEG file
    (:func:`jpeg_bytes`)."""
    Path(path).write_bytes(jpeg_bytes(img, quality))


def write_landmarks(scene_dir, cameras, images, points3D, p3d_desc, p3d_seg, seg_vrf, n_cluster: int,
                    compressed: bool, query_p3d: dict, feats: dict) -> None:
    """One scene's landmark directory: the COLMAP model (``compress_model_birch/``
    or ``model/``) with point3D_desc.npy, the cluster, VRF and query-point
    files of ``n_cluster`` clusters (cluster_mode xz, method birch), and the
    query feature cache ``feats/<name>.npy``."""
    import numpy as np

    from pram_tpu_torch.maps.colmap_io import write_compressed_model, write_model

    scene_dir = Path(scene_dir)
    tag = f"n{n_cluster}_xz_birch"
    if compressed:
        model_dir = scene_dir / "compress_model_birch"
        write_compressed_model(cameras, images, points3D, str(model_dir))
        np.save(model_dir / "point3D_desc.npy", p3d_desc)
    else:
        write_model(cameras, images, points3D, str(scene_dir / "model"), ".bin")
        np.save(scene_dir / "point3D_desc.npy", p3d_desc)
    ids = np.array(sorted(p3d_seg), np.int64)
    np.save(scene_dir / f"point3D_cluster_{tag}.npy",
            {"id": ids, "label": np.array([p3d_seg[i] for i in ids], np.int64)})
    np.save(scene_dir / f"point3D_vrf_{tag}.npy", seg_vrf)
    np.save(scene_dir / f"point3D_query_{tag}.npy", query_p3d)
    (scene_dir / "feats").mkdir(parents=True, exist_ok=True)
    for name, feat in feats.items():
        np.save(scene_dir / "feats" / (name.replace("/", "+") + ".npy"), feat)


def write_queries(data_dir, names, qvecs, tvecs, intrinsics=None, first: int = 4) -> None:
    """``imglist.txt`` and ``queries_poses.txt`` (name qw qx qy qz tx ty tz),
    and ``imglist_<first>.txt`` of the first ``first`` names; with
    ``intrinsics`` (model, w, h, params) also ``queries_with_intrinsics.txt``
    and ``queries_with_intrinsics_<first>.txt``."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    (data_dir / "imglist.txt").write_text("".join(f"{n}\n" for n in names))
    (data_dir / f"imglist_{first}.txt").write_text("".join(f"{n}\n" for n in names[:first]))
    (data_dir / "queries_poses.txt").write_text("".join(
        f"{n} " + " ".join(repr(float(v)) for v in (*q, *t)) + "\n" for n, q, t in zip(names, qvecs, tvecs)))
    if intrinsics is not None:
        model, w, h, params = intrinsics
        for fn, some in (("queries_with_intrinsics.txt", names),
                         (f"queries_with_intrinsics_{first}.txt", names[:first])):
            (data_dir / fn).write_text("".join(
                f"{n} {model} {w} {h} " + " ".join(repr(float(p)) for p in params) + "\n" for n in some))


def write_configs(root, dataset: str, scene: str, n_cluster: int, top: dict, config_dir=None,
                  image_list: str = "imglist.txt") -> Path:
    """The dataset YAML (``<config_dir>/configs/<dataset>.yaml``, listing the
    queries of ``image_list``) and the top config ``<config_dir>/config.yaml``
    (``top`` over the landmark and dataset paths under ``root``);
    ``config_dir`` defaults to ``root``. Returns the top config's path."""
    root = Path(root)
    cdir = Path(config_dir) if config_dir is not None else root
    (cdir / "configs").mkdir(parents=True, exist_ok=True)
    write_yaml(cdir / "configs" / f"{dataset}.yaml", {
        "dataset": dataset, "scenes": [scene],
        scene: {"n_cluster": n_cluster, "cluster_mode": "xz", "cluster_method": "birch",
                "training_sample_ratio": 1, "eval_sample_ratio": 1,
                "gt_pose_path": "queries_poses.txt", "query_path": "queries_with_intrinsics.txt",
                "image_path_prefix": "", "image_list": image_list},
    })
    cfg = {"dataset": [dataset], "landmark_path": str(root / "landmarks"),
           "dataset_path": str(root / "datasets"), "config_path": str(cdir / "configs"), **top}
    write_yaml(cdir / "config.yaml", cfg)
    return cdir / "config.yaml"


def seg_vrf_of(pmap, images) -> dict:
    """A packed map's ``{sid: {0: {"image_id": fid}}}`` VRF table (the first
    VRF frame of each segment), as point3D_vrf_*.npy stores it."""
    fid_of = {im.name: fid for fid, im in images.items()}
    return {sid: {0: {"image_id": fid_of[pmap.frame_names[pmap.vrf_frame_idx[slot]]]}}
            for sid, slot in enumerate(pmap.seg_vrf_slot) if slot >= 0}


def synthetic_layout(root, scene, queries, names, n_cluster: int, top: dict) -> Path:
    """A synthetic scene on disk: a compressed model whose frames hold the
    points of their packed tables (at most the scene's keypoints a frame,
    1024 for the GML slice's and 2048 for the Aachen scene, as PRAM's
    compression caps a frame's keypoints), every
    point with its track, and the queries' feature caches (valid keypoints
    only, image_size (h, w)); returns the top config."""
    import numpy as np

    from pram_tpu_torch.maps.colmap_io import ColmapImage

    m = scene.map
    row = {name: r for r, name in enumerate(m.frame_names)}
    images = {}
    for fid, im in scene.images.items():
        r = row.get(im.name)
        pids = m.point_ids[m.frame_point_idx[r][m.frame_kp_mask[r]]] if r is not None else []
        images[fid] = ColmapImage(fid, im.qvec, np.asarray(im.tvec), im.camera_id, im.name,
                                  np.zeros((0, 2)), np.asarray(pids, np.int64))
    feats, query_p3d = {}, {}
    for name, q in zip(names, queries):
        v = q["mask"]
        feats[name] = {"keypoints": q["keypoints"][v], "scores": q["scores"][v],
                       "descriptors": q["descriptors"][v], "image_size": np.array([scene.height, scene.width])}
        query_p3d[name] = m.point_ids[q["point_idx"][v]]
    root = Path(root)
    write_landmarks(root / "landmarks" / "Synthetic" / "scene", scene.cameras, images, scene.points3D,
                    scene.point_descs, dict(zip(m.point_ids.tolist(), m.point_seg.tolist())),
                    seg_vrf_of(m, scene.images), n_cluster, True, query_p3d, feats)
    write_queries(root / "datasets" / "Synthetic" / "scene", names, [q["qvec"] for q in queries],
                  [q["tvec"] for q in queries])
    return write_configs(root, "Synthetic", "scene", n_cluster, top)


def training_layout(root, scene, n_frames: int, n_cluster: int, top: dict, desc_dim: int = 256,
                    n_kpts: int = 384, n_outliers: int = 384, seed: int = 0) -> Path:
    """A scene's training inputs in the reference layout, for cli.train:
    ``n_frames`` views rendered from the synthetic scene (seeded), each of
    ``n_kpts`` visible map points and ``n_outliers`` keypoints of no point,
    as a full COLMAP model (``3D-models/``, each image's keypoints with
    their point ids), their feature caches with ``desc_dim``-d descriptors
    (a seeded unit descriptor a map point, noised a view; outliers random),
    the cluster file of ``n_cluster`` clusters and the training list;
    returns the top config."""
    import numpy as np

    from pram_tpu_torch.maps.colmap_io import ColmapImage, write_model

    rng = np.random.RandomState(seed)
    m = scene.map
    w, h = scene.width, scene.height

    def unit(a):
        return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)

    point_desc = unit(rng.randn(m.num_points, desc_dim))
    images, feats, names = {}, {}, []
    for i in range(n_frames):
        q = scene.render_query(rng, noise_px=0.3, max_kpts=n_kpts)
        v = q["mask"]
        idx = q["point_idx"][v]
        kp = np.concatenate([q["keypoints"][v], rng.rand(n_outliers, 2) * [w, h]]).astype(np.float32)
        pids = np.concatenate([m.point_ids[idx], np.full(n_outliers, -1)]).astype(np.int64)
        desc = np.concatenate([point_desc[idx] + 0.05 * rng.randn(len(idx), desc_dim),
                               rng.randn(n_outliers, desc_dim)])
        name = f"train/frame_{i:03d}.png"
        names.append(name)
        images[i + 1] = ColmapImage(i + 1, q["qvec"], q["tvec"].astype(np.float64), 1, name, kp.astype(np.float64),
                                    pids)
        feats[name] = {"keypoints": kp, "scores": rng.rand(len(kp)).astype(np.float32), "descriptors": unit(desc),
                       "image_size": np.array([h, w])}
    root = Path(root)
    scene_dir = root / "landmarks" / "Synthetic" / "scene"
    write_model(scene.cameras, images, scene.points3D, str(scene_dir / "3D-models"), ".bin")
    np.save(scene_dir / f"point3D_cluster_n{n_cluster}_xz_birch.npy",
            {"id": m.point_ids.astype(np.int64), "label": m.point_seg.astype(np.int64)})
    (scene_dir / "feats").mkdir(parents=True, exist_ok=True)
    for name, feat in feats.items():
        np.save(scene_dir / "feats" / (name.replace("/", "+") + ".npy"), feat)
    data_dir = root / "datasets" / "Synthetic" / "scene"
    data_dir.mkdir(parents=True, exist_ok=True)
    (data_dir / "imglist.txt").write_text("".join(f"{n}\n" for n in names))
    return write_configs(root, "Synthetic", "scene", n_cluster, top)


def rendered_layout(root, scene, n_cluster: int, top: dict) -> Path:
    """The rendered world's map on disk as a full COLMAP model: a 3D point a
    reference keypoint (track length 1), its descriptor and grid segment;
    returns the top config."""
    import numpy as np

    from pram_tpu_torch.maps.colmap_io import ColmapCamera, ColmapImage, ColmapPoint3D
    from pram_tpu_torch.maps.synthetic import _rotmat2qvec_np

    cameras = {1: ColmapCamera(1, "PINHOLE", scene.width, scene.height, np.array(scene.cam, float))}
    images, points, desc, seg = {}, {}, {}, {}
    for i, v in enumerate(scene.ref_views):
        images[i + 1] = ColmapImage(i + 1, _rotmat2qvec_np(v["R"]), np.asarray(v["t"]), 1,
                                    f"ref_{i:03d}.png", v["kpts"], v["point_ids"])
        for j, pid in enumerate(v["point_ids"].tolist()):
            points[pid] = ColmapPoint3D(pid, v["xyz"][j], np.array([128, 128, 128], np.uint8), 0.5,
                                        np.asarray([i + 1], np.int32), np.asarray([j], np.int64))
            desc[pid] = v["descs"][j]
            seg[pid] = int(v["seg"][j])
    root = Path(root)
    write_landmarks(root / "landmarks" / "Rendered" / "scene", cameras, images, points, desc, seg,
                    seg_vrf_of(scene.map, images), n_cluster, False, {}, {})
    return write_configs(root, "Rendered", "scene", n_cluster, top)


def rendered_path(world, n: int, jumps=(11, 22), width: int = 640, height: int = 480, focal: float = 500.0,
                  starts=(0.08, 0.78, 0.40), looks=((None, None),) * 3):
    """``n`` views of the rendered world along a smooth path (the query
    poses' corridor, ``maps/rendered.py:query_pose``) that jumps to another
    part of the corridor at the frames in ``jumps``: images ``[n, H, W, 3]``
    f32 in [0, 1], qvecs, tvecs. Segment ``k`` starts at corridor position
    ``starts[k]``; ``looks[k]`` gives the x of the back-wall point its first
    and its last view look at (None: the corridor's own), turning linearly
    between them."""
    import numpy as np

    from pram_tpu_torch.maps.synthetic import _look_at, _rotmat2qvec_np

    seg = np.searchsorted(np.asarray(jumps), np.arange(n), side="right")
    bounds = np.concatenate([[0], np.asarray(jumps), [n]])
    imgs, qvecs, tvecs = [], [], []
    for i in range(n):
        k = seg[i]
        j, length = i - bounds[k], bounds[k + 1] - bounds[k]
        a = starts[k] + 0.012 * j
        eye = np.array([-1.6 + 3.0 * a, -0.1 + 0.2 * np.sin(0.3 * i), -0.4 + 0.5 * a])
        x0, x1 = (-0.8 + 1.6 * a if x is None else x for x in looks[k])
        target = np.array([x0 + (x1 - x0) * j / max(length - 1, 1), 0.2, 6.0])
        R, t = _look_at(eye, target)
        imgs.append(world.render(R, t, (focal, focal, width / 2, height / 2), width, height))
        qvecs.append(_rotmat2qvec_np(R))
        tvecs.append(t)
    return np.stack(imgs).astype(np.float32), np.stack(qvecs), np.stack(tvecs)


# phase 22's online path: the first segment turns far left and the second
# starts far right, so the view after the first jump shares no point of the
# map with the one before it (tracking has nothing to match and the frame
# relocalizes); the second jump stays in the corridor's view
ONLINE_JUMPS = (11, 22)
ONLINE_STARTS = (0.08, 0.88, 0.40)
ONLINE_LOOKS = ((None, -4.5), (4.0, None), (None, None))


# kernels a pass of each model launches (kernel 12 runs as kernel 1's message
# pass, counted as kernel 1's)
SEGNETVIT_LAUNCHES = {"self_attention": 15, "residual_mlp": 15}
GML_LAUNCHES = {"self_attention": 9, "cross_attention": 9, "residual_mlp": 18, "sinkhorn": 1}
# a localization with projection refinement, or a tracking step (which
# computes its projection refinement whether or not it takes it): two RANSAC
# PnPs and the refinement NN, besides the matcher
PNP_LAUNCHES = {"ransac_score": 2, "gn_polish": 2, "refine_nn": 1}


def add_launches(total: dict, part: dict, times: int = 1) -> dict:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v * times
    return total


def run_cli(log_name: str, fn, argv):
    """``fn(argv)`` (a CLI's ``main``) with its printed lines logged after it;
    returns (result, lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  {log_name} | {line}")
    return out, lines


def same_tables(name: str, built, loaded, n_seg: int) -> None:
    """A packed map read back from disk against the one built in memory,
    table by table (the declared 112 clusters pad seg_vrf_slot with -1)."""
    import numpy as np

    for f in ("point_xyz", "point_desc", "point_seg", "point_ids", "point_error", "frame_R", "frame_t",
              "frame_cam", "frame_size", "frame_point_idx", "frame_kp_uv", "frame_kp_score", "frame_kp_mask",
              "vrf_frame_idx"):
        require(np.array_equal(getattr(built, f), getattr(loaded, f)), f"{name}: {f} read back differs")
    require(built.frame_names == loaded.frame_names, f"{name}: frame names read back differ")
    require(np.array_equal(loaded.seg_vrf_slot[:n_seg], built.seg_vrf_slot[:n_seg])
            and bool((loaded.seg_vrf_slot[n_seg:] == -1).all()), f"{name}: seg_vrf_slot read back differs")


def write_online_inputs(torch, np, dev, bf16, online_root: Path, loc_top: dict, n_frames: int = 32) -> dict:
    """Phase 22's online inputs under ``online_root``: the rendered world's
    map, built by SFD2 in bf16 on the card, written in the reference layout
    and read back equal, and ``n_frames`` frames along ONLINE_JUMPS' path as
    PNG with their queries files (``images/``); ``loc_top`` is the config's
    localization section. Returns the config's path, the image directory,
    the frames (f32 in [0, 1]), their poses and file names."""
    from pram_tpu_torch.engine.rendered_guard import FOCAL, HEIGHT, MAP_KPTS, SFD2_W, WIDTH
    from pram_tpu_torch.maps.loader import load_scene_map
    from pram_tpu_torch.maps.rendered import build_rendered_scene
    from pram_tpu_torch.models.convert import load_sfd2
    from pram_tpu_torch.models.sfd2 import extract, preprocess_image

    t_w = time.perf_counter()
    sfd2 = load_sfd2(SFD2_W, device=dev, dtype=bf16)

    def extract_np(images):
        kp, sc, de, mk = [], [], [], []
        for i in range(0, images.shape[0], 12):
            x = preprocess_image(torch.as_tensor(images[i:i + 12]).to(dev)).to(bf16)
            with torch.no_grad():
                f = extract(sfd2, x, max_keypoints=MAP_KPTS, conf_th=1e-4)
            k = f["keypoints"]
            kp.append(k.xy.cpu().numpy())
            sc.append(k.scores.float().cpu().numpy())
            de.append(f["descriptors"].float().cpu().numpy())
            mk.append(k.mask.cpu().numpy())
        return tuple(np.concatenate(a) for a in (kp, sc, de, mk))

    rscene = build_rendered_scene(extract_np, np.random.RandomState(0), width=WIDTH, height=HEIGHT,
                                  n_ref=12, kp_per_ref=MAP_KPTS, max_ref_points=2048)
    del sfd2
    top = {"network": "segnetvit", "use_mid_feature": True, "layers": 15,
           "localization": {**loc_top, "with_compress": False}}
    cfg = rendered_layout(online_root, rscene, 112, top)
    loaded = load_scene_map(str(online_root / "landmarks" / "Rendered" / "scene"), n_cluster=112,
                            with_compress=False, covisibility_frame=4, max_kp_per_frame=MAP_KPTS,
                            max_ref_points=2048)
    n_seg = int(rscene.map.seg_vrf_slot.shape[0])
    same_tables("online map", rscene.map, loaded, n_seg)
    for f in ("vrf_covis", "vrf_ref_point_idx"):
        require(np.array_equal(getattr(rscene.map, f), getattr(loaded, f)), f"online map: {f} read back differs")
    imgs, qvecs, tvecs = rendered_path(rscene.world, n_frames, ONLINE_JUMPS, starts=ONLINE_STARTS,
                                       looks=ONLINE_LOOKS)
    img_dir = online_root / "images"
    img_dir.mkdir()
    fnames = [f"frame_{i:03d}.png" for i in range(n_frames)]
    for name, img in zip(fnames, imgs):
        write_png(img_dir / name, uint8_image(np, img))
    write_queries(img_dir, fnames, qvecs, tvecs, ("PINHOLE", WIDTH, HEIGHT, (FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2)))
    log(f"online inputs: the rendered map ({loaded.num_points} points, {loaded.num_frames} frames) built on "
        f"the card, written and read back equal, and {n_frames} frames rendered and written as PNG in "
        f"{time.perf_counter() - t_w:.1f} s")
    return dict(cfg=cfg, img_dir=img_dir, imgs=imgs, qvecs=qvecs, tvecs=tvecs, fnames=fnames)


def run_cli_phase(torch, np, dev, bf16, scene, queries, grecall, rec_w, gml_w, reset_counts, read_counts,
                  online_root: Path) -> dict:
    """Phase 22: both serving CLIs through ``main(argv)`` on the card, on
    their inputs written to a temporary directory (the online CLI's under
    ``online_root``, which phase 32 reads again); returns each path's
    launches and figures, and under ``online_inputs`` what phase 32 needs
    (``main`` pops it)."""
    import tempfile

    from pram_tpu_torch.cli import inference as cli_inference
    from pram_tpu_torch.cli import online_localization as cli_online
    from pram_tpu_torch.engine.rendered_guard import GML_W, REC_W, SFD2_W
    from pram_tpu_torch.geometry.rotations import compute_pose_error
    from pram_tpu_torch.maps.loader import load_scene_map

    n_q = len(queries)
    names_all = set(read_counts())
    out = {}
    loc_top = {"seg_k": 1, "threshold": 8.0, "min_inliers": 32, "do_refinement": True,
               "matching_method": "gml", "refinement_method": "projection"}
    with tempfile.TemporaryDirectory(prefix="pram_cli_") as tmp:
        tmp = Path(tmp)
        # -- offline: the GML slice's scene and queries from disk
        names = [f"query_{i:03d}.png" for i in range(n_q)]
        top = {"network": "segnetvit", "feat_dim": 128, "use_mid_feature": False, "layers": 15,
               "eval_max_keypoints": 512, "localization": {**loc_top, "with_compress": True}}
        t_w = time.perf_counter()
        cfg = synthetic_layout(tmp / "offline", scene, queries, names, 112, top)
        loaded = load_scene_map(str(tmp / "offline" / "landmarks" / "Synthetic" / "scene"), n_cluster=112,
                                covisibility_frame=4, max_kp_per_frame=1024, max_ref_points=2048)
        same_tables("offline map", scene.map, loaded, scene.n_cluster)
        log(f"offline inputs written and the map read back equal in {time.perf_counter() - t_w:.2f} s: "
            f"{loaded.num_points} points, {loaded.num_frames} frames of {loaded.frame_point_idx.shape[1]} "
            f"keypoints (the covisibility and refinement sets are rebuilt from the compressed frames)")
        argv = ["--config", str(cfg), "--rec_weight_path", rec_w, "--matcher_weight_path", gml_w]
        reset_counts()
        report, lines = run_cli("inference", cli_inference.main, argv + ["--batch", str(n_q)])
        torch.cuda.synchronize()
        got = read_counts()
        want = add_launches(add_launches(add_launches({}, SEGNETVIT_LAUNCHES), GML_LAUNCHES), PNP_LAUNCHES)
        log(f"inference CLI launches: {got}")
        require(got == {k: want.get(k, 0) for k in names_all},
                f"inference CLI: launches {got}, expected {want} and no other")
        recall = report.bucket_counts[0] / max(report.n_total, 1)
        require(report.n_total == n_q, "inference CLI: not every query was evaluated")
        require(recall >= grecall - 1.0 / n_q,
                f"inference CLI: recall@5cm/5deg {recall:.4f} more than one query below the GML slice's {grecall:.4f}")
        # a second run at --batch 8: four batches, so steady_fps leaves the
        # first drain out and still counts three
        report8, lines8 = run_cli("inference --batch 8", cli_inference.main, argv + ["--batch", "8"])
        require(report8.bucket_counts[0] / max(report8.n_total, 1) >= grecall - 1.0 / n_q,
                "inference CLI (--batch 8): recall below the GML slice's")
        # the first 4 queries on the card and on the CPU, each through the CLI
        cfg4 = write_configs(tmp / "offline", "Synthetic", "scene", 112, top, config_dir=tmp / "offline_4",
                             image_list="imglist_4.txt")
        argv4 = ["--config", str(cfg4), "--rec_weight_path", rec_w, "--matcher_weight_path", gml_w, "--batch", "4"]
        card4, _ = run_cli("inference, 4 queries", cli_inference.main, argv4)
        t_cpu = time.perf_counter()
        cpu4, _ = run_cli("inference, 4 queries, --device cpu", cli_inference.main, argv4 + ["--device", "cpu"])
        log(f"inference CLI on the CPU: 4 queries in {time.perf_counter() - t_cpu:.1f} s (models and map loaded "
            f"included); failed card {card4.failed_cases} CPU {cpu4.failed_cases}")
        require(card4.failed_cases == cpu4.failed_cases, "inference CLI: success flags differ card vs CPU")
        require(card4.bucket_counts[0] == card4.n_success and cpu4.bucket_counts[0] == cpu4.n_success,
                "inference CLI: a localized query of the first 4 is outside 5 cm / 5 deg")
        stage = next(line for line in lines if line.startswith("stage times:"))
        out["inference"] = dict(
            launches=got, recall=recall, n_success=report.n_success, fps=report.fps(),
            steady_fps=report.steady_fps(), per_query_ms=1e3 * float(np.mean(report.time_results["total"])),
            stage_times=stage, batch8=dict(recall=report8.bucket_counts[0] / max(report8.n_total, 1),
                                           fps=report8.fps(), steady_fps=report8.steady_fps(),
                                           stage_times=next(l for l in lines8 if l.startswith("stage times:"))),
            card_vs_cpu=dict(failed_card=card4.failed_cases, failed_cpu=cpu4.failed_cases))
        log(f"inference CLI on card: recall@5cm/5deg {recall:.4f} ({report.n_success}/{n_q} localized; the GML "
            f"slice {grecall:.4f}), {report.fps():.1f} queries/s over the one batch of {n_q} (steady_fps "
            f"{report.steady_fps():.1f}, the same run), {stage}; --batch 8: steady_fps {report8.steady_fps():.1f} "
            f"queries/s over the last 3 of 4 batches, fps {report8.fps():.1f}, {out['inference']['batch8']['stage_times']}")

        # -- online: the rendered world's map from disk and 32 frames as PNG
        online = write_online_inputs(torch, np, dev, bf16, online_root, loc_top)
        cfg, img_dir, imgs, qvecs, tvecs, fnames = (online[k] for k in ("cfg", "img_dir", "imgs", "qvecs", "tvecs",
                                                                        "fnames"))
        n_frames = len(fnames)
        argv = ["--config", str(cfg), "--image_dir", str(img_dir), "--rec_weight_path", REC_W,
                "--feat_weight_path", SFD2_W, "--matcher_weight_path", GML_W, "--max_keypoints", "512"]
        reset_counts()
        recs, lines = run_cli("online", cli_online.main,
                              argv + ["--queries", str(img_dir / "queries_with_intrinsics.txt")])
        torch.cuda.synchronize()
        got = read_counts()
        q_err, t_err = compute_pose_error(torch.tensor(np.stack([r["qvec"] for r in recs])).double(),
                                          torch.tensor(np.stack([r["tvec"] for r in recs])).double(),
                                          torch.tensor(qvecs), torch.tensor(tvecs).double())
        modes = [r["mode"] for r in recs]
        log("online CLI frames: " + ", ".join(
            f"{r['name']} {r['mode']} {r['inliers']} {q:.3f} deg {e:.4f} m"
            for r, q, e in zip(recs, q_err.tolist(), t_err.tolist())))
        require(len(recs) == n_frames and all(r["success"] for r in recs), "online CLI: a frame failed")
        require(bool((t_err < 0.05).all() and (q_err < 5.0).all()), "online CLI: a frame outside 5 cm / 5 deg")
        require("tracked" in modes, "online CLI: no tracked frame")
        # a frame tries tracking when the previous one ended localized; the
        # fallback: tracking tried, failed, and the frame relocalized
        tried = sum(1 for i in range(1, n_frames) if recs[i - 1]["success"])
        fallback = [i for i in range(1, n_frames) if modes[i] == "relocalized" and recs[i - 1]["success"]]
        require(ONLINE_JUMPS[0] in fallback,
                f"online CLI: frame {ONLINE_JUMPS[0]} did not fall back from tracking to relocalization "
                f"(fallback frames {fallback})")
        matched = tried + modes.count("relocalized")
        want = add_launches({"fused_stem": n_frames, "nms": n_frames}, SEGNETVIT_LAUNCHES, n_frames)
        want = add_launches(add_launches(want, GML_LAUNCHES, matched), PNP_LAUNCHES, matched)
        log(f"online CLI launches: {got} ({tried} tracking steps, {modes.count('relocalized')} relocalizations, "
            f"frames {fallback} both)")
        require(got == {k: want.get(k, 0) for k in names_all},
                f"online CLI: launches {got}, expected {want} and no other")
        ms = {k: [r["ms"][k] for r in recs] for k in ("feat", "rec", "loc", "total")}
        t_cpu = time.perf_counter()
        cpu4, _ = run_cli("online, 4 frames, --device cpu", cli_online.main,
                          argv + ["--queries", str(img_dir / "queries_with_intrinsics_4.txt"), "--device", "cpu"])
        q4, e4 = compute_pose_error(torch.tensor(np.stack([r["qvec"] for r in cpu4])).double(),
                                    torch.tensor(np.stack([r["tvec"] for r in cpu4])).double(),
                                    torch.tensor(qvecs[:4]), torch.tensor(tvecs[:4]).double())
        log(f"online CLI on the CPU: 4 frames in {time.perf_counter() - t_cpu:.1f} s (models and map loaded "
            f"included); success card {[r['success'] for r in recs[:4]]} CPU {[r['success'] for r in cpu4]}, "
            f"modes card {modes[:4]} CPU {[r['mode'] for r in cpu4]}")
        require([r["success"] for r in cpu4] == [r["success"] for r in recs[:4]],
                "online CLI: success flags differ card vs CPU")
        require(bool((e4 < 0.05).all() and (q4 < 5.0).all()), "online CLI (CPU): a frame outside 5 cm / 5 deg")
        out["online"] = dict(
            launches=got, frames=n_frames, tracked=modes.count("tracked"),
            relocalized=modes.count("relocalized"), tracking_steps=tried, fallback_frames=fallback,
            max_err=[float(q_err.max()), float(t_err.max())],
            mean_ms={k: float(np.mean(v)) for k, v in ms.items()},
            mean_ms_after_first={k: float(np.mean(v[1:])) for k, v in ms.items()},
            summary=lines[-1])
        log(f"online CLI on card: {n_frames} frames, {modes.count('tracked')} tracked, "
            f"{modes.count('relocalized')} relocalized, max error {float(q_err.max()):.4f} deg "
            f"{float(t_err.max()):.5f} m; {lines[-1]}; after the first frame: "
            + ", ".join(f"{k}={v:.2f}" for k, v in out["online"]["mean_ms_after_first"].items()) + " ms")

        # the first 4 frames at --max_keypoints 1000, off every kernel's
        # tile (SegNetViT's 1000 tokens, GML's 1000 + 1024, kernel 7's 1000
        # queries): padded inside the wrappers (phase 27 reports it); GML's
        # 1001 x 1025 plan holds more rows than a 16-block cluster, so it
        # takes kernel 6's wide instance
        reset_counts()
        recs1k, lines1k = run_cli("online, 4 frames, --max_keypoints 1000", cli_online.main,
                                  argv[:-1] + ["1000", "--queries", str(img_dir / "queries_with_intrinsics_4.txt")])
        torch.cuda.synchronize()
        got = read_counts()
        q1k, e1k = compute_pose_error(torch.tensor(np.stack([r["qvec"] for r in recs1k])).double(),
                                      torch.tensor(np.stack([r["tvec"] for r in recs1k])).double(),
                                      torch.tensor(qvecs[:4]), torch.tensor(tvecs[:4]).double())
        modes1k = [r["mode"] for r in recs1k]
        tried = sum(1 for i in range(1, 4) if recs1k[i - 1]["success"])
        matched = tried + modes1k.count("relocalized")
        want = add_launches({"fused_stem": 4, "nms": 4}, SEGNETVIT_LAUNCHES, 4)
        want = add_launches(want, {**GML_LAUNCHES, "sinkhorn": 0, "sinkhorn_wide": 1}, matched)
        want = add_launches(want, PNP_LAUNCHES, matched)
        log(f"online CLI at --max_keypoints 1000: modes {modes1k}, errors {[round(v, 4) for v in q1k.tolist()]} deg "
            f"{[round(v, 5) for v in e1k.tolist()]} m; launches {got}")
        require(len(recs1k) == 4 and all(r["success"] for r in recs1k), "online CLI at 1000 keypoints: a frame failed")
        require(bool((e1k < 0.05).all() and (q1k < 5.0).all()), "online CLI at 1000 keypoints: a frame outside 5 cm / 5 deg")
        require(got == {k: want.get(k, 0) for k in names_all},
                f"online CLI at 1000 keypoints: launches {got}, expected {want} and no other")
        out["online_1000"] = dict(launches=got, modes=modes1k, max_err=[float(q1k.max()), float(e1k.max())],
                                  summary=lines1k[-1])
        out["online_inputs"] = dict(cfg=cfg, argv=argv, imgs=imgs, qvecs=qvecs, tvecs=tvecs, fnames=fnames,
                                    img_dir=img_dir)
    return out


# phase 23: GML training through its entry point. A step launches kernels
# 1 and 5 once a layer forward and 13 and 14 once a layer backward, 2 and 15
# twice a layer, 6 once (the forward of the differentiable Sinkhorn)
GML_TRAIN_STEP_LAUNCHES = {"self_attention": 9, "cross_attention": 9, "residual_mlp": 18, "sinkhorn": 1,
                           "self_attention_bwd": 9, "cross_attention_bwd": 9, "residual_mlp_bwd": 18}
GML_TRAIN_STEPS, GML_TRAIN_BATCH = 600, 8
GML_RECALL_MIN = 31 / 32  # recall@5cm/5deg of the card-trained weights (the JAX script's chip record: 1.0)
# SinkhornPlan on the card against plain autograd: the plan as the kernel's
# (SINKHORN_ATOL, SINKHORN_DUSTBIN_RTOL); d sim within 1e-4 of its scale (the
# backward recomputes the plain iterations, at the kernel plan's cotangent);
# d dustbin is ~0 (the dustbin row's and column's scalings absorb a shift of
# it), so within 1e-4 of d sim's scale
SINKHORN_GRAD_TOL = 1e-4
# step-0 gradient A/B of the 9-layer GML, bf16 over f32 masters. In bf16
# neither the kernel path nor the plain path is within GRAD_AB_TOL of f32
# on every tensor (the attention logits round to bf16 in every layer, and
# the gradient of the dustbin score is f32 noise), and the two differ from
# each other as much (per tensor up to ~10%). So the kernels are held to
# GRAD_AB_TOL where the bf16 forward is shared: the kernel forward once,
# its gradients by the backward kernels 13-15 against their plain versions,
# every tensor whose f32 gradient is above GRAD_ZERO of the largest. A
# planted fault, kernel 14's dqk scaled by 1 + GRAD_FAULT, must fail that
# gate. The whole kernel path (forward and backward) is held to the plain
# bf16 path's own distance from f32: its global relative L2, and that of
# kernel vs plain, within GRAD_L2_RATIO of the plain path's, and each
# tensor within max(GRAD_AB_TOL, GRAD_PLAIN_RATIO x the plain path's error)
# (two card runs read L2 ratios 0.98-1.04, kernel vs plain 1.02-1.03, and
# per tensor up to 1.74x the plain path's error: PERF.md)
GRAD_L2_RATIO = 1.25
GRAD_PLAIN_RATIO = 2.0
GRAD_FAULT = 0.05
GRAD_ZERO = 1e-6
# phase 24: cli.train at configs/config_train_7scenes_sfd2.yaml's operating
# point (SegNetViT 15 layers, batch 32, 512 tokens), 2 epochs of 5 its
TRAIN_CONFIG = "configs/config_train_7scenes_sfd2.yaml"
TRAIN_CLI_EPOCHS, TRAIN_CLI_ITS = 2, 5


def grad_errors(ga: dict, gb: dict) -> tuple:
    """Per tensor max |a - b| / max |b|, and the global relative L2."""
    rel = {k: ((ga[k] - gb[k]).abs().max() / gb[k].abs().max().clamp(min=1e-30)).item() for k in gb}
    l2 = (sum(((ga[k] - gb[k]) ** 2).sum() for k in gb) / sum((gb[k] ** 2).sum() for k in gb)).sqrt().item()
    return rel, l2


def run_gml_train_phase(torch, np, dev, bf16, reset_counts, read_counts, out_path) -> dict:
    """Phase 23: ``cli.train_synthetic_gml.main`` on the card at full width
    (9 layers, d 256, 8 x (512 + 1024) tokens, 600 steps). Before the first
    step (its ``pool`` mark): the step-0 gradient A/B on the pool's first
    batch and SinkhornPlan against plain autograd on that batch's similarity;
    the loop's launches counted apart from the validation's; after the loop
    (its ``train`` mark), a step's stages by CUDA events and its kernels by
    torch.profiler on a copy of the trained model, and kernel 14 on the
    inputs the path gave it. Returns the phase's figures."""
    from pram_tpu_torch.cli import train_synthetic_gml as cli_gml
    from pram_tpu_torch.models import gml as gml_mod
    from pram_tpu_torch.ops import attention_bwd, mlp_bwd, sinkhorn
    from pram_tpu_torch.train.losses import matching_nll_loss
    from pram_tpu_torch.train.trainer import cast_forward

    out = {}
    names_all = set(read_counts())
    seen = {}
    attention_bwd_k14 = attention_bwd.cross_attention_bwd

    def swap(module, name, fn):
        """Set ``module.name`` to ``fn``; returns the undo."""
        old = getattr(module, name)
        setattr(module, name, fn)
        return lambda: setattr(module, name, old)

    def recorded(name, fn):
        """``fn``, keeping its first call's arguments in ``seen[name]``."""

        def wrapped(*args, **kw):
            seen.setdefault(name, (args, kw))
            return fn(*args, **kw)

        return wrapped

    def gradients(model, batch, kernels, dtype, swaps=()):
        """The loss and the f32 master gradients of one step, with each
        ``(module, name, fn)`` of ``swaps`` in place meanwhile."""
        d0, d1, nk0, nk1, m0, m1, gt = batch
        undo = [swap(*s) for s in swaps]
        try:
            model.use_kernels = kernels
            model.zero_grad(set_to_none=True)
            if dtype is not None:
                d0, d1 = d0.to(dtype), d1.to(dtype)
            plan = cast_forward(model, dtype, d0, d1, nk0, nk1, m0, m1)["plan"]
            loss = matching_nll_loss(plan, gt, m1)
            loss.backward()
            grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        finally:
            for u in undo:
                u()
            model.use_kernels = True
            model.zero_grad(set_to_none=True)
        return loss.item(), grads

    def at_pool(model, pool):
        batch = pool[0]
        loss_k, g_k = gradients(model, batch, True, bf16, swaps=[
            (gml_mod, "sinkhorn", recorded("sinkhorn", sinkhorn.sinkhorn)),
            (attention_bwd, "cross_attention_bwd", recorded("cross_attention_bwd", attention_bwd_k14))])
        loss_p, g_p = gradients(model, batch, False, bf16)
        loss_f, g_f = gradients(model, batch, False, None)
        top = max(g.abs().max().item() for g in g_f.values())
        live = [k for k in g_f if g_f[k].abs().max().item() > GRAD_ZERO * top]

        # the backward kernels against their plain versions on the kernel
        # forward, and the planted fault in kernel 14's dqk
        plain_bwd = [(attention_bwd, "self_attention_bwd", attention_bwd.self_attention_bwd_plain),
                     (attention_bwd, "cross_attention_bwd", attention_bwd.cross_attention_bwd_plain),
                     (mlp_bwd, "residual_mlp_bwd", mlp_bwd.residual_mlp_bwd_plain)]
        _, g_b = gradients(model, batch, True, bf16, swaps=plain_bwd)

        def faulty(*a, **k):
            got = attention_bwd_k14(*a, **k)
            return (got[0] * (1.0 + GRAD_FAULT), *got[1:])

        _, g_x = gradients(model, batch, True, bf16, swaps=[(attention_bwd, "cross_attention_bwd", faulty)])
        rel_b, l2_b = grad_errors(g_k, g_b)
        rel_x, l2_x = grad_errors(g_x, g_b)
        over_b = {k: rel_b[k] for k in live if rel_b[k] > GRAD_AB_TOL}
        over_x = sorted(((rel_x[k], k) for k in live if rel_x[k] > GRAD_AB_TOL), reverse=True)
        bwd = dict(l2=l2_b, max=max(rel_b[k] for k in live), median=sorted(rel_b[k] for k in live)[len(live) // 2],
                   worst=[[k, round(rel_b[k], 5)] for k in sorted(live, key=lambda k: -rel_b[k])[:4]],
                   fault=dict(scale=1.0 + GRAD_FAULT, l2=l2_x, max=max(rel_x[k] for k in live),
                              tensors_over=len(over_x), worst=[[k, round(v, 5)] for v, k in over_x[:4]]))
        log(f"gml_train step-0 backward A/B (the kernel forward; kernels 13-15 vs their plain versions, tol "
            f"{GRAD_AB_TOL} a tensor): " + json.dumps(bwd))

        ab = {}
        for a, b, ga, gb in (("kernel", "plain", g_k, g_p), ("kernel", "f32", g_k, g_f), ("plain", "f32", g_p, g_f)):
            rel, l2 = grad_errors(ga, gb)
            worst = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
            ab[f"{a} vs {b}"] = dict(l2=l2, max=worst[0][1], median=sorted(rel.values())[len(rel) // 2],
                                     worst=[[k, round(v, 5)] for k, v in worst], per_tensor=rel)
        rel_k, rel_p = ab["kernel vs f32"]["per_tensor"], ab["plain vs f32"]["per_tensor"]
        over = {k: (rel_k[k], rel_p[k]) for k in live if rel_k[k] > max(GRAD_AB_TOL, GRAD_PLAIN_RATIO * rel_p[k])}
        log(f"gml_train step-0 gradient A/B (bf16 over f32 masters, {len(g_f)} tensors, {len(live)} with a "
            f"gradient above {GRAD_ZERO} of the largest; losses kernel {loss_k:.6f} plain {loss_p:.6f} f32 "
            f"{loss_f:.6f}): " + json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "per_tensor"}
                                             for k, v in ab.items()}))
        log("gml_train per-tensor errors against f32 (kernel / plain bf16): " + json.dumps(
            {k: [round(rel_k[k], 5), round(rel_p[k], 5)] for k in g_f}))
        require(not over_b, f"gml_train: backward kernels' gradients beyond {GRAD_AB_TOL} of the plain "
                            f"backward's: {over_b}")
        require(bool(over_x), f"gml_train: the gate passed kernel 14 with its dqk scaled by {1.0 + GRAD_FAULT}")
        plain_l2 = ab["plain vs f32"]["l2"]
        require(ab["kernel vs f32"]["l2"] <= GRAD_L2_RATIO * plain_l2 and
                ab["kernel vs plain"]["l2"] <= GRAD_L2_RATIO * plain_l2,
                f"gml_train: the kernel path's gradients are further from f32 or from the plain bf16 path than "
                f"{GRAD_L2_RATIO} x the plain bf16 path's distance from f32")
        require(not over, f"gml_train: tensors beyond max({GRAD_AB_TOL}, {GRAD_PLAIN_RATIO} x the plain path's "
                          f"error) against f32: {over}")
        out["grad_ab"] = {k: {kk: vv for kk, vv in v.items() if kk != "per_tensor"} for k, v in ab.items()}
        out["grad_ab"]["backward kernels vs plain"] = bwd

        # SinkhornPlan (kernel 6 forward, plain iterations differentiated)
        # against plain autograd on the batch's similarity and loss
        (sim, dustbin, iters, m0, m1), _ = seen["sinkhorn"]
        sim, dustbin, gt = sim.detach(), dustbin.detach().float(), batch[6]

        def plan_grads(fn):
            s = sim.clone().requires_grad_()
            d = dustbin.clone().requires_grad_()
            plan = fn(s, d, iters, m0, m1)
            matching_nll_loss(plan, gt, m1).backward()
            return plan.detach(), s.grad, d.grad

        plan, ds, dd = plan_grads(sinkhorn.sinkhorn)
        ref, rs, rd = plan_grads(sinkhorn.sinkhorn_matching)
        n, m = sim.shape[1:]
        real = (plan[:, :n, :m] - ref[:, :n, :m]).abs().max().item()
        dust = max(((a - r).abs() / r.abs().clamp(min=1e-6)).max().item()
                   for a, r in ((plan[:, n, :], ref[:, n, :]), (plan[:, :, m], ref[:, :, m])))
        dsim = ((ds - rs).abs().max() / rs.abs().max()).item()
        dbin = (dd - rd).abs().item() / rs.abs().max().item()
        log(f"gml_train SinkhornPlan vs plain autograd ({tuple(sim.shape)}): plan real block {real:.3e} (tol "
            f"{SINKHORN_ATOL}), dustbin rel {dust:.3e} (tol {SINKHORN_DUSTBIN_RTOL}); d sim {dsim:.3e} of its "
            f"scale, d dustbin {dd.item():.3e} vs {rd.item():.3e}: {dbin:.3e} of d sim's scale (tol "
            f"{SINKHORN_GRAD_TOL})")
        require(real <= SINKHORN_ATOL and dust <= SINKHORN_DUSTBIN_RTOL, "gml_train: SinkhornPlan's plan disagrees")
        require(dsim <= SINKHORN_GRAD_TOL and dbin <= SINKHORN_GRAD_TOL,
                "gml_train: SinkhornPlan's gradients disagree with plain autograd")
        g_plan = torch.randn(plan.shape, generator=torch.Generator().manual_seed(4)).to(dev)
        s = sim.clone().requires_grad_()
        d = dustbin.clone().requires_grad_()
        p_k = sinkhorn.sinkhorn(s, d, iters, m0, m1)
        out["sinkhorn"] = dict(
            plan_err=real, dustbin_rel=dust, dsim_rel=dsim, dbin_rel=dbin,
            forward_ms=cuda_ms(torch, lambda: sinkhorn.sinkhorn(sim, dustbin, iters, m0, m1)),
            recompute_backward_ms=cuda_ms(torch, lambda: torch.autograd.grad(p_k, (s, d), g_plan,
                                                                              retain_graph=True), iters=10))
        out["k14_args"] = seen["cross_attention_bwd"]
        reset_counts()

    def at_train(model):
        out["breakdown"] = gml_step_breakdown(torch, out.pop("pool"), model)
        args, kw = out.pop("k14_args")
        got = attention_bwd.cross_attention_bwd(*args, **kw)
        err = max(check_scaled(f"cross_attention_bwd (gml_train) {n}", a, r, BWD_TOL)
                  for n, a, r in zip(("dqk", "dv"), got, attention_bwd.cross_attention_bwd_plain(*args, **kw)))
        qk, scale, heads, n0 = args[0], args[5], args[6], args[7]
        b, tok, hd = qk.shape[0], qk.shape[1], qk.shape[2] // heads
        bnd, by = bound_ms(b * tok * (3 * 256 * 2 + 2 * 256 * 2 + 2 * 4), 14.0 * b * heads * n0 * (tok - n0) * hd,
                           BF16_TENSOR_FLOPS)
        out["k14"] = dict(shape=[b, n0, tok - n0], max_abs_err=err, bound_ms=bnd, bound_by=by,
                          ms=cuda_ms(torch, lambda: attention_bwd.cross_attention_bwd(*args, **kw)),
                          plain_ms=cuda_ms(torch, lambda: attention_bwd.cross_attention_bwd_plain(*args, **kw),
                                           iters=3))

    def mark(stage, **state):
        if stage == "pool":
            at_pool(state["model"], state["pool"])
            out["pool"] = state["pool"]
        elif stage == "train":
            out["launches"] = read_counts()
            at_train(state["model"])
            reset_counts()
        elif stage == "validate":
            out["validate_launches"] = read_counts()

    t_main = time.perf_counter()
    res = cli_gml.main(["--steps", str(GML_TRAIN_STEPS), "--batch", str(GML_TRAIN_BATCH), "--out", str(out_path)],
                       mark=mark)
    out["main_s"] = time.perf_counter() - t_main
    want = {k: GML_TRAIN_STEPS * GML_TRAIN_STEP_LAUNCHES.get(k, 0) for k in names_all}
    log(f"gml_train launches over {GML_TRAIN_STEPS} steps: {out['launches']}")
    require(out["launches"] == want, f"gml_train: launches {out['launches']}, expected {want}")
    val_want = add_launches(add_launches({}, GML_LAUNCHES), PNP_LAUNCHES)
    require(out["validate_launches"] == {k: val_want.get(k, 0) for k in names_all},
            f"gml_train validation: launches {out['validate_launches']}, expected {val_want}")
    losses = np.asarray(res["losses"])
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    out.update(losses_first50=first, losses_last50=last, steps_per_s=res["steps_per_s"],
               ms_per_step=1e3 / res["steps_per_s"], validation=res["validation"])
    log(f"gml_train: {res['steps_per_s']:.3f} steps/s, {1e3 / res['steps_per_s']:.2f} ms a step (host clock over "
        f"the {GML_TRAIN_STEPS} steps, synchronized at the ends and at every 50th step's log), loss mean "
        f"{first:.4f} over the first 50 steps, {last:.4f} over the last 50; validation {json.dumps(res['validation'])}")
    require(bool(np.isfinite(losses).all()), "gml_train: non-finite loss")
    require(last < first, "gml_train: the loss did not fall")
    require(res["validation"]["recall_5cm5deg_gml"] >= GML_RECALL_MIN,
            f"gml_train: recall@5cm/5deg {res['validation']['recall_5cm5deg_gml']} below {GML_RECALL_MIN}")
    return out


def gml_step_breakdown(torch, pool, model) -> dict:
    """Where a GML training step's time goes, on a copy of ``model`` with
    its own optimizer: the stages by CUDA events (median of 3 runs of 10
    steps) and each kernel's device ms a step by torch.profiler (3 steps)."""
    from pram_tpu_torch.train.matcher import make_matcher_train_step

    twin = copy.deepcopy(model)
    step = make_matcher_train_step(twin, 2e-4, torch.bfloat16)
    for b in pool[:2]:
        step(*b)
    runs = []
    for _ in range(3):
        events = []

        def mark(stage):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[-1].append((stage, e))

        t_s = time.perf_counter()
        for i in range(10):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append([("start", e)])
            step(*pool[i % len(pool)], mark=mark)
        torch.cuda.synchronize()
        stages = {}
        for ev in events:
            for (_, a), (stage, b) in zip(ev[:-1], ev[1:]):
                stages[stage] = stages.get(stage, 0.0) + a.elapsed_time(b) / 10
        runs.append(((time.perf_counter() - t_s) / 10 * 1e3, stages))
    runs.sort(key=lambda r: r[0])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            step(*pool[i])
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = kernel_name(e.key)
            by_kernel[name] = by_kernel.get(name, 0.0) + e.device_time_total / 3 / 1e3
    return dict(ms_per_step=runs[1][0], stages=runs[1][1], runs_ms=[r[0] for r in runs],
                device_ms_per_step=sum(by_kernel.values()),
                by_kernel=dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])))


def run_train_cli_phase(torch, np, scene, reset_counts, read_counts, root) -> dict:
    """Phase 24: ``cli.train.main`` on the card at the 7-Scenes training
    config's operating point (SegNetViT 15 layers, batch 32, 512 tokens,
    bf16 over f32 masters), cut to 2 epochs of 5 its, on 48 views of the GML
    slice's scene written by :func:`training_layout` (112 declared clusters:
    the config's nc113; 256-d descriptors in the caches); then a resume from
    the first epoch's checkpoint. Launches counted (kernels 1, 2, 13 and 15
    once a layer a step, no other); checkpoints and the best copy written;
    the losses finite. Returns the phase's figures."""
    import tempfile

    from pram_tpu_torch.cli import train as cli_train
    from pram_tpu_torch.core.config import load_yaml

    names_all = set(read_counts())
    per_step = {"self_attention": 15, "residual_mlp": 15, "self_attention_bwd": 15, "residual_mlp_bwd": 15}
    out = {}
    with tempfile.TemporaryDirectory(prefix="pram_train_") as tmp:
        tmp = Path(tmp)
        top = load_yaml(str(root / TRAIN_CONFIG))
        for k in ("dataset", "landmark_path", "dataset_path", "config_path"):
            top.pop(k)
        top.update(epochs=TRAIN_CLI_EPOCHS, its_per_epoch=TRAIN_CLI_ITS, save_path=str(tmp / "exp"))
        t_w = time.perf_counter()
        cfg = training_layout(tmp, scene, 48, 112, top)
        log(f"train_cli inputs: 48 views (384 map points and 384 outliers each, 256-d descriptors), a COLMAP "
            f"model and the training list written in {time.perf_counter() - t_w:.2f} s")
        for name, argv, steps in (
            ("train", ["--config", str(cfg), "--save_dir", str(tmp / "a")], TRAIN_CLI_EPOCHS * TRAIN_CLI_ITS),
            ("train, resumed", None, TRAIN_CLI_ITS),
        ):
            if argv is None:  # resume from the first epoch's checkpoint, from a config that names it
                resumed = write_configs(tmp, "Synthetic", "scene", 112,
                                        {**top, "resume_path": str(tmp / "a" / "epoch_0001.pt")},
                                        config_dir=tmp / "resume")
                argv = ["--config", str(resumed), "--save_dir", str(tmp / "b")]
            reset_counts()
            t_r = time.perf_counter()
            trainer, lines = run_cli(name, cli_train.main, argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t_r
            got = read_counts()
            want = {k: steps * per_step.get(k, 0) for k in names_all}
            log(f"{name} CLI launches over {steps} steps: {got}")
            require(got == want, f"{name} CLI: launches {got}, expected {want}")
            losses = [float(line.split(" loss ")[1].split()[0]) for line in lines if line.startswith("Epoch [")]
            require(len(losses) == steps // TRAIN_CLI_ITS and bool(np.isfinite(losses).all()),
                    f"{name} CLI: epoch losses {losses}")
            require(trainer.state.iteration == TRAIN_CLI_EPOCHS * TRAIN_CLI_ITS,
                    f"{name} CLI: ends at iteration {trainer.state.iteration}")
            out[name] = dict(launches=got, steps=steps, seconds=seconds, epoch_losses=losses,
                             files=sorted(p.name for p in Path(argv[-1]).iterdir()))
        require(out["train"]["files"] == ["best.pt", "epoch_0001.pt", "epoch_0002.pt"],
                f"train CLI: checkpoints {out['train']['files']}")
        require("epoch_0002.pt" in out["train, resumed"]["files"], "train CLI (resumed): no checkpoint of epoch 2")
    return out


# ---- phases 25-27: the Aachen operating point (scripts/bench_aachen.py) and
# token counts off the kernels' tiles

AACHEN_W, AACHEN_H, AACHEN_KPTS, AACHEN_CLASSES = 1024, 768, 4096, 513
AACHEN_CAM = (500.0, 500.0, AACHEN_W / 2, AACHEN_H / 2)  # scripts/bench_aachen.py:175-186
FRONT_BATCH = 8  # scripts/bench_aachen.py:146
# the Aachen config's seg_k 10 over a batch of 8: the GML problems of one
# cli.inference batch
WIDE_PROBLEMS = 80
# queries of phase 26's Aachen cli.inference run on the card and with
# --device cpu, whose success flags must be equal
AACHEN_CLI_CPU_QUERIES = 4
# kernel 6's wide instance against its plain version entry by entry on the
# real block: |kernel - plain| <= WIDE_RTOL |plain| + WIDE_ATOL. SINKHORN_ATOL
# (1e-4) is above most entries of a 4097 x 2049 plan (a row's mass of 1
# over 2049 columns); the plain Sinkhorn in bf16, the control, must fail
# this bound (its entries carry bf16's 2^-9 relative rounding)
WIDE_RTOL, WIDE_ATOL = 1e-3, 1e-9
# int8 against float extraction at 4096 keypoints (all of them): the kernel
# path's spread of descriptor cosines against the plain path's on the same
# views, the share below INT8_FLOAT_COS within 0.02 and the mean within
# 1e-3 (the kernels may not widen the method's own gap)
INT8_SPREAD_TOL = (0.02, 1e-3)


def aachen_views(np, n: int, seed: int):
    """``n`` views of the rendered world (``make_world(RandomState(0))``) at
    ``query_pose(RandomState(seed))``, 1024 x 768, focal 500 and the
    principal point at the centre, as scripts/bench_aachen.py:175-186
    renders its calibration views: ``[n, 768, 1024, 3]`` f32 in [0, 1], and
    the ``n`` poses ``(R, t)``."""
    from pram_tpu_torch.maps.rendered import make_world, query_pose

    world = make_world(np.random.RandomState(0))
    rng = np.random.RandomState(seed)
    poses = [query_pose(rng) for _ in range(n)]
    imgs = np.stack([world.render(R, t, AACHEN_CAM, AACHEN_W, AACHEN_H) for R, t in poses]).astype(np.float32)
    return imgs, poses


def gt_logits(np, world, kpts, mask, poses, n_class: int, cam=AACHEN_CAM):
    """Logits ``[B, N, n_class]`` that route rendered views (taken with
    ``cam``) by the ground truth, as phase 11 routes its queries: +10 at the
    class of the world's segment each keypoint lies on (0 where it lies on
    none), -10 elsewhere."""
    b, n = mask.shape
    logits = np.full((b, n, n_class), -10.0, np.float32)
    for i, (R, t) in enumerate(poses):
        _, plane, lu, lv, ok = world.lift(kpts[i].astype(np.float64), R, t, cam)
        cls = np.where(ok & mask[i], world.seg_class(plane, lu, lv) + 1, 0)
        logits[i, np.arange(n), cls] = 10.0
    return logits


@contextlib.contextmanager
def recording_first(patches):
    """Each ``(module, name)`` wrapped to keep its first call's ``(args,
    kwargs)`` in the yielded dict, by name; restored on exit."""
    seen, saved = {}, []
    for module, name in patches:
        real = getattr(module, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            seen.setdefault(_name, (a, kw))
            return _real(*a, **kw)

        saved.append((module, name, real))
        setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        for module, name, real in saved:
            setattr(module, name, real)


def at_shape(torch, fn, plain, err, shape, bound, plain_iters: int = 2) -> dict:
    """A kernel's figures at a path's shape: its time and its plain
    version's by CUDA events, its bound ``(ms, by)``, the checked error."""
    bnd, by = bound
    return dict(shape=shape, max_abs_err=err, ms=cuda_ms(torch, fn, iters=10),
                plain_ms=cuda_ms(torch, plain, iters=plain_iters, warmup=1), bound_ms=bnd, bound_by=by)


def self_attention_cost(b: int, sides, heads: int = 4, hd: int = 64):
    """Bytes and bf16 operations of kernel 1 on ``b`` frames of ``sides``
    (the projection and the attention of each side), as phase 6 counts them."""
    tok = b * sum(sides)
    n_bytes = tok * 256 * 2 * 2 + 768 * 256 * 2 + 768 * 4 + 2 * tok * 64 * 4 + tok * 4
    return n_bytes, 2 * tok * 256 * 768 + 2 * 2 * b * heads * hd * sum(s * s for s in sides)


def cross_attention_cost(b: int, n0: int, n1: int, heads: int = 4, hd: int = 64):
    tok = b * (n0 + n1)
    n_bytes = 2 * tok * 256 * 2 + 2 * 256 * 256 * 2 + 2 * 256 * 4 + tok * 4
    return n_bytes, 2 * tok * 256 * 512 + 3 * 2 * b * heads * hd * n0 * n1


def sinkhorn_cost(b: int, n: int, m: int, iters: int):
    """Bytes (the similarity read once, the plan written once, the
    marginals) and f32 operations (softmax ~4 an entry, an iteration 4, the
    plan 2) of kernel 6, as phase 6 counts them."""
    plan = b * (n + 1) * (m + 1)
    return b * n * m * 4 + plan * 4 + b * (n + m + 2) * 4, plan * (4 + 4 * iters + 2)


def check_plan(name: str, plan, ref, n: int, m: int) -> float:
    """Kernel 6's plan against its plain version: the real block within
    SINKHORN_ATOL, the dustbin row and column within SINKHORN_DUSTBIN_RTOL;
    returns the real block's max abs error."""
    err = (plan[:, :n, :m] - ref[:, :n, :m]).abs().max().item()
    rel = max(((a - r).abs() / r.abs().clamp(min=1e-6)).max().item()
              for a, r in ((plan[:, n], ref[:, n]), (plan[:, :, m], ref[:, :, m])))
    log(f"{name}: real block max abs err {err:.3e} (tol {SINKHORN_ATOL}), dustbin max relative err "
        f"{rel:.3e} (tol {SINKHORN_DUSTBIN_RTOL})")
    require(err <= SINKHORN_ATOL and rel <= SINKHORN_DUSTBIN_RTOL, f"{name}: kernel disagrees with its plain version")
    return err


def wide_excess(plan, ref, n: int, m: int) -> tuple:
    """The real block of a plan against its plain version: the largest
    ``|plan - ref| / (WIDE_RTOL |ref| + WIDE_ATOL)`` (<= 1 is within the
    bound), the largest relative error on entries above 1e-6, and the
    largest error relative to the row's largest entry (rows with mass)."""
    d = (plan[:, :n, :m] - ref[:, :n, :m]).abs()
    r = ref[:, :n, :m].abs()
    excess = (d / (WIDE_RTOL * r + WIDE_ATOL)).max().item()
    big = r > 1e-6
    rel = (d[big] / r[big]).max().item() if bool(big.any()) else 0.0
    row_max = ref[:, :n].amax(-1)
    has = row_max > 0
    row_rel = (d.amax(-1)[has] / row_max[has]).max().item() if bool(has.any()) else 0.0
    return excess, rel, row_rel


def check_wide_plan(name: str, plan, ref, controls: dict, n: int, m: int) -> dict:
    """Kernel 6's wide instance against its plain version: check_plan's
    bounds, and the real block entry by entry within WIDE_RTOL / WIDE_ATOL;
    each control (a plan computed otherwise) is read against the same
    bound, and the bf16 one must fail it."""
    err = check_plan(name, plan, ref, n, m)
    excess, rel, row_rel = wide_excess(plan, ref, n, m)
    out = dict(max_abs_err=err, excess=excess, max_rel_err=rel, max_row_rel_err=row_rel, controls={})
    for what, ctl in controls.items():
        c_excess, c_rel, c_row = wide_excess(ctl, ref, n, m)
        out["controls"][what] = dict(excess=c_excess, max_rel_err=c_rel, max_row_rel_err=c_row)
    log(f"{name}: real block entry by entry {excess:.3e} of the bound |d| <= {WIDE_RTOL} |ref| + {WIDE_ATOL} "
        f"(max relative err {rel:.3e} on entries above 1e-6, {row_rel:.3e} of the row's largest entry); controls "
        f"{json.dumps(out['controls'])}")
    require(excess <= 1.0, f"{name}: kernel disagrees with its plain version entry by entry")
    require(out["controls"]["plain in bf16"]["excess"] > 1.0, f"{name}: the bf16 control passes the bound")
    return out


def common_cosines(fa: dict, fb: dict):
    """The descriptor cosines of two extract outputs on the keypoints both
    found (the pairs extraction_agreement averages), as one numpy array."""
    import numpy as np

    out = []
    for i in range(fa["keypoints"].mask.shape[0]):
        sets = []
        for f in (fa, fb):
            m = f["keypoints"].mask[i].cpu().numpy()
            k = f["keypoints"].xy[i].cpu().numpy().astype(np.int64)[m]
            sets.append(({tuple(p): j for j, p in enumerate(k.tolist())}, f["descriptors"][i].float().cpu().numpy()[m]))
        (ia, da), (ib, db) = sets
        out.extend(float((da[ia[p]] * db[ib[p]]).sum()) for p in ia.keys() & ib.keys())
    return np.asarray(out)


def run_aachen_front_phase(torch, np, dev, bf16, a_scene, r_scene, a_cfg, ada_w, ada_fn, reset_counts,
                           read_counts) -> dict:
    """Phase 25, path A: scripts/bench_aachen.py:242-280's ``front`` and
    localization through the port's entry points, int8 (the bench's
    default) and float; returns each run's launches and figures and the
    kernels' figures at this path's shapes. ``r_scene``: the image slice's
    rendered map (phase 8), of the world the views are rendered from, which
    the card vs CPU check localizes 2 views against."""
    from pram_tpu_torch.engine.localizer import Localizer
    from pram_tpu_torch.engine.matching import make_adagml_match_fn
    from pram_tpu_torch.engine.rendered_guard import SFD2_W, extraction_agreement
    from pram_tpu_torch.geometry.camera import Camera
    from pram_tpu_torch.geometry.rotations import compute_pose_error
    from pram_tpu_torch.maps.device import to_device
    from pram_tpu_torch.maps.rendered import _rotmat2qvec_np
    from pram_tpu_torch.models import sfd2_int8
    from pram_tpu_torch.models.adagml import AdaGMLConfig
    from pram_tpu_torch.models.convert import load_adagml, load_sfd2, load_sfd2_int8
    from pram_tpu_torch.models.segnetvit import SegNetViT, SegNetViTConfig
    from pram_tpu_torch.models.sfd2 import extract, preprocess_image
    from pram_tpu_torch.ops import attention, conv_int8, mlp, nms, stem

    f32 = torch.float32
    t_r = time.perf_counter()
    calib, _ = aachen_views(np, 2, 99)
    imgs, poses = aachen_views(np, FRONT_BATCH, 11)
    log(f"aachen front: rendered 2 calibration views and {FRONT_BATCH} queries at {AACHEN_W} x {AACHEN_H} in "
        f"{time.perf_counter() - t_r:.1f} s")
    calib_x = preprocess_image(torch.from_numpy(calib))
    extractors = {"int8": load_sfd2_int8(SFD2_W, calib_x, device=dev, dtype=bf16, conv_kernel=True),
                  "float": load_sfd2(SFD2_W, device=dev, dtype=bf16)}
    # SegNetViT nc513 (15 layers, d 256) from its seeded flax-like init
    rec = SegNetViT(SegNetViTConfig(n_class=AACHEN_CLASSES)).to(dev, bf16).eval()
    wh = torch.tensor([float(AACHEN_W), float(AACHEN_H)])

    def camera(n, device):
        return Camera(torch.tensor([500.0, 500.0, AACHEN_W / 2, AACHEN_H / 2, 0, 0, 0, 0]).repeat(n, 1).to(device),
                      wh.repeat(n, 1).to(device))

    def front(model, rec_m, images, device, dtype, kernels=True):
        x = preprocess_image(torch.as_tensor(images).to(device, f32)).to(dtype)
        f = extract(model, x, max_keypoints=AACHEN_KPTS, conf_th=1e-4, use_nms_kernel=kernels)
        kps = f["keypoints"]
        logits = rec_m(f["seg_descriptors"].to(dtype), kps.xy / wh.to(device) - 0.5, kps.mask)["prediction"]
        return f, (kps.xy, kps.scores.float(), f["descriptors"].to(dtype), kps.mask, logits.float())

    loc = Localizer(to_device(a_scene.map, dev, desc_dtype=bf16), ada_fn, a_cfg)
    names_all = set(read_counts())
    out = {"runs": {}, "kernels": {}}
    feats = {}
    for kind, model in extractors.items():
        reset_counts()
        with torch.no_grad():
            f, inputs = front(model, rec, imgs, dev, bf16)
            res = loc.localize_batch(torch.Generator().manual_seed(7), camera(FRONT_BATCH, dev), *inputs)
        torch.cuda.synchronize()
        got = read_counts()
        log(f"aachen front ({kind}) launches: {got}")
        once = {"fused_stem": 1, "nms": 1, "self_attention": 15, "conv3x3_int8": 14 if kind == "int8" else 0}
        for name, count in once.items():
            require(got[name] == count, f"aachen front ({kind}): {name} launched {got[name]} times, not {count}")
        for name in ("residual_mlp", "self_attention_qkv", "cross_attention_packed", "ransac_score", "gn_polish",
                     "refine_nn"):
            require(got[name] > 0, f"aachen front ({kind}): kernel {name} was not launched")
        require(got["residual_mlp"] > 15, f"aachen front ({kind}): AdaGML's MLPs were not launched")
        for name in names_all - set(once) - {"residual_mlp", "self_attention_qkv", "cross_attention_packed",
                                             "ransac_score", "gn_polish", "refine_nn"}:
            require(got[name] == 0, f"aachen front ({kind}): kernel {name} is not on this path but launched")
        n_kp = f["keypoints"].mask.sum(-1)
        require(bool((n_kp > 1000).all()), f"aachen front ({kind}): too few keypoints {n_kp.tolist()}")
        require(bool(torch.isfinite(inputs[4]).all() and torch.isfinite(res.tvec).all()),
                f"aachen front ({kind}): non-finite logits or poses")
        require(tuple(inputs[4].shape) == (FRONT_BATCH, AACHEN_KPTS, AACHEN_CLASSES), "aachen front: bad logits")
        feats[kind] = f
        gen = torch.Generator()

        def one_batch(model=model):
            with torch.no_grad():
                loc.localize_batch(gen.manual_seed(7), camera(FRONT_BATCH, dev),
                                   *front(model, rec, imgs, dev, bf16)[1])
            torch.cuda.synchronize()

        def one_front(model=model):
            with torch.no_grad():
                front(model, rec, imgs, dev, bf16)
            torch.cuda.synchronize()

        batch_s, front_s = median_s(one_batch, 3), median_s(one_front, 3)
        out["runs"][kind] = dict(launches=got, keypoints=n_kp.tolist(), success=res.success.tolist(),
                                 batch_ms=batch_s * 1e3, front_ms=front_s * 1e3, queries_per_s=FRONT_BATCH / batch_s)
        log(f"aachen front ({kind}): {n_kp.tolist()} keypoints; batch of {FRONT_BATCH} in {batch_s * 1e3:.2f} ms "
            f"(median of 3, host clock, synchronized) = {FRONT_BATCH / batch_s:.2f} queries/s; extraction + "
            f"recognition {front_s * 1e3:.2f} ms, localization {(batch_s - front_s) * 1e3:.2f} ms; success "
            f"{res.success.tolist()} (an untrained recognizer routes these views: no recall figure)")

    # the A/B checks: each extractor's kernel path against its plain path,
    # int8 against float, SegNetViT's kernel path against its plain path
    with torch.no_grad():
        x = preprocess_image(torch.as_tensor(imgs).to(dev, f32)).to(bf16)
        kw = dict(max_keypoints=AACHEN_KPTS, conf_th=1e-4)
        plains = {}
        for kind, model in extractors.items():
            flag = "use_kernels" if kind == "int8" else "use_stem_kernel"
            setattr(model, flag, False)
            plains[kind] = extract(model, x, use_nms_kernel=False, **kw)
            setattr(model, flag, True)
            ab = extraction_agreement(feats[kind], plains[kind])
            log(f"aachen extraction A/B ({kind}, bf16, kernel path vs plain path, {FRONT_BATCH} views): {json.dumps(ab)}")
            require(ab["kpt_set_agreement"] >= AB_BF16[0] and ab["desc_cos_min"] >= AB_BF16[1],
                    f"aachen extraction A/B ({kind}) below {AB_BF16}")
            out[f"ab_{kind}"] = ab
        # int8 against float on every keypoint both found: the bound
        # (cosine >= INT8_FLOAT_COS) is not met by the method itself at 4096
        # keypoints (tests/aachen_int8_agreement.py reads the same spread from
        # pram_tpu's extractors in f32 on the CPU), so it is recorded, and
        # the kernel path is held to the plain path's spread
        spreads = {}
        for path, fs in (("kernel path", feats), ("plain path", plains)):
            cos = common_cosines(fs["int8"], fs["float"])
            spreads[path] = dict(common=int(cos.size), min=float(cos.min()), mean=float(cos.mean()),
                                 below=float((cos < INT8_FLOAT_COS).mean()),
                                 quantiles_001_01_05=[float(v) for v in np.quantile(cos, [0.001, 0.01, 0.5])])
        sk, sp = spreads["kernel path"], spreads["plain path"]
        met = sk["min"] >= INT8_FLOAT_COS
        log(f"aachen int8 extractor vs float (bf16, all {AACHEN_KPTS} keypoints of {FRONT_BATCH} views, on those "
            f"both found): {json.dumps(spreads)}; the bound min >= {INT8_FLOAT_COS} is "
            f"{'met' if met else 'NOT MET (the method at 4096 keypoints, recorded)'}; the kernel path's share "
            f"below {INT8_FLOAT_COS} and mean within {INT8_SPREAD_TOL} of the plain path's")
        require(abs(sk["below"] - sp["below"]) <= INT8_SPREAD_TOL[0] and sk["mean"] >= sp["mean"] - INT8_SPREAD_TOL[1],
                "aachen int8 extractor vs float: the kernel path's spread is not the plain path's")
        out["int8_vs_float"] = dict(spreads, bound_met=met)
        del plains
        f = feats["int8"]
        kps = f["keypoints"]
        norm = kps.xy / wh.to(dev) - 0.5
        patches = [(attention, "self_attention"), (mlp, "residual_mlp")]
        with recording_first(patches) as seen:
            lk = rec(f["seg_descriptors"], norm, kps.mask)["prediction"].float()
        rec.use_kernels = False
        lp = rec(f["seg_descriptors"], norm, kps.mask)["prediction"].float()
        rec.use_kernels = True
        # the control: the plain path in f32 on the same tokens, the reading
        # of bf16's own noise on these logits
        rec32 = copy.deepcopy(rec).float()
        rec32.use_kernels = False
        l32 = rec32(f["seg_descriptors"].float(), norm, kps.mask)["prediction"]
        del rec32
        # held by the logits, within ATTN_TOL of their scale: the head is a
        # seeded init (no nc513 weights exist), whose 513 logits a token
        # have top-2 margins near bf16's noise, so the argmax agreement >=
        # 0.99 is not met by the plain bf16 path against f32
        # either (recorded); its flips are counted where the plain path's
        # margin exceeds twice the largest logit difference, and the kernel
        # path agrees with f32 within 0.005 of the plain bf16 path
        valid = kps.mask
        err = (lk - lp).abs().max().item()
        scale = lp.abs().max().item()
        top2 = lp.topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1])[valid]
        flips = (lk.argmax(-1) != lp.argmax(-1))[valid]
        agree = 1.0 - flips.float().mean().item()
        clear = margin > 2 * err
        a32 = {name: (l.argmax(-1) == l32.argmax(-1))[valid].float().mean().item() for name, l in
               (("kernel path", lk), ("plain path", lp))}
        e32 = {name: (l - l32).abs().max().item() for name, l in (("kernel path", lk), ("plain path", lp))}
        log(f"aachen SegNetViT nc513 A/B (bf16, kernel path vs plain path, {FRONT_BATCH} x {AACHEN_KPTS} tokens): "
            f"logits max abs diff {err:.4f} of max|plain| {scale:.3f} ({err / scale:.2e}, tol {ATTN_TOL}); argmax "
            f"agreement {agree:.5f} on {int(valid.sum())} valid tokens, the plain path's median top-2 margin "
            f"{margin.median().item():.4f}; {int(clear.sum())} tokens with a margin above {2 * err:.4f}, "
            f"{int((flips & clear).sum())} of them flipped; against the plain path in f32 (the control): argmax "
            f"agreement {json.dumps(a32)}, logits max abs diff {json.dumps(e32)}; the bound argmax agreement >= "
            f"0.99 is {'met' if agree >= 0.99 else 'NOT MET (bf16 on a seeded head, recorded)'}")
        require(err <= ATTN_TOL * scale and not bool((flips & clear).any()),
                "aachen SegNetViT nc513: kernel path disagrees with its plain path")
        require(a32["kernel path"] >= a32["plain path"] - 0.005,
                "aachen SegNetViT nc513: the kernel path is further from f32 than the plain bf16 path")
        out["segnetvit_ab"] = dict(max_abs_err=err, scale=scale, argmax_agreement=agree,
                                   median_margin=margin.median().item(), argmax_agreement_f32=a32,
                                   max_abs_err_f32=e32)
        del l32

        # kernels 1 and 2 at SegNetViT's 8 x 4096 tokens, 8 and 9 at 8 x 768
        # x 1024, 18 on the int8 extractor's 14 layers from 384 x 512
        (a_args, _), (m_args, m_kw) = seen["self_attention"], seen["residual_mlp"]
        err = check_scaled("self_attention (SegNetViT nc513, 8 x 4096)", attention.self_attention(*a_args),
                           attention.self_attention_plain(*a_args), ATTN_TOL)
        out["kernels"]["self_attention"] = at_shape(
            torch, lambda: attention.self_attention(*a_args), lambda: attention.self_attention_plain(*a_args),
            err, [FRONT_BATCH, AACHEN_KPTS],
            bound_ms(*self_attention_cost(FRONT_BATCH, (AACHEN_KPTS,)), BF16_TENSOR_FLOPS))
        err = check_scaled("residual_mlp (SegNetViT nc513, 32768 tokens)", mlp.residual_mlp(*m_args, **m_kw),
                           mlp.residual_mlp_plain(*m_args, **m_kw), MLP_TOL)
        out["kernels"]["residual_mlp"] = at_shape(
            torch, lambda: mlp.residual_mlp(*m_args, **m_kw), lambda: mlp.residual_mlp_plain(*m_args, **m_kw),
            err, [FRONT_BATCH * AACHEN_KPTS], mlp_bound(FRONT_BATCH * AACHEN_KPTS, False))
        m = extractors["float"]
        st_args = (*m.conv1a.stem_args(), *m.conv1b.stem_args())
        y = stem.fused_stem(x, *st_args)
        err = check_scaled("fused_stem (bf16, 8 x 768 x 1024)", y, stem.fused_stem_plain(x, *st_args), STEM_TOL)
        require(torch.equal(stem.fused_stem(x, *st_args), y), "fused_stem at 768 x 1024: two launches differ")
        n_img, n_out = x.shape[0] * x.shape[1] * x.shape[2], y.shape[0] * y.shape[1] * y.shape[2]
        out["kernels"]["fused_stem"] = at_shape(
            torch, lambda: stem.fused_stem(x, *st_args), lambda: stem.fused_stem_plain(x, *st_args), err,
            list(x.shape[:3]), bound_ms(n_img * 3 * 2 + n_out * 64 * 2 + (27 + 576) * 64 * 2 + 2 * 64 * 4,
                                        2.0 * (27 * 64 * n_img + 576 * 64 * n_out), BF16_TENSOR_FLOPS))
        smap = m(x)["score_map"]
        got, ref = nms.nms(smap, 4), nms.simple_nms(smap, 4)
        diff = int((got != ref).sum().item())
        log(f"nms (bf16, {tuple(smap.shape)}, R = 4): {diff} elements differ; {int((ref > 0).sum())} maxima survive")
        require(diff == 0 and torch.equal(nms.nms(smap, 4), got), "nms at 768 x 1024: not bit-equal to its plain version")
        n_px = smap.numel()
        out["kernels"]["nms"] = at_shape(
            torch, lambda: nms.nms(smap, 4), lambda: nms.simple_nms(smap, 4), 0.0, list(smap.shape),
            bound_ms(2 * n_px * smap.element_size(), n_px * (3 * 2 * 3 + 2 * 6 * 4 / 32 + 3 + 2 * 2 + 1), F32_FLOPS))
        conv_calls = []
        real = sfd2_int8.conv3x3_int8
        sfd2_int8.conv3x3_int8 = lambda *a, **kw: conv_calls.append((a, kw)) or real(*a, **kw)
        try:
            extractors["int8"](x)
        finally:
            sfd2_int8.conv3x3_int8 = real
        require(len(conv_calls) == 14, f"aachen int8 extractor: {len(conv_calls)} conv launches, not 14")
        k_ms = p_ms = c_bytes = c_ops = worst = 0.0
        shapes = []
        for (xc8, wqc, sac, wsc, bc), ckw in conv_calls:
            x_coff = ckw.get("x_coff", 0)
            own = dict(stride=ckw["stride"], relu=ckw["relu"], bf16_tail=ckw["bf16_tail"])
            cin, cout, stride = wqc.shape[2], wqc.shape[3], ckw["stride"]
            xin = xc8[..., x_coff:x_coff + cin]
            g = conv_int8.conv3x3_int8(xc8, wqc, sac, wsc, bc, x_coff=x_coff, **own)
            r = conv_int8.conv3x3_int8_plain(xin, wqc, sac, wsc, bc, **own)
            e = (g.float() - r.float()).abs().max().item()
            require((g == r).float().mean().item() >= CONV_EQUAL_SHARE and e <= INT8_TOL * r.float().abs().max().item(),
                    f"conv3x3_int8 {tuple(xin.shape)} -> {cout} disagrees with its plain version")
            worst = max(worst, e)
            k_ms += cuda_ms(torch, lambda: conv_int8.conv3x3_int8(xc8, wqc, sac, wsc, bc, x_coff=x_coff, **own), iters=10)
            p_ms += cuda_ms(torch, lambda: conv_int8.conv3x3_int8_plain(xin, wqc, sac, wsc, bc, **own), iters=1, warmup=1)
            b_, h_, w_ = xin.shape[:3]
            ho_, wo_ = (h_ - 1) // stride + 1, (w_ - 1) // stride + 1
            c_bytes += b_ * h_ * w_ * cin * 2 + b_ * ho_ * wo_ * cout * 2 + 9 * cin * cout + 8 * cout
            c_ops += 2.0 * b_ * ho_ * wo_ * cout * 9 * cin
            shapes.append([h_, w_, cin, cout, stride])
        bnd, by = bound_ms(c_bytes, c_ops, INT8_TENSOR_OPS)
        out["kernels"]["conv3x3_int8"] = dict(shape=shapes, max_abs_err=worst, ms=k_ms, plain_ms=p_ms, bound_ms=bnd,
                                              bound_by=by)
        del conv_calls, seen, smap, y
    for name, k in out["kernels"].items():
        log(f"{name} at the Aachen front's shape {k['shape']}: {k['ms']:.4f} ms (CUDA events), plain "
            f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']})")

    # the first 2 views on the card and on the card machine's CPU (the plain
    # versions in bf16, as the card), int8, routed by the ground truth to the
    # image slice's rendered map of the same world (the Aachen scene holds
    # no point of these views), the same RANSAC seed. Held: the extraction
    # card vs CPU within AB_BF16, and the CPU's localization of the card's
    # features against the card's (flags, poses within 5 mm / 0.1 deg, at
    # least one view localized). Recorded: the CPU end to end from its own
    # features (flags held equal; its keypoints differ on a few tenths of a
    # percent, which moves RANSAC's draws, so its poses are read against
    # the card's and the ground truth)
    t_cpu = time.perf_counter()
    world = r_scene.world
    n_cls = int(r_scene.map.n_class)
    sub, sub_poses = imgs[:2], poses[:2]

    def routed(model, device):
        x = preprocess_image(torch.as_tensor(sub).to(device, f32)).to(bf16)
        f = extract(model, x, max_keypoints=AACHEN_KPTS, conf_th=1e-4)
        kps = f["keypoints"]
        logits = gt_logits(np, world, kps.xy.float().cpu().numpy(), kps.mask.cpu().numpy(), sub_poses, n_cls)
        return f, (kps.xy, kps.scores.float(), f["descriptors"].to(bf16), kps.mask,
                   torch.from_numpy(logits).to(device))

    with torch.no_grad():
        r_loc = Localizer(to_device(r_scene.map, dev, desc_dtype=bf16), ada_fn, a_cfg)
        f_g, in_g = routed(extractors["int8"], dev)
        res_g = r_loc.localize_batch(torch.Generator().manual_seed(3), camera(2, dev), *in_g)
        q_cpu = load_sfd2_int8(SFD2_W, calib_x, device="cpu", dtype=bf16, conv_kernel=True)
        ada_cpu = load_adagml(ada_w, AdaGMLConfig(), device="cpu", dtype=bf16)
        loc_cpu = Localizer(to_device(r_scene.map, "cpu", desc_dtype=bf16),
                            make_adagml_match_fn(ada_cpu, ada_cpu.config.match_threshold), a_cfg)
        res_c = loc_cpu.localize_batch(torch.Generator().manual_seed(3), camera(2, "cpu"), *(t.cpu() for t in in_g))
        f_c, in_c = routed(q_cpu, "cpu")
        res_e = loc_cpu.localize_batch(torch.Generator().manual_seed(3), camera(2, "cpu"), *in_c)
    ab = extraction_agreement(f_g, f_c)
    gq = torch.from_numpy(np.stack([_rotmat2qvec_np(R) for R, _ in sub_poses])).float()
    gt = torch.from_numpy(np.stack([t for _, t in sub_poses])).float()

    def apart(a, b):
        both = a.success.cpu() & b.success.cpu()
        dq, dt = compute_pose_error(a.qvec.cpu(), a.tvec.cpu(), b.qvec.cpu(), b.tvec.cpu())
        return both, dq, dt

    both, dq, dt = apart(res_g, res_c)
    both_e, dq_e, dt_e = apart(res_g, res_e)
    err = {name: [[round(v, 5) for v in e.tolist()] for e in compute_pose_error(r.qvec.cpu(), r.tvec.cpu(), gq, gt)]
           for name, r in (("card", res_g), ("CPU end to end", res_e))}
    log(f"aachen front card vs CPU (2 views, int8, bf16 on both; routed by the ground truth to the rendered map "
        f"of {r_scene.map.num_points} points) in {time.perf_counter() - t_cpu:.1f} s: extraction {json.dumps(ab)}; "
        f"the card's features localized on the CPU: success card {res_g.success.tolist()} CPU "
        f"{res_c.success.tolist()}, inliers {res_g.num_inliers.tolist()} vs {res_c.num_inliers.tolist()}"
        + (f", pose diff max {dq[both].max().item():.4f} deg {dt[both].max().item():.5f} m" if both.any() else "")
        + f"; end to end on the CPU: success {res_e.success.tolist()}, inliers {res_e.num_inliers.tolist()}"
        + (f", pose diff from the card's max {dq_e[both_e].max().item():.4f} deg {dt_e[both_e].max().item():.5f} m"
           if both_e.any() else "")
        + f"; error from the ground truth (deg, m) {json.dumps(err)}")
    require(ab["kpt_set_agreement"] >= AB_BF16[0] and ab["desc_cos_min"] >= AB_BF16[1],
            f"aachen front: extraction card vs CPU below {AB_BF16}")
    require(torch.equal(res_g.success.cpu(), res_c.success) and torch.equal(res_g.success.cpu(), res_e.success),
            "aachen front: success differs card vs CPU")
    require(bool(both.any()), "aachen front: no view localized on both sides, no pose to compare")
    require(bool((dq[both] < SLICE_R_TOL_DEG).all() and (dt[both] < SLICE_T_TOL).all()),
            "aachen front: pose differs card vs CPU")
    out["card_vs_cpu"] = dict(card=res_g.success.tolist(), cpu=res_c.success.tolist(), extraction=ab,
                              pose_diff_deg=dq[both].tolist(), pose_diff_m=dt[both].tolist(),
                              end_to_end=dict(cpu=res_e.success.tolist(), pose_diff_deg=dq_e[both_e].tolist(),
                                              pose_diff_m=dt_e[both_e].tolist()), error_from_gt=err)
    return out


def aachen_cli_top(root) -> dict:
    """configs/config_train_aachen_sfd2.yaml's settings for cli.inference
    (read by the port's YAML reader), with two changes the synthetic
    layout needs: ``use_mid_feature`` off, since the CLI feeds the caches'
    128-d descriptors to the recognizer and the matcher alike (the JAX
    CLI's behaviour, ROADMAP section 3), and the layout's own paths."""
    from pram_tpu_torch.core.config import safe_load

    cfg = safe_load((root / "configs" / "config_train_aachen_sfd2.yaml").read_text())
    for key in ("dataset", "landmark_path", "dataset_path", "config_path"):
        cfg.pop(key)
    cfg["use_mid_feature"] = False
    return cfg


# the CPU side of phase 26's cli.inference comparison, run in a child
# process (started by start_cli_cpu at the end of phase 11); it prints the
# report's count and failed queries as its last line
CLI_CPU_CHILD = (
    "import json, os, sys\n"
    "os.nice(19)\n"
    "from pram_tpu_torch.cli import inference\n"
    "report = inference.main(sys.argv[1:])\n"
    "print('RESULT ' + json.dumps({'n_total': report.n_total, 'failed': report.failed_cases}), flush=True)\n"
)
CLI_CPU_WAIT_S = 600  # the longest phase 26 waits for it
CHILDREN = []  # (process, its log file) of every child started
TEMP_DIRS = []  # directories made by aachen_cli_layout


def stop_children() -> None:
    """Kill every child still running and remove the temporary layouts (at
    exit, on success or failure)."""
    import shutil

    for proc, f in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        f.close()
    for d in TEMP_DIRS:
        shutil.rmtree(d, ignore_errors=True)


def aachen_cli_layout(root, a_scene, a_queries, gml_w: str) -> dict:
    """The Aachen scene written as cli.inference's layout in a temporary
    directory (removed at exit): a compressed model with 512 clusters,
    frames of up to 2048 points and the queries' 4096-keypoint caches,
    configured by :func:`aachen_cli_top`; returns its directory and the
    CLI's arguments for all queries in batches of 8 (``argv``) and for the
    first AACHEN_CLI_CPU_QUERIES one at a time (``argv_k``)."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="pram_aachen_cli_"))
    TEMP_DIRS.append(tmp)
    top = aachen_cli_top(root)
    names = [f"query_{i:03d}.png" for i in range(len(a_queries))]
    cfg = synthetic_layout(tmp, a_scene, a_queries, names, 512, top)
    k = AACHEN_CLI_CPU_QUERIES
    (tmp / "datasets" / "Synthetic" / "scene" / f"imglist_{k}.txt").write_text("".join(f"{nm}\n" for nm in names[:k]))
    cfg_k = write_configs(tmp, "Synthetic", "scene", 512, top, config_dir=tmp / "cfg_k", image_list=f"imglist_{k}.txt")
    return dict(dir=tmp, argv=["--config", str(cfg), "--matcher_weight_path", gml_w, "--batch", str(FRONT_BATCH)],
                argv_k=["--config", str(cfg_k), "--matcher_weight_path", gml_w, "--batch", "1"])


def start_cli_cpu(root, layout: dict) -> dict:
    """cli.inference ``--device cpu`` on the layout's first
    AACHEN_CLI_CPU_QUERIES queries in a child process that lowers itself
    to the lowest CPU priority (niceness 19) and sees no CUDA device: it takes the cores
    the card's phases leave idle (each query ~90 s of the card machine's 8
    cores: 10 GML problems at 4096 x 2048) and phase 26 waits for it."""
    import os

    f = open(layout["dir"] / "cli_cpu.log", "w")
    proc = subprocess.Popen([sys.executable, "-c", CLI_CPU_CHILD, *layout["argv_k"], "--device", "cpu"], cwd=root,
                            stdout=f, stderr=subprocess.STDOUT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    CHILDREN.append((proc, f))
    return dict(proc=proc, log=layout["dir"] / "cli_cpu.log", t0=time.perf_counter())


def run_aachen_gml_phase(torch, np, dev, bf16, gml, gml_w, a_scene, a_queries, a_inputs, a_cfg, outcome,
                         layout, cli_cpu, reset_counts, read_counts) -> dict:
    """Phase 26, path B: GML (9 layers, weights/gml_synthetic.msgpack) at
    the Aachen shape through the Localizer, 4096-keypoint queries against
    frames of 2048, routed by ground-truth logits; then cli.inference at
    configs/config_train_aachen_sfd2.yaml on the Aachen-shaped layout
    (:func:`aachen_cli_layout`), and on its first AACHEN_CLI_CPU_QUERIES
    queries on the card and with ``--device cpu`` (the child process
    ``cli_cpu`` of :func:`start_cli_cpu`)."""
    from pram_tpu_torch.cli import inference as cli_inference
    from pram_tpu_torch.engine.localizer import Localizer
    from pram_tpu_torch.engine.matching import make_gml_match_fn
    from pram_tpu_torch.geometry.rotations import compute_pose_error
    from pram_tpu_torch.maps.device import to_device
    from pram_tpu_torch.models import gml as gml_mod
    from pram_tpu_torch.models.convert import load_gml
    from pram_tpu_torch.models.gml import GMLConfig
    from pram_tpu_torch.ops import attention, cross_attention, mlp, sinkhorn

    names_all = set(read_counts())
    out = {"kernels": {}}
    fn = make_gml_match_fn(gml, gml.config.match_threshold)
    loc = Localizer(to_device(a_scene.map, dev, desc_dtype=bf16), fn, a_cfg)
    batches = [a_queries[i:i + FRONT_BATCH] for i in range(0, len(a_queries), FRONT_BATCH)]
    n_q = len(a_queries)

    def run(kernels):
        gml.use_kernels = kernels
        try:
            with torch.no_grad():
                return [loc.localize_batch(torch.Generator().manual_seed(7 + i), *a_inputs(qs, dev))
                        for i, qs in enumerate(batches)]
        finally:
            gml.use_kernels = True

    reset_counts()
    res_k = run(True)
    torch.cuda.synchronize()
    got = read_counts()
    want = add_launches({}, {**GML_LAUNCHES, "sinkhorn": 0, "sinkhorn_wide": 1}, len(batches))
    want = add_launches(want, PNP_LAUNCHES, len(batches))
    log(f"aachen GML launches ({n_q} queries in batches of {FRONT_BATCH}): {got}")
    require(got == {k: want.get(k, 0) for k in names_all}, f"aachen GML: launches {got}, expected {want} and no other")
    res_p = run(False)
    rec_k = sum(outcome(qs, r)[0] for qs, r in zip(batches, res_k)) / n_q
    rec_p = sum(outcome(qs, r)[0] for qs, r in zip(batches, res_p)) / n_q
    log(f"aachen GML recall@25cm/2deg: kernel path {rec_k:.4f}, plain path {rec_p:.4f} (the same RANSAC seeds; "
        f"at most one query below)")
    require(rec_k >= rec_p - 1.0 / n_q, "aachen GML: the kernel path's recall is more than one query below the plain path's")
    out.update(launches=got, recall=rec_k, recall_plain=rec_p)
    gen = torch.Generator()
    args0 = a_inputs(batches[0], dev)

    def one_batch():
        with torch.no_grad():
            loc.localize_batch(gen.manual_seed(7), *args0)
        torch.cuda.synchronize()

    batch_s = median_s(one_batch, 3)
    out.update(batch_ms=batch_s * 1e3, queries_per_s=FRONT_BATCH / batch_s)
    log(f"aachen GML: a batch of {FRONT_BATCH} in {batch_s * 1e3:.2f} ms (median of 3, host clock, synchronized) "
        f"= {FRONT_BATCH / batch_s:.2f} queries/s")

    # the kernels at this path's shapes, on the inputs of batch 0
    patches = [(attention, "self_attention"), (cross_attention, "cross_attention"), (mlp, "residual_mlp"),
               (gml_mod, "sinkhorn")]
    with torch.no_grad(), recording_first(patches) as seen:
        loc.localize_batch(gen.manual_seed(7), *args0)
    with torch.no_grad():
        (a_args, a_kw) = seen["self_attention"]
        splits = a_args[8]
        err = check_scaled(f"self_attention (GML, splits {splits})", attention.self_attention(*a_args),
                           attention.self_attention_plain(*a_args), ATTN_TOL)
        out["kernels"]["self_attention"] = at_shape(
            torch, lambda: attention.self_attention(*a_args), lambda: attention.self_attention_plain(*a_args),
            err, [a_args[0].shape[0], *splits],
            bound_ms(*self_attention_cost(a_args[0].shape[0], splits), BF16_TENSOR_FLOPS))
        c_args, _ = seen["cross_attention"]
        n0 = c_args[9]
        n1 = c_args[0].shape[1] - n0
        err = check_scaled(f"cross_attention (GML, {n0} x {n1})", cross_attention.cross_attention(*c_args),
                           cross_attention.cross_attention_plain(*c_args), ATTN_TOL)
        out["kernels"]["cross_attention"] = at_shape(
            torch, lambda: cross_attention.cross_attention(*c_args),
            lambda: cross_attention.cross_attention_plain(*c_args), err, [c_args[0].shape[0], n0, n1],
            bound_ms(*cross_attention_cost(c_args[0].shape[0], n0, n1), BF16_TENSOR_FLOPS))
        m_args, m_kw = seen["residual_mlp"]
        err = check_scaled("residual_mlp (GML, Aachen)", mlp.residual_mlp(*m_args, **m_kw),
                           mlp.residual_mlp_plain(*m_args, **m_kw), MLP_TOL)
        tok = m_args[0].numel() // 256
        out["kernels"]["residual_mlp"] = at_shape(
            torch, lambda: mlp.residual_mlp(*m_args, **m_kw), lambda: mlp.residual_mlp_plain(*m_args, **m_kw),
            err, [tok], mlp_bound(tok, False))
        (sim, dustbin, iters, sm0, sm1), _ = seen["sinkhorn"]
        b, n, m = sim.shape
        require(sinkhorn.instance(n, m, dev)[0] == sinkhorn.WIDE, "aachen GML: the plan did not take the wide instance")
        plan = sinkhorn.sinkhorn(sim, dustbin, iters, sm0, sm1)
        controls = {"plain in bf16": sinkhorn.sinkhorn_matching(sim.bfloat16(), dustbin, iters, sm0, sm1).float(),
                    f"plain, {iters - 1} iterations": sinkhorn.sinkhorn_matching(sim, dustbin, iters - 1, sm0, sm1)}
        wide_chk = check_wide_plan(f"sinkhorn_wide ({b} x {n + 1} x {m + 1})", plan,
                                   sinkhorn.sinkhorn_matching(sim, dustbin, iters, sm0, sm1), controls, n, m)
        err = wide_chk["max_abs_err"]
        del controls
        require(torch.equal(sinkhorn.sinkhorn(sim, dustbin, iters, sm0, sm1).view(torch.int32), plan.view(torch.int32)),
                "sinkhorn_wide: two calls differ")
        out["kernels"]["sinkhorn_wide"] = at_shape(
            torch, lambda: sinkhorn.sinkhorn(sim, dustbin, iters, sm0, sm1),
            lambda: sinkhorn.sinkhorn_matching(sim, dustbin, iters, sm0, sm1), err, [b, n + 1, m + 1],
            bound_ms(*sinkhorn_cost(b, n, m, iters), F32_FLOPS))
        out["kernels"]["sinkhorn_wide"].update(launches_a_call=2 * iters + 1, entry_check=wide_chk)
        # at the Aachen config's 80 problems: its inputs ten times over
        r = WIDE_PROBLEMS // b
        sim80, m080, m180 = sim.repeat(r, 1, 1), sm0.repeat(r, 1), sm1.repeat(r, 1)
        del plan
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        plan80 = sinkhorn.sinkhorn(sim80, dustbin, iters, m080, m180)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        require(torch.equal(plan80[:b].view(torch.int32), sinkhorn.sinkhorn(sim, dustbin, iters, sm0, sm1).view(torch.int32)),
                "sinkhorn_wide at 80 problems: the first 8 plans differ from the 8-problem call")
        del plan80
        bnd, by = bound_ms(*sinkhorn_cost(WIDE_PROBLEMS, n, m, iters), F32_FLOPS)
        out["kernels"]["sinkhorn_wide"].update(
            ms_80=cuda_ms(torch, lambda: sinkhorn.sinkhorn(sim80, dustbin, iters, m080, m180), iters=3, warmup=1),
            bound_80_ms=bnd, bound_80_by=by, peak_gb_80=peak / 1e9)
        del sim80, m080, m180, seen
    for name, k in out["kernels"].items():
        log(f"{name} at the Aachen GML shape {k['shape']}: {k['ms']:.4f} ms (CUDA events), plain "
            f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']})")
    w = out["kernels"]["sinkhorn_wide"]
    log(f"sinkhorn_wide at {WIDE_PROBLEMS} problems: {w['ms_80']:.3f} ms a call, bound {w['bound_80_ms']:.4f} ms "
        f"({w['bound_80_by']}), {w['peak_gb_80']:.3f} GB allocated at its peak above what was held")

    # the first 2 queries on the card and on the card machine's CPU (plain
    # versions, bf16 as the card), the same RANSAC seed
    t_cpu = time.perf_counter()
    sub = batches[0][:2]
    with torch.no_grad():
        res_g = loc.localize_batch(torch.Generator().manual_seed(3), *a_inputs(sub, dev))
        g_cpu = load_gml(gml_w, GMLConfig(), device="cpu", dtype=bf16)
        res_c = Localizer(to_device(a_scene.map, "cpu", desc_dtype=bf16),
                          make_gml_match_fn(g_cpu, g_cpu.config.match_threshold), a_cfg).localize_batch(
            torch.Generator().manual_seed(3), *a_inputs(sub, "cpu"))
    both = res_g.success.cpu() & res_c.success
    dq, dt = compute_pose_error(res_g.qvec.cpu(), res_g.tvec.cpu(), res_c.qvec, res_c.tvec)
    log(f"aachen GML card vs CPU (2 queries) in {time.perf_counter() - t_cpu:.1f} s: success card "
        f"{res_g.success.tolist()} CPU {res_c.success.tolist()}"
        + (f", pose diff max {dq[both].max().item():.4f} deg {dt[both].max().item():.5f} m" if both.any() else ""))
    require(torch.equal(res_g.success.cpu(), res_c.success), "aachen GML: success differs card vs CPU")
    require(bool((dq[both] < SLICE_R_TOL_DEG).all() and (dt[both] < SLICE_T_TOL).all()),
            "aachen GML: pose differs card vs CPU")
    out["card_vs_cpu"] = dict(card=res_g.success.tolist(), cpu=res_c.success.tolist())
    del g_cpu

    # cli.inference at the Aachen config (seg_k 10, GML) on the Aachen-shaped
    # layout: 512 clusters, frames of up to 2048 points, 4096-keypoint caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    report, lines = run_cli("inference (Aachen)", cli_inference.main, layout["argv"])
    torch.cuda.synchronize()
    got = read_counts()
    n_b = -(-n_q // FRONT_BATCH)
    want = add_launches(add_launches({}, SEGNETVIT_LAUNCHES, n_b), {**GML_LAUNCHES, "sinkhorn": 0,
                                                                     "sinkhorn_wide": 1}, n_b)
    want = add_launches(want, PNP_LAUNCHES, n_b)
    log(f"inference CLI (Aachen) launches: {got}; peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    require(got == {k: want.get(k, 0) for k in names_all},
            f"inference CLI (Aachen): launches {got}, expected {want} and no other")
    require(report.n_total == n_q, "inference CLI (Aachen): not every query was evaluated")
    # the first k queries one at a time on the card, and the child's run of
    # the same with --device cpu (10 GML problems at 4096 x 2048 a query)
    k = AACHEN_CLI_CPU_QUERIES
    card_k, _ = run_cli(f"inference (Aachen), {k} queries", cli_inference.main, layout["argv_k"])
    t_w = time.perf_counter()
    proc = cli_cpu["proc"]
    try:
        proc.wait(timeout=CLI_CPU_WAIT_S)
    except subprocess.TimeoutExpired:
        require(False, f"inference CLI (Aachen) --device cpu: not done {CLI_CPU_WAIT_S} s after phase 26 asked")
    waited = time.perf_counter() - t_w
    cpu_lines = cli_cpu["log"].read_text().splitlines()
    for line in cpu_lines:
        log(f"  inference (Aachen), {k} queries, --device cpu | {line}")
    require(proc.returncode == 0, f"inference CLI (Aachen) --device cpu: exit code {proc.returncode}")
    cpu_k = json.loads(next(l for l in reversed(cpu_lines) if l.startswith("RESULT "))[len("RESULT "):])
    log(f"inference CLI (Aachen) on the CPU (a child at niceness 19 since phase 11): {k} queries in "
        f"{time.perf_counter() - cli_cpu['t0']:.1f} s, of which phase 26 waited {waited:.1f} s; failed card "
        f"{card_k.failed_cases} CPU {cpu_k['failed']}")
    require(card_k.n_total == cpu_k["n_total"] == k, "inference CLI (Aachen): the card or CPU run missed a query")
    require(card_k.failed_cases == cpu_k["failed"], "inference CLI (Aachen): success flags differ card vs CPU")
    out["cli"] = dict(launches=got, n_success=report.n_success, fps=report.fps(),
                      peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                      stage_times=next(l for l in lines if l.startswith("stage times:")),
                      failed_card=card_k.failed_cases, failed_cpu=cpu_k["failed"], cpu_waited_s=waited)
    log(f"inference CLI (Aachen) on card: {report.n_success}/{n_q} localized (a seeded, untrained nc513 "
        f"recognizer and the CLI's default camera: no recall figure), {report.fps():.2f} queries/s, "
        f"{out['cli']['stage_times']}")
    return out


def run_shapes_phase(torch, np, dev, bf16, ada_w, ada_inputs, reset_counts, read_counts) -> dict:
    """Phase 27: every padded wrapper, forward and backward, at a token count
    off its kernel's tile against its plain version on the card, one counted
    launch a call (rows of zeros alone give kernel 15 zero weight gradients:
    one more launch); AdaGML at off-tile counts in f32, masks and stop
    layers equal to its plain path."""
    from pram_tpu_torch.models.adagml import AdaGMLConfig, adagml_batched_adaptive_apply
    from pram_tpu_torch.models.convert import load_adagml
    from pram_tpu_torch.ops import (
        attention, attention_bwd, attention_qkv, cross_attention, mlp, mlp_bwd, padding, quant, refine,
    )

    g = torch.Generator().manual_seed(27)

    def rnd(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def rot(b, n):
        ang = torch.randn(b, n, 32, generator=g)
        return (torch.cos(ang).repeat_interleave(2, -1).to(dev), torch.sin(ang).repeat_interleave(2, -1).to(dev))

    def bias(b, n, p=0.8):
        mask = torch.rand(b, n, generator=g) < p
        mask[-1, : n // 3] = False
        return attention.mask_to_bias(mask, b, n, "cpu").to(dev)

    reset_counts()
    checks = {}
    with torch.no_grad():
        w, bq = rnd(768, 256, scale=1 / 16), rnd(768, scale=0.1, dtype=torch.float32)
        wq, ws = quant.quant_linear(w)
        for b, sides in ((1, (1000,)), (2, (1000, 1024)), (2, (4000, 2000))):
            n = sum(sides)
            x, (cos, sin), kb = rnd(b, n, 256), rot(b, n), bias(b, n)
            sp = None if len(sides) == 1 else sides
            a = (cos, sin, kb, 0.125, 4, sp)
            checks[f"self_attention {b} x {sides}"] = check_scaled(
                f"self_attention {b} x {sides}", attention.self_attention(x, w, bq, *a),
                attention.self_attention_plain(x, w, bq, *a), ATTN_TOL)
            checks[f"self_attention_int8 {b} x {sides}"] = check_scaled(
                f"self_attention_int8 {b} x {sides}", attention.self_attention_int8(x, wq, ws, bq, *a),
                attention.self_attention_int8_plain(x, wq, ws, bq, *a), INT8_TOL)
            qkv = rnd(b, n, 768)
            for dt in (bf16, torch.float32):
                got = attention_qkv.self_attention_qkv(qkv.to(dt), *a, return_stats=True)
                ref = attention_qkv.self_attention_qkv_plain(qkv.to(dt), *a, return_stats=True)
                tol = (ATTN_TOL, STATS_TOL) if dt == bf16 else (1e-4, 1e-4)
                for part, ga, ra, t_ in (("messages", got[0], ref[0], tol[0]), ("statistics", got[1], ref[1], tol[1])):
                    checks[f"self_attention_qkv {dt} {part} {b} x {sides}"] = check_scaled(
                        f"self_attention_qkv ({dt}, {part}) {b} x {sides}", ga, ra, t_)
        for b, n0, n1 in ((2, 1000, 1024), (2, 4000, 2000)):
            x = rnd(b, n0 + n1, 256)
            wqk, wv = rnd(256, 256, scale=1 / 16), rnd(256, 256, scale=1 / 16)
            bqk, bv = rnd(256, scale=0.1, dtype=torch.float32), rnd(256, scale=0.1, dtype=torch.float32)
            b0, b1 = bias(b, n0), bias(b, n1, 0.6)
            c = (wqk, bqk, wv, bv, b0, b1, 0.125, 4, n0)
            checks[f"cross_attention {b} x {n0} x {n1}"] = check_scaled(
                f"cross_attention {b} x {n0} x {n1}", cross_attention.cross_attention(x, *c),
                cross_attention.cross_attention_plain(x, *c), ATTN_TOL)
            (q1, s1), (q2, s2) = quant.quant_linear(wqk), quant.quant_linear(wv)
            c8 = (q1, s1, bqk, q2, s2, bv, b0, b1, 0.125, 4, n0)
            checks[f"cross_attention_int8 {b} x {n0} x {n1}"] = check_scaled(
                f"cross_attention_int8 {b} x {n0} x {n1}", cross_attention.cross_attention_int8(x, *c8),
                cross_attention.cross_attention_int8_plain(x, *c8), INT8_TOL)
            qk, v = rnd(b, n0 + n1, 256), rnd(b, n0 + n1, 256)
            pk = (qk[:, :n0], qk[:, n0:], v[:, :n0], v[:, n0:], b0, b1, 0.125, 4, True)
            got, ref = cross_attention.cross_attention_packed(*pk), cross_attention.cross_attention_packed_plain(*pk)
            for i, t_ in enumerate((ATTN_TOL, ATTN_TOL, STATS_TOL, STATS_TOL)):
                checks[f"cross_attention_packed {i} {b} x {n0} x {n1}"] = check_scaled(
                    f"cross_attention_packed (output {i}) {b} x {n0} x {n1}", got[i], ref[i], t_)
        for tok in (1000, 2 * 6000 + 8):
            xm, msg = rnd(tok, 256), rnd(tok, 256, scale=0.1)
            wts = (rnd(256, 256, scale=1 / 16), rnd(256, scale=0.1, dtype=torch.float32), rnd(512, 512, scale=1 / 23),
                   rnd(512, scale=0.1, dtype=torch.float32), 1 + rnd(512, scale=0.1, dtype=torch.float32),
                   rnd(512, scale=0.1, dtype=torch.float32), rnd(256, 512, scale=1 / 23),
                   rnd(256, scale=0.1, dtype=torch.float32))
            checks[f"residual_mlp {tok}"] = check_scaled(
                f"residual_mlp {tok} tokens", mlp.residual_mlp(xm, msg, *wts), mlp.residual_mlp_plain(xm, msg, *wts),
                MLP_TOL)
            (pq, ps), (zq, zs), (tq, ts) = (quant.quant_linear(wts[i]) for i in (0, 2, 6))
            w8 = (pq, ps, wts[1], zq, zs, wts[3], wts[4], wts[5], tq, ts, wts[7])
            checks[f"residual_mlp_int8 {tok}"] = check_scaled(
                f"residual_mlp_int8 {tok} tokens", mlp.residual_mlp_int8(xm, msg, *w8),
                mlp.residual_mlp_int8_plain(xm, msg, *w8), INT8_TOL)
        x = rnd(1, 1000, 256)
        cos, sin = rot(1, 1000)
        checks["projection 1000"] = check_projection(
            "projection, 1000 tokens", attention.project(x, w, bq, cos, sin, rotary_cols=512),
            attention.project_plain(x, w, bq, cos, sin, rotary_cols=512), attention.project_plain(x, w, bq), 512)
        checks["projection_int8 1000"] = check_projection(
            "s8 projection, 1000 tokens", torch.cat(attention.project_int8(x, wq, ws, bq, split=256), -1),
            attention.project_int8_plain(x, wq, ws, bq))
        # kernel 7: 1000 queries, 2000 points, every similarity of the last
        # problem below 0 and its points outside the image, so the zero
        # descriptors of the padded points would win there if the kernel
        # folded them
        b, nq, npt = 2, 1000, 2000
        descs = torch.nn.functional.normalize(torch.randn(b, nq, 128, generator=g), dim=-1)
        pdesc = torch.nn.functional.normalize(torch.randn(b, npt, 128, generator=g), dim=-1)
        pdesc[:, :500] = torch.nn.functional.normalize(descs[:, :500] + 0.05 * torch.randn(b, 500, 128, generator=g), dim=-1)
        descs[-1], pdesc[-1] = descs[-1].abs(), -pdesc[-1].abs()
        kpts = torch.rand(b, nq, 2, generator=g) * torch.tensor([640.0, 480.0])
        uv = torch.rand(b, npt, 2, generator=g) * torch.tensor([640.0, 480.0])
        uv[:, :500] = kpts[:, :500] + torch.randn(b, 500, 2, generator=g)
        in_img = torch.rand(b, npt, generator=g) > 0.1
        in_img[-1] = False
        r_args = [descs.to(dev, bf16), pdesc.to(dev, bf16)] + [t.to(dev) for t in (kpts, uv, in_img)]
        r_args += [(torch.rand(b, nq, generator=g) > 0.1).to(dev), 16.0, 0.995]
        idx, d1, keep = refine.refine_nn(*r_args)
        ridx, rd1, rkeep = refine.refine_nn_plain(*r_args)
        agree = min((idx == ridx).float().mean().item(), (keep == rkeep).float().mean().item())
        log(f"refine_nn {b} x {nq} x {npt}: index / keep agreement {agree:.5f} (min {REFINE_AGREE}), d1 max abs err "
            f"{(d1 - rd1).abs().max().item():.3e}, largest index {int(idx.max())} of {npt} points, kept {int(keep.sum())}")
        require(agree >= REFINE_AGREE and (d1 - rd1).abs().max().item() <= REFINE_D1_ATOL and int(idx.max()) < npt,
                "refine_nn at off-tile counts disagrees with its plain version or chose a padded point")
        # kernels 13, 14 and 15: sides of 1000 and 600 tokens (64-token tiles), 1000 MLP rows (32-row tiles)
        b, n0, n1 = 2, 1000, 600
        n = n0 + n1
        (cos, sin), kb = rot(b, n), bias(b, n)
        sa = (rnd(b, n, 768), cos, sin, kb, rnd(b, n, 256), 64**-0.5, 4, (n0, n1))
        ca = (rnd(b, n, 256), rnd(b, n, 256), bias(b, n0), bias(b, n1, 0.6), rnd(b, n, 256), 64**-0.5, 4, n0)
        ma = (rnd(2, 500, 256), rnd(2, 500, 256), rnd(2, 500, 256), rnd(512, 512, scale=1 / 23),
              rnd(512, scale=0.1), 1 + rnd(512, scale=0.1), rnd(512, scale=0.1), rnd(256, 512, scale=1 / 23))
        for name, fn, plain, args, n_bf16, shape in (
                ("self_attention_bwd", attention_bwd.self_attention_bwd, attention_bwd.self_attention_bwd_plain,
                 sa, 1, f"{b} x ({n0}, {n1})"),
                ("cross_attention_bwd", attention_bwd.cross_attention_bwd, attention_bwd.cross_attention_bwd_plain,
                 ca, 2, f"{b} x {n0} x {n1}"),
                ("residual_mlp_bwd", mlp_bwd.residual_mlp_bwd, mlp_bwd.residual_mlp_bwd_plain, ma, 2, "1000 rows")):
            got, ref = fn(*args), plain(*args)
            for i, (a_, r_) in enumerate(zip(got, ref)):
                require(a_.shape == r_.shape, f"{name} at {shape}: output {i} of shape {tuple(a_.shape)}")
                checks[f"{name} {i} {shape}"] = check_scaled(f"{name} {shape} (output {i})", a_, r_,
                                                             BWD_TOL if i < n_bf16 else BWD_F32_TOL)
        z = torch.zeros(32, 256, device=dev, dtype=bf16)
        zero = mlp_bwd._residual_mlp_bwd_cuda(z, z, z, *ma[3:])
        require(all(bool(torch.isfinite(t_).all()) and not bool(t_.any()) for t_ in zero[2:]),
                "residual_mlp_bwd: rows of zeros (the padding) add to a weight gradient")
    torch.cuda.synchronize()
    launches = read_counts()
    want = {"self_attention": 3, "self_attention_int8": 3, "projection_int8": 3 + 2 + 1, "self_attention_qkv": 2,
            "self_attention_qkv_blocked": 4, "cross_attention": 2, "cross_attention_int8": 2,
            "cross_attention_packed": 2, "residual_mlp": 2, "residual_mlp_int8": 2, "projection": 1, "refine_nn": 1,
            "self_attention_bwd": 1, "cross_attention_bwd": 1, "residual_mlp_bwd": 1 + 1}
    log(f"shapes launches: {launches}")
    require(launches == {k: want.get(k, 0) for k in launches}, f"shapes: launches {launches}, expected {want}")
    # kernels 13-15 off their tiles (the wrapper's padding and slicing
    # included) against the same kernels at the padded shapes, on the tile
    bwd_ms = {}
    with torch.no_grad():
        pn0, pn1 = padding.round_up(n0, 64), padding.round_up(n1, 64)
        pn = pn0 + pn1
        (pcos, psin), pkb = rot(b, pn), bias(b, pn)
        on_tile = {
            "self_attention_bwd": (attention_bwd.self_attention_bwd, sa,
                                   (rnd(b, pn, 768), pcos, psin, pkb, rnd(b, pn, 256), 64**-0.5, 4, (pn0, pn1))),
            "cross_attention_bwd": (attention_bwd.cross_attention_bwd, ca,
                                    (rnd(b, pn, 256), rnd(b, pn, 256), bias(b, pn0), bias(b, pn1, 0.6),
                                     rnd(b, pn, 256), 64**-0.5, 4, pn0)),
            "residual_mlp_bwd": (mlp_bwd.residual_mlp_bwd, ma,
                                 (rnd(2, 512, 256), rnd(2, 512, 256), rnd(2, 512, 256), *ma[3:])),
        }
        for name, (fn, off, on) in on_tile.items():
            bwd_ms[name] = dict(off_tile_ms=cuda_ms(torch, lambda: fn(*off)),
                                on_tile_ms=cuda_ms(torch, lambda: fn(*on)))
    log(f"backward kernels off their tiles (2 x ({n0} + {n1}) tokens, 1000 MLP rows; the padding included) "
        f"against the padded shapes on the tile (2 x ({pn0} + {pn1}), 1024 rows), ms a call by CUDA events: "
        + json.dumps({k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in bwd_ms.items()}))
    # AdaGML at off-tile counts in f32: its statistics decide masks and stop
    # layers, which the padded routes must leave as the plain path's
    d0, nk0, _, m0, d1, nk1, _, m1 = ada_inputs
    n0, n1 = d0.shape[1] - 96, d1.shape[1] - 48
    ada32 = load_adagml(ada_w, AdaGMLConfig(), device=dev, dtype=torch.float32)
    m_args = (d0[:, :n0].float(), d1[:, :n1].float(), nk0[:, :n0], nk1[:, :n1], m0[:, :n0], m1[:, :n1])
    with torch.no_grad():
        o32 = adagml_batched_adaptive_apply(ada32, *m_args)
        ada32.use_kernels = False
        p32 = adagml_batched_adaptive_apply(ada32, *m_args)
    diff = int((o32["mask0"] != p32["mask0"]).sum() + (o32["mask1"] != p32["mask1"]).sum())
    log(f"AdaGML at {n0} x {n1} tokens (f32, kernel path vs plain path): stop layers {o32['stop_layer'].tolist()} "
        f"vs {p32['stop_layer'].tolist()}, tokens whose mask differs {diff}, alive "
        f"{o32['mask0'].float().mean().item():.3f} / {o32['mask1'].float().mean().item():.3f}")
    require(torch.equal(o32["stop_layer"], p32["stop_layer"]) and diff == 0,
            "AdaGML at off-tile counts prunes or stops otherwise than its plain path")
    return dict(launches=launches, max_rel_err={k: v for k, v in checks.items()}, adagml_mask_diff=diff,
                adagml_shape=[n0, n1], bwd_ms=bwd_ms)


# ---- phases 28-29: the second model family (SuperPoint, SegNet, GM) through
# the registry and the CLIs. SuperPoint at the superpoint-n4096 config
# (pram_tpu/cli/extract_features.py:39-44: 4096 keypoints, conf_th 0.005,
# NMS radius 3, border 4), 480 x 640 grayscale; every model from its seeded
# init (no trained weights of them are in the repository)
SP_W, SP_H = 640, 480
SP_CAM = (500.0, 500.0, SP_W / 2, SP_H / 2)
SP_QUERIES, SP_BATCH = 32, 8
SP_MAP_KPTS = 2048  # a reference view's keypoints in the map (the Aachen frames' 2048)
SP_REFINE_POINTS = 4096  # a landmark's refinement set (the Aachen scene's)
SP_CPU_QUERIES = 4
# kernel 7's 256-d instance against its plain version on the path's inputs:
# nn_idx and keep equal on every query whose top-2 gap (d2 - d1) and
# distance from the ratio test's edge (|d1 - ratio d2|) both exceed
# REFINE_D1_ATOL, the d1 tolerance (f32 sums in another order move d1 by up
# to ~1e-3 where d1 is small); kernel 6's plan within check_plan's
# (and for the wide instance check_wide_plan's) bounds and its row argmax
# equal on REFINE_AGREE of the valid rows.
# RetNet and the compressor on the card in bf16 against the CPU in f32:
# cosine of each output vector at least BF16_COS_MIN
BF16_COS_MIN = 0.99


def sp_front(torch, np, dev, model, seg, world, imgs, poses, n_class: int, kw: dict, use_nms_kernel: bool = True):
    """SuperPoint extraction and SegNet on the card for rendered images
    ``[B, H, W, 3]`` taken at ``poses``: (features, SegNet's prediction,
    the Localizer's arguments routed by gt_logits)."""
    from pram_tpu_torch.geometry.camera import Camera
    from pram_tpu_torch.models.superpoint import extract, preprocess_image

    bf16 = torch.bfloat16
    x = preprocess_image(torch.as_tensor(imgs).to(dev)).to(bf16)
    f = extract(model, x, use_nms_kernel=use_nms_kernel, **kw)
    k = f["keypoints"]
    nk = k.xy / torch.tensor([float(SP_W), float(SP_H)], device=dev) - 0.5
    pred = seg(f["seg_descriptors"], nk, mask=k.mask)["prediction"]
    logits = torch.from_numpy(gt_logits(np, world, k.xy.cpu().numpy(), k.mask.cpu().numpy(), poses, n_class,
                                        SP_CAM)).to(dev)
    b = k.mask.shape[0]
    cam = Camera(torch.tensor([[*SP_CAM, 0.0, 0.0, 0.0, 0.0]] * b, device=dev),
                 torch.tensor([[float(SP_W), float(SP_H)]] * b, device=dev))
    return f, pred, (cam, k.xy, k.scores.float(), f["descriptors"], k.mask, logits)


def to_cpu_args(args):
    """Localizer arguments on the CPU."""
    cam, *rest = args
    return (type(cam)(cam.params.cpu(), cam.size.cpu()), *(t.cpu() for t in rest))


@contextlib.contextmanager
def recording_triplets():
    """The RANSAC triplets the port draws, in call order."""
    from pram_tpu_torch.geometry import pnp as gpnp

    real, drawn = gpnp._sample_triplets, []

    def wrapped(*a):
        drawn.append(real(*a))
        return drawn[-1]

    gpnp._sample_triplets = wrapped
    try:
        yield drawn
    finally:
        gpnp._sample_triplets = real


def card_vs_cpu(torch, what: str, res_g, res_c) -> dict:
    """Require the same success flags and, where both succeed, poses within
    SLICE_T_TOL / SLICE_R_TOL_DEG of each other."""
    from pram_tpu_torch.geometry.rotations import compute_pose_error

    both = res_g.success.cpu() & res_c.success
    dq, dt = compute_pose_error(res_g.qvec.cpu().double(), res_g.tvec.cpu().double(), res_c.qvec.double(),
                                res_c.tvec.double())
    out = dict(card=res_g.success.tolist(), cpu=res_c.success.tolist(),
               max_deg=float(dq[both].max()) if both.any() else None,
               max_m=float(dt[both].max()) if both.any() else None)
    log(f"{what} card vs CPU: {json.dumps(out)}")
    require(torch.equal(res_g.success.cpu(), res_c.success), f"{what}: success differs card vs CPU")
    require(bool((dq[both] < SLICE_R_TOL_DEG).all() and (dt[both] < SLICE_T_TOL).all()),
            f"{what}: pose differs card vs CPU")
    return out


def run_superpoint_phase(torch, np, dev, bf16, build, reset_counts, read_counts) -> dict:
    """Phase 28: SuperPoint -> SegNet -> GM (and mutual NN) -> Localizer with
    projection refinement on the card at full width, counted; kernels 9 (R
    = 3), 7 (256-d) and 6 at the path's shapes against their plain
    versions; the first queries on the card machine's CPU."""
    from pram_tpu_torch.cli.extract_features import CONFS
    from pram_tpu_torch.engine import localizer as loc_mod
    from pram_tpu_torch.engine.localizer import LocConfig, Localizer
    from pram_tpu_torch.engine.matching import make_gm_match_fn, make_nn_match_fn
    from pram_tpu_torch.engine.rendered_guard import apply_noise, extraction_agreement
    from pram_tpu_torch.geometry.rotations import compute_pose_error
    from pram_tpu_torch.maps.device import to_device
    from pram_tpu_torch.maps.rendered import _rotmat2qvec_np, build_rendered_scene, query_pose
    from pram_tpu_torch.models import gm as gm_mod
    from pram_tpu_torch.models import superpoint as sp_mod
    from pram_tpu_torch.models.gm import GM, GMConfig
    from pram_tpu_torch.models.registry import build_extractor
    from pram_tpu_torch.models.segnet import SegNet, SegNetConfig
    from pram_tpu_torch.ops import nms, refine, sinkhorn

    conf = CONFS["superpoint-n4096"]["model"]
    kw = dict(max_keypoints=conf["max_keypoints"], conf_th=conf["conf_th"], border=4,
              min_keypoints=conf["min_keypoints"], nms_radius=conf["nms_radius"])
    names_all = set(read_counts())
    out = {"kernels": {}, "paths": {}}
    torch.manual_seed(0)
    sp = build_extractor("superpoint").to(dev, bf16).to(memory_format=torch.channels_last).eval()

    # the map: 12 rendered reference views through SuperPoint on the card
    t_b = time.perf_counter()

    def extract_np(images):
        parts = []
        for i in range(0, len(images), SP_BATCH):
            x = sp_mod.preprocess_image(torch.as_tensor(images[i:i + SP_BATCH]).to(dev)).to(bf16)
            with torch.no_grad():
                f = sp_mod.extract(sp, x, **{**kw, "max_keypoints": SP_MAP_KPTS})
            k = f["keypoints"]
            parts.append((k.xy.cpu().numpy(), k.scores.float().cpu().numpy(), f["descriptors"].float().cpu().numpy(),
                          k.mask.cpu().numpy()))
        return tuple(np.concatenate(a) for a in zip(*parts))

    rscene = build_rendered_scene(extract_np, np.random.RandomState(0), width=SP_W, height=SP_H, focal=SP_CAM[0],
                                  n_ref=12, kp_per_ref=SP_MAP_KPTS, max_ref_points=SP_REFINE_POINTS)
    world = rscene.world
    n_class = int(rscene.map.seg_vrf_slot.shape[0]) + 1
    dmap = to_device(rscene.map, dev, desc_dtype=bf16)
    m_tok = int(dmap.frame_point_idx.shape[1])
    rng = np.random.RandomState(11)
    poses = [query_pose(rng) for _ in range(SP_QUERIES)]
    imgs = np.stack([world.render(R, t, SP_CAM, SP_W, SP_H) for R, t in poses]).astype(np.float32)
    imgs = apply_noise(imgs, np.random.RandomState(12))
    gt_q = torch.from_numpy(np.stack([_rotmat2qvec_np(R) for R, _ in poses])).double()
    gt_t = torch.from_numpy(np.stack([t for _, t in poses])).double()
    log(f"superpoint map: {rscene.map.num_points} points of 256-d SuperPoint descriptors, "
        f"{rscene.map.num_frames} frames of {m_tok} keypoints, {n_class} classes, built on the card in "
        f"{time.perf_counter() - t_b:.1f} s; {SP_QUERIES} noisy queries rendered at {SP_W} x {SP_H}")

    seg = SegNet(SegNetConfig(n_class=n_class)).to(dev, bf16).eval()
    gm = GM(GMConfig(descriptor_dim=256)).to(dev, bf16).eval()
    loc_cfg = LocConfig(seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128, gn_iters=5, lo_rounds=1,
                        do_refinement=True)
    matchers = {"gm": make_gm_match_fn(gm, gm.config.match_threshold), "nn": make_nn_match_fn()}
    wide = sinkhorn.instance(conf["max_keypoints"], m_tok, dev)[0] == sinkhorn.WIDE
    plan_key = "sinkhorn_wide" if wide else "sinkhorn"
    batches = [slice(s, s + SP_BATCH) for s in range(0, SP_QUERIES, SP_BATCH)]

    def front(qi, use_nms_kernel=True):
        return sp_front(torch, np, dev, sp, seg, world, imgs[qi], poses[qi], n_class, kw, use_nms_kernel)

    for name, fn in matchers.items():
        loc = Localizer(dmap, fn, loc_cfg)
        reset_counts()
        with torch.no_grad():
            res, preds = [], []
            for i, qi in enumerate(batches):
                f, pred, args = front(qi)
                preds.append(pred)
                res.append(loc.localize_batch(torch.Generator().manual_seed(7 + i), *args))
        torch.cuda.synchronize()
        got = read_counts()
        n_b = len(batches)
        want = {"nms": n_b, "refine_nn": n_b, "ransac_score": 2 * n_b, "gn_polish": 2 * n_b}
        if name == "gm":
            want[plan_key] = n_b
        log(f"superpoint path ({name}) launches ({SP_QUERIES} queries in batches of {SP_BATCH}): {got}")
        require(got == {k: want.get(k, 0) for k in names_all},
                f"superpoint path ({name}): launches {got}, expected {want} and no other")
        require(all(bool(torch.isfinite(p).all()) and p.shape[-1] == n_class for p in preds),
                "superpoint path: SegNet's prediction is not finite or not of the scene's classes")
        qv = torch.cat([r.qvec.cpu() for r in res]).double()
        tv = torch.cat([r.tvec.cpu() for r in res]).double()
        ok = torch.cat([r.success.cpu() for r in res])
        dq, dt = compute_pose_error(qv, tv, gt_q, gt_t)
        recall = float(((dq < 5.0) & (dt < 0.05) & ok).float().mean())
        gen = torch.Generator()

        def one_batch():
            with torch.no_grad():
                _, _, a = front(batches[0])
                loc.localize_batch(gen.manual_seed(7), *a)
            torch.cuda.synchronize()

        batch_s = median_s(one_batch, 3)
        out["paths"][name] = dict(launches=got, recall=recall, n_success=int(ok.sum()), batch_ms=batch_s * 1e3,
                                  queries_per_s=SP_BATCH / batch_s)
        log(f"superpoint path ({name}): recall@5cm/5deg {recall:.4f} ({int(ok.sum())}/{SP_QUERIES} localized; "
            f"seeded SuperPoint, SegNet and GM, routed by the ground truth: a record, not a gate); a batch of "
            f"{SP_BATCH} (extraction, SegNet, matching, localization) in {batch_s * 1e3:.2f} ms (median of 3, host "
            f"clock, synchronized) = {SP_BATCH / batch_s:.2f} queries/s")

    # kernel 9 at R = 3 on SuperPoint's score maps of the 32 queries
    with torch.no_grad():
        x_all = sp_mod.preprocess_image(torch.as_tensor(imgs).to(dev)).to(bf16)
        smap = torch.cat([sp(x_all[qi])["score_map"] for qi in batches])
    r = kw["nms_radius"]
    for tname, sm in (("bf16", smap), ("f32", smap.float())):
        got_n, ref_n = nms.nms(sm, r), nms.simple_nms(sm, r)
        diff = int((got_n != ref_n).sum().item())
        log(f"nms R = {r} ({tname}, {tuple(sm.shape)}): {diff} elements differ of {ref_n.numel()}; "
            f"{int((ref_n > 0).sum().item())} maxima survive")
        require(diff == 0, f"nms R = {r} ({tname}) kernel is not bit-equal to its plain version")
        require(torch.equal(nms.nms(sm, r), got_n), f"nms R = {r} ({tname}): two launches differ")
    n_px = smap.numel()
    nms_ops = n_px * (3 * 2 * 3 + 2 * 6 * r / 32 + 3 + 2 * 2 + 1)
    out["kernels"]["nms"] = at_shape(torch, lambda: nms.nms(smap, r), lambda: nms.simple_nms(smap, r), 0.0,
                                     [*smap.shape, r], bound_ms(2 * n_px * smap.element_size(), nms_ops, F32_FLOPS),
                                     plain_iters=5)
    smap32 = smap.float()
    out["kernels"]["nms"].update(
        f32_ms=cuda_ms(torch, lambda: nms.nms(smap32, r), iters=10),
        f32_plain_ms=cuda_ms(torch, lambda: nms.simple_nms(smap32, r), iters=3, warmup=1),
        device_ms=launch_ms(torch, lambda: nms.nms(smap, r), want=lambda k: k == "nms_kernel").get("nms_kernel"))
    del smap32, x_all

    # extraction, kernel path against plain path (bf16)
    with torch.no_grad():
        fa = front(batches[0])[0]
        fb = front(batches[0], use_nms_kernel=False)[0]
    ab = extraction_agreement(fa, fb)
    log(f"superpoint extraction A/B (bf16, {SP_BATCH} queries, kernel 9 vs simple_nms): {json.dumps(ab)}")
    require(ab["kpt_set_agreement"] >= AB_BF16[0] and ab["desc_cos_min"] >= AB_BF16[1],
            f"superpoint extraction A/B below {AB_BF16}")
    out["extraction_ab"] = ab
    del fa, fb

    # kernels 7 (256-d) and 6 on the inputs the GM path gave them (batch 0)
    loc = Localizer(dmap, matchers["gm"], loc_cfg)
    with torch.no_grad(), recording_first([(loc_mod, "refine_nn"), (gm_mod, "sinkhorn")]) as seen:
        loc.localize_batch(torch.Generator().manual_seed(7), *front(batches[0])[2])
    with torch.no_grad():
        ra, _ = seen["refine_nn"]
        descs, pdesc, kpts, uv, in_img, qmask, gate_r, ratio = ra
        b, n, d = descs.shape
        p = pdesc.shape[1]
        require(d == 256, f"refine_nn on the superpoint path took {d}-d descriptors")
        idx, d1, keep = refine.refine_nn(*ra)
        ridx, rd1, rkeep = refine.refine_nn_plain(*ra)
        sim = descs.float() @ pdesc.float().transpose(-1, -2)
        dist = torch.sqrt(torch.clamp(2.0 - 2.0 * sim + 1e-6, min=0.0))
        gate = (torch.linalg.norm(kpts[:, :, None, :] - uv[:, None], dim=-1) < gate_r) & in_img[:, None]
        top2 = torch.where(gate, dist, dist + 100.0).topk(2, dim=-1, largest=False).values
        del sim, dist, gate
        decided = ((top2[..., 1] - top2[..., 0]) > REFINE_D1_ATOL) & \
            ((top2[..., 0] - ratio * top2[..., 1]).abs() > REFINE_D1_ATOL)
        bad = int(((idx != ridx) | (keep != rkeep))[decided].sum())
        err = float((d1 - rd1).abs().max())
        log(f"refine_nn 256-d ({b} x {n} x {p}): {int(decided.sum())} of {b * n} queries decided beyond "
            f"{REFINE_D1_ATOL}, {bad} of them differ; all queries: nn_idx agree "
            f"{float((idx == ridx).float().mean()):.5f}, keep {float((keep == rkeep).float().mean()):.5f}, "
            f"d1 max abs err {err:.3e}; kept {int(keep.sum())}")
        require(bad == 0, "refine_nn 256-d: a decided query differs from the plain version")
        require(err <= REFINE_D1_ATOL, "refine_nn 256-d: d1 disagrees with the plain version")
        out["kernels"]["refine_nn"] = at_shape(torch, lambda: refine.refine_nn(*ra), lambda: refine.refine_nn_plain(*ra),
                                               err, [b, n, p, d], tuple(refine_bound(b, n, p, d).values()))
        out["kernels"]["refine_nn"].update(decided=int(decided.sum()), queries=b * n, ptxas=ptxas_summary(build, "refine.cu"))
        del top2, decided

        (sim, dustbin, iters, sm0, sm1), _ = seen["sinkhorn"]
        b, n, m = sim.shape
        plan = sinkhorn.sinkhorn(sim, dustbin, iters, sm0, sm1)
        ref = sinkhorn.sinkhorn_matching(sim, dustbin, iters, sm0, sm1)
        if wide:
            controls = {"plain in bf16": sinkhorn.sinkhorn_matching(sim.bfloat16(), dustbin, iters, sm0, sm1).float(),
                        f"plain, {iters - 1} iterations": sinkhorn.sinkhorn_matching(sim, dustbin, iters - 1, sm0, sm1)}
            err = check_wide_plan(f"{plan_key} (GM, {b} x {n + 1} x {m + 1})", plan, ref, controls, n, m)["max_abs_err"]
            del controls
        else:
            err = check_plan(f"sinkhorn (GM, {b} x {n + 1} x {m + 1})", plan, ref, n, m)
        rows_ok = sm0 if sm0 is not None else torch.ones(b, n, dtype=torch.bool, device=dev)
        agree = float((plan[:, :n].argmax(-1) == ref[:, :n].argmax(-1))[rows_ok].float().mean())
        log(f"{plan_key} (GM): row argmax agrees on {agree:.5f} of the {int(rows_ok.sum())} valid rows")
        require(agree >= REFINE_AGREE, f"{plan_key} (GM): row argmax agrees on {agree:.5f} of the rows")
        out["kernels"][plan_key] = at_shape(
            torch, lambda: sinkhorn.sinkhorn(sim, dustbin, iters, sm0, sm1),
            lambda: sinkhorn.sinkhorn_matching(sim, dustbin, iters, sm0, sm1), err, [b, n + 1, m + 1],
            bound_ms(*sinkhorn_cost(b, n, m, iters), F32_FLOPS))
        out["kernels"][plan_key]["argmax_agree"] = agree
        del plan, ref, seen
    for kname, k in out["kernels"].items():
        log(f"{kname} on the superpoint path {k['shape']}: {k['ms']:.4f} ms (CUDA events), plain "
            f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']})")

    # the first queries of each matcher on the card and on the card
    # machine's CPU (bf16, the plain versions), the card's triplets fed to
    # the CPU, the card's features
    cpu_map = to_device(rscene.map, "cpu", desc_dtype=bf16)
    sub = slice(0, SP_CPU_QUERIES)

    def recording(fn, store):
        def wrapped(*a):
            store.append(fn(*a))
            return store[-1]
        return wrapped

    for name in matchers:
        t_cpu = time.perf_counter()
        found = {"card": [], "cpu": []}
        with torch.no_grad():
            f, _, args = front(sub)
            with recording_triplets() as drawn:
                res_g = Localizer(dmap, recording(matchers[name], found["card"]), loc_cfg).localize_batch(
                    torch.Generator().manual_seed(3), *args)
            cpu_fn = make_nn_match_fn() if name == "nn" else make_gm_match_fn(
                GM(GMConfig(descriptor_dim=256)).to(bf16).eval(), gm.config.match_threshold)
            res_c = Localizer(cpu_map, recording(cpu_fn, found["cpu"]), loc_cfg).localize_batch(
                torch.Generator().manual_seed(3), *to_cpu_args(args), triplets=drawn[0].cpu(),
                refine_triplets=drawn[1].cpu())
        cmp = card_vs_cpu(torch, f"superpoint path ({name}, {SP_CPU_QUERIES} queries)", res_g, res_c)
        # the first stage's matches (a record: the flags are vacuous where
        # a seeded model localizes nothing on either side)
        m_card, m_cpu = found["card"][0].cpu(), found["cpu"][0]
        valid = args[4].cpu().repeat_interleave(m_card.shape[0] // args[4].shape[0], 0)
        cmp.update(match_agree=float((m_card == m_cpu)[valid].float().mean()),
                   matches_card=int((m_card[valid] >= 0).sum()), matches_cpu=int((m_cpu[valid] >= 0).sum()),
                   inliers_card=res_g.num_inliers.tolist(), inliers_cpu=res_c.num_inliers.tolist(),
                   cpu_s=time.perf_counter() - t_cpu)
        log(f"superpoint path ({name}) card vs CPU, first-stage matches: agree on {cmp['match_agree']:.5f} of the "
            f"valid query keypoints, {cmp['matches_card']} vs {cmp['matches_cpu']} matches; inliers "
            f"{cmp['inliers_card']} vs {cmp['inliers_cpu']}; the CPU side {cmp['cpu_s']:.1f} s")
        out["paths"][name]["card_vs_cpu"] = cmp
    del dmap, cpu_map, gm, seg, sp
    return out


def run_segnet_gm_cli_phase(torch, np, dev, bf16, scene, queries, reset_counts, read_counts) -> dict:
    """Phase 29: cli.inference with network segnet and matching_method gm
    (GMConfig(), the JAX CLI's) on phase 22's offline layout, counted, and
    its first queries on the card and with --device cpu; the superpoint-n4096
    extractor of cli.extract_features on rendered PNG frames, build_compressor
    on SFD2 descriptors and RetNet on SFD2 mid_features, each against the
    CPU."""
    import tempfile

    from pram_tpu_torch.cli import extract_features as cli_extract
    from pram_tpu_torch.cli import inference as cli_inference
    from pram_tpu_torch.engine import localizer as loc_mod
    from pram_tpu_torch.engine.rendered_guard import SFD2_W, extraction_agreement
    from pram_tpu_torch.maps.rendered import make_world
    from pram_tpu_torch.models.convert import load_sfd2
    from pram_tpu_torch.models.retnet import RetNet
    from pram_tpu_torch.models.sfd2 import extract as sfd2_extract
    from pram_tpu_torch.models.sfd2 import preprocess_image as sfd2_pre
    from pram_tpu_torch.ops import sinkhorn

    n_q = len(queries)
    names_all = set(read_counts())
    out = {}
    with tempfile.TemporaryDirectory(prefix="pram_cli_segnet_gm_") as tmp:
        tmp = Path(tmp)
        names = [f"query_{i:03d}.png" for i in range(n_q)]
        top = {"network": "segnet", "feat_dim": 128, "use_mid_feature": False, "layers": 9,
               "eval_max_keypoints": 512,
               "localization": {"seg_k": 1, "threshold": 8.0, "min_inliers": 32, "do_refinement": True,
                                "matching_method": "gm", "refinement_method": "projection", "with_compress": True}}
        cfg = synthetic_layout(tmp / "offline", scene, queries, names, 112, top)
        reset_counts()
        report, lines = run_cli("inference (segnet + gm)", cli_inference.main, ["--config", str(cfg), "--batch",
                                                                               str(n_q)])
        torch.cuda.synchronize()
        got = read_counts()
        wide = sinkhorn.instance(512, int(scene.map.frame_point_idx.shape[1]), dev)[0] == sinkhorn.WIDE
        plan_key = "sinkhorn_wide" if wide else "sinkhorn"
        want = add_launches({plan_key: 1}, PNP_LAUNCHES)
        log(f"inference CLI (segnet + gm) launches: {got}")
        require(got == {k: want.get(k, 0) for k in names_all},
                f"inference CLI (segnet + gm): launches {got}, expected {want} and no other")
        require(report.n_total == n_q, "inference CLI (segnet + gm): not every query was evaluated")
        stage = next(line for line in lines if line.startswith("stage times:"))
        cfg4 = write_configs(tmp / "offline", "Synthetic", "scene", 112, top, config_dir=tmp / "offline_4",
                             image_list="imglist_4.txt")
        argv4 = ["--config", str(cfg4), "--batch", "4"]
        # the runs' results, by side; the evaluator draws the same triplets on
        # both from its seeded CPU generator
        found, side = {}, ["card"]
        real = loc_mod.Localizer.localize_batch

        def recording(self, *a, **k):
            res = real(self, *a, **k)
            found.setdefault(side[0], []).append(res)
            return res

        loc_mod.Localizer.localize_batch = recording
        try:
            card4, _ = run_cli("inference (segnet + gm), 4 queries", cli_inference.main, argv4)
            t_cpu = time.perf_counter()
            side[0] = "cpu"
            cpu4, _ = run_cli("inference (segnet + gm), 4 queries, --device cpu", cli_inference.main,
                              argv4 + ["--device", "cpu"])
        finally:
            loc_mod.Localizer.localize_batch = real
        cpu_s = time.perf_counter() - t_cpu
        require(card4.failed_cases == cpu4.failed_cases, "inference CLI (segnet + gm): success flags differ card vs CPU")
        cmp = card_vs_cpu(torch, "inference CLI (segnet + gm), 4 queries", found["card"][0], found["cpu"][0])
        out["inference"] = dict(launches=got, n_success=report.n_success, fps=report.fps(), stage_times=stage,
                                card_vs_cpu=dict(cmp, failed_card=card4.failed_cases, failed_cpu=cpu4.failed_cases,
                                                 cpu_s=cpu_s))
        log(f"inference CLI (segnet + gm) on card: {report.n_success}/{n_q} localized (seeded SegNet nc113 and "
            f"GM: no recall figure), {report.fps():.1f} queries/s over one batch of {n_q}, {stage}; 4 queries on "
            f"the CPU in {cpu_s:.1f} s")

        # the superpoint-n4096 extractor through the CLI's builder on PNG frames
        world = make_world(np.random.RandomState(0))
        imgs, _, _ = rendered_path(world, 4, jumps=())
        paths = []
        for i, img in enumerate(imgs):
            paths.append(tmp / f"frame_{i:03d}.png")
            write_png(paths[-1], uint8_image(np, img))
        conf = cli_extract.CONFS["superpoint-n4096"]
        gray = np.stack([cli_extract.load_image(str(p), conf["preprocessing"]["grayscale"], None)[0] for p in paths])
        kw = {k: conf["model"][k] for k in ("max_keypoints", "conf_th", "min_keypoints", "nms_radius")}
        model, extract, pre = cli_extract.build_extractor(conf, None, dev)
        reset_counts()
        with torch.no_grad():
            fc = extract(model, pre(torch.from_numpy(gray).to(dev)).to(model.convDb.weight.dtype), **kw)
        torch.cuda.synchronize()
        got_x = read_counts()
        require(got_x == {k: (1 if k == "nms" else 0) for k in names_all},
                f"superpoint-n4096 extractor: launches {got_x}, expected one nms")
        model_cpu, _, _ = cli_extract.build_extractor(conf, None, "cpu")
        with torch.no_grad():
            f32_card = extract(model.float(), pre(torch.from_numpy(gray[:2]).to(dev)), **kw)
            f32_cpu = extract(model_cpu, pre(torch.from_numpy(gray[:2])), **kw)
        ab = extraction_agreement(f32_card, f32_cpu)
        log(f"superpoint-n4096 extractor (cli.extract_features.build_extractor) on 4 PNG frames: "
            f"{int(fc['keypoints'].mask.sum())} keypoints, launches {got_x}; card f32 vs CPU f32 on 2 frames: "
            f"{json.dumps(ab)}")
        require(ab["kpt_set_agreement"] >= AB_F32[0] and ab["desc_cos_min"] >= AB_F32[1],
                f"superpoint-n4096 extractor: card vs CPU below {AB_F32}")
        del model, model_cpu, f32_card, f32_cpu

        # build_compressor(64) on SFD2 descriptors, RetNet on SFD2 mid_features
        sfd2 = load_sfd2(SFD2_W, device=dev, dtype=bf16)
        with torch.no_grad():
            fs = sfd2_extract(sfd2, sfd2_pre(torch.from_numpy(imgs[:2]).to(dev)).to(bf16), max_keypoints=512,
                              conf_th=1e-4)
        descs = fs["descriptors"].float()
        mid = fs["mid_features"].float()
        comp_card = cli_extract.build_compressor(64, None, dev)
        comp_cpu = cli_extract.build_compressor(64, None, "cpu")
        cg, cc = comp_card(descs).float().cpu(), comp_cpu(descs.cpu())
        m = fs["keypoints"].mask.cpu()
        comp_cos = float((cg * cc).sum(-1)[m].min())
        torch.manual_seed(0)
        ret = RetNet().eval()
        ret_card = RetNet().eval()
        ret_card.load_state_dict(ret.state_dict())
        ret_card = ret_card.to(dev, bf16)
        with torch.no_grad():
            rg = ret_card(mid.to(bf16)).float().cpu()
            rc = ret(mid.cpu())
        ret_cos = float((rg * rc).sum(-1).min())
        log(f"build_compressor(64) on SFD2 descriptors ({tuple(descs.shape)}): card bf16 vs CPU f32 cosine min "
            f"{comp_cos:.5f}; RetNet on SFD2 mid_features ({tuple(mid.shape)}) -> {tuple(rg.shape)}: card bf16 vs "
            f"CPU f32 cosine min {ret_cos:.5f} (min {BF16_COS_MIN})")
        require(cg.shape[-1] == 64 and comp_cos >= BF16_COS_MIN, "build_compressor: card vs CPU below the bound")
        require(rg.shape == (2, 1024) and ret_cos >= BF16_COS_MIN, "RetNet: card vs CPU below the bound")
        out["extractor"] = dict(launches=got_x, keypoints=int(fc["keypoints"].mask.sum()), card_vs_cpu_f32=ab)
        out["compressor_cos_min"] = comp_cos
        out["retnet_cos_min"] = ret_cos
        del sfd2, ret, ret_card
    return out



# ---- phase 30: map building (the offline landmark pipeline) on the card, at
# a real mapping run's size: 64 reference views of the image slice's textured
# world at 480 x 640, SFD2 (bf16, kernels 8 and 9) at 2048 keypoints a view,
# 8 nearest views a view, mutual-NN matching on the card (cli/match_features
# .py's NNM), triangulation with the known poses, then cli.build_map with
# KMeans and with Birch; the KMeans map localizes phase 10's 32 queries
MAP_VIEWS, MAP_W, MAP_H, MAP_FOCAL = 64, 640, 480, 500.0
MAP_KPTS = 2048
MAP_QUERIES = 32  # phase 10's noisy queries (seed 11)
MAP_PAIRS = 8
MAP_MATCH_BATCH = 64  # pairs a mutual-NN call
MAP_EXTRACT_BATCH = 16  # views an SFD2 call
# cli.build_map's flags: the landmark count of the image slice's scene (16
# clusters), xyz as the rendered world is a room and not a street; a frame
# becomes a VRF candidate with 300 of its ~1000 triangulated keypoints (the
# reference's 120-250 on views of 4096); the compression's 8 px keeps a
# covisible frame's points away from those kept (its 2048 keypoints sit
# ~12 px apart; the reference's 15-64 px are for 4096 keypoints on larger
# images); Birch at the CLI's default threshold, the reference's 0.01 for
# indoor scenes
MAP_N_CLUSTER = 16
MAP_FLAGS = ["--n_cluster", str(MAP_N_CLUSTER), "--cluster_mode", "xyz", "--vrf_min_obs", "300",
             "--compress_radius", "8"]
# the localizer's tables: the image slice's caps (frames of 1024 points, 2048
# refinement points), which keep GML's frame side on kernel 6's cluster
# instance (m + 1 <= 1152)
MAP_LOAD_CAPS = dict(max_kp_per_frame=1024, max_ref_points=2048)
MAP_ROUTE_RADIUS = 0.25  # a query keypoint takes the label of the map point nearest its lift within this
MAP_LIFT_AGREE = 0.03  # a track the ground truth confirms: every observation lifts within this of the first's
MAP_RECALL_MIN = 31 / 32
# card vs CPU builds: KMeans labels (f32 sums in another order) and the
# track descriptor (its median ties within the sums' rounding) by share;
# Birch is host code on both sides, so equal
MAP_KMEANS_AGREE = 0.999
MAP_DESC_AGREE, MAP_DESC_MEDIAN_TOL = 0.999, 1e-5
# scale timings: KMeans over 10^6 points at the Aachen config's 512
# clusters, 50 iterations; best_of over 65536 tracks of up to 64 views of
# 128-d descriptors
SCALE_KMEANS = (1_000_000, 512, 50)
SCALE_TRACKS = (65536, 64, 128)


def nearest_view_pairs(np, poses, names, k: int) -> list:
    """``(name_i, name_j)`` for each view and its ``k`` nearest views by camera
    centre, nearest first."""
    centres = np.array([-R.T @ t for R, t in poses])
    d = np.linalg.norm(centres[:, None] - centres[None], axis=-1)
    pairs = []
    for i in range(len(poses)):
        near = [j for j in np.argsort(d[i], kind="stable") if j != i][:k]
        pairs += [(names[i], names[j]) for j in near]
    return pairs


def route_by_lift(np, world, kpts, mask, poses, cam, point_xyz, point_seg, n_class: int):
    """Logits ``[B, N, n_class]`` that route queries by the ground truth over
    a built map's labels: +10 at 1 + the label of the map point nearest the
    world point each keypoint lifts to (within MAP_ROUTE_RADIUS; else class
    0, the background), -10 elsewhere."""
    from scipy.spatial import cKDTree

    tree = cKDTree(point_xyz)
    b, n = mask.shape
    logits = np.full((b, n, n_class), -10.0, np.float32)
    for i, (R, t) in enumerate(poses):
        xyz, _, _, _, ok = world.lift(kpts[i].astype(np.float64), R, t, cam)
        dist, nn = tree.query(xyz)
        cls = np.where(ok & mask[i] & (dist <= MAP_ROUTE_RADIUS), point_seg[nn] + 1, 0)
        logits[i, np.arange(n), cls] = 10.0
    return logits


def surface_distances(np, world, points, poses, names, kp_by_name, cam):
    """Each triangulated point's distance to the surface point its first
    observation lifts to (``TexturedWorld.lift``), and that distance's
    ``[count, median, p90]`` over the readings that tell its causes apart:
    tracks of 3 or more views; points the ground truth confirms (every
    observation lifts within MAP_LIFT_AGREE of the first's: no look-alike
    match); those of both; and confirmed points by their widest triangulation
    angle (the depth's spread grows as the angle shrinks)."""
    obs_by_img = {}
    for pid, p in points.items():
        for o, (iid, k) in enumerate(zip(p.image_ids, p.point2D_idxs)):
            obs_by_img.setdefault(int(iid), []).append((pid, o, int(k)))
    lifts = {pid: np.full((len(p.image_ids), 3), np.nan) for pid, p in points.items()}
    for iid, obs in obs_by_img.items():
        R, t = poses[iid - 1]
        gt, _, _, _, ok = world.lift(kp_by_name[names[iid - 1]][[k for _, _, k in obs]].astype(np.float64), R, t, cam)
        for (pid, o, _), x, v in zip(obs, gt, ok):
            if v:
                lifts[pid][o] = x
    centres = np.array([-R.T @ t for R, t in poses])
    rows = []  # (distance, track length, confirmed, widest angle in degrees)
    for pid, p in points.items():
        lift = lifts[pid]
        if not np.isfinite(lift[0]).all():
            continue
        rays = p.xyz[None] - centres[np.asarray(p.image_ids) - 1]
        rays /= np.linalg.norm(rays, axis=1, keepdims=True)
        angle = np.degrees(np.arccos(np.clip((rays @ rays.T).min(), -1.0, 1.0)))
        confirmed = bool(np.isfinite(lift).all() and (np.linalg.norm(lift - lift[0], axis=1) <= MAP_LIFT_AGREE).all())
        rows.append((np.linalg.norm(p.xyz - lift[0]), len(p.image_ids), confirmed, angle))
    d, n, c, a = (np.array(x) for x in zip(*rows))
    stat = lambda sel: [int(sel.sum()), float(np.median(d[sel])), float(np.percentile(d[sel], 90))] if sel.any() \
        else [0, None, None]
    by = {"track3": stat(n >= 3), "confirmed": stat(c), "confirmed_track3": stat(c & (n >= 3))}
    for lo, hi in ((0, 5), (5, 15), (15, 180)):
        by[f"confirmed_angle_{lo}_{hi}"] = stat(c & (a >= lo) & (a < hi))
    return d, by


def same_records(a, b) -> bool:
    """Nested dicts / lists / arrays equal."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(same_records(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(map(same_records, a, b))
    if hasattr(a, "shape"):
        return hasattr(b, "shape") and a.shape == b.shape and bool((a == b).all())
    return a == b


def compare_builds(np, card_dir: Path, cpu_dir: Path, tag: str, tracks: dict) -> dict:
    """The card's and the CPU's builds of one method: labels, track
    descriptors (by the medians where the choice differs), VRFs of the
    segments whose points agree, the compressed model's point ids."""
    from pram_tpu_torch.maps.colmap_io import read_compressed_model

    load = lambda d, f: np.load(d / f, allow_pickle=True)[()]
    cg, cc = load(card_dir, f"point3D_cluster_{tag}.npy"), load(cpu_dir, f"point3D_cluster_{tag}.npy")
    require(np.array_equal(cg["id"], cc["id"]), f"{tag}: clustered points differ card vs CPU")
    label_agree = float((cg["label"] == cc["label"]).mean())
    dg, dc = load(card_dir, "point3D_desc.npy"), load(cpu_dir, "point3D_desc.npy")
    require(list(dg) == list(dc), f"{tag}: described points differ card vs CPU")
    differ, gap = 0, 0.0
    for pid, d in dg.items():
        if np.array_equal(d, dc[pid]):
            continue
        differ += 1
        t = tracks[pid].astype(np.float64)
        med = np.median(2.0 - 2.0 * t @ t.T, axis=1)
        i, j = (int(np.nonzero((tracks[pid] == x).all(1))[0][0]) for x in (d, dc[pid]))
        gap = max(gap, abs(float(med[i] - med[j])))
    members = {}
    for side, c in (("card", cg), ("cpu", cc)):
        for pid, lab in zip(c["id"], c["label"]):
            members.setdefault(side, {}).setdefault(int(lab), set()).add(int(pid))
    same_segs = [s for s, m in members["card"].items() if members["cpu"].get(s) == m]
    vg, vc = load(card_dir, f"point3D_vrf_{tag}.npy"), load(cpu_dir, f"point3D_vrf_{tag}.npy")
    vrf_equal = all(same_records(vg.get(s), vc.get(s)) for s in same_segs)
    # the compression is host code over the shared model, seeded by each
    # segment's first VRF: equal seeds must give equal point ids, whether or
    # not every label agrees
    seeds = lambda v: [int(r[0]["image_id"]) for r in v.values() if 0 in r]
    method = tag.split("_")[-1]
    pg = set(read_compressed_model(str(card_dir / f"compress_model_{method}"), ".bin")[2])
    pc = set(read_compressed_model(str(cpu_dir / f"compress_model_{method}"), ".bin")[2])
    return dict(label_agree=label_agree, desc_agree=1.0 - differ / max(len(dg), 1), desc_differ=differ,
                desc_median_gap_max=gap, segments=len(members["card"]), segments_same=len(same_segs),
                vrf_equal_on_same_segments=vrf_equal, vrf_seeds_equal=seeds(vg) == seeds(vc),
                compressed_points=[len(pg), len(pc)], compressed_equal=pg == pc)


def localize_built_map(torch, np, dev, bf16, sfd2, landmarks, world, queries, reset_counts, read_counts,
                       path_kernels, what: str) -> dict:
    """The KMeans map under ``landmarks``, loaded as a user loads it, localizes
    ``queries`` (images, qvecs, tvecs): SFD2 at 512 keypoints, GML, the
    localizer at the image slice's settings, routed by the ground truth;
    counted once, then timed (median of 3). Requires every kernel of
    ``path_kernels`` launched and recall@5cm/5deg >= MAP_RECALL_MIN."""
    from pram_tpu_torch.engine.localizer import LocConfig, Localizer
    from pram_tpu_torch.engine.matching import make_gml_match_fn
    from pram_tpu_torch.engine.rendered_guard import GML_W
    from pram_tpu_torch.geometry.camera import Camera
    from pram_tpu_torch.geometry.rotations import compute_pose_error
    from pram_tpu_torch.maps.device import to_device
    from pram_tpu_torch.maps.loader import load_scene_map
    from pram_tpu_torch.maps.packed import _qvec2rotmat_np
    from pram_tpu_torch.models.convert import load_gml
    from pram_tpu_torch.models.gml import GMLConfig
    from pram_tpu_torch.models.sfd2 import extract, preprocess_image

    cam = (MAP_FOCAL, MAP_FOCAL, MAP_W / 2, MAP_H / 2)
    q_imgs, q_qvecs, q_tvecs = queries
    nq = len(q_imgs)
    pmap = load_scene_map(str(landmarks), n_cluster=MAP_N_CLUSTER, cluster_mode="xyz", cluster_method="kmeans",
                          with_compress=True, **MAP_LOAD_CAPS)
    gml = load_gml(GML_W, GMLConfig(), device=dev, dtype=bf16)
    cfg = LocConfig(seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128, do_refinement=True,
                    gn_iters=5, lo_rounds=1)
    loc = Localizer(to_device(pmap, dev, desc_dtype=bf16), make_gml_match_fn(gml, gml.config.match_threshold),
                    cfg)
    q_poses = [(_qvec2rotmat_np(q), tv.astype(np.float64)) for q, tv in zip(q_qvecs, q_tvecs)]
    camera = Camera(torch.tensor([[*cam, 0.0, 0.0, 0.0, 0.0]] * nq, device=dev),
                    torch.tensor([[float(MAP_W), float(MAP_H)]] * nq, device=dev))

    def localize(route=None):
        """(features, logits, result, extraction s, localization s)."""
        with torch.no_grad():
            t0 = time.perf_counter()
            f = extract(sfd2, preprocess_image(torch.from_numpy(q_imgs).to(dev)).to(bf16), max_keypoints=512,
                        conf_th=1e-4)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            k = f["keypoints"]
            logits = route if route is not None else torch.from_numpy(route_by_lift(
                np, world, k.xy.cpu().numpy(), k.mask.cpu().numpy(), q_poses, cam, pmap.point_xyz,
                pmap.point_seg, pmap.n_class)).to(dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            res = loc.localize_batch(torch.Generator().manual_seed(7), camera, k.xy, k.scores.float(),
                                     f["descriptors"].to(bf16), k.mask, logits)
            torch.cuda.synchronize()
            return f, logits, res, t1 - t0, time.perf_counter() - t2

    reset_counts()
    f, logits, res, _, _ = localize()
    launches = read_counts()
    log(f"{what}: localization launches {launches}")
    for name in path_kernels:
        require(launches[name] > 0, f"{what}: kernel {name} was not launched on the built map's path")
    qe, te = compute_pose_error(res.qvec.cpu(), res.tvec.cpu(), torch.from_numpy(q_qvecs).float(),
                                torch.from_numpy(q_tvecs))
    ok = res.success.cpu() & (te < 0.05) & (qe < 5.0)
    runs = [localize(logits) for _ in range(3)]
    ext_s, loc_s = sorted(r[3] for r in runs)[1], sorted(r[4] for r in runs)[1]
    out = dict(
        map_points=pmap.num_points, map_frames=pmap.num_frames, n_class=pmap.n_class,
        recall=int(ok.sum()) / nq, n_ok=int(ok.sum()), success=int(res.success.sum()),
        median_t_err=float(te.median()), median_q_err=float(qe.median()),
        routed_share=float((logits.argmax(-1) > 0)[f["keypoints"].mask].float().mean()),
        extract_ms=ext_s * 1e3, localize_ms=loc_s * 1e3, queries_per_s=nq / (ext_s + loc_s),
        launches=launches)
    log(f"{what}: the KMeans map localized {int(ok.sum())}/{nq} queries within 5 cm / 5 deg "
        f"{json.dumps({k: v for k, v in out.items() if k != 'launches'})} (median of 3 runs by "
        f"host clock, synchronized; the ground-truth routing excluded)")
    require(ok.sum() >= MAP_RECALL_MIN * nq, f"{what}: recall@5cm/5deg below 31/32 on the built map")
    del gml, loc
    return out


def run_mapping_phase(torch, np, dev, bf16, reset_counts, read_counts, path_kernels) -> dict:
    """Phase 30: the offline landmark pipeline on the card from the port's
    own SFD2 features (triangulation, cli.build_map with KMeans and Birch),
    the KMeans map localized through kernels 1-9, counted; the same build
    on the card machine's CPU, compared."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from pram_tpu_torch.cli import build_map as cli_build_map
    from pram_tpu_torch.engine.rendered_guard import SFD2_W, apply_noise, render_views
    from pram_tpu_torch.maps.colmap_io import ColmapCamera, ColmapImage, read_model
    from pram_tpu_torch.maps.parsers import parse_retrieval
    from pram_tpu_torch.maps.rendered import make_world, ref_poses
    from pram_tpu_torch.maps.synthetic import _rotmat2qvec_np
    from pram_tpu_torch.mapping.triangulate import triangulate_model
    from pram_tpu_torch.models.convert import load_sfd2
    from pram_tpu_torch.models.nn_matcher import mutual_nn_match
    from pram_tpu_torch.models.sfd2 import extract, preprocess_image

    out, secs = {}, {}
    cam = (MAP_FOCAL, MAP_FOCAL, MAP_W / 2, MAP_H / 2)
    with tempfile.TemporaryDirectory(prefix="pram_mapping_") as tmp:
        tmp = Path(tmp)
        # 1. reference views of the image slice's world, rendered on the host
        t = time.perf_counter()
        wrng = np.random.RandomState(0)
        world = make_world(wrng)
        poses = ref_poses(MAP_VIEWS, wrng)
        with ThreadPoolExecutor(8) as pool:
            imgs = np.stack(list(pool.map(lambda p: world.render(*p, cam, MAP_W, MAP_H), poses))).astype(np.float32)
        secs["render"] = time.perf_counter() - t

        # 2. SFD2 on the card (bf16: kernels 8 and 9), written as FeatureSource's npy directory
        t = time.perf_counter()
        sfd2 = load_sfd2(SFD2_W, device=dev, dtype=bf16)
        names = [f"db/view_{i:03d}.png" for i in range(MAP_VIEWS)]
        feats_dir = tmp / "features"
        feats_dir.mkdir()
        kp_by_name, desc_by_name = {}, {}
        with torch.no_grad():
            for s in range(0, MAP_VIEWS, MAP_EXTRACT_BATCH):
                x = preprocess_image(torch.from_numpy(imgs[s:s + MAP_EXTRACT_BATCH]).to(dev)).to(bf16)
                f = extract(sfd2, x, max_keypoints=MAP_KPTS, conf_th=1e-4)
                k = f["keypoints"]
                for j in range(x.shape[0]):
                    m = k.mask[j].cpu().numpy()
                    name = names[s + j]
                    kp_by_name[name] = k.xy[j].cpu().numpy()[m].astype(np.float32)
                    desc_by_name[name] = f["descriptors"][j].float().cpu().numpy()[m]
                    np.save(feats_dir / (name.replace("/", "+") + ".npy"), {
                        "keypoints": kp_by_name[name], "scores": k.scores[j].float().cpu().numpy()[m],
                        "descriptors": desc_by_name[name], "image_size": np.array([MAP_W, MAP_H])})
        torch.cuda.synchronize()
        secs["extract"] = time.perf_counter() - t
        n_kp = [len(v) for v in kp_by_name.values()]

        # 3. pairs: the 8 nearest views by camera centre, through a retrieval file
        pairs_txt = tmp / "pairs.txt"
        pairs_txt.write_text("".join(f"{a} {b}\n" for a, b in nearest_view_pairs(np, poses, names, MAP_PAIRS)))
        pairs = [(q, r) for q, rs in parse_retrieval(str(pairs_txt)).items() for r in rs]

        # 4. mutual-NN matching of every pair on the card (cli/match_features.py's NNM)
        t = time.perf_counter()
        row = {n: i for i, n in enumerate(names)}
        dpad = torch.zeros(MAP_VIEWS, MAP_KPTS, desc_by_name[names[0]].shape[1], device=dev)
        mpad = torch.zeros(MAP_VIEWS, MAP_KPTS, dtype=torch.bool, device=dev)
        for n, d in desc_by_name.items():
            dpad[row[n], :len(d)] = torch.from_numpy(d).to(dev)
            mpad[row[n], :len(d)] = True
        matches = {}
        for s in range(0, len(pairs), MAP_MATCH_BATCH):
            chunk = pairs[s:s + MAP_MATCH_BATCH]
            i0 = torch.tensor([row[a] for a, _ in chunk], device=dev)
            i1 = torch.tensor([row[b] for _, b in chunk], device=dev)
            res = mutual_nn_match(dpad[i0], dpad[i1], mpad[i0], mpad[i1])
            m0, s0 = res.matches0.cpu().numpy(), res.scores0.cpu().numpy()
            for j, p in enumerate(chunk):
                idx = np.nonzero(m0[j] >= 0)[0]
                matches[p] = (np.stack([idx, m0[j][idx]], -1), s0[j][idx])
        torch.cuda.synchronize()
        secs["match"] = time.perf_counter() - t
        n_matches = [len(m) for m, _ in matches.values()]

        # 5. triangulation with the known poses (the sqlite database in the temporary directory)
        t = time.perf_counter()
        # the renderer's pixel centres sit at whole coordinates and COLMAP's at
        # half ones (triangulation adds 0.5 to every keypoint): the principal
        # point moves with them
        cameras = {1: ColmapCamera(1, "PINHOLE", MAP_W, MAP_H, np.array([*cam[:2], cam[2] + 0.5, cam[3] + 0.5]))}
        images = {i + 1: ColmapImage(i + 1, _rotmat2qvec_np(R), t_, 1, names[i], np.zeros((0, 2)),
                                     np.zeros(0, np.int64)) for i, (R, t_) in enumerate(poses)}
        model_dir = tmp / "model"
        tri = triangulate_model(cameras, images, kp_by_name, pairs, matches, str(model_dir))
        secs["triangulate"] = time.perf_counter() - t
        _, _, points = read_model(str(model_dir), ".bin")
        errs, by = surface_distances(np, world, points, poses, names, kp_by_name, cam)
        tri.update(seconds=secs["triangulate"], lift_err_median=float(np.median(errs)),
                   lift_err_p90=float(np.percentile(errs, 90)), lifted=len(errs), lift_err_by=by)
        log(f"mapping: {MAP_VIEWS} views of {MAP_H} x {MAP_W} rendered in {secs['render']:.2f} s (host, 8 threads); "
            f"SFD2 bf16 at {MAP_KPTS} keypoints {secs['extract']:.2f} s ({min(n_kp)}-{max(n_kp)} a view); "
            f"{len(pairs)} pairs matched by mutual NN on the card in {secs['match']:.2f} s ({np.mean(n_matches):.0f} "
            f"matches a pair); triangulation {json.dumps(tri)}")
        require(tri["num_points"] > 1000 and np.isfinite(errs).all(), "mapping: triangulation gave too few points")

        # tracks' descriptors, for the card vs CPU check of the descriptor choice
        tracks = {pid: np.stack([desc_by_name[names[i - 1]][k] for i, k in zip(p.image_ids, p.point2D_idxs)])
                  for pid, p in points.items()}

        # 6. cli.build_map through main(argv): KMeans and Birch, on the card, then on the CPU
        builds = {}
        for method in ("kmeans", "birch"):
            for side, device in (("card", str(dev)), ("cpu", "cpu")):
                d = tmp / f"landmarks_{method}_{side}"
                t = time.perf_counter()
                stages, _ = run_cli(f"build_map ({method}, {side})", cli_build_map.main, [
                    "--model", str(model_dir), "--features", str(feats_dir), "--output", str(d),
                    "--cluster_method", method, "--device", device, *MAP_FLAGS])
                builds[(method, side)] = dict(dir=d, seconds=time.perf_counter() - t,
                                              stages_ms={k: round(v, 3) for k, v in stages.items()})
        out["build"] = {f"{m}_{s}": {k: v for k, v in b.items() if k != "dir"} for (m, s), b in builds.items()}
        log(f"mapping: cli.build_map {json.dumps(out['build'])}")

        # 8. card vs CPU builds
        tag = f"n{MAP_N_CLUSTER}_xyz"
        cmp = {m: compare_builds(np, builds[(m, "card")]["dir"], builds[(m, "cpu")]["dir"], f"{tag}_{m}", tracks)
               for m in ("kmeans", "birch")}
        out["card_vs_cpu"] = cmp
        log(f"mapping: card vs CPU builds {json.dumps(cmp)}")
        require(cmp["kmeans"]["label_agree"] >= MAP_KMEANS_AGREE, "mapping: KMeans labels differ card vs CPU")
        require(cmp["birch"]["label_agree"] == 1.0, "mapping: Birch labels differ card vs CPU")
        for m, c in cmp.items():
            require(c["desc_agree"] >= MAP_DESC_AGREE and c["desc_median_gap_max"] <= MAP_DESC_MEDIAN_TOL,
                    f"mapping ({m}): track descriptors differ card vs CPU")
            require(c["vrf_equal_on_same_segments"], f"mapping ({m}): VRFs differ card vs CPU")
            require(c["compressed_equal"] or not c["vrf_seeds_equal"],
                    f"mapping ({m}): compressed models differ card vs CPU from equal VRF seeds")

        # 7. the KMeans map, loaded as a user loads it, localizes phase 10's queries, counted
        q_imgs, q_qvecs, q_tvecs = render_views(MAP_QUERIES, 11, world)
        q_imgs = apply_noise(q_imgs, np.random.RandomState(12))
        queries = (q_imgs, q_qvecs, q_tvecs)
        out["localization"] = localize_built_map(torch, np, dev, bf16, sfd2, builds[("kmeans", "card")]["dir"], world,
                                                 queries, reset_counts, read_counts, path_kernels, "mapping")
        out["views"], out["pairs"], out["secs"] = MAP_VIEWS, len(pairs), secs
        out["keypoints"], out["matches_per_pair"] = [min(n_kp), max(n_kp)], float(np.mean(n_matches))
        out["triangulation"] = tri
        # what phase 31 starts from: the world, its reference views and the queries
        out["world"] = dict(world=world, imgs=imgs, poses=poses, names=names, queries=queries)
        del sfd2
    return out


def mapping_scale_timings(torch, dev) -> dict:
    """KMeans at SCALE_KMEANS and best_of at SCALE_TRACKS on the card: a call
    by host clock (synchronized) and by CUDA events, and the peak of device
    memory it allocated."""
    from pram_tpu_torch.mapping.clustering import kmeans
    from pram_tpu_torch.mapping.recmap import best_of

    out = {}
    g = torch.Generator(device=dev).manual_seed(0)
    n, k, iters = SCALE_KMEANS
    pts = torch.rand(n, 3, generator=g, device=dev) * torch.tensor([10.0, 7.0, 5.0], device=dev)
    b, tmax, d = SCALE_TRACKS
    desc = torch.randn(b, tmax, d, generator=g, device=dev)
    desc = (desc / desc.norm(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    lens = torch.randint(1, tmax + 1, (b,), generator=g, device=dev)
    mask = torch.arange(tmax, device=dev)[None] < lens[:, None]
    cases = {
        "kmeans": lambda: kmeans(pts, k, iters, generator=torch.Generator().manual_seed(0)),
        "best_of": lambda: best_of(desc, mask),
    }
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out[name] = dict(host_ms=host_ms, cuda_ms=start.elapsed_time(end), peak_bytes=int(peak))
    out["kmeans"]["shape"] = dict(points=n, clusters=k, iterations=iters)
    out["best_of"]["shape"] = dict(tracks=b, max_views=tmax, dim=d, views=int(lens.sum()))
    log(f"mapping scale timings: {json.dumps(out)}")
    return out


# ---- phase 31: the hloc file pipeline through the CLIs' main(argv), on
# phase 30's world: the 64 reference views and the 32 queries as PNGs,
# cli.extract_features (SFD2 bf16, the sfd2 config's 4096 keypoints, one
# image at a time) into feats.h5, the 8 nearest views a view, cli.
# match_features with GML (batches of 8 pairs padded to 4096 a side: kernel
# 6's wide instance at 4097 x 4097) into matches.h5, cli.triangulate against
# the known poses, cli.build_map --features feats.h5 (KMeans); the queries
# localized on the built map by Localizer (phase 30's way) and by the
# retrieval-driven run_localizer (each query's 10 nearest reference views by
# camera centre: no retrieval network is in the repo), the latter with
# mutual NN on the card against the card machine's CPU on the first 4
HLOC_RETRIEVAL = 10
HLOC_CPU_QUERIES = 4
HLOC_RECALL_MIN = 31 / 32  # run_localizer at 0.25 m / 2 deg
HLOC_T_TOL, HLOC_R_TOL_DEG = 0.005, 0.1  # card vs CPU poses


def write_hloc_inputs(np, root: Path, names, imgs, q_names, q_imgs) -> None:
    """The views as 8-bit RGB PNGs under ``root`` by name."""
    from concurrent.futures import ThreadPoolExecutor

    def one(item):
        name, img = item
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        write_png(root / name, (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, [*zip(names, imgs), *zip(q_names, q_imgs)]))


@contextlib.contextmanager
def recording_h5_writes():
    """Every dataset ``io/h5.py`` is asked to write, as ``(file, name,
    array)``, in call order."""
    import numpy as np

    from pram_tpu_torch.io import h5

    real, written = h5.Group.create_dataset, []

    def create_dataset(self, path, data):
        ds = real(self, path, data)
        written.append((self.file.filename, ds.name, np.array(data, copy=True)))
        return ds

    h5.Group.create_dataset = create_dataset
    try:
        yield written
    finally:
        h5.Group.create_dataset = real


def replaying_triplets(drawn):
    """A ``_sample_triplets`` that hands out ``drawn`` in order, on the CPU;
    each call must ask for the recorded shape."""
    it = iter(drawn)

    def sample(generator, mask, num_hyps):
        t = next(it)
        require(tuple(t.shape) == (mask.shape[0], num_hyps, 3), "hloc: the CPU's RANSAC asks for other triplets")
        return t.cpu()

    return sample


def run_hloc_phase(torch, np, dev, bf16, world_inputs, reset_counts, read_counts, path_kernels) -> dict:
    """Phase 31: the hloc file pipeline through the CLIs' ``main(argv)`` on
    the card, counted; the h5 files read back; kernels 1, 2, 5 and 6's wide
    instance held against their plain versions at the pair matcher's
    shapes; run_localizer with mutual NN, card against CPU."""
    import tempfile

    from pram_tpu_torch.cli import build_map as cli_build_map
    from pram_tpu_torch.cli import extract_features as cli_extract
    from pram_tpu_torch.cli import match_features as cli_match
    from pram_tpu_torch.cli import triangulate as cli_triangulate
    from pram_tpu_torch.engine import hloc_localizer
    from pram_tpu_torch.engine.rendered_guard import GML_W, SFD2_W
    from pram_tpu_torch.geometry import pnp as gpnp
    from pram_tpu_torch.geometry.rotations import compute_pose_error
    from pram_tpu_torch.io import h5
    from pram_tpu_torch.maps.colmap_io import ColmapCamera, ColmapImage, write_model
    from pram_tpu_torch.maps.packed import _qvec2rotmat_np
    from pram_tpu_torch.maps.parsers import names_to_pair
    from pram_tpu_torch.maps.synthetic import _rotmat2qvec_np
    from pram_tpu_torch.models import gml as gml_mod
    from pram_tpu_torch.models.convert import load_sfd2
    from pram_tpu_torch.ops import attention, cross_attention, mlp, sinkhorn

    world, imgs, poses, names = (world_inputs[k] for k in ("world", "imgs", "poses", "names"))
    q_imgs, q_qvecs, q_tvecs = world_inputs["queries"]
    q_names = [f"query/q_{i:03d}.png" for i in range(len(q_imgs))]
    cam = (MAP_FOCAL, MAP_FOCAL, MAP_W / 2, MAP_H / 2)
    out, secs, launches = {}, {}, {}
    total = {}

    def counted(stage):
        torch.cuda.synchronize()
        launches[stage] = read_counts()
        for k, v in launches[stage].items():
            total[k] = total.get(k, 0) + v
        reset_counts()

    with tempfile.TemporaryDirectory(prefix="pram_hloc_") as tmp:
        tmp = Path(tmp)
        img_dir, feats, matches = tmp / "images", tmp / "feats.h5", tmp / "matches.h5"
        t = time.perf_counter()
        write_hloc_inputs(np, img_dir, names, imgs, q_names, q_imgs)
        secs["png"] = time.perf_counter() - t

        # the path, counted stage by stage: extraction, matching, triangulation, the build
        patches = [(attention, "self_attention"), (cross_attention, "cross_attention"), (mlp, "residual_mlp"),
                   (gml_mod, "sinkhorn")]
        with recording_h5_writes() as written:
            reset_counts()
            t = time.perf_counter()
            run_cli("extract_features", cli_extract.main, [
                "--image_dir", str(img_dir), "--export_fn", str(feats), "--conf", "sfd2", "--weight_path", SFD2_W,
                "--device", str(dev)])
            secs["extract"] = time.perf_counter() - t
            counted("extract")

            pairs = nearest_view_pairs(np, poses, names, MAP_PAIRS)
            pairs_txt = tmp / "pairs.txt"
            pairs_txt.write_text("".join(f"{a} {b}\n" for a, b in pairs))
            t = time.perf_counter()
            with recording_first(patches) as seen:
                run_cli("match_features", cli_match.main, [
                    "--pairs", str(pairs_txt), "--features", str(feats), "--export_fn", str(matches), "--conf",
                    "gml", "--weight_path", GML_W, "--device", str(dev)])
            secs["match"] = time.perf_counter() - t
            counted("match")

            # the reference model: the known poses, COLMAP's principal point half a pixel on (phase 30)
            ref_dir, model_dir, landmarks = tmp / "ref_model", tmp / "model", tmp / "landmarks"
            cameras = {1: ColmapCamera(1, "PINHOLE", MAP_W, MAP_H, np.array([*cam[:2], cam[2] + 0.5, cam[3] + 0.5]))}
            images = {i + 1: ColmapImage(i + 1, _rotmat2qvec_np(R), t_, 1, names[i], np.zeros((0, 2)),
                                         np.zeros(0, np.int64)) for i, (R, t_) in enumerate(poses)}
            write_model(cameras, images, {}, str(ref_dir), ".bin")
            t = time.perf_counter()
            tri, _ = run_cli("triangulate", cli_triangulate.main, [
                "--reference_model", str(ref_dir), "--features", str(feats), "--pairs", str(pairs_txt),
                "--matches", str(matches), "--output", str(model_dir)])
            secs["triangulate"] = time.perf_counter() - t
            t = time.perf_counter()
            stages, _ = run_cli("build_map (kmeans, h5)", cli_build_map.main, [
                "--model", str(model_dir), "--features", str(feats), "--output", str(landmarks),
                "--cluster_method", "kmeans", "--device", str(dev), *MAP_FLAGS])
            secs["build_map"] = time.perf_counter() - t
            counted("triangulate_build")

        # every h5 file the phase wrote, read back by io/h5.py, equal to what was written
        t = time.perf_counter()
        by_file = {}
        for fn, name, arr in written:
            by_file.setdefault(fn, []).append((name, arr))
        for fn, items in by_file.items():
            with h5.File(fn, "r") as f:
                for name, arr in items:
                    got = f[name][()]
                    require(np.asarray(got).dtype == arr.dtype and np.array_equal(got, arr),
                            f"hloc: {Path(fn).name}:{name} reads back other than written")
        out["h5_read_back"] = {Path(fn).name: len(items) for fn, items in by_file.items()}
        secs["read_back"] = time.perf_counter() - t
        with h5.File(str(feats), "r") as f:
            n_kp = [f[n]["keypoints"].shape[0] for n in names + q_names]
        with h5.File(str(matches), "r") as f:
            n_m = [int((f[names_to_pair(a, b)]["matches0"][()] >= 0).sum()) for a, b in pairs]
        log(f"hloc: {len(names)} + {len(q_names)} PNGs in {secs['png']:.2f} s; cli.extract_features "
            f"{secs['extract']:.2f} s ({min(n_kp)}-{max(n_kp)} keypoints a view, mean {np.mean(n_kp):.0f}); "
            f"cli.match_features (GML) {len(pairs)} pairs in {secs['match']:.2f} s ({np.mean(n_m):.0f} matches a "
            f"pair); cli.triangulate {secs['triangulate']:.2f} s {json.dumps(tri)}; cli.build_map "
            f"{secs['build_map']:.2f} s {json.dumps({k: round(v, 3) for k, v in stages.items()})}; h5 read back "
            f"{json.dumps(out['h5_read_back'])} in {secs['read_back']:.2f} s")
        require(tri["num_points"] > 1000, "hloc: triangulation gave too few points")

        # the built map through Localizer, as phase 30 localizes its map
        sfd2 = load_sfd2(SFD2_W, device=dev, dtype=bf16)
        reset_counts()
        out["localization"] = localize_built_map(torch, np, dev, bf16, sfd2, landmarks, world, (q_imgs, q_qvecs,
                                                 q_tvecs), reset_counts, read_counts, path_kernels, "hloc")
        del sfd2
        for k, v in out["localization"]["launches"].items():
            total[k] = total.get(k, 0) + v
        reset_counts()

        # run_localizer: each query's 10 nearest reference views by camera centre
        centres = np.array([-R.T @ t_ for R, t_ in poses])
        q_centres = np.array([-_qvec2rotmat_np(np.asarray(q, np.float64)).T @ tv for q, tv in zip(q_qvecs, q_tvecs)])
        retrieval, queries_txt, queries4 = tmp / "retrieval.txt", tmp / "queries.txt", tmp / "queries4.txt"
        lines = []
        for qn, c in zip(q_names, q_centres):
            near = np.argsort(np.linalg.norm(centres - c, axis=1), kind="stable")[:HLOC_RETRIEVAL]
            lines += [f"{qn} {names[j]}\n" for j in near]
        retrieval.write_text("".join(lines))
        intr = f"PINHOLE {MAP_W} {MAP_H} {cam[0]} {cam[1]} {cam[2] + 0.5} {cam[3] + 0.5}"
        qlines = [f"{qn} {intr}\n" for qn in q_names]
        queries_txt.write_text("".join(qlines))
        queries4.write_text("".join(qlines[:HLOC_CPU_QUERIES]))
        gt = {qn: {"qvec": q, "tvec": tv} for qn, q, tv in zip(q_names, q_qvecs, q_tvecs)}
        args = (str(model_dir), str(feats), str(retrieval))
        gml_fn = cli_match.build_match_fn("gml", GML_W, dev)
        t = time.perf_counter()
        res = hloc_localizer.run_localizer(*args, str(queries_txt), gml_fn, str(tmp / "hloc_gml"), gt_poses=gt,
                                           device=dev)
        torch.cuda.synchronize()
        secs["run_localizer"] = time.perf_counter() - t
        counted("run_localizer")
        for name in path_kernels:
            require(total[name] > 0, f"hloc: kernel {name} was not launched on the path")
        require(total["sinkhorn_wide"] > 0, "hloc: kernel 6's wide instance was not launched on the path")
        f32 = lambda v: torch.tensor(np.array(v), dtype=torch.float32)
        errs = [compute_pose_error(*map(f32, (*res["poses"][qn], gt[qn]["qvec"], gt[qn]["tvec"])))
                for qn in q_names if qn in res["poses"]]
        n5 = sum(float(qe) <= 5.0 and float(te) <= 0.05 for qe, te in errs)
        out["run_localizer"] = dict(
            recall=res["recall"], recall_5cm5deg=n5 / len(q_names), failed=res["failed"],
            seconds=secs["run_localizer"], queries_per_s=len(q_names) / secs["run_localizer"],
            mean_query_s=res["mean_time"], median_t_err=float(np.median([float(te) for _, te in errs])),
            median_q_err=float(np.median([float(qe) for qe, _ in errs])),
            artifacts=sorted(p.name for p in (tmp / "hloc_gml").iterdir()))
        log(f"hloc: run_localizer (GML, {HLOC_RETRIEVAL} retrieved) {json.dumps(out['run_localizer'])}; launches "
            f"{json.dumps(launches['run_localizer'])}")
        require(res["recall"]["0.25m/2.0deg"] >= HLOC_RECALL_MIN, "hloc: run_localizer recall@0.25m/2deg below 31/32")

        # kernels 1, 5, 2 and 6 wide at the pair matcher's shapes (batch 0), against their plain versions
        out["kernels"] = {}
        with torch.no_grad():
            (a_args, _) = seen["self_attention"]
            splits = a_args[8]
            err = check_scaled(f"self_attention (pairs, splits {splits})", attention.self_attention(*a_args),
                               attention.self_attention_plain(*a_args), ATTN_TOL)
            out["kernels"]["self_attention"] = at_shape(
                torch, lambda: attention.self_attention(*a_args), lambda: attention.self_attention_plain(*a_args),
                err, [a_args[0].shape[0], *splits],
                bound_ms(*self_attention_cost(a_args[0].shape[0], splits), BF16_TENSOR_FLOPS))
            c_args, _ = seen["cross_attention"]
            n0 = c_args[9]
            n1 = c_args[0].shape[1] - n0
            err = check_scaled(f"cross_attention (pairs, {n0} x {n1})", cross_attention.cross_attention(*c_args),
                               cross_attention.cross_attention_plain(*c_args), ATTN_TOL)
            out["kernels"]["cross_attention"] = at_shape(
                torch, lambda: cross_attention.cross_attention(*c_args),
                lambda: cross_attention.cross_attention_plain(*c_args), err, [c_args[0].shape[0], n0, n1],
                bound_ms(*cross_attention_cost(c_args[0].shape[0], n0, n1), BF16_TENSOR_FLOPS))
            m_args, m_kw = seen["residual_mlp"]
            err = check_scaled("residual_mlp (pairs)", mlp.residual_mlp(*m_args, **m_kw),
                               mlp.residual_mlp_plain(*m_args, **m_kw), MLP_TOL)
            tok = m_args[0].numel() // 256
            out["kernels"]["residual_mlp"] = at_shape(
                torch, lambda: mlp.residual_mlp(*m_args, **m_kw), lambda: mlp.residual_mlp_plain(*m_args, **m_kw),
                err, [tok], mlp_bound(tok, False))
            (sim, dustbin, iters, sm0, sm1), _ = seen["sinkhorn"]
            b, n, m = sim.shape
            require(sinkhorn.instance(n, m, dev)[0] == sinkhorn.WIDE, "hloc: the pairs' plan did not take the wide "
                    "instance")
            plan = sinkhorn.sinkhorn(sim, dustbin, iters, sm0, sm1)
            controls = {"plain in bf16": sinkhorn.sinkhorn_matching(sim.bfloat16(), dustbin, iters, sm0, sm1).float(),
                        f"plain, {iters - 1} iterations": sinkhorn.sinkhorn_matching(sim, dustbin, iters - 1, sm0,
                                                                                     sm1)}
            chk = check_wide_plan(f"sinkhorn_wide (pairs, {b} x {n + 1} x {m + 1})", plan,
                                  sinkhorn.sinkhorn_matching(sim, dustbin, iters, sm0, sm1), controls, n, m)
            del controls, plan
            out["kernels"]["sinkhorn_wide"] = at_shape(
                torch, lambda: sinkhorn.sinkhorn(sim, dustbin, iters, sm0, sm1),
                lambda: sinkhorn.sinkhorn_matching(sim, dustbin, iters, sm0, sm1), chk["max_abs_err"],
                [b, n + 1, m + 1], bound_ms(*sinkhorn_cost(b, n, m, iters), F32_FLOPS))
        del seen, a_args, c_args, m_args, sim
        torch.cuda.empty_cache()
        for name, k in out["kernels"].items():
            log(f"hloc: {name} at {k['shape']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, bound "
                f"{k['bound_ms']:.4f} ms ({k['bound_by']}), max abs err {k['max_abs_err']:.3e}")

        # card against CPU: run_localizer with mutual NN on the first queries, the card's triplets replayed
        nn_fn = cli_match.build_match_fn("NNM", None, dev)
        t = time.perf_counter()
        with recording_triplets() as drawn:
            card = hloc_localizer.run_localizer(*args, str(queries4), nn_fn, str(tmp / "nn_card"), gt_poses=gt,
                                                device=dev)
        real = gpnp._sample_triplets
        gpnp._sample_triplets = replaying_triplets(drawn)
        try:
            cpu = hloc_localizer.run_localizer(*args, str(queries4), nn_fn, str(tmp / "nn_cpu"), gt_poses=gt,
                                               device="cpu")
        finally:
            gpnp._sample_triplets = real
        secs["card_vs_cpu"] = time.perf_counter() - t
        reset_counts()
        require(card["failed"] == cpu["failed"] and card["recall"] == cpu["recall"]
                and list(card["poses"]) == list(cpu["poses"]), "hloc: run_localizer's flags differ card vs CPU")
        diffs = [compute_pose_error(*map(f32, (*card["poses"][qn], *cpu["poses"][qn]))) for qn in card["poses"]]
        max_deg, max_m = max(float(d) for d, _ in diffs), max(float(d) for _, d in diffs)
        out["card_vs_cpu"] = dict(queries=HLOC_CPU_QUERIES, failed=card["failed"], recall=card["recall"],
                                  max_deg=max_deg, max_m=max_m, triplet_calls=len(drawn),
                                  seconds=secs["card_vs_cpu"])
        log(f"hloc: run_localizer (mutual NN) card vs CPU {json.dumps(out['card_vs_cpu'])}")
        require(max_deg < HLOC_R_TOL_DEG and max_m < HLOC_T_TOL, "hloc: run_localizer's poses differ card vs CPU")

    out.update(secs=secs, launches=total, launches_by_stage=launches, keypoints=[min(n_kp), max(n_kp)],
               keypoints_mean=float(np.mean(n_kp)), matches_per_pair=float(np.mean(n_m)), pairs=len(pairs),
               triangulation=tri, build_stages_ms={k: round(v, 3) for k, v in stages.items()})
    return out


# ---- phase 32: the runtime remainder. (a) the JPEG fixtures of
# tests/jpeg_fixtures/ decoded by io/jpeg.py on the card's host against the
# digests of cv2.imread's arrays, and a decode's host ms at 640 x 480 and
# 1024 x 768; (b) phase 22's 32 online frames written as JPEG (write_jpeg,
# q95 4:2:0) through cli.online_localization.main with the viewer on
# loopback at each of RUNTIME_ONLINE_KPTS;
# (c) scripts/reconstruct_scene_torch.sh on phase 30's world written as
# JPEG (a subprocess: its CLIs' launches are their own processes' and not
# counted here), its map localizing the 32 queries, decoded from JPEG, at
# phase 30's gate; (d) cli.train and GML matcher steps at token counts off
# the backward kernels' tiles, counted
JPEG_FIXTURES = Path(__file__).resolve().parent / "tests" / "jpeg_fixtures"
# the online CLI on the JPEG frames at 512 keypoints (phase 22's operating
# point), held to phase 22's gates, and at 1024 (the CLI's default), held to
# the JAX CLI's outcome on the same JPEG frames: it loses
# RUNTIME_1024_LOST and localizes every other frame within 5 cm / 5 deg
# (scripts/online_keypoints_witness.py). At 1024 the recognizer gives the
# landmark it ranks first 128 votes or more on those frames, which turns on
# the semantic gate (LocConfig.min_kpts), and matching the keypoints that
# vote for it against its own points finds at most 4 inliers: in pram_tpu
# as in the port, on the card as on the CPU (scripts/online_keypoints.py;
# PERF.md)
RUNTIME_ONLINE_KPTS = (512, 1024)
RUNTIME_1024_LOST = (11, 12, 13, 14, 15)
RUNTIME_TRAIN_KPTS, RUNTIME_TRAIN_BATCH, RUNTIME_TRAIN_ITS = 1000, 6, 3  # 6000 MLP rows: off the 32-row tile
RUNTIME_GML_BATCH, RUNTIME_GML_SIDES, RUNTIME_GML_STEPS = 4, (500, 1000), 2
RUNTIME_SCRIPT_TIMEOUT_S = 400


def host_ms(fn, n: int = 5) -> float:
    """Median host milliseconds of ``fn()`` over ``n`` calls."""
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[n // 2]


def jpeg_checks(np, world_inputs) -> dict:
    """(a): the fixtures against their digests; decode ms of a rendered view
    at 640 x 480 and 1024 x 768 (baseline q95 4:2:0, median of 5)."""
    import hashlib

    from pram_tpu_torch.io.image import read_image
    from pram_tpu_torch.io.jpeg import decode_jpeg

    table = json.loads((JPEG_FIXTURES / "digests.json").read_text())
    t = time.perf_counter()
    for name, want in table.items():
        color = read_image(str(JPEG_FIXTURES / name))
        gray = read_image(str(JPEG_FIXTURES / name), grayscale=True)
        same = (list(color.shape) == want["shape"] and hashlib.sha256(color.tobytes()).hexdigest() == want["color"]
                and hashlib.sha256(gray.tobytes()).hexdigest() == want["gray"])
        require(same, f"runtime: tests/jpeg_fixtures/{name} decodes other than cv2.imread (its digest)")
    out = dict(fixtures=len(table), fixtures_s=time.perf_counter() - t)
    world, (R, t_) = world_inputs["world"], world_inputs["poses"][0]
    for w, h, f in ((640, 480, 500.0), (1024, 768, 800.0)):
        view = uint8_image(np, world.render(R, t_, (f, f, w / 2, h / 2), w, h))
        data = jpeg_bytes(view, 95)
        out[f"decode_ms_{w}x{h}"] = host_ms(lambda: decode_jpeg(data))
        out[f"bytes_{w}x{h}"] = len(data)
    log(f"runtime: {len(table)} JPEG fixtures decoded equal to cv2.imread's digests in {out['fixtures_s']:.3f} s; "
        f"decode (host ms, median of 5, baseline q95 4:2:0): 640 x 480 {out['decode_ms_640x480']:.1f} ms "
        f"({out['bytes_640x480']} bytes), 1024 x 768 {out['decode_ms_1024x768']:.1f} ms "
        f"({out['bytes_1024x768']} bytes)")
    return out


@contextlib.contextmanager
def recording_viewers():
    """Every ``viz.ViewerServer`` the port makes, its updates timed."""
    from pram_tpu_torch import viz

    real, made = viz.ViewerServer, []

    class Timed(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.update_ms = []
            made.append(self)

        def update(self, *a, **k):
            t = time.perf_counter()
            super().update(*a, **k)
            self.update_ms.append((time.perf_counter() - t) * 1e3)

    viz.ViewerServer = Timed
    try:
        yield made
    finally:
        viz.ViewerServer = real
        for v in made:
            v.close()


def runtime_online(torch, np, oi, png_512_ms, reset_counts, read_counts) -> dict:
    """(b): the online CLI on the JPEG frames with the viewer at each of
    RUNTIME_ONLINE_KPTS, counted; ``oi`` is what phase 22 left (its online
    inputs), ``png_512_ms`` its PNG run's frame ms."""
    from pram_tpu_torch.cli import online_localization as cli_online
    from pram_tpu_torch.engine.rendered_guard import FOCAL, HEIGHT, WIDTH
    from pram_tpu_torch.io.image import read_image

    png_dir, n = oi["img_dir"], len(oi["fnames"])
    jpg_dir = png_dir.parent / "images_jpeg"
    jpg_dir.mkdir()
    jnames = [f.replace(".png", ".jpg") for f in oi["fnames"]]
    t = time.perf_counter()
    for name, img in zip(jnames, oi["imgs"]):
        write_jpeg(jpg_dir / name, uint8_image(np, img), 95)
    enc_s = time.perf_counter() - t
    write_queries(jpg_dir, jnames, oi["qvecs"], oi["tvecs"],
                  ("PINHOLE", WIDTH, HEIGHT, (FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2)))
    dec = {"jpeg": [host_ms(lambda p=jpg_dir / j: read_image(str(p)), 3) for j in jnames],
           "png": [host_ms(lambda p=png_dir / f: read_image(str(p)), 3) for f in oi["fnames"]]}
    argv = oi["argv"][:-2]  # its --max_keypoints goes
    at = argv.index("--image_dir") + 1
    argv[at] = str(jpg_dir)
    names_all = set(read_counts())
    out = dict(encode_s=enc_s, decode_ms={k: float(np.mean(v)) for k, v in dec.items()},
               jpeg_bytes=int(np.mean([(jpg_dir / j).stat().st_size for j in jnames])))
    runs = {}
    for kpts, lost in zip(RUNTIME_ONLINE_KPTS, ((), RUNTIME_1024_LOST)):
        key = f"jpeg_{kpts}"
        with recording_viewers() as viewers:
            reset_counts()
            recs, lines = run_cli(f"online (jpeg, {kpts} keypoints)", cli_online.main, [
                *argv, "--max_keypoints", str(kpts), "--queries", str(jpg_dir / "queries_with_intrinsics.txt"),
                "--viewer_port", "0"])
            torch.cuda.synchronize()
            runs[key] = online_run(torch, np, oi, recs, lines, read_counts(), names_all, key, lost)
            runs[key]["viewer"] = viewer_check(torch, np, viewers, lines, recs, jnames[-1])
    out.update(runs=runs)
    log(f"runtime online: {n} frames written as JPEG in {enc_s:.2f} s ({out['jpeg_bytes']} bytes a frame); decode "
        f"{out['decode_ms']['jpeg']:.1f} ms (JPEG) vs {out['decode_ms']['png']:.1f} ms (PNG) a frame (host, median "
        f"of 3); frame ms after the first: "
        + "; ".join(f"{k} " + ", ".join(f"{kk}={vv:.2f}" for kk, vv in r["mean_ms_after_first"].items())
                    for k, r in runs.items())
        + "; the viewer's update " + ", ".join(f"{k} {r['viewer']['update_ms']:.3f}" for k, r in runs.items())
        + " ms a frame; phase 22's PNG run at "
        f"512 keypoints: " + ", ".join(f"{k}={v:.2f}" for k, v in png_512_ms.items()))
    return out


def online_run(torch, np, oi, recs, lines, got, names_all, key: str, lost: tuple) -> dict:
    """One online CLI run's figures, held to phase 22's gates but for the
    frames in ``lost``, which must fail: every other frame localized within
    5 cm / 5 deg, frame ONLINE_JUMPS[0] falling back from tracking to
    relocalization; its launches as its frames need them."""
    from pram_tpu_torch.geometry.rotations import compute_pose_error

    n = len(oi["fnames"])
    q_err, t_err = compute_pose_error(torch.tensor(np.stack([r["qvec"] for r in recs])).double(),
                                      torch.tensor(np.stack([r["tvec"] for r in recs])).double(),
                                      torch.tensor(oi["qvecs"]), torch.tensor(oi["tvecs"]).double())
    modes = [r["mode"] for r in recs]
    fallback = [i for i in range(1, n) if modes[i] == "relocalized" and recs[i - 1]["success"]]
    ok = [bool(r["success"]) and float(te) < 0.05 and float(qe) < 5.0 for r, qe, te in zip(recs, q_err, t_err)]
    failed = [i for i, o in enumerate(ok) if not o]
    log(f"online ({key}): {sum(ok)}/{n} frames within 5 cm / 5 deg, failed {failed} (the JAX CLI's: "
        f"{list(lost)}), fallback frames {fallback}")
    require(len(recs) == n and failed == list(lost),
            f"online CLI ({key}): frames {failed} failed or lie outside 5 cm / 5 deg, where the JAX CLI loses "
            f"{list(lost)}")
    require(ONLINE_JUMPS[0] in fallback, f"online CLI ({key}): frame {ONLINE_JUMPS[0]} did not fall back "
            f"from tracking to relocalization (fallback frames {fallback})")
    tried = sum(1 for i in range(1, n) if recs[i - 1]["success"])
    matched = tried + modes.count("relocalized")
    want = add_launches({"fused_stem": n, "nms": n}, SEGNETVIT_LAUNCHES, n)
    want = add_launches(add_launches(want, {**GML_LAUNCHES, "sinkhorn": 0}, matched), PNP_LAUNCHES, matched)
    plans = got["sinkhorn"] + got["sinkhorn_wide"]
    require({k: v for k, v in got.items() if k not in ("sinkhorn", "sinkhorn_wide")}
            == {k: want.get(k, 0) for k in names_all if k not in ("sinkhorn", "sinkhorn_wide")}
            and plans == matched, f"online CLI ({key}): launches {got}, expected {want} and {matched} Sinkhorn plans")
    ms = {k: float(np.mean([r["ms"][k] for r in recs[1:]])) for k in ("feat", "rec", "loc", "total")}
    return dict(launches=got, modes=modes, fallback_frames=fallback, localized=sum(ok), failed=failed,
                max_err=[float(q_err.max()), float(t_err.max())], mean_ms_after_first=ms, summary=lines[-1])


def viewer_check(torch, np, viewers, lines, recs, last_name: str) -> dict:
    """The CLI's one viewer: its ``viewer:`` line, ``/map`` parsed, ``/state``
    holding an update a frame, the last one the CLI's last result."""
    import urllib.request

    from pram_tpu_torch.geometry.rotations import qvec2rotmat

    require(len(viewers) == 1 and any(ln.startswith(f"viewer: http://127.0.0.1:{viewers[0].port}/")
                                      for ln in lines), "online CLI: no viewer line")
    v = viewers[0]
    loopback = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # past any proxy in the environment
    t = time.perf_counter()
    with loopback.open(f"http://127.0.0.1:{v.port}/map", timeout=30) as r:
        vmap = json.loads(r.read())
    with loopback.open(f"http://127.0.0.1:{v.port}/state", timeout=30) as r:
        state = json.loads(r.read())
    get_ms = (time.perf_counter() - t) * 1e3
    last = recs[-1]
    rot = qvec2rotmat(torch.from_numpy(last["qvec"]).float()).numpy()
    centre = -(rot.T @ last["tvec"])
    frame = state["frames"][-1] if state["frames"] else {}
    same = (state["seq"] == len(recs) and len(state["frames"]) == len(recs) and frame.get("name") == last_name
            and frame.get("num_inliers") == last["inliers"]
            and np.allclose(frame.get("center", [np.inf] * 3), centre, atol=1e-4))
    log(f"viewer: /map {len(vmap['points'])} points, {len(vmap['frames'])} frames, {len(vmap['vrfs'])} VRFs; /state "
        f"{state['seq']} updates, last "
        f"{json.dumps({k: frame.get(k) for k in ('name', 'success', 'tracking', 'matched_sid', 'num_inliers', 'center')})}; "
        f"the CLI's last centre {np.round(centre, 5).tolist()}; both GETs {get_ms:.1f} ms")
    require(bool(vmap["points"]) and same, "viewer: /state's updates are not the CLI's frames")
    return dict(points=len(vmap["points"]), updates=state["seq"], update_ms=float(np.mean(v.update_ms)),
                get_ms=get_ms)


def runtime_script(torch, np, dev, bf16, root, world_inputs, reset_counts, read_counts, path_kernels) -> dict:
    """(c): scripts/reconstruct_scene_torch.sh on the 64 reference views
    written as JPEG; its h5 files read back; the 32 queries, written as JPEG
    and decoded by the port, localized on the map it built."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from pram_tpu_torch.engine.rendered_guard import GML_W, SFD2_W
    from pram_tpu_torch.io import h5
    from pram_tpu_torch.io.image import read_image
    from pram_tpu_torch.maps.colmap_io import ColmapCamera, ColmapImage, write_model
    from pram_tpu_torch.maps.parsers import names_to_pair
    from pram_tpu_torch.maps.synthetic import _rotmat2qvec_np
    from pram_tpu_torch.models.convert import load_sfd2

    world, imgs, poses, names = (world_inputs[k] for k in ("world", "imgs", "poses", "names"))
    q_imgs, q_qvecs, q_tvecs = world_inputs["queries"]
    jnames = [n_.replace(".png", ".jpg") for n_ in names]
    cam = (MAP_FOCAL, MAP_FOCAL, MAP_W / 2, MAP_H / 2)
    out, secs = {}, {}
    with tempfile.TemporaryDirectory(prefix="pram_recon_") as tmp:
        tmp = Path(tmp)
        data_dir, lm, q_dir = tmp / "dataset", tmp / "landmarks", tmp / "queries"

        def one(item):
            path, img = item
            path.parent.mkdir(parents=True, exist_ok=True)
            write_jpeg(path, uint8_image(np, img), 95)

        t = time.perf_counter()
        q_paths = [q_dir / f"q_{i:03d}.jpg" for i in range(len(q_imgs))]
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(one, [*((data_dir / j, im) for j, im in zip(jnames, imgs)), *zip(q_paths, q_imgs)]))
        secs["write_jpeg"] = time.perf_counter() - t
        pairs = nearest_view_pairs(np, poses, jnames, MAP_PAIRS)
        pairs_txt = tmp / "pairs.txt"
        pairs_txt.write_text("".join(f"{a} {b}\n" for a, b in pairs))
        ref_dir = tmp / "ref_model"  # the known poses, COLMAP's principal point half a pixel on (phase 30)
        cameras = {1: ColmapCamera(1, "PINHOLE", MAP_W, MAP_H, np.array([*cam[:2], cam[2] + 0.5, cam[3] + 0.5]))}
        images = {i + 1: ColmapImage(i + 1, _rotmat2qvec_np(R), t_, 1, jnames[i], np.zeros((0, 2)),
                                     np.zeros(0, np.int64)) for i, (R, t_) in enumerate(poses)}
        write_model(cameras, images, {}, str(ref_dir), ".bin")
        shim = tmp / "bin"  # the script calls `python`: this interpreter
        shim.mkdir()
        (shim / "python").write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        (shim / "python").chmod(0o755)
        env = {**os.environ, "PATH": f"{shim}{os.pathsep}{os.environ.get('PATH', '')}", "SFD2_WEIGHTS": SFD2_W,
               "GML_WEIGHTS": GML_W}
        env.pop("DEVICE", None)  # the card, the script's default
        cmd = ["bash", str(root / "scripts" / "reconstruct_scene_torch.sh"), str(data_dir), str(lm), str(ref_dir),
               str(pairs_txt), str(MAP_N_CLUSTER), "xyz", "kmeans"]
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=str(root), env=env, capture_output=True, text=True,
                              timeout=RUNTIME_SCRIPT_TIMEOUT_S)
        secs["script"] = time.perf_counter() - t
        for line in (proc.stdout + proc.stderr).splitlines()[-40:]:
            log(f"  reconstruct_scene_torch.sh | {line}")
        require(proc.returncode == 0, f"reconstruct_scene_torch.sh exited {proc.returncode}")
        t = time.perf_counter()
        with h5.File(str(lm / "feats-sfd2.h5"), "r") as f:
            n_kp = [f[j]["keypoints"].shape[0] for j in jnames]
            ok = all(f[j]["descriptors"].shape[1] == n_kp[i] for i, j in enumerate(jnames))
        with h5.File(str(lm / "matches-gml.h5"), "r") as f:
            n_m = [int((f[names_to_pair(a, b)]["matches0"][()] >= 0).sum()) for a, b in pairs]
        secs["read_back"] = time.perf_counter() - t
        require(ok and min(n_kp) > 0 and len(n_m) == len(pairs) and min(n_m) > 0,
                "reconstruct_scene_torch.sh: its h5 files do not read back whole")
        require((lm / "model" / "points3D.bin").exists() and (lm / "compress_model_kmeans" / "points3D.bin").exists(),
                "reconstruct_scene_torch.sh: no triangulated model or built map")
        t = time.perf_counter()
        q_dec = np.stack([read_image(str(p)) for p in q_paths]).astype(np.float32) / 255.0
        secs["decode_queries"] = time.perf_counter() - t
        sfd2 = load_sfd2(SFD2_W, device=dev, dtype=bf16)
        reset_counts()
        out["localization"] = localize_built_map(torch, np, dev, bf16, sfd2, lm, world, (q_dec, q_qvecs, q_tvecs),
                                                 reset_counts, read_counts, path_kernels, "runtime (script's map)")
        del sfd2
    out.update(secs=secs, keypoints=[min(n_kp), max(n_kp)], matches_per_pair=float(np.mean(n_m)), pairs=len(pairs))
    log(f"runtime script: {len(jnames)} + {len(q_paths)} views written as JPEG in {secs['write_jpeg']:.2f} s; "
        f"reconstruct_scene_torch.sh {secs['script']:.1f} s ({min(n_kp)}-{max(n_kp)} keypoints a view, "
        f"{np.mean(n_m):.0f} matches a pair); h5 read back in {secs['read_back']:.2f} s; queries decoded in "
        f"{secs['decode_queries']:.2f} s")
    return out


def runtime_train(torch, np, dev, scene, reset_counts, read_counts, root) -> dict:
    """(d): cli.train at RUNTIME_TRAIN_KPTS tokens a view and a batch of
    RUNTIME_TRAIN_BATCH (SegNetViT 15 layers: kernels 13 and 15 off their
    tiles), and GML matcher steps at RUNTIME_GML_SIDES (9 layers: 13, 14
    and 15 off their tiles), counted; the losses finite."""
    import tempfile

    from pram_tpu_torch.cli import train as cli_train
    from pram_tpu_torch.core.config import load_yaml
    from pram_tpu_torch.models.gml import GML, GMLConfig
    from pram_tpu_torch.train.matcher import make_matcher_train_step

    names_all = set(read_counts())
    out = {}
    with tempfile.TemporaryDirectory(prefix="pram_train_tiles_") as tmp:
        tmp = Path(tmp)
        top = load_yaml(str(root / TRAIN_CONFIG))
        for k in ("dataset", "landmark_path", "dataset_path", "config_path"):
            top.pop(k)
        top.update(epochs=1, its_per_epoch=RUNTIME_TRAIN_ITS, max_keypoints=RUNTIME_TRAIN_KPTS,
                   batch_size=RUNTIME_TRAIN_BATCH, save_path=str(tmp / "exp"))
        cfg = training_layout(tmp, scene, 24, 112, top)
        reset_counts()
        t = time.perf_counter()
        trainer, lines = run_cli(f"train at {RUNTIME_TRAIN_KPTS} keypoints", cli_train.main,
                                 ["--config", str(cfg), "--save_dir", str(tmp / "ck")])
        torch.cuda.synchronize()
        got = read_counts()
        per_step = {"self_attention": 15, "residual_mlp": 15, "self_attention_bwd": 15, "residual_mlp_bwd": 15}
        want = {k: RUNTIME_TRAIN_ITS * per_step.get(k, 0) for k in names_all}
        losses = [float(line.split(" loss ")[1].split()[0]) for line in lines if line.startswith("Epoch [")]
        log(f"train at {RUNTIME_TRAIN_KPTS} keypoints, batch {RUNTIME_TRAIN_BATCH}: launches {got}, epoch losses "
            f"{losses}, {time.perf_counter() - t:.1f} s")
        require(got == want, f"train at {RUNTIME_TRAIN_KPTS} keypoints: launches {got}, expected {want}")
        require(trainer.state.iteration == RUNTIME_TRAIN_ITS and len(losses) == 1 and bool(np.isfinite(losses).all()),
                f"train at {RUNTIME_TRAIN_KPTS} keypoints: iteration {trainer.state.iteration}, losses {losses}")
        out["train"] = dict(launches=got, losses=losses)

    torch.manual_seed(0)
    gml = GML(GMLConfig()).to(dev)
    step = make_matcher_train_step(gml, 1e-4, torch.bfloat16)
    g = torch.Generator().manual_seed(32)
    b, (n0, n1) = RUNTIME_GML_BATCH, RUNTIME_GML_SIDES
    dd = gml.config.descriptor_dim
    d0, d1 = (torch.nn.functional.normalize(torch.randn(b, k, dd, generator=g), dim=-1).to(dev) for k in (n0, n1))
    nk0, nk1 = ((torch.rand(b, k, 2, generator=g) - 0.5).to(dev) for k in (n0, n1))
    m0, m1 = torch.rand(b, n0, generator=g) > 0.1, torch.ones(b, n1, dtype=torch.bool)
    gt = torch.randint(0, n1 + 1, (b, n0), generator=g)
    gt[~m0] = -1
    args = [t_.to(dev) for t_ in (m0, m1, gt)]
    reset_counts()
    losses = [float(step(d0, d1, nk0, nk1, *args)["loss"]) for _ in range(RUNTIME_GML_STEPS)]
    torch.cuda.synchronize()
    got = read_counts()
    per_step = {"self_attention": 9, "cross_attention": 9, "residual_mlp": 18, "self_attention_bwd": 9,
                "cross_attention_bwd": 9, "residual_mlp_bwd": 18}
    want = {k: RUNTIME_GML_STEPS * per_step.get(k, 0) for k in names_all}
    plans = got["sinkhorn"] + got["sinkhorn_wide"]
    log(f"GML matcher steps at {b} x ({n0} + {n1}): launches {got}, losses {losses}")
    require({k: v for k, v in got.items() if k not in ("sinkhorn", "sinkhorn_wide")}
            == {k: v for k, v in want.items() if k not in ("sinkhorn", "sinkhorn_wide")}
            and plans == RUNTIME_GML_STEPS, f"GML matcher steps: launches {got}, expected {want}")
    require(bool(np.isfinite(losses).all()), f"GML matcher steps: losses {losses}")
    out["gml"] = dict(launches=got, losses=losses, sides=[b, n0, n1])
    del gml, step
    return out


def run_runtime_phase(torch, np, dev, bf16, root, online_inputs, png_512_ms, world_inputs, scene, reset_counts,
                      read_counts, path_kernels) -> dict:
    """Phase 32 (a)-(d); the launches of its counted runs summed by kernel."""
    out = dict(jpeg=jpeg_checks(np, world_inputs))
    t = time.perf_counter()
    out["online"] = runtime_online(torch, np, online_inputs, png_512_ms, reset_counts, read_counts)
    out["online_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["script"] = runtime_script(torch, np, dev, bf16, root, world_inputs, reset_counts, read_counts, path_kernels)
    out["script_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["train"] = runtime_train(torch, np, dev, scene, reset_counts, read_counts, root)
    out["train_s"] = time.perf_counter() - t
    total = {}
    for part in (*out["online"]["runs"].values(), out["script"]["localization"], *out["train"].values()):
        for k, v in part["launches"].items():
            total[k] = total.get(k, 0) + v
    out["launches"] = total
    return out


def main() -> int:
    import argparse

    import torch
    import torch.nn.functional as F

    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--seed", type=int, default=0, help="seed of the training batch")
    args = args.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    atexit.register(stop_children)
    root = Path(__file__).resolve().parent
    if not (root / "pram_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: pram_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import numpy as np

    from pram_tpu_torch import _build
    from pram_tpu_torch.engine.localizer import (
        LocConfig,
        Localizer,
        gather_refine_set,
        gather_vrf_tables,
        project_refine_set,
        rank_candidates,
        refine_matching_core,
    )
    from pram_tpu_torch.engine.matching import (
        make_adagml_match_fn,
        make_gml_match_fn,
        make_nn_match_fn,
    )
    from pram_tpu_torch.engine.rendered_guard import (
        SFD2_W,
        RenderedGuard,
        apply_noise,
        extraction_ab_check,
        extraction_agreement,
        load_extractor,
        render_views,
    )
    from pram_tpu_torch.geometry import pnp as gpnp
    from pram_tpu_torch.geometry.camera import Camera, project
    from pram_tpu_torch.geometry.rotations import compute_pose_error, qvec2rotmat, rotmat2qvec, so3_exp
    from pram_tpu_torch.maps.device import to_device
    from pram_tpu_torch.maps.synthetic import make_synthetic_scene
    from pram_tpu_torch.models.adagml import AdaGMLConfig, adagml_batched_adaptive_apply
    from pram_tpu_torch.models.convert import load_adagml, load_gml, load_segnetvit, load_sfd2
    from pram_tpu_torch.models.gml import GMLConfig
    from pram_tpu_torch.models.segnetvit import SegNetViTConfig
    from pram_tpu_torch.models import sfd2_int8
    from pram_tpu_torch.models.sfd2 import extract as sfd2_extract
    from pram_tpu_torch.models.sfd2 import preprocess_image
    from pram_tpu_torch.train.augmented import make_augmented_train_step
    from pram_tpu_torch.train.losses import seg_loss_weighted
    from pram_tpu_torch.train.trainer import TrainConfig, Trainer, cast_forward, seg_metrics
    from pram_tpu_torch.ops.matching import mutual_matches
    from pram_tpu_torch.ops import (
        attention,
        attention_bwd,
        attention_qkv,
        conv_int8,
        convpair,
        cross_attention,
        keypoints,
        mlp,
        mlp_bwd,
        nms,
        pnp,
        quant,
        refine,
        sampling,
        sinkhorn,
        stem,
    )

    counters = (
        attention.LAUNCHES, mlp.LAUNCHES, pnp.LAUNCHES, cross_attention.LAUNCHES,
        sinkhorn.LAUNCHES, refine.LAUNCHES, stem.LAUNCHES, nms.LAUNCHES,
        attention_qkv.LAUNCHES, attention_bwd.LAUNCHES, mlp_bwd.LAUNCHES,
        conv_int8.LAUNCHES, convpair.LAUNCHES,
    )
    gml_kernels = ("self_attention", "residual_mlp", "ransac_score", "gn_polish",
                   "cross_attention", "sinkhorn", "refine_nn")
    # kernels 10-12: AdaGML's (10, 11) and the blocked form (12), on no
    # earlier slice's path
    ada_kernels = ("self_attention_qkv", "cross_attention_packed", "self_attention_qkv_blocked")
    # kernels 13-15: the backward kernels, on the training slice (13, 15) and
    # on GML training (13-15, phase 23)
    train_kernels = ("self_attention_bwd", "cross_attention_bwd", "residual_mlp_bwd")
    # kernels 16-19: the int8 image slice's (16-18) and the conv pair (19, on
    # no path), and the s8 pass that both forms of 17 launch
    int8_kernels = ("residual_mlp_int8", "self_attention_int8", "cross_attention_int8",
                    "conv3x3_int8", "fused_conv_pair", "projection_int8")
    # the standalone projection wrapper, which no path calls: kernels 1 and 5
    # launch the pass from their C entries, counted as theirs
    pass_only = ("projection",)
    # kernel 6's wide instance, on GML past 1535 frame tokens: path B and
    # the Aachen CLI (phase 26) only
    wide_only = ("sinkhorn_wide",)

    def reset_counts():
        for c in counters:
            for k in c:
                c[k] = 0

    def read_counts():
        return {k: v for c in counters for k, v in c.items()}

    # ---- 1. env
    t = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"card: {smi}")
    phase("env", t)

    # ---- 2. build
    t = time.perf_counter()
    _build.library()
    log(f"nvcc build {_build.BUILD_SECONDS:.2f} s -> {_build.library_path().name}")
    phase("build", t)

    # ---- 3. setup
    t = time.perf_counter()
    bf16 = torch.bfloat16
    batch, n_kpts, width, height = 32, 512, 640, 480
    rng = np.random.RandomState(0)
    scene = make_synthetic_scene(
        rng, n_cluster=16, points_per_cluster=400, n_ref_frames=12,
        desc_dim=128, width=width, height=height, max_kp_per_frame=1024,
        max_ref_points=2048,
    )
    queries = [scene.render_query(rng, noise_px=0.3, max_kpts=n_kpts) for _ in range(batch)]

    def stack(key, dtype=np.float32):
        return torch.from_numpy(np.stack([q[key] for q in queries]).astype(dtype))

    kpts, descs, scores, mask = (
        stack("keypoints"), stack("descriptors"), stack("scores"), stack("mask", bool)
    )
    gt_q, gt_t = stack("qvec"), stack("tvec")
    nk = kpts / torch.tensor([width, height], dtype=torch.float32) - 0.5
    n_class = scene.map.n_class
    rec_cfg = SegNetViTConfig(descriptor_dim=128, n_class=113)
    weights = str(root / "weights" / "segnetvit_synthetic.msgpack")
    gml_weights = str(root / "weights" / "gml_synthetic.msgpack")
    model = load_segnetvit(weights, rec_cfg, device=dev, dtype=bf16)
    gml = load_gml(gml_weights, GMLConfig(), device=dev, dtype=bf16)
    loc_kw = dict(seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128, gn_iters=5, lo_rounds=1)
    loc_cfg = LocConfig(do_refinement=False, **loc_kw)
    gml_cfg = LocConfig(do_refinement=True, **loc_kw)
    cam_params = torch.tensor([500.0, 500.0, width / 2, height / 2, 0, 0, 0, 0]).repeat(batch, 1)
    cam_size = torch.tensor([float(width), float(height)]).repeat(batch, 1)
    log(f"scene: {scene.map.num_points} points, {scene.map.num_frames} frames, n_class {n_class}")
    phase("setup", t)

    def make_localizer(device, match_fn, cfg):
        return Localizer(to_device(scene.map, device, desc_dtype=bf16), match_fn, cfg)

    def sync(device):
        if device != "cpu":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def run_slice(device, rec_model, loc, seed=7):
        """Recognition -> localization for the whole batch on ``device``;
        returns (logits, result, recognition s, localization s)."""
        t_start = sync(device)
        d = descs.to(device, bf16)
        logits = rec_model(d, nk.to(device), mask.to(device))["prediction"]
        logits = logits.float()[:, :, :n_class]
        t_rec = sync(device)
        res = loc.localize_batch(
            torch.Generator().manual_seed(seed),
            Camera(cam_params.to(device), cam_size.to(device)),
            kpts.to(device), scores.to(device), d, mask.to(device), logits,
        )
        t_end = sync(device)
        return logits, res, t_rec - t_start, t_end - t_rec

    def recall_of(res):
        q_err, t_err = compute_pose_error(res.qvec.cpu(), res.tvec.cpu(), gt_q, gt_t)
        ok = res.success.cpu() & (t_err < 0.05) & (q_err < 5.0)
        return float(ok.float().mean()), q_err, t_err

    def compare_with_cpu(name, res_gpu, res_cpu, recall_gpu, logits_gpu=None, logits_cpu=None):
        """The card's result against the CPU's plain run of the same batch."""
        recall_cpu, _, _ = recall_of(res_cpu)
        both = res_gpu.success.cpu() & res_cpu.success
        dq, dt = compute_pose_error(res_gpu.qvec.cpu(), res_gpu.tvec.cpu(), res_cpu.qvec, res_cpu.tvec)
        msg = ""
        if logits_gpu is not None:
            logit_err = (logits_gpu.cpu() - logits_cpu).abs().max().item()
            top1 = (logits_gpu.cpu().argmax(-1) == logits_cpu.argmax(-1))[mask].float().mean().item()
            msg = f"logits max abs diff {logit_err:.4f}, top-1 agreement {top1:.4f}, "
        log(f"{name} card vs CPU: {msg}success card {int(res_gpu.success.sum())}/{batch} "
            f"cpu {int(res_cpu.success.sum())}/{batch}, pose diff on {int(both.sum())} localized: "
            f"max {dq[both].max().item():.4f} deg, {dt[both].max().item():.5f} m; "
            f"recall card {recall_gpu:.4f} cpu {recall_cpu:.4f}")
        require(bool(torch.equal(res_gpu.success.cpu(), res_cpu.success)), f"{name}: success flags differ card vs CPU")
        require(bool((dq[both] < SLICE_R_TOL_DEG).all()), f"{name}: rotation differs card vs CPU")
        require(bool((dt[both] < SLICE_T_TOL).all()), f"{name}: translation differs card vs CPU")
        require(recall_gpu >= recall_cpu - 1.0 / batch, f"{name}: card recall below CPU recall")
        return recall_cpu

    # ---- 4. the first slice's kernels vs plain versions at its shapes
    t = time.perf_counter()
    rows = {}
    gen = torch.Generator().manual_seed(1)

    # attention + MLP on SegNetViT layer 0's real inputs
    with torch.no_grad():
        d = descs.to(dev, bf16)
        m_dev = mask.to(dev)
        cos, sin = model.kenc(nk.to(dev))
        x = model.input_proj(d).contiguous()
        blk = model.gnn[0]
        kb = attention.mask_to_bias(m_dev, batch, n_kpts, dev)
        scale = blk.head_dim**-0.5
        a_args = (x, blk.qkv.weight, blk.qkv.bias, cos, sin, kb, scale, blk.num_heads)
        msg = attention.self_attention(*a_args)
        check_scaled("self_attention (SegNetViT)", msg, attention.self_attention_plain(*a_args), ATTN_TOL)
        require(torch.equal(attention.self_attention(*a_args), msg), "self_attention: two launches differ")
        k1_512_ms = cuda_ms(torch, lambda: attention.self_attention(*a_args))
        log(f"self_attention (SegNetViT, 32 x 512 tokens): {k1_512_ms:.4f} ms")
        m_args = (
            x, msg, blk.proj.weight, blk.proj.bias, blk.mlp_0.weight, blk.mlp_0.bias,
            blk.mlp_ln.weight, blk.mlp_ln.bias, blk.mlp_3.weight, blk.mlp_3.bias,
        )
        y2 = mlp.residual_mlp(*m_args)
        check_scaled("residual_mlp (SegNetViT)", y2, mlp.residual_mlp_plain(*m_args), MLP_TOL)
        require(torch.equal(mlp.residual_mlp(*m_args), y2), "residual_mlp (SegNetViT): two launches differ")
        # timed by events (the wrapper's host work included: its casts of
        # the model's bf16 vectors to f32 outlast the kernel) and by the
        # profiler (the kernel alone, "mlptile" in its name)
        k2_dev_ms, k2_dev_by = mlp_device_ms(torch, mlp.residual_mlp, m_args)
        k2_16384 = dict(ms_16384=cuda_ms(torch, lambda: mlp.residual_mlp(*m_args)),
                        device_ms_16384=k2_dev_ms,
                        bound_16384_ms=mlp_bound(batch * n_kpts, False)[0],
                        library_chain_16384_ms=cuda_ms(torch, lambda: mlp_chain(*m_args)))
        log(f"residual_mlp (SegNetViT, {batch * n_kpts} tokens): {k2_16384['ms_16384']:.4f} ms a call, the kernel "
            f"{k2_16384['device_ms_16384']:.4f} ms ({k2_dev_by}), against its bound "
            f"{k2_16384['bound_16384_ms']:.4f} ms; the eager bf16 chain (3 F.linear, F.layer_norm, F.gelu) "
            f"{k2_16384['library_chain_16384_ms']:.4f} ms")

    # RANSAC scoring and polish: 32 problems x 512 correspondences, 30% outliers,
    # 512 pose hypotheses around the true pose (both slices' shapes)
    P, N, K = batch * loc_cfg.seg_k, n_kpts, 4 * loc_cfg.num_hypotheses
    cam = cam_params.repeat_interleave(loc_cfg.seg_k, 0)
    R_gt = so3_exp(torch.randn(P, 3, generator=gen) * 0.2)
    t_gt = torch.randn(P, 3, generator=gen) * 0.3 + torch.tensor([0.0, 0.0, 5.0])
    xyz = torch.randn(P, N, 3, generator=gen) * 2.0
    uv, _ = project(Camera(cam, None), R_gt, t_gt, xyz)
    uv = uv + torch.randn(P, N, 2, generator=gen) * 0.3
    outl = torch.rand(P, N, generator=gen) < 0.3
    uv[outl] = torch.rand(int(outl.sum()), 2, generator=gen) * torch.tensor([float(width), float(height)])
    pmask = torch.rand(P, N, generator=gen) > 0.1
    R_h = so3_exp(torch.randn(P, K, 3, generator=gen) * 0.05) @ R_gt[:, None]
    t_h = t_gt[:, None] + torch.randn(P, K, 3, generator=gen) * 0.05
    valid = torch.rand(P, K, generator=gen) > 0.2
    cam_d, R_d, t_d, v_d, xyz_d, uv_d, m_d = (
        a.to(dev).contiguous() for a in (cam, R_h, t_h, valid, xyz, uv, pmask)
    )
    th = loc_cfg.threshold
    s_args = (cam_d, R_d, t_d, v_d, xyz_d, uv_d, m_d, th)
    cnt = pnp.ransac_score(*s_args)
    cnt_ref = pnp.ransac_score_plain(*s_args)
    diff = (cnt - cnt_ref).abs().max().item()
    log(f"ransac_score: max |count diff| {diff} (tol {SCORE_MAX_DIFF}); mean count "
        f"{cnt_ref[cnt_ref >= 0].float().mean().item():.1f}")
    require(diff <= SCORE_MAX_DIFF, "ransac_score kernel disagrees with its plain version")
    rows["ransac_score"] = dict(
        name="ransac_score", route="cuda", source="pram_tpu_torch/csrc/pnp.cu",
        replaces="pram_tpu/ops/pnp_pallas.py:101",
        launches=None, max_abs_err=float(diff),
        ms=cuda_ms(torch, lambda: pnp.ransac_score(*s_args)),
        plain_ms=cuda_ms(torch, lambda: pnp.ransac_score_plain(*s_args), iters=5),
        library_ms=None, **score_bound(cam_d, K, N),
    )

    rows["ransac_score"]["device_ms"] = launch_ms(torch, lambda: pnp.ransac_score(*s_args),
                                                  want=lambda k: "ransac" in k).get("ransac_score_kernel")
    rows["ransac_score"]["slices"] = pnp.score_slices(P, K, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    # kernel 3 at the other shapes of the localizer's paths: AdaGML's,
    # matching refinement's (C = 20 frames of 512 keypoints; 128 and 256
    # hypotheses) and a tail (K not a multiple of 128, N of the 256-point
    # chunk), pinhole cameras, points in view (score_case); its issue floor
    # by the SASS instructions a pair of the built kernel
    sass = score_sass_per_pair(_build)
    log(f"ransac_score SASS instructions a pair: {sass}")
    shapes = {"gml": (P, K, N)}
    for label, (P3, K3, N3) in SCORE_SHAPES:
        args3 = [a.to(dev).contiguous() for a in score_case(torch, gen, P3, K3, N3)] + [th]
        got3 = pnp.ransac_score(*args3)
        d3 = (got3 - score_plain_by_poses(pnp, args3)).abs().max().item()
        require(d3 <= SCORE_MAX_DIFF and bool((got3[~args3[3]] == -1).all()),
                f"ransac_score kernel disagrees with its plain version at {P3} x {K3} x {N3}")
        require(torch.equal(pnp.ransac_score(*args3), got3), f"ransac_score: two launches differ at {label}")
        shapes[label] = dict(
            shape=[P3, K3, N3], max_count_diff=d3, ms=cuda_ms(torch, lambda: pnp.ransac_score(*args3)),
            device_ms=launch_ms(torch, lambda: pnp.ransac_score(*args3),
                                want=lambda k: "ransac" in k).get("ransac_score_kernel"),
            slices=pnp.score_slices(P3, K3, N3, torch.cuda.get_device_properties(dev).multi_processor_count),
            issue_ms=score_issue_ms(args3[0], K3, N3, sass), **score_bound(args3[0], K3, N3))
        log(f"ransac_score {label} ({P3} x {K3} x {N3}): max |count diff| {d3} (tol {SCORE_MAX_DIFF}), "
            f"{shapes[label]['ms']:.4f} ms a call, the kernel {shapes[label]['device_ms']} ms, "
            f"{shapes[label]['slices']} slices; bound {shapes[label]['bound_ms']:.4f} ms, issue floor "
            f"{shapes[label]['issue_ms']} ms")
        if label == "matching_256":
            # kernel 4 at matching refinement's 32 x 10240 (clusters of 8
            # CTAs, 1280 points a CTA) from each problem's best hypothesis,
            # as RANSAC starts it
            best = got3.argmax(dim=1)
            ar = torch.arange(P3, device=dev)
            R0m = args3[1][ar, best].contiguous()
            t0m = args3[2][ar, best].contiguous()
            gm_args = (args3[0], R0m, t0m, *args3[4:7], th, loc_cfg.min_inliers)
            gm_kw = dict(gn_iters=loc_cfg.gn_iters, lo_rounds=loc_cfg.lo_rounds)
            gm, gm_ref = pnp.gn_polish(*gm_args, **gm_kw), pnp.gn_polish_plain(*gm_args, **gm_kw)
            dRm = max((gm[0] - gm_ref[0]).abs().max().item(), (gm[1] - gm_ref[1]).abs().max().item())
            dNm = max((gm[2] - gm_ref[2]).abs().max().item(), (gm[3] != gm_ref[3]).sum(-1).max().item())
            require(dRm <= POLISH_POSE_ATOL and dNm <= POLISH_COUNT_DIFF,
                    f"gn_polish disagrees with its plain version at {P3} x {N3}")
            polish_10240 = dict(shape=[P3, N3], cluster=pnp.polish_cluster(N3), max_pose_diff=dRm,
                                max_count_diff=dNm, ms=cuda_ms(torch, lambda: pnp.gn_polish(*gm_args, **gm_kw)),
                                device_ms=launch_ms(torch, lambda: pnp.gn_polish(*gm_args, **gm_kw),
                                                    want=lambda k: k == "polish_kernel").get("polish_kernel"),
                                **polish_bound(P3, N3, loc_cfg))
            log(f"gn_polish ({P3} x {N3}, clusters of {polish_10240['cluster']}): max |dpose| {dRm:.2e}, max count "
                f"/ flag diff {dNm}; {polish_10240['ms']:.4f} ms a call, the kernel {polish_10240['device_ms']} ms")
        del args3, got3
    torch.cuda.empty_cache()  # the plain version's GB of intermediates at these shapes
    shapes["gml"] = dict(shape=[P, K, N], max_count_diff=diff, ms=rows["ransac_score"]["ms"],
                         device_ms=rows["ransac_score"]["device_ms"], slices=rows["ransac_score"]["slices"],
                         issue_ms=score_issue_ms(cam_d, K, N, sass), **score_bound(cam_d, K, N))
    rows["ransac_score"].update(shapes=shapes, sass_per_pair=sass, ptxas=ptxas_summary(_build, "pnp.cu"))
    log(f"ransac_score ({P} x {K} x {N}): {rows['ransac_score']['ms']:.4f} ms a call (CUDA events), the kernel "
        f"{rows['ransac_score']['device_ms']} ms (torch.profiler), {rows['ransac_score']['slices']} slices; "
        f"bound {rows['ransac_score']['bound_ms']:.4f} ms, issue floor {shapes['gml']['issue_ms']} ms")

    R0 = (so3_exp(torch.randn(P, 3, generator=gen) * 0.02) @ R_gt).to(dev).contiguous()
    t0 = (t_gt + torch.randn(P, 3, generator=gen) * 0.05).to(dev).contiguous()
    g_args = (cam_d, R0, t0, xyz_d, uv_d, m_d, th, loc_cfg.min_inliers)
    g_kw = dict(gn_iters=loc_cfg.gn_iters, lo_rounds=loc_cfg.lo_rounds)
    got = pnp.gn_polish(*g_args, **g_kw)
    ref = pnp.gn_polish_plain(*g_args, **g_kw)
    dR = (got[0] - ref[0]).abs().max().item()
    dT = (got[1] - ref[1]).abs().max().item()
    dN = (got[2] - ref[2]).abs().max().item()
    dI = (got[3] != ref[3]).sum(-1).max().item()
    log(f"gn_polish: max |dR| {dR:.2e} |dt| {dT:.2e} (tol {POLISH_POSE_ATOL}), "
        f"max |count diff| {dN}, max flag diffs per problem {dI} (tol {POLISH_COUNT_DIFF})")
    require(max(dR, dT) <= POLISH_POSE_ATOL, "gn_polish pose disagrees with its plain version")
    require(dN <= POLISH_COUNT_DIFF and dI <= POLISH_COUNT_DIFF, "gn_polish inliers disagree")
    again = pnp.gn_polish(*g_args, **g_kw)
    require(all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip(again, got)),
            "gn_polish: two launches differ")
    require_no_spills(_build, ("pnp.cu", "refine.cu"))
    require(all(k[2] == 0 for src in ("pnp.cu", "refine.cu") for k in ptxas_summary(_build, src).values()),
            "a kernel of pnp.cu / refine.cu keeps an array on the stack")
    rows["gn_polish"] = dict(
        name="gn_polish", route="cuda", source="pram_tpu_torch/csrc/pnp.cu",
        replaces="pram_tpu/ops/pnp_pallas.py:378",
        launches=None, max_abs_err=max(dR, dT),
        ms=cuda_ms(torch, lambda: pnp.gn_polish(*g_args, **g_kw)),
        plain_ms=cuda_ms(torch, lambda: pnp.gn_polish_plain(*g_args, **g_kw), iters=5),
        library_ms=None, **polish_bound(P, N, loc_cfg),
        device_ms=launch_ms(torch, lambda: pnp.gn_polish(*g_args, **g_kw),
                            want=lambda k: k == "polish_kernel").get("polish_kernel"),
        cluster=pnp.polish_cluster(N), ptxas=ptxas_summary(_build, "pnp.cu"),
    )
    rows["gn_polish"]["at_32x10240"] = polish_10240
    log(f"gn_polish ({P} x {N}): {rows['gn_polish']['ms']:.4f} ms a call (CUDA events), the kernel "
        f"{rows['gn_polish']['device_ms']} ms a launch (torch.profiler), clusters of "
        f"{rows['gn_polish']['cluster']} CTAs; bound {rows['gn_polish']['bound_ms']:.5f} ms; "
        f"ptxas {rows['gn_polish']['ptxas']}")
    phase("kernels", t)

    # ---- 5. the first slice, counted; its matcher inputs are kept for phase 6
    t = time.perf_counter()
    matcher_inputs = []
    nn_fn = make_nn_match_fn()

    def recording_nn(*args):
        matcher_inputs.append(args)
        return nn_fn(*args)

    reset_counts()
    loc_gpu = make_localizer(dev, recording_nn, loc_cfg)
    with torch.no_grad():
        logits_gpu, res_gpu, _, _ = run_slice(dev, model, loc_gpu)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"first slice launches: {launches}")
    for name in ("self_attention", "residual_mlp", "ransac_score", "gn_polish"):
        require(launches[name] > 0, f"kernel {name} was not launched on the first slice")
    require(bool(torch.isfinite(logits_gpu).all()), "non-finite recognition logits")
    require(tuple(res_gpu.qvec.shape) == (batch, 4), "bad pose batch shape")
    require(bool(torch.isfinite(res_gpu.tvec).all()), "non-finite poses")
    recall_gpu, _, _ = recall_of(res_gpu)
    loc_gpu.match_fn = nn_fn

    # queries/s of recognition + localization on the card (host clock,
    # synchronized), median of 5 batches after one warm-up batch
    with torch.no_grad():
        timed = [run_slice(dev, model, loc_gpu)[2:] for _ in range(6)][1:]
    rec_s = sorted(r for r, _ in timed)[2]
    loc_s = sorted(lo for _, lo in timed)[2]
    batch_s = sorted(r + lo for r, lo in timed)[2]
    log(f"first slice on card: recall@5cm/5deg {recall_gpu:.4f}, batch {batch} in "
        f"{batch_s * 1e3:.2f} ms (median of 5; recognition {rec_s * 1e3:.2f} ms, "
        f"localization {loc_s * 1e3:.2f} ms) = {batch / batch_s:.1f} queries/s")

    # the same batch on the CPU, plain versions, same RANSAC noise
    model_cpu = load_segnetvit(weights, rec_cfg, device="cpu", dtype=bf16)
    with torch.no_grad():
        logits_cpu, res_cpu, _, _ = run_slice("cpu", model_cpu, make_localizer("cpu", nn_fn, loc_cfg))
    compare_with_cpu("first slice", res_gpu, res_cpu, recall_gpu, logits_gpu, logits_cpu)
    phase("slice", t)

    # ---- 6. the second slice's kernels vs plain versions at GML's shapes
    t = time.perf_counter()
    d0, nk0, _, m0, d1, nk1, _, m1 = matcher_inputs[0]
    n0, n1 = d0.shape[1], d1.shape[1]
    splits = (n0, n1)
    tok = batch * (n0 + n1)
    heads, hd = gml.config.num_heads, gml.config.hidden_dim // gml.config.num_heads
    gscale = hd**-0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        x = gml.input_proj(torch.cat([d0, d1], 1)).contiguous()
        cos, sin = gml.poseenc(torch.cat([nk0, nk1], 1))
        m_cat = torch.cat([m0, m1], 1)
        kb = attention.mask_to_bias(m_cat, batch, n0 + n1, dev)
        blk = gml.self_attn[0]

        # kernel 1 with splits
        a_args = (x, blk.qkv.weight, blk.qkv.bias, cos, sin, kb, gscale, heads)
        msg = attention.self_attention(*a_args, splits=splits)
        err = check_scaled("self_attention (GML, splits)", msg,
                           attention.self_attention_plain(*a_args, splits=splits), ATTN_TOL)
        # library yardstick: one SDPA call on the projected, rotated q, k, v
        # with a block-diagonal key mask
        qkv = (x.float() @ blk.qkv.weight.float().T + blk.qkv.bias.float()).to(bf16)
        qkv = qkv.reshape(batch, n0 + n1, heads, hd, 3).permute(0, 2, 1, 3, 4)
        enc = (cos[:, None], sin[:, None])
        q_ = attention.apply_rotary(enc, qkv[..., 0].float()).to(bf16).contiguous()
        k_ = attention.apply_rotary(enc, qkv[..., 1].float()).to(bf16).contiguous()
        v_ = qkv[..., 2].contiguous()
        side = torch.arange(n0 + n1, device=dev) >= n0
        amask = (side[:, None] == side[None, :])[None, None] & m_cat[:, None, None, :]
        lib_ms = cuda_ms(torch, lambda: sdpa(q_, k_, v_, attn_mask=amask, scale=gscale))
        require(torch.equal(attention.self_attention(*a_args, splits=splits), msg),
                "self_attention (GML, splits): two launches differ")
        # its projection pass alone, on the weights in kernel 12's block
        # order, against the plain projection; cuBLAS's F.linear of the same
        # projection (no rotary) as the projection's yardstick
        order = attention.qkv_block_order(256, dev)
        w_blk = blk.qkv.weight.index_select(0, order)
        b_blk = blk.qkv.bias.float().index_select(0, order)
        p_args = (x, w_blk, b_blk, cos, sin)
        check_projection("projection (kernel 1, GML, 768 columns, rotary)",
                         attention.project(*p_args, rotary_cols=512),
                         attention.project_plain(*p_args, rotary_cols=512),
                         attention.project_plain(x, w_blk, b_blk), 512)
        p_bnd, p_by = bound_ms(tok * (256 * 2 + 2 * 64 * 4 + 768 * 2) + 768 * (256 * 2 + 4),
                               2.0 * tok * 256 * 768, BF16_TENSOR_FLOPS)
        b_blk16 = b_blk.to(bf16)
        proj1 = dict(proj_ms=cuda_ms(torch, lambda: attention.project(*p_args, rotary_cols=512)),
                     proj_plain_epilogue_ms=cuda_ms(torch, lambda: attention.project(x, w_blk, b_blk)),
                     proj_bound_ms=p_bnd, linear_ms=cuda_ms(torch, lambda: F.linear(x, w_blk, b_blk16)))
        a_bytes = tok * 256 * 2 * 2 + 768 * 256 * 2 + 768 * 4 + 2 * tok * 64 * 4 + tok * 4
        a_ops = 2 * tok * 256 * 768 + 2 * 2 * batch * heads * hd * (n0 * n0 + n1 * n1)
        bnd, by = bound_ms(a_bytes, a_ops, BF16_TENSOR_FLOPS)
        rows["self_attention"] = dict(
            name="self_attention", route="cuda", source="pram_tpu_torch/csrc/attention.cu",
            replaces="pram_tpu/ops/attention_pallas.py:802",
            launches=None, max_abs_err=err,
            ms=cuda_ms(torch, lambda: attention.self_attention(*a_args, splits=splits)),
            plain_ms=cuda_ms(torch, lambda: attention.self_attention_plain(*a_args, splits=splits), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=lib_ms, ms_32x512=k1_512_ms, **proj1,
        )
        log(f"self_attention (GML, splits): {rows['self_attention']['ms']:.4f} ms, of which the projection "
            f"{proj1['proj_ms']:.4f} ms alone ({proj1['proj_plain_epilogue_ms']:.4f} ms without the rotary; "
            f"bound {p_bnd:.4f} ms, {p_by}; cuBLAS F.linear {proj1['linear_ms']:.4f} ms); SDPA "
            f"{lib_ms:.4f} ms, SDPA + F.linear "
            f"{lib_ms + proj1['linear_ms']:.4f} ms")

        # kernel 2 over all 1536 tokens
        m_args = (
            x, msg, blk.proj.weight, blk.proj.bias, blk.mlp_0.weight, blk.mlp_0.bias,
            blk.mlp_ln.weight, blk.mlp_ln.bias, blk.mlp_3.weight, blk.mlp_3.bias,
        )
        # (the TMA/wgmma tile of csrc/mlp_tile.cuh: 0 bytes spilled, two
        # launches bit-equal, timed beside its bound and the eager chain)
        require_no_spills(_build, ("mlp.cu",))
        y = mlp.residual_mlp(*m_args)
        err = check_scaled("residual_mlp (GML)", y, mlp.residual_mlp_plain(*m_args), MLP_TOL)
        require(torch.equal(mlp.residual_mlp(*m_args), y), "residual_mlp (GML): two launches differ")
        bnd, by = mlp_bound(tok, False)
        k2_dev_ms, k2_dev_by = mlp_device_ms(torch, mlp.residual_mlp, m_args)
        rows["residual_mlp"] = dict(
            name="residual_mlp", route="cuda", source="pram_tpu_torch/csrc/mlp.cu",
            replaces="pram_tpu/ops/mlp_pallas.py:175",
            launches=None, max_abs_err=err,
            ms=cuda_ms(torch, lambda: mlp.residual_mlp(*m_args)),
            plain_ms=cuda_ms(torch, lambda: mlp.residual_mlp_plain(*m_args), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=None,
            device_ms=k2_dev_ms, device_ms_by=k2_dev_by,
            library_chain_ms=cuda_ms(torch, lambda: mlp_chain(*m_args)), **k2_16384,
        )
        log(f"residual_mlp (GML, {tok} tokens): {rows['residual_mlp']['ms']:.4f} ms a call, the kernel "
            f"{rows['residual_mlp']['device_ms']:.4f} ms ({k2_dev_by}), against its bound {bnd:.4f} ms ({by}); "
            f"the eager bf16 chain {rows['residual_mlp']['library_chain_ms']:.4f} ms")

        # kernel 5 on layer 0's cross-attention input
        cblk = gml.cross_attn[0]
        b0 = attention.mask_to_bias(m0, batch, n0, dev)
        b1 = attention.mask_to_bias(m1, batch, n1, dev)
        c_args = (y, cblk.to_qk.weight, cblk.to_qk.bias, cblk.to_v.weight, cblk.to_v.bias,
                  b0, b1, gscale, heads, n0)
        cmsg = cross_attention.cross_attention(*c_args)
        err = check_scaled("cross_attention", cmsg, cross_attention.cross_attention_plain(*c_args), ATTN_TOL)
        # library yardstick: two SDPA calls (one per direction) on the
        # projected qk and v
        qk = (y.float() @ cblk.to_qk.weight.float().T + cblk.to_qk.bias.float()).to(bf16)
        vv = (y.float() @ cblk.to_v.weight.float().T + cblk.to_v.bias.float()).to(bf16)
        qk = qk.reshape(batch, n0 + n1, heads, hd).transpose(1, 2)
        vv = vv.reshape(batch, n0 + n1, heads, hd).transpose(1, 2)
        qk0, qk1 = qk[:, :, :n0].contiguous(), qk[:, :, n0:].contiguous()
        v0, v1 = vv[:, :, :n0].contiguous(), vv[:, :, n0:].contiguous()
        mk0, mk1 = m0[:, None, None, :], m1[:, None, None, :]

        def two_sdpa():
            sdpa(qk0, qk1, v1, attn_mask=mk1, scale=gscale)
            sdpa(qk1, qk0, v0, attn_mask=mk0, scale=gscale)

        lib_ms = cuda_ms(torch, two_sdpa)
        require(torch.equal(cross_attention.cross_attention(*c_args), cmsg), "cross_attention: two launches differ")
        # its projection pass alone ([to_qk | to_v] rows into qk and v)
        # against the plain projection, and cuBLAS's F.linear of the same
        w_cat = torch.cat([cblk.to_qk.weight, cblk.to_v.weight])
        b_cat = torch.cat([cblk.to_qk.bias.float(), cblk.to_v.bias.float()])
        check_projection("projection (kernel 5, 512 columns into qk and v)",
                         torch.cat(attention.project(y, w_cat, b_cat, split=256), -1),
                         attention.project_plain(y, w_cat, b_cat))
        p_bnd, p_by = bound_ms(tok * (256 * 2 + 512 * 2) + 512 * (256 * 2 + 4),
                               2.0 * tok * 256 * 512, BF16_TENSOR_FLOPS)
        b_cat16 = b_cat.to(bf16)
        proj5 = dict(proj_ms=cuda_ms(torch, lambda: attention.project(y, w_cat, b_cat, split=256)),
                     proj_bound_ms=p_bnd, linear_ms=cuda_ms(torch, lambda: F.linear(y, w_cat, b_cat16)))
        c_bytes = 2 * tok * 256 * 2 + 2 * 256 * 256 * 2 + 2 * 256 * 4 + tok * 4
        c_ops = 2 * tok * 256 * 512 + 3 * 2 * batch * heads * hd * n0 * n1
        bnd, by = bound_ms(c_bytes, c_ops, BF16_TENSOR_FLOPS)
        rows["cross_attention"] = dict(
            name="cross_attention", route="cuda", source="pram_tpu_torch/csrc/cross_attention.cu",
            replaces="pram_tpu/ops/attention_pallas.py:957",
            launches=None, max_abs_err=err,
            ms=cuda_ms(torch, lambda: cross_attention.cross_attention(*c_args)),
            plain_ms=cuda_ms(torch, lambda: cross_attention.cross_attention_plain(*c_args), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=lib_ms, **proj5,
        )
        log(f"cross_attention: {rows['cross_attention']['ms']:.4f} ms, of which the projection "
            f"{proj5['proj_ms']:.4f} ms alone (bound {p_bnd:.4f} ms, {p_by}; cuBLAS F.linear "
            f"{proj5['linear_ms']:.4f} ms); two SDPA {lib_ms:.4f} ms, two SDPA + F.linear "
            f"{lib_ms + proj5['linear_ms']:.4f} ms")

        # kernel 6 on the trained GML's similarity of this batch
        out = gml(d0, d1, nk0, nk1, m0, m1)
        sim = (out["mdesc0"].float() @ out["mdesc1"].float().transpose(1, 2)).contiguous()
        k_args = (sim, gml.bin_score, gml.config.sinkhorn_iterations, m0, m1)
        plan = sinkhorn.sinkhorn(*k_args)
        plan_ref = sinkhorn.sinkhorn_matching(*k_args)
        err = (plan[:, :n0, :n1] - plan_ref[:, :n0, :n1]).abs().max().item()
        rel = max(
            ((a - r).abs() / r.abs().clamp(min=1e-6)).max().item()
            for a, r in ((plan[:, n0], plan_ref[:, n0]), (plan[:, :, n1], plan_ref[:, :, n1]))
        )
        log(f"sinkhorn: real block max abs err {err:.3e} (tol {SINKHORN_ATOL}), dustbin max "
            f"relative err {rel:.3e} (tol {SINKHORN_DUSTBIN_RTOL})")
        require(err <= SINKHORN_ATOL and rel <= SINKHORN_DUSTBIN_RTOL,
                "sinkhorn kernel disagrees with its plain version")
        require(torch.equal(sinkhorn.sinkhorn(*k_args).view(torch.int32), plan.view(torch.int32)),
                "sinkhorn: two launches differ")
        cl_size, cl_active = sinkhorn.instance(n0, n1, dev)
        log(f"sinkhorn ({batch} x {n0} x {n1}): the cluster instance with {cl_size} blocks a problem; "
            f"cudaOccupancyMaxActiveClusters places {cl_active} such clusters at once")
        require(cl_size > 0, "sinkhorn: GML's shape did not take the cluster instance")
        plan_elems = batch * (n0 + 1) * (n1 + 1)
        k_bytes = sim.numel() * 4 + plan_elems * 4 + batch * (n0 + n1 + 2) * 4
        # softmax ~4 ops an entry, each iteration 4 (row and column multiply-add), the plan 2
        k_ops = plan_elems * (4 + 4 * gml.config.sinkhorn_iterations + 2)
        bnd, by = bound_ms(k_bytes, k_ops, F32_FLOPS)
        require_no_spills(_build, ("sinkhorn.cu", "nms.cu"))
        require(all(k[2] == 0 for src in ("sinkhorn.cu", "nms.cu") for k in ptxas_summary(_build, src).values()),
                "a kernel of sinkhorn.cu / nms.cu keeps an array on the stack")
        rows["sinkhorn"] = dict(
            name="sinkhorn", route="cuda", source="pram_tpu_torch/csrc/sinkhorn.cu",
            replaces="pram_tpu/ops/sinkhorn_pallas.py:70",
            launches=None, max_abs_err=err,
            ms=cuda_ms(torch, lambda: sinkhorn.sinkhorn(*k_args)),
            plain_ms=cuda_ms(torch, lambda: sinkhorn.sinkhorn_matching(*k_args), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=None,
            device_ms=launch_ms(torch, lambda: sinkhorn.sinkhorn(*k_args),
                                want=lambda k: k == "cluster_kernel").get("cluster_kernel"),
            cluster=cl_size, active_clusters=cl_active, ptxas=ptxas_summary(_build, "sinkhorn.cu"),
        )
        log(f"sinkhorn: {rows['sinkhorn']['ms']:.4f} ms a call (CUDA events), the kernel "
            f"{rows['sinkhorn']['device_ms']} ms a launch (torch.profiler); bound {bnd:.4f} ms ({by}); "
            f"ptxas {rows['sinkhorn']['ptxas']}")

        # kernel 7 on the refinement inputs of the first slice's poses
        cam_dev = Camera(cam_params.to(dev), cam_size.to(dev))
        dmap = loc_gpu.dmap
        rank = rank_candidates(dmap.seg_vrf_slot, dmap.vrf_frame_idx, logits_gpu, mask.to(dev), gml_cfg)
        rset = gather_refine_set(dmap, rank.safe_slots[:, 0])
        ruv, in_img = project_refine_set(cam_dev, rset, res_gpu.R, res_gpu.tvec)
        r_args = (d.contiguous(), rset.desc.contiguous(), kpts.to(dev).contiguous(), ruv, in_img,
                  rank.mask.contiguous(), 2.0 * gml_cfg.threshold, gml_cfg.projection_ratio)
        idx, dd1, keep = refine.refine_nn(*r_args)
        ridx, rd1, rkeep = refine.refine_nn_plain(*r_args)
        qm = rank.mask
        idx_agree = (idx == ridx)[qm].float().mean().item()
        keep_agree = (keep == rkeep).float().mean().item()
        err = (dd1 - rd1).abs().max().item()
        log(f"refine_nn: index agreement {idx_agree:.5f}, keep agreement {keep_agree:.5f} "
            f"(tol {REFINE_AGREE}), max |d1 diff| {err:.3e} (tol {REFINE_D1_ATOL}); kept "
            f"{int(keep.sum())} of {int(qm.sum())} valid queries")
        require(idx_agree >= REFINE_AGREE and keep_agree >= REFINE_AGREE and err <= REFINE_D1_ATOL,
                "refine_nn kernel disagrees with its plain version")
        again = refine.refine_nn(*r_args)
        require(all(torch.equal(a, b) for a, b in zip(again, (idx, dd1, keep))), "refine_nn: two launches differ")
        n_pts = rset.desc.shape[1]
        rows["refine_nn"] = dict(
            name="refine_nn", route="cuda", source="pram_tpu_torch/csrc/refine.cu",
            replaces="pram_tpu/ops/refine_pallas.py:139",
            launches=None, max_abs_err=err,
            ms=cuda_ms(torch, lambda: refine.refine_nn(*r_args)),
            plain_ms=cuda_ms(torch, lambda: refine.refine_nn_plain(*r_args), iters=5),
            library_ms=None, **refine_bound(batch, n0, n_pts),
            device_ms=launch_ms(torch, lambda: refine.refine_nn(*r_args),
                                want=lambda k: k == "refine_nn_kernel").get("refine_nn_kernel"),
            ptxas=ptxas_summary(_build, "refine.cu"),
        )
        log(f"refine_nn ({batch} x {n0} x {n_pts}): {rows['refine_nn']['ms']:.4f} ms a call (CUDA events), "
            f"the kernel {rows['refine_nn']['device_ms']} ms a launch (torch.profiler); bound "
            f"{rows['refine_nn']['bound_ms']:.4f} ms ({rows['refine_nn']['bound_by']}); "
            f"ptxas {rows['refine_nn']['ptxas']}")
        # GML layer 0's activations, for the backward kernels of phase 15
        gml_l0 = dict(x=x, cos=cos, sin=sin, m0=m0, m1=m1, y=y, splits=splits)
    phase("gml_kernels", t)

    # ---- 7. the second slice: recognition -> GML -> PnP -> refinement, counted
    t = time.perf_counter()
    gml_fn = make_gml_match_fn(gml, gml.config.match_threshold)
    reset_counts()
    gloc = make_localizer(dev, gml_fn, gml_cfg)
    with torch.no_grad():
        _, gres_gpu, _, _ = run_slice(dev, model, gloc)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"GML slice launches: {launches}")
    for name, count in launches.items():
        # later slices' kernels and the standalone projection wrapper aside
        if name not in ("fused_stem", "nms") + ada_kernels + train_kernels + int8_kernels + pass_only + wide_only:
            require(count > 0, f"kernel {name} was not launched on the GML slice")
    require(tuple(gres_gpu.qvec.shape) == (batch, 4), "bad pose batch shape")
    require(bool(torch.isfinite(gres_gpu.tvec).all()), "non-finite poses")
    gml_launches = launches
    grecall_gpu, gq_err, gt_err = recall_of(gres_gpu)

    matcher_s = []

    def timed_gml(*args):
        t_m = sync(dev)
        out = gml_fn(*args)
        matcher_s.append(sync(dev) - t_m)
        return out

    gloc.match_fn = timed_gml
    with torch.no_grad():
        timed = [run_slice(dev, model, gloc)[2:] for _ in range(6)][1:]
    gloc.match_fn = gml_fn
    rec_s = sorted(r for r, _ in timed)[2]
    loc_s = sorted(lo for _, lo in timed)[2]
    batch_s = sorted(r + lo for r, lo in timed)[2]
    match_s = sorted(matcher_s[1:])[2]
    refined = (gres_gpu.num_inliers != gres_gpu.initial_num_inliers).sum().item()
    log(f"GML slice on card: recall@5cm/5deg {grecall_gpu:.4f} over {batch} queries (max error "
        f"{gq_err.max().item():.4f} deg, {gt_err.max().item():.5f} m; final inlier count "
        f"differs from the first RANSAC's on {refined}); batch {batch} in {batch_s * 1e3:.2f} ms (median of 5; recognition "
        f"{rec_s * 1e3:.2f} ms, localization {loc_s * 1e3:.2f} ms of which GML matching "
        f"{match_s * 1e3:.2f} ms) = {batch / batch_s:.1f} queries/s")

    # the same batch on the CPU through the plain versions, same RANSAC noise
    # in both RANSAC calls (drawn on the CPU from one seed)
    t_cpu = time.perf_counter()
    gml_cpu = load_gml(gml_weights, GMLConfig(), device="cpu", dtype=bf16)
    with torch.no_grad():
        _, gres_cpu, _, _ = run_slice(
            "cpu", model_cpu,
            make_localizer("cpu", make_gml_match_fn(gml_cpu, gml_cpu.config.match_threshold), gml_cfg),
        )
    log(f"GML slice on the CPU: {batch} queries in {time.perf_counter() - t_cpu:.1f} s")
    compare_with_cpu("GML slice", gres_gpu, gres_cpu, grecall_gpu)
    del model_cpu, gml_cpu
    phase("gml_slice", t)

    # ---- 8. the image slice's guard: models in bf16, the map built on the card
    t = time.perf_counter()
    guard = RenderedGuard(batch=batch, device=dev, dtype=bf16)
    torch.cuda.synchronize()
    image_map_points = guard.scene.map.num_points
    log(f"rendered map: {guard.scene.map.num_points} points, {guard.scene.map.num_frames} frames, "
        f"n_class {guard.n_class}")
    q_imgs, q_qvecs, q_tvecs = render_views(batch, 11, guard.scene.world)
    q_imgs = apply_noise(q_imgs, np.random.RandomState(12))
    phase("image_setup", t)

    # ---- 9. the third slice's kernels vs plain versions at its shapes
    t = time.perf_counter()
    sfd2 = guard.sfd2
    h_img, w_img = q_imgs.shape[1:3]
    with torch.no_grad():
        x = preprocess_image(torch.from_numpy(q_imgs).to(dev)).to(bf16).contiguous()
        st_args = (*sfd2.conv1a.stem_args(), *sfd2.conv1b.stem_args())
        y = stem.fused_stem(x, *st_args)
        err = check_scaled("fused_stem (bf16)", y, stem.fused_stem_plain(x, *st_args), STEM_TOL)
        sfd2_f32 = load_sfd2(SFD2_W, device=dev, dtype=torch.float32)
        x32 = preprocess_image(torch.from_numpy(q_imgs).to(dev)).contiguous()
        st32 = (*sfd2_f32.conv1a.stem_args(), *sfd2_f32.conv1b.stem_args())
        y32, r32 = stem.fused_stem(x32, *st32), stem.fused_stem_plain(x32, *st32)
        err32 = (y32 - r32).abs().max().item()
        excess = ((y32 - r32).abs() - STEM_F32_TOL * r32.abs()).max().item()
        log(f"fused_stem (f32): max abs err {err32:.3e} over max|ref| {r32.abs().max().item():.3e} "
            f"(rtol = atol = {STEM_F32_TOL})")
        require(excess <= STEM_F32_TOL, "fused_stem (f32) kernel disagrees with its plain version")
        # library yardstick: two cuDNN convolutions (bf16, channels_last,
        # folded weights) with ReLU
        k1f, b1f = stem.fold_bn(*sfd2.conv1a.stem_args()[:2], *sfd2.conv1a.stem_args()[2])
        k2f, b2f = stem.fold_bn(*sfd2.conv1b.stem_args()[:2], *sfd2.conv1b.stem_args()[2])
        cl = torch.channels_last
        k1c, k2c = k1f.to(bf16).contiguous(memory_format=cl), k2f.to(bf16).contiguous(memory_format=cl)
        b1c, b2c = b1f.to(bf16), b2f.to(bf16)
        xc = x.permute(0, 3, 1, 2)
        conv = torch.nn.functional.conv2d

        def cudnn_stem():
            a = torch.relu(conv(xc, k1c, b1c, padding=1))
            return torch.relu(conv(a, k2c, b2c, stride=2, padding=1))

        lib_ms = cuda_ms(torch, cudnn_stem)
        n_img, n_out = batch * h_img * w_img, y.shape[0] * y.shape[1] * y.shape[2]
        s_bytes = n_img * 3 * 2 + n_out * 64 * 2 + (27 + 576) * 64 * 2 + 2 * 64 * 4
        s_ops = 2.0 * (27 * 64 * n_img + 576 * 64 * n_out)
        bnd, by = bound_ms(s_bytes, s_ops, BF16_TENSOR_FLOPS)
        rows["fused_stem"] = dict(
            name="fused_stem", route="cuda", source="pram_tpu_torch/csrc/stem.cu",
            replaces="pram_tpu/ops/stem_pallas.py:198",
            launches=None, max_abs_err=err,
            ms=cuda_ms(torch, lambda: stem.fused_stem(x, *st_args)),
            plain_ms=cuda_ms(torch, lambda: stem.fused_stem_plain(x, *st_args), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=lib_ms,
        )
        require(torch.equal(stem.fused_stem(x, *st_args), y), "fused_stem (bf16): two launches differ")
        require(torch.equal(stem.fused_stem(x32, *st32), y32), "fused_stem (f32): two launches differ")
        require_no_spills(_build, ("stem.cu",))
        st_dev = launch_ms(torch, lambda: stem.fused_stem(x, *st_args),
                           want=lambda k: k == "stem_kernel_bf16").get("stem_kernel_bf16")
        log(f"fused_stem (bf16, {batch} x {h_img} x {w_img}): {rows['fused_stem']['ms']:.4f} ms a call "
            f"(CUDA events, the wrapper's BN folding included), the kernel {st_dev} ms a launch "
            f"(torch.profiler); bound {bnd:.4f} ms ({by}; it counts conv1a's K as its 27 taps x channels, "
            f"the kernel multiplies 32, zero-padded: {2.0 * 32 * 64 * n_img / 1e9:.1f} against "
            f"{2.0 * 27 * 64 * n_img / 1e9:.1f} GFLOP of conv1a); cuDNN's pair {lib_ms:.4f} ms")
        log(f"fused_stem f32: {cuda_ms(torch, lambda: stem.fused_stem(x32, *st32), iters=5):.4f} ms")

        # kernel 9 on the model's score maps of the same images
        smap = sfd2(x)["score_map"]
        smap32 = sfd2_f32(x32)["score_map"]
        for name, sm in (("bf16", smap), ("f32", smap32)):
            got, ref = nms.nms(sm, 4), nms.simple_nms(sm, 4)
            diff = int((got != ref).sum().item())
            log(f"nms ({name}): {diff} elements differ of {ref.numel()}; "
                f"{int((ref > 0).sum().item())} maxima survive")
            require(diff == 0, f"nms ({name}) kernel is not bit-equal to its plain version")
            require(torch.equal(nms.nms(sm, 4), got), f"nms ({name}): two launches differ")
        n_px = smap.numel()
        # The cheapest exact form of the chain, a pixel: three float pools at
        # ~3 max a pixel a direction (van Herk / Gil-Werman), two binary pools
        # as word operations (a column OR of 2R + 1 words, 2R funnel shifts and
        # 2R ORs along the row, for 32 pixels), three equality tests, the two
        # re-detections' and-not and or, the output's select. The bytes bind.
        nms_r = 4
        nms_ops = n_px * (3 * 2 * 3 + 2 * 6 * nms_r / 32 + 3 + 2 * 2 + 1)
        bnd, by = bound_ms(2 * n_px * smap.element_size(), nms_ops, F32_FLOPS)
        rows["nms"] = dict(
            name="nms", route="cuda", source="pram_tpu_torch/csrc/nms.cu",
            replaces="pram_tpu/ops/nms_pallas.py:102",
            launches=None, max_abs_err=0.0,
            ms=cuda_ms(torch, lambda: nms.nms(smap, nms_r)),
            plain_ms=cuda_ms(torch, lambda: nms.simple_nms(smap, nms_r), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=None,
            device_ms=launch_ms(torch, lambda: nms.nms(smap, nms_r),
                                want=lambda k: k == "nms_kernel").get("nms_kernel"),
            f32_ms=cuda_ms(torch, lambda: nms.nms(smap32, nms_r), iters=5),
            ptxas=ptxas_summary(_build, "nms.cu"),
        )
        log(f"nms (bf16, {tuple(smap.shape)}): {rows['nms']['ms']:.4f} ms a call (CUDA events), the kernel "
            f"{rows['nms']['device_ms']} ms a launch (torch.profiler); f32 {rows['nms']['f32_ms']:.4f} ms; "
            f"bound {bnd:.4f} ms ({by}: {2 * n_px * smap.element_size() / 1e6:.1f} MB, "
            f"{nms_ops / n_px:.2f} operations a pixel); ptxas {rows['nms']['ptxas']}")
        del sfd2_f32, x32, y32, r32, smap32
    phase("extract_kernels", t)

    # ---- 10. the image slice (the main path), counted
    t = time.perf_counter()
    reset_counts()
    metrics = guard.recall(n_queries=batch, noise=True, seed=11)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"image slice launches: {launches}")
    for name, count in launches.items():
        if name not in ada_kernels + train_kernels + int8_kernels + pass_only + wide_only:
            require(count > 0, f"kernel {name} was not launched on the image slice")
    log(f"image slice on card: {json.dumps(metrics)}")
    require(metrics["n_queries"] == batch, "image slice did not localize every query")
    require(metrics["recall"] == 1.0, "image slice recall@5cm/5deg below 1.0")

    gen = torch.Generator()

    def one_batch():
        guard.pipeline(gen.manual_seed(7), q_imgs)
        torch.cuda.synchronize()

    def one_extract():
        guard.extract(q_imgs, 512)
        torch.cuda.synchronize()

    def one_front():
        guard.front(q_imgs)
        torch.cuda.synchronize()

    def one_copy():  # the images' way onto the card in RenderedGuard.extract
        torch.as_tensor(q_imgs).to(dev, torch.float32)
        torch.cuda.synchronize()

    batch_s, ext_s, front_s = median_s(one_batch), median_s(one_extract), median_s(one_front)
    copy_s = median_s(one_copy)
    with torch.no_grad():
        x_dev = torch.as_tensor(q_imgs).to(dev, torch.float32)
        pre_ms = cuda_ms(torch, lambda: preprocess_image(x_dev).to(bf16), iters=5)
        xs = preprocess_image(x_dev).to(bf16).contiguous()
        out = sfd2(xs)
        nmsd = nms.nms(out["score_map"], 4)
        kps = keypoints.extract_keypoints(nmsd, max_keypoints=512, conf_th=1e-4)
        dmap = out["desc_map"].permute(0, 3, 1, 2)
        mid = out["mid_features"].permute(0, 3, 1, 2)
        fwd_ms = cuda_ms(torch, lambda: sfd2(xs), iters=5)
        topk_ms = cuda_ms(torch, lambda: keypoints.extract_keypoints(nmsd, max_keypoints=512, conf_th=1e-4), iters=5)
        samp_ms = cuda_ms(torch, lambda: (sampling.sample_descriptors(kps.xy, dmap, 4),
                                          sampling.sample_descriptors(kps.xy, mid, 4)), iters=5)
    log(f"image slice: batch {batch} in {batch_s * 1e3:.2f} ms (median of 5, host clock, synchronized) "
        f"= {batch / batch_s:.1f} queries/s; extraction {ext_s * 1e3:.2f} ms, extraction + recognition "
        f"{front_s * 1e3:.2f} ms, localization {(batch_s - front_s) * 1e3:.2f} ms")
    log(f"extraction by CUDA events: SFD2 forward {fwd_ms:.3f} ms (stem kernel {rows['fused_stem']['ms']:.3f}, "
        f"other convolutions and heads {fwd_ms - rows['fused_stem']['ms']:.3f}), NMS {rows['nms']['ms']:.4f}, "
        f"top-k {topk_ms:.3f}, sampling {samp_ms:.3f}")
    staged_ms = copy_s * 1e3 + pre_ms + fwd_ms + rows["nms"]["ms"] + topk_ms + samp_ms
    log(f"extraction's host side: copy of the {q_imgs.nbytes / 1e6:.1f} MB of {q_imgs.dtype} images "
        f"from pageable numpy memory {copy_s * 1e3:.2f} ms (host clock, synchronized, median of 5) "
        f"= {q_imgs.nbytes / copy_s / 1e9:.2f} GB/s; preprocessing and cast {pre_ms:.3f} ms (CUDA events); "
        f"unattributed {ext_s * 1e3 - staged_ms:.2f} ms of {ext_s * 1e3:.2f}")

    for name, dt, thr in (("bf16", bf16, AB_BF16), ("f32", torch.float32, AB_F32)):
        ab = extraction_ab_check(n_images=4, seed=13, device=dev, dtype=dt)
        log(f"extraction A/B ({name}, kernel path vs plain path): {json.dumps(ab)}")
        require(ab["kpt_set_agreement"] >= thr[0] and ab["desc_cos_min"] >= thr[1],
                f"extraction A/B ({name}) below {thr}")
    phase("image_slice", t)
    image_launches = launches
    r_scene = guard.scene  # the rendered map (numpy), for phase 25's card vs CPU check
    del guard, sfd2

    # ---- 11. the AdaGML slice at scripts/bench_aachen.py's operating point
    t = time.perf_counter()
    a_w, a_h, a_kpts, a_cls, a_batch, n_batches = 1024, 768, 4096, 512, 8, 4
    ada_w = str(root / "weights" / "adagml_aachen.msgpack")
    ada = load_adagml(ada_w, AdaGMLConfig(), device=dev, dtype=bf16)
    a_scene = make_synthetic_scene(
        np.random.RandomState(0), n_cluster=a_cls, points_per_cluster=40, n_ref_frames=24,
        desc_dim=128, width=a_w, height=a_h, max_kp_per_frame=2048, max_ref_points=4096,
    )
    qrng = np.random.RandomState(11)
    a_queries = [
        a_scene.render_query(qrng, noise_px=0.5, desc_noise=0.05, max_kpts=a_kpts)
        for _ in range(a_batch * n_batches)
    ]
    a_batches = [a_queries[i * a_batch:(i + 1) * a_batch] for i in range(n_batches)]

    def a_stack(qs, key, dtype=np.float32):
        return torch.from_numpy(np.stack([q[key] for q in qs]).astype(dtype))

    def a_inputs(qs, device):
        """(camera, kpts, scores, descs, mask, logits) of queries qs on device;
        the logits route by the ground truth: -10, and +10 at the true class."""
        n = len(qs)
        cls = np.stack([np.where(q["gt_seg"] >= 0, q["gt_seg"] + 1, 0) for q in qs])
        logits = np.full((n, a_kpts, a_cls + 1), -10.0, np.float32)
        np.put_along_axis(logits, cls[..., None], 10.0, axis=2)
        cam = Camera(
            torch.tensor([500.0, 500.0, a_w / 2, a_h / 2, 0, 0, 0, 0]).repeat(n, 1).to(device),
            torch.tensor([float(a_w), float(a_h)]).repeat(n, 1).to(device),
        )
        return (cam, a_stack(qs, "keypoints").to(device), a_stack(qs, "scores").to(device),
                a_stack(qs, "descriptors").to(device, bf16), a_stack(qs, "mask", bool).to(device),
                torch.from_numpy(logits).to(device))

    a_cfg = LocConfig(seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128,
                      do_refinement=True, gn_iters=5, lo_rounds=1)
    ada_fn = make_adagml_match_fn(ada, ada.config.match_threshold)
    a_loc = Localizer(to_device(a_scene.map, dev, desc_dtype=bf16), ada_fn, a_cfg)
    log(f"Aachen scene: {a_scene.map.num_points} points, {a_scene.map.num_frames} frames of "
        f"{a_scene.map.frame_kp_mask.shape[1]} keypoints, {a_scene.map.vrf_ref_point_idx.shape[1]} "
        f"refinement points, n_class {a_scene.map.n_class}; {len(a_queries)} queries of {a_kpts} keypoints")
    # the Aachen CLI's layout for phase 26, and its CPU side started now in
    # a child process that takes the cores the next phases leave idle
    a_layout = aachen_cli_layout(root, a_scene, a_queries, gml_weights)
    cli_cpu = start_cli_cpu(root, a_layout)
    phase("aachen_setup", t)

    # ---- 12. kernels 10-12 vs plain versions at the slice's shapes, on the
    # matcher inputs of batch 0 (recorded on an uncounted run)
    t = time.perf_counter()
    ada_inputs = []

    def recording_ada(*args):
        ada_inputs.append(args)
        return ada_fn(*args)

    a_loc.match_fn = recording_ada
    # and the first inputs kernels 7 and 4 take on this run
    from pram_tpu_torch.engine import localizer as localizer_mod
    k47_inputs = {}

    def recording(name, fn):
        def wrapped(*args, **kwargs):
            k47_inputs.setdefault(name, (args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    polish_fn = pnp.gn_polish
    localizer_mod.refine_nn = recording("refine_nn", refine.refine_nn)
    pnp.gn_polish = recording("gn_polish", polish_fn)
    try:
        with torch.no_grad():
            a_loc.localize_batch(torch.Generator().manual_seed(7), *a_inputs(a_batches[0], dev))
    finally:
        localizer_mod.refine_nn = refine.refine_nn
        pnp.gn_polish = polish_fn
    a_loc.match_fn = ada_fn
    d0, nk0, _, m0, d1, nk1, _, m1 = ada_inputs[0]
    n0, n1 = d0.shape[1], d1.shape[1]
    heads = ada.config.num_heads
    hd = ada.config.hidden_dim // heads
    ascale = hd**-0.5
    # masks with pruned, padded and fully masked tokens
    km0, km1 = m0.clone(), m1.clone()
    km0[0, ::7] = False
    km0[1, 3 * n0 // 4:] = False
    km0[-1] = False
    km1[0, ::5] = False
    km1[1, 3 * n1 // 4:] = False
    km1[-2] = False

    def rotated_heads(qkv, enc, n):
        """q, k (rotated, rounded) and v ``[B, H, n, hd]`` of a packed qkv."""
        t_ = qkv.reshape(a_batch, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        rot = (enc[0][:, None], enc[1][:, None])
        q_ = attention.apply_rotary(rot, t_[0].float()).to(bf16).contiguous()
        k_ = attention.apply_rotary(rot, t_[1].float()).to(bf16).contiguous()
        return q_, k_, t_[2].contiguous()

    with torch.no_grad():
        x0 = d0 @ ada.input_proj.weight.T + ada.input_proj.bias
        x1 = d1 @ ada.input_proj.weight.T + ada.input_proj.bias
        enc0, enc1 = ada.poseenc(nk0), ada.poseenc(nk1)
        sa = ada.self_attn[0]
        wp, bp = attention_qkv.permute_qkv_kernel(sa.qkv.weight.T, sa.qkv.bias, heads, hd)
        k10 = dict(err=0.0, ms=0.0, plain_ms=0.0, lib=0.0, no_stats_ms=0.0, bytes=0.0, ops=0.0,
                   stats_ops=0.0, exps=0.0)
        for x, enc, km in ((x0, enc0, km0), (x1, enc1, km1)):
            n = x.shape[1]
            qkv = (x @ wp + bp).contiguous()
            kb = attention.mask_to_bias(km, a_batch, n, dev)
            s_args = (qkv, enc[0], enc[1], kb, ascale, heads)
            msg, stat = attention_qkv.self_attention_qkv(*s_args, return_stats=True)
            rmsg, rstat = attention_qkv.self_attention_qkv_plain(*s_args, return_stats=True)
            err = check_scaled(f"self_attention_qkv messages ({a_batch} x {n} tokens)", msg, rmsg, ATTN_TOL)
            check_scaled(f"self_attention_qkv statistics ({a_batch} x {n} tokens)", stat, rstat, STATS_TOL)
            require(bool((stat[~km.any(-1)] == 0).all()), "a frame without valid queries gave mass")
            msg2, stat2 = attention_qkv.self_attention_qkv(*s_args, return_stats=True)
            require(torch.equal(msg2, msg) and torch.equal(stat2, stat),
                    f"self_attention_qkv ({a_batch} x {n} tokens): two launches differ")
            require(torch.equal(attention_qkv.self_attention_qkv(*s_args), msg),
                    "self_attention_qkv messages change with the statistics")
            q_, k_, v_ = rotated_heads(qkv, enc, n)
            # library yardstick: one SDPA call on the rotated q, k and v with
            # the key mask (the messages without the statistics)
            side = dict(
                lib=cuda_ms(torch, lambda: sdpa(q_, k_, v_, attn_mask=km[:, None, None, :], scale=ascale)),
                ms=cuda_ms(torch, lambda: attention_qkv.self_attention_qkv(*s_args, return_stats=True)),
                plain_ms=cuda_ms(
                    torch, lambda: attention_qkv.self_attention_qkv_plain(*s_args, return_stats=True), iters=3),
                no_stats_ms=cuda_ms(torch, lambda: attention_qkv.self_attention_qkv(*s_args)),
            )
            log(f"self_attention_qkv ({a_batch} x {n} tokens): {side['ms']:.4f} ms with statistics, "
                f"{side['no_stats_ms']:.4f} ms without; plain {side['plain_ms']:.4f} ms; SDPA {side['lib']:.4f} ms")
            for key in ("lib", "ms", "plain_ms", "no_stats_ms"):
                k10[key] += side[key]
            k10["err"] = max(k10["err"], err)
            tok = a_batch * n
            n_valid = int(km.sum())  # the statistics sum over the valid queries only
            # qkv, cos, sin, bias in; messages and statistics out
            k10["bytes"] += tok * (768 * 2 + 2 * 64 * 4 + 4 + 256 * 2 + 4)
            k10["ops"] += 4.0 * a_batch * heads * n * n * hd  # QK and PV
            k10["stats_ops"] += 2.0 * heads * n_valid * n * hd  # the statistics' QK once more
            k10["exps"] += heads * n * (a_batch * n + n_valid)  # one a weight, one a statistic term
        k10_bounds = attention_bounds("self_attention_qkv, one layer's two sides", k10)
        rows["self_attention_qkv"] = dict(
            name="self_attention_qkv", route="cuda", source="pram_tpu_torch/csrc/attention_qkv.cu",
            replaces="pram_tpu/ops/attention_pallas.py:349",
            launches=None, max_abs_err=k10["err"], ms=k10["ms"], plain_ms=k10["plain_ms"],
            library_ms=k10["lib"], **k10_bounds,
        )

        # kernel 11 on layer 0's cross-attention input
        nx0, _ = sa(x0, enc0, km0)
        nx1, _ = sa(x1, enc1, km1)
        ca = ada.cross_attn[0]
        cat = torch.cat([nx0, nx1], 1)
        qk = cat @ ca.to_qk.weight.T + ca.to_qk.bias
        vv = cat @ ca.to_v.weight.T + ca.to_v.bias
        kb0 = attention.mask_to_bias(km0, a_batch, n0, dev)
        kb1 = attention.mask_to_bias(km1, a_batch, n1, dev)
        c_args = (qk[:, :n0], qk[:, n0:], vv[:, :n0], vv[:, n0:], kb0, kb1, ascale, heads)
        got = cross_attention.cross_attention_packed(*c_args, return_stats=True)
        ref = cross_attention.cross_attention_packed_plain(*c_args, return_stats=True)
        err = max(check_scaled(f"cross_attention_packed m{i} ({a_batch} x {n0} x {n1})", got[i], ref[i], ATTN_TOL)
                  for i in (0, 1))
        for i in (2, 3):
            check_scaled(f"cross_attention_packed stat{i - 2}", got[i], ref[i], STATS_TOL)
        again = cross_attention.cross_attention_packed(*c_args, return_stats=True)
        require(all(torch.equal(a, b) for a, b in zip(again, got)), "cross_attention_packed: two launches differ")
        no_stats = cross_attention.cross_attention_packed(*c_args)
        require(torch.equal(no_stats[0], got[0]) and torch.equal(no_stats[1], got[1]),
                "cross_attention_packed messages change with the statistics")
        qh = qk.reshape(a_batch, n0 + n1, heads, hd).transpose(1, 2)
        vh = vv.reshape(a_batch, n0 + n1, heads, hd).transpose(1, 2)
        q0_, q1_ = qh[:, :, :n0].contiguous(), qh[:, :, n0:].contiguous()
        v0_, v1_ = vh[:, :, :n0].contiguous(), vh[:, :, n0:].contiguous()

        def two_sdpa():
            sdpa(q0_, q1_, v1_, attn_mask=km1[:, None, None, :], scale=ascale)
            sdpa(q1_, q0_, v0_, attn_mask=km0[:, None, None, :], scale=ascale)

        nv0, nv1 = int(km0.sum()), int(km1.sum())
        k11 = dict(
            bytes=a_batch * (n0 + n1) * (2 * 256 * 2 + 4 + 256 * 2 + 4),
            ops=8.0 * a_batch * heads * n0 * n1 * hd,  # both directions' QK and PV
            stats_ops=2.0 * heads * hd * (n0 * nv1 + n1 * nv0),  # the statistics' QK over valid queries
            exps=heads * (2 * a_batch * n0 * n1 + n0 * nv1 + n1 * nv0),
            ms=cuda_ms(torch, lambda: cross_attention.cross_attention_packed(*c_args, return_stats=True)),
            no_stats_ms=cuda_ms(torch, lambda: cross_attention.cross_attention_packed(*c_args)),
            lib=cuda_ms(torch, two_sdpa),
        )
        log(f"cross_attention_packed ({a_batch} x {n0} x {n1}): {k11['ms']:.4f} ms with statistics, "
            f"{k11['no_stats_ms']:.4f} ms without; two SDPA {k11['lib']:.4f} ms")
        rows["cross_attention_packed"] = dict(
            name="cross_attention_packed", route="cuda",
            source="pram_tpu_torch/csrc/cross_attention_packed.cu",
            replaces="pram_tpu/ops/attention_pallas.py:647",
            launches=None, max_abs_err=err, ms=k11["ms"],
            plain_ms=cuda_ms(
                torch, lambda: cross_attention.cross_attention_packed_plain(*c_args, return_stats=True), iters=3),
            library_ms=k11["lib"], **attention_bounds(f"cross_attention_packed ({a_batch} x {n0} x {n1})", k11),
        )

        # kernel 12 at GML's splits, on the first slice's GML inputs
        g0, gk0, _, gm0, g1, gk1, _, gm1 = matcher_inputs[0]
        gn0, gn1 = g0.shape[1], g1.shape[1]
        gx = gml.input_proj(torch.cat([g0, g1], 1))
        gcos, gsin = gml.poseenc(torch.cat([gk0, gk1], 1))
        gm = torch.cat([gm0, gm1], 1)
        gb = gm.shape[0]
        gwp, gbp = attention_qkv.permute_qkv_kernel(
            gml.self_attn[0].qkv.weight.T, gml.self_attn[0].qkv.bias, heads, hd)
        gqkv = (gx @ gwp + gbp).contiguous()
        b_args = (gqkv, gcos, gsin, attention.mask_to_bias(gm, gb, gn0 + gn1, dev), gscale, heads)
        gsplits = (gn0, gn1)
        got = attention_qkv.self_attention_qkv(*b_args, splits=gsplits)
        err = check_scaled(
            f"self_attention_qkv_blocked (GML splits {gsplits})", got,
            attention_qkv.self_attention_qkv_plain(*b_args, splits=gsplits), ATTN_TOL)
        require(torch.equal(attention_qkv.self_attention_qkv(*b_args, splits=gsplits), got),
                "self_attention_qkv_blocked: two launches differ")
        gq = gqkv.reshape(gb, gn0 + gn1, 3, heads, hd).permute(2, 0, 3, 1, 4)
        genc = (gcos[:, None], gsin[:, None])
        gq_ = attention.apply_rotary(genc, gq[0].float()).to(bf16).contiguous()
        gk_ = attention.apply_rotary(genc, gq[1].float()).to(bf16).contiguous()
        gv_ = gq[2].contiguous()
        gside = torch.arange(gn0 + gn1, device=dev) >= gn0
        gmask = (gside[:, None] == gside[None, :])[None, None] & gm[:, None, None, :]
        tok = gb * (gn0 + gn1)
        bnd, by = bound_ms(tok * (768 * 2 + 2 * 64 * 4 + 4 + 256 * 2),
                           4.0 * gb * heads * hd * (gn0 * gn0 + gn1 * gn1), BF16_TENSOR_FLOPS)
        rows["self_attention_qkv_blocked"] = dict(
            name="self_attention_qkv_blocked", route="cuda", source="pram_tpu_torch/csrc/attention_qkv.cu",
            replaces="pram_tpu/ops/attention_pallas.py:189",
            launches=None, max_abs_err=err,
            ms=cuda_ms(torch, lambda: attention_qkv.self_attention_qkv(*b_args, splits=gsplits)),
            plain_ms=cuda_ms(
                torch, lambda: attention_qkv.self_attention_qkv_plain(*b_args, splits=gsplits), iters=5),
            bound_ms=bnd, bound_by=by,
            library_ms=cuda_ms(torch, lambda: sdpa(gq_, gk_, gv_, attn_mask=gmask, scale=gscale)),
        )
        del q_, k_, v_, q0_, q1_, v0_, v1_, got, ref, msg, rmsg, stat, rstat

        # kernels 7 and 4 at this slice's shapes, on their inputs of the
        # uncounted run: against their plain versions at the GML rows'
        # tolerances, two launches bit-equal, timed beside the GML rows
        r_args, _ = k47_inputs["refine_nn"]
        rb, rn, rp = r_args[0].shape[0], r_args[0].shape[1], r_args[1].shape[1]
        idx, dd1, keep = refine.refine_nn(*r_args)
        ridx, rd1, rkeep = refine.refine_nn_plain(*r_args)
        qm = r_args[5]
        idx_agree = (idx == ridx)[qm].float().mean().item()
        keep_agree = (keep == rkeep).float().mean().item()
        err = (dd1 - rd1).abs().max().item()
        log(f"refine_nn ({rb} x {rn} x {rp}): index agreement {idx_agree:.5f}, keep agreement {keep_agree:.5f} "
            f"(tol {REFINE_AGREE}), max |d1 diff| {err:.3e} (tol {REFINE_D1_ATOL}); kept {int(keep.sum())} of "
            f"{int(qm.sum())} valid queries")
        require(idx_agree >= REFINE_AGREE and keep_agree >= REFINE_AGREE and err <= REFINE_D1_ATOL,
                "refine_nn kernel disagrees with its plain version at the AdaGML shape")
        again = refine.refine_nn(*r_args)
        require(all(torch.equal(a, b) for a, b in zip(again, (idx, dd1, keep))),
                "refine_nn: two launches differ at the AdaGML shape")
        ada7 = refine_bound(rb, rn, rp)
        rows["refine_nn"].update(
            shape_adagml=[rb, rn, rp], max_abs_err_adagml=err,
            ms_adagml=cuda_ms(torch, lambda: refine.refine_nn(*r_args)),
            plain_ms_adagml=cuda_ms(torch, lambda: refine.refine_nn_plain(*r_args), iters=3),
            device_ms_adagml=launch_ms(torch, lambda: refine.refine_nn(*r_args),
                                       want=lambda k: k == "refine_nn_kernel").get("refine_nn_kernel"),
            bound_adagml_ms=ada7["bound_ms"], bound_adagml_by=ada7["bound_by"])
        r7 = rows["refine_nn"]
        log(f"refine_nn ({rb} x {rn} x {rp}): {r7['ms_adagml']:.4f} ms a call, the kernel {r7['device_ms_adagml']} "
            f"ms a launch; plain {r7['plain_ms_adagml']:.4f} ms; bound {r7['bound_adagml_ms']:.4f} ms "
            f"({r7['bound_adagml_by']})")
        del idx, dd1, keep, ridx, rd1, rkeep, again

        g_args, g_kw = k47_inputs["gn_polish"]
        gp, gn = g_args[5].shape
        got = pnp.gn_polish(*g_args, **g_kw)
        ref = pnp.gn_polish_plain(*g_args, **g_kw)
        dR = (got[0] - ref[0]).abs().max().item()
        dT = (got[1] - ref[1]).abs().max().item()
        dN = (got[2] - ref[2]).abs().max().item()
        dI = (got[3] != ref[3]).sum(-1).max().item()
        log(f"gn_polish ({gp} x {gn}): max |dR| {dR:.2e} |dt| {dT:.2e} (tol {POLISH_POSE_ATOL}), "
            f"max |count diff| {dN}, max flag diffs per problem {dI} (tol {POLISH_COUNT_DIFF})")
        require(max(dR, dT) <= POLISH_POSE_ATOL, "gn_polish pose disagrees with its plain version at the AdaGML shape")
        require(dN <= POLISH_COUNT_DIFF and dI <= POLISH_COUNT_DIFF, "gn_polish inliers disagree at the AdaGML shape")
        again = pnp.gn_polish(*g_args, **g_kw)
        require(all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip(again, got)),
                "gn_polish: two launches differ at the AdaGML shape")
        ada4 = polish_bound(gp, gn, a_cfg)
        rows["gn_polish"].update(
            shape_adagml=[gp, gn], max_abs_err_adagml=max(dR, dT), cluster_adagml=pnp.polish_cluster(gn),
            ms_adagml=cuda_ms(torch, lambda: pnp.gn_polish(*g_args, **g_kw)),
            plain_ms_adagml=cuda_ms(torch, lambda: pnp.gn_polish_plain(*g_args, **g_kw), iters=3),
            device_ms_adagml=launch_ms(torch, lambda: pnp.gn_polish(*g_args, **g_kw),
                                       want=lambda k: k == "polish_kernel").get("polish_kernel"),
            bound_adagml_ms=ada4["bound_ms"], bound_adagml_by=ada4["bound_by"])
        r4 = rows["gn_polish"]
        log(f"gn_polish ({gp} x {gn}): clusters of {r4['cluster_adagml']} CTAs; {r4['ms_adagml']:.4f} ms a call, "
            f"the kernel {r4['device_ms_adagml']} ms a launch; plain {r4['plain_ms_adagml']:.4f} ms; bound "
            f"{r4['bound_adagml_ms']:.5f} ms ({r4['bound_adagml_by']})")
        del got, ref, again
    phase("aachen_kernels", t)

    # ---- 13. the AdaGML slice (the main path of this slice), counted
    t = time.perf_counter()
    reset_counts()
    a_results = []
    with torch.no_grad():
        for i, qs in enumerate(a_batches):
            a_results.append(a_loc.localize_batch(torch.Generator().manual_seed(7 + i), *a_inputs(qs, dev)))
    torch.cuda.synchronize()
    launches = read_counts()
    ada_launches = launches
    log(f"AdaGML slice launches: {launches}")
    for name in ("self_attention_qkv", "cross_attention_packed", "residual_mlp", "ransac_score",
                 "gn_polish", "refine_nn"):
        require(launches[name] > 0, f"kernel {name} was not launched on the AdaGML slice")
    for name in ("self_attention", "cross_attention", "sinkhorn", "self_attention_qkv_blocked",
                 "fused_stem", "nms") + train_kernels + int8_kernels:
        require(launches[name] == 0, f"kernel {name} is not on the AdaGML slice but launched")

    def aachen_outcome(qs, res):
        """(successes within 25 cm / 2 deg, t_err, q_err, matched, precise, median reprojection px)."""
        require(tuple(res.qvec.shape) == (len(qs), 4), "bad pose batch shape")
        require(bool(torch.isfinite(res.tvec).all()), "non-finite poses")
        q_err, t_err = compute_pose_error(res.qvec.cpu(), res.tvec.cpu(), a_stack(qs, "qvec"), a_stack(qs, "tvec"))
        ok = res.success.cpu() & (t_err < 0.25) & (q_err < 2.0)
        # match precision: assigned 3-D points reproject within 4 px of their
        # keypoint through the true pose
        kpi, kxyz = res.kpt_point_idx.cpu().numpy(), res.kpt_xyz.cpu().double().numpy()
        R = qvec2rotmat(a_stack(qs, "qvec").double()).numpy()
        matched = precise = 0
        medians = []
        for i, q in enumerate(qs):
            sel = (kpi[i] >= 0) & q["mask"]
            if not sel.any():
                continue
            xc = kxyz[i][sel] @ R[i].T + np.asarray(q["tvec"], np.float64)
            z = np.clip(xc[:, 2], 1e-6, None)
            uv = np.stack([xc[:, 0] / z * 500.0 + a_w / 2, xc[:, 1] / z * 500.0 + a_h / 2], -1)
            e = np.linalg.norm(uv - q["keypoints"][sel], axis=-1)
            matched += int(sel.sum())
            precise += int((e < 4.0).sum())
            medians.append(float(np.median(e)))
        return int(ok.sum()), t_err, q_err, matched, precise, medians

    outs = [aachen_outcome(qs, res) for qs, res in zip(a_batches, a_results)]
    n_q = a_batch * n_batches
    a_recall = sum(o[0] for o in outs) / n_q
    t_all = torch.cat([o[1] for o in outs])
    q_all = torch.cat([o[2] for o in outs])
    precision = sum(o[4] for o in outs) / max(sum(o[3] for o in outs), 1)
    log(f"AdaGML slice on card: recall@25cm/2deg {a_recall:.4f} over {n_q} queries, match precision "
        f"{precision:.4f} ({sum(o[3] for o in outs) / n_q:.1f} matches a query), median t_err "
        f"{t_all.median().item():.5f} m, median q_err {q_all.median().item():.4f} deg, median reprojection "
        f"{float(np.median(sum((o[5] for o in outs), []))):.3f} px")
    require(a_recall >= ADA_RECALL_MIN, f"AdaGML slice recall@25cm/2deg below {ADA_RECALL_MIN}")

    # queries/s: 5 batches of 8 after a warm-up, median; the matcher split
    # out with CUDA events around its calls
    m_events = []

    def timed_ada(*args):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = ada_fn(*args)
        e1.record()
        m_events.append((e0, e1))
        return out

    a_loc.match_fn = timed_ada
    timed = []
    with torch.no_grad():
        for i in range(6):
            args_i = a_inputs(a_batches[i % n_batches], dev)
            t_b = sync(dev)
            a_loc.localize_batch(torch.Generator().manual_seed(7), *args_i)
            timed.append(sync(dev) - t_b)
    a_loc.match_fn = ada_fn
    match_ms = sorted(e0.elapsed_time(e1) for e0, e1 in m_events[1:])[2]
    a_batch_s = sorted(timed[1:])[2]
    log(f"AdaGML slice: batch {a_batch} in {a_batch_s * 1e3:.2f} ms (median of 5, host clock, synchronized) "
        f"= {a_batch / a_batch_s:.2f} queries/s; AdaGML matching {match_ms:.2f} ms (CUDA events, median), "
        f"the rest of localization {a_batch_s * 1e3 - match_ms:.2f} ms")

    # matcher A/B on batch 0: kernel path vs plain path, early exit vs unrolled
    with torch.no_grad():
        m_args = (d0, d1, nk0, nk1, m0, m1)
        out_k = adagml_batched_adaptive_apply(ada, *m_args)
        full = ada(*m_args)
        ada.use_kernels = False
        out_p = adagml_batched_adaptive_apply(ada, *m_args)
        ada.use_kernels = True
    mk = mutual_matches(out_k["plan"], ada.config.match_threshold).matches0
    mp = mutual_matches(out_p["plan"], ada.config.match_threshold).matches0
    agree = (mk == mp)[m0].float().mean().item()
    log(f"AdaGML A/B on batch 0 (bf16, kernel path vs plain path, {n0} x {n1} tokens): match agreement "
        f"{agree:.5f} (min {ADA_AB_AGREE}), matches {int((mk[m0] >= 0).sum())} vs {int((mp[m0] >= 0).sum())}, "
        f"plan max abs diff {(out_k['plan'] - out_p['plan']).abs().max().item():.5f}, stop layers "
        f"{out_k['stop_layer'].tolist()} vs {out_p['stop_layer'].tolist()}, tokens whose mask differs "
        f"{int((out_k['mask0'] != out_p['mask0']).sum() + (out_k['mask1'] != out_p['mask1']).sum())}, alive "
        f"after pruning {out_k['mask0'].float().mean().item():.3f} / {out_k['mask1'].float().mean().item():.3f}")
    require(agree >= ADA_AB_AGREE, "AdaGML kernel path disagrees with its plain path")
    exit_diff = (out_k["plan"] - full["plan"]).abs().max().item()
    log(f"AdaGML early exit vs unrolled (bf16, kernel path): stop layers {full['stop_layer'].tolist()}, "
        f"plan max abs diff {exit_diff:.3e}")
    require(torch.equal(out_k["stop_layer"], full["stop_layer"]), "early exit stops elsewhere than unrolled")
    require(torch.equal(out_k["mask0"], full["mask0"]) and torch.equal(out_k["mask1"], full["mask1"]),
            "early exit prunes otherwise than unrolled")
    require(torch.allclose(out_k["plan"], full["plan"], rtol=ADA_EXIT_RTOL, atol=ADA_EXIT_ATOL),
            "early exit plan differs from unrolled")
    del full, out_k, out_p

    ada32 = load_adagml(ada_w, AdaGMLConfig(), device=dev, dtype=torch.float32)
    with torch.no_grad():
        m32 = (d0.float(), d1.float(), nk0, nk1, m0, m1)
        o32 = adagml_batched_adaptive_apply(ada32, *m32)
        ada32.use_kernels = False
        p32 = adagml_batched_adaptive_apply(ada32, *m32)
    diff32 = int((o32["mask0"] != p32["mask0"]).sum() + (o32["mask1"] != p32["mask1"]).sum())
    log(f"AdaGML A/B on batch 0 (f32, TF32 off, kernel path vs plain path): stop layers "
        f"{o32['stop_layer'].tolist()} vs {p32['stop_layer'].tolist()}, tokens whose mask differs {diff32}, "
        f"plan max abs diff {(o32['plan'] - p32['plan']).abs().max().item():.3e}")
    require(torch.equal(o32["stop_layer"], p32["stop_layer"]) and diff32 == 0,
            "AdaGML f32 kernel path prunes or stops otherwise than its plain path")
    del ada32, o32, p32

    # the first 2 queries on the card and on the card machine's CPU (plain
    # versions), the same RANSAC triplets (drawn on the CPU from one seed)
    sub = a_batches[0][:2]
    found = {"card": [], "cpu": []}

    def recording(fn, store):
        def wrapped(*args):
            store.append(fn(*args))
            return store[-1]
        return wrapped

    with torch.no_grad():
        a_loc.match_fn = recording(ada_fn, found["card"])
        res_g = a_loc.localize_batch(torch.Generator().manual_seed(3), *a_inputs(sub, dev))
        a_loc.match_fn = ada_fn
        t_cpu = time.perf_counter()
        ada_cpu = load_adagml(ada_w, AdaGMLConfig(), device="cpu", dtype=bf16)
        cpu_fn = recording(make_adagml_match_fn(ada_cpu, ada_cpu.config.match_threshold), found["cpu"])
        res_c = Localizer(to_device(a_scene.map, "cpu", desc_dtype=bf16), cpu_fn, a_cfg).localize_batch(
            torch.Generator().manual_seed(3), *a_inputs(sub, "cpu"))
    log(f"AdaGML slice on the CPU: {len(sub)} queries in {time.perf_counter() - t_cpu:.1f} s")
    both = res_g.success.cpu() & res_c.success
    dq, dt = compute_pose_error(res_g.qvec.cpu(), res_g.tvec.cpu(), res_c.qvec, res_c.tvec)
    sub_mask = a_stack(sub, "mask", bool)
    m_card, m_cpu = found["card"][0].cpu(), found["cpu"][0]
    log(f"AdaGML slice card vs CPU: matches differ on {int((m_card != m_cpu)[sub_mask].sum())} of "
        f"{int(sub_mask.sum())} valid query keypoints ({int((m_card[sub_mask] >= 0).sum())} vs "
        f"{int((m_cpu[sub_mask] >= 0).sum())} matches); success card {res_g.success.tolist()} cpu "
        f"{res_c.success.tolist()}, pose diff max {dq[both].max().item():.4f} deg, "
        f"{dt[both].max().item():.5f} m; inliers {res_g.num_inliers.tolist()} vs {res_c.num_inliers.tolist()}")
    require(bool(torch.equal(res_g.success.cpu(), res_c.success)), "AdaGML slice: success differs card vs CPU")
    require(bool((dq[both] < SLICE_R_TOL_DEG).all() and (dt[both] < SLICE_T_TOL).all()),
            "AdaGML slice: pose differs card vs CPU")
    del ada_cpu
    phase("aachen_slice", t)

    # ---- 14. the training slice at scripts/bench_train.py's operating point
    t = time.perf_counter()
    del a_loc, a_results  # the Aachen scene, queries and AdaGML stay for phases 25-27
    tb, th, tw, tn, t_cls = 32, 480, 640, 512, 113
    trng = np.random.RandomState(args.seed)
    t_mask = np.ones((tb, tn), bool)
    t_mask[::4, tn - 32:] = False  # padded tokens in every 4th frame
    t_batch = {
        "image": torch.from_numpy(trng.rand(tb, th, tw, 3).astype(np.float32)).to(dev),
        "keypoints": torch.from_numpy((trng.rand(tb, tn, 2) * [tw - 8, th - 8] + 4).astype(np.float32)).to(dev),
        "norm_keypoints": torch.from_numpy((trng.rand(tb, tn, 2) * 2 - 1).astype(np.float32)).to(dev),
        "gt_seg": torch.from_numpy(trng.randint(0, t_cls, (tb, tn))).to(dev),
        "mask": torch.from_numpy(t_mask).to(dev),
    }
    t_m = t_batch["mask"]
    rec = load_segnetvit(str(root / "weights" / "segnetvit_rendered.msgpack"), SegNetViTConfig(n_class=t_cls),
                         device=dev).train()
    t_sfd2 = load_sfd2(SFD2_W, device=dev, dtype=bf16).requires_grad_(False)
    t_cfg = TrainConfig(batch_size=tb)
    n_layers = rec.config.n_layers
    log(f"training batch (seed {args.seed}): {tb} images of {th} x {tw} on the card, {tn} keypoints a frame, "
        f"{int(t_mask.sum())} valid tokens, {t_cls} classes; SegNetViT of {n_layers} layers, "
        f"{sum(p.numel() for p in rec.parameters())} f32 master parameters; SFD2 in bf16")
    phase("train_setup", t)

    # ---- 15. kernels 13-15 vs plain versions: 13 and 15 on SegNetViT layer
    # 0's inputs of the batch with the layer's real output cotangent, 13 at
    # GML's splits and 14 on GML layer 0's activations of phase 6
    t = time.perf_counter()
    with torch.no_grad():
        mid = t_sfd2(preprocess_image(t_batch["image"]).to(bf16).contiguous())["mid_features"]
        t_descs = sampling.sample_descriptors(
            t_batch["keypoints"], mid.permute(0, 3, 1, 2), 4, normalize=False).to(bf16)
        del mid
    nk16 = t_batch["norm_keypoints"].to(bf16)
    rec16 = copy.deepcopy(rec).to(bf16)
    l0 = {}

    def keep_layer0(mod, inp, out):
        out.retain_grad()
        l0.update(x=inp[0], y=out)

    hook = rec16.gnn[0].register_forward_hook(keep_layer0)
    seg_loss_weighted(rec16(t_descs, nk16, t_m)["prediction"].float(), t_batch["gt_seg"], t_m).backward()
    hook.remove()
    blk = rec16.gnn[0]
    heads, hd = blk.num_heads, blk.head_dim
    tscale = hd**-0.5
    tok = tb * tn

    def bit_equal(got, again):
        return all(torch.equal(a, b) for a, b in zip(got, again))

    # the backward passes' registers and spills, as ptxas reported them when
    # the library was built: the gradient passes hold their accumulators
    # beside an o tile's scores and must not spill
    require_no_spills(_build, ("attention_bwd.cu", "cross_attention_bwd.cu"))

    def check_outputs(name, got, ref, names, n_bf16):
        """Each output against the plain version's: the first n_bf16 (bf16)
        to BWD_TOL, the f32 ones to BWD_F32_TOL; returns the bf16 outputs'
        max error."""
        errs = [check_scaled(f"{name} {n}", a, r, BWD_TOL if i < n_bf16 else BWD_F32_TOL)
                for i, (n, a, r) in enumerate(zip(names, got, ref))]
        return max(errs[:n_bf16])

    with torch.no_grad():
        x0, ct = l0["x"].detach(), l0["y"].grad.detach()
        cos_t, sin_t = rec16.kenc(nk16)
        kb_t = attention.mask_to_bias(t_m, tb, tn, dev)
        qkv = F.linear(x0, blk.qkv.weight, blk.qkv.bias).contiguous()
        msg = attention.self_attention(x0, blk.qkv.weight, blk.qkv.bias, cos_t, sin_t, kb_t, tscale, heads)
        pm = F.linear(msg, blk.proj.weight, blk.proj.bias).contiguous()

        # kernel 2 on layer 0's forward inputs of the step (16384 tokens)
        m2 = (x0, msg, blk.proj.weight, blk.proj.bias, blk.mlp_0.weight, blk.mlp_0.bias,
              blk.mlp_ln.weight, blk.mlp_ln.bias, blk.mlp_3.weight, blk.mlp_3.bias, blk.mlp_ln.eps)
        y2 = mlp.residual_mlp(*m2)
        check_scaled("residual_mlp (training layer 0)", y2, mlp.residual_mlp_plain(*m2), MLP_TOL)
        require(torch.equal(mlp.residual_mlp(*m2), y2), "residual_mlp (training layer 0): two launches differ")

        # kernel 15 on layer 0 (16384 tokens)
        m15 = (x0, pm, ct, blk.mlp_0.weight, blk.mlp_0.bias, blk.mlp_ln.weight, blk.mlp_ln.bias,
               blk.mlp_3.weight, blk.mlp_ln.eps)
        ref15 = mlp_bwd.residual_mlp_bwd_plain(*m15)
        err = check_outputs("residual_mlp_bwd", mlp_bwd.residual_mlp_bwd(*m15), ref15,
                            ("dx", "dpm", "dw0", "db0", "dln_w", "dln_b", "dw3", "db3"), 2)
        w_elems = 2 * 512 * 512 + 256 * 512
        b15 = (3 * tok * 256 * 2 + w_elems * 2 + 3 * 512 * 4 + 2 * tok * 256 * 2
               + (512 * 512 + 256 * 512) * 4 + (3 * 512 + 256) * 4)
        bnd, by = bound_ms(b15, 2.0 * tok * (3 * 512 * 512 + 2 * 256 * 512), BF16_TENSOR_FLOPS)
        rows["residual_mlp_bwd"] = dict(
            name="residual_mlp_bwd", route="cuda", source="pram_tpu_torch/csrc/mlp_bwd.cu",
            replaces="pram_tpu/ops/mlp_bwd_pallas.py:171",
            launches=None, max_abs_err=err,
            ms=cuda_ms(torch, lambda: mlp_bwd.residual_mlp_bwd(*m15)),
            plain_ms=cuda_ms(torch, lambda: mlp_bwd.residual_mlp_bwd_plain(*m15), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=None,
        )
        require(bit_equal(mlp_bwd.residual_mlp_bwd(*m15), mlp_bwd.residual_mlp_bwd(*m15)),
                "residual_mlp_bwd (training layer 0): two launches differ")
        log_ptxas(_build, ("mlp_bwd.cu",))
        passes = {k: v for k, v in launch_ms(torch, lambda: mlp_bwd.residual_mlp_bwd(*m15),
                                              want=lambda k: k == "token_kernel").items()
                  if k in ("token_kernel", "weight_kernel", "reduce_kernel")}
        dev15 = sum(passes.values())
        log(f"residual_mlp_bwd ({tok} tokens, vectors {blk.mlp_0.bias.dtype}): {rows['residual_mlp_bwd']['ms']:.4f} "
            f"ms a call (CUDA events), the kernel {dev15:.4f} ms (torch.profiler, its three launches: "
            + ", ".join(f"{k} {v:.4f} ({v / dev15:.0%})" for k, v in passes.items())
            + f") against its bound {bnd:.4f} ms ({by})")

        # kernel 13 on layer 0 (32 x 512 tokens), the attention cotangent
        # through the MLP's plain backward (dmsg = dpm wp)
        g13 = (ref15[1].float() @ blk.proj.weight.float()).to(bf16).contiguous()
        a13 = (qkv, cos_t, sin_t, kb_t, g13, tscale, heads)
        names13 = ("dqkv", "dcos", "dsin", "dbias")
        got = attention_bwd.self_attention_bwd(*a13)
        err = check_outputs("self_attention_bwd (SegNetViT)", got,
                            attention_bwd.self_attention_bwd_plain(*a13), names13, 1)
        require(bit_equal(attention_bwd.self_attention_bwd(*a13), got),
                "self_attention_bwd (SegNetViT): two launches differ")
        # library yardstick: the backward of one SDPA call on the rotated q, k
        # and v with the key mask
        t3 = qkv.reshape(tb, tn, heads, hd, 3).permute(4, 0, 2, 1, 3)
        enc = (cos_t[:, None], sin_t[:, None])
        sd_in = [attention.apply_rotary(enc, t3[0].float()).to(bf16), attention.apply_rotary(enc, t3[1].float()).to(bf16),
                 t3[2].contiguous()]
        g_heads = g13.reshape(tb, tn, heads, hd).transpose(1, 2)
    with torch.enable_grad():
        sd_in = [a.detach().contiguous().requires_grad_() for a in sd_in]
        sd_out = sdpa(*sd_in, attn_mask=t_m[:, None, None, :], scale=tscale)
        lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(sd_out, sd_in, g_heads, retain_graph=True))
    del sd_in, sd_out
    b13 = tok * (768 * 2 + 256 * 2 + 2 * 64 * 4 + 4 + 768 * 2 + 2 * 64 * 4 + 4)
    bnd, by = bound_ms(b13, 10.0 * hd * tb * heads * tn * tn, BF16_TENSOR_FLOPS)
    rows["self_attention_bwd"] = dict(
        name="self_attention_bwd", route="cuda", source="pram_tpu_torch/csrc/attention_bwd.cu",
        replaces="pram_tpu/ops/attention_bwd_pallas.py:330",
        launches=None, max_abs_err=err,
        ms=cuda_ms(torch, lambda: attention_bwd.self_attention_bwd(*a13)),
        plain_ms=cuda_ms(torch, lambda: attention_bwd.self_attention_bwd_plain(*a13), iters=5),
        bound_ms=bnd, bound_by=by, library_ms=lib_ms,
    )

    with torch.no_grad():
        # kernel 13 at GML's splits and kernel 14, on GML layer 0's
        # activations with more padded and masked tokens; unit cotangents
        gen = torch.Generator().manual_seed(args.seed + 1)
        gm0, gm1 = gml_l0["m0"].clone(), gml_l0["m1"].clone()
        gm0[0, ::7] = False
        gm0[1, 3 * gm0.shape[1] // 4:] = False
        gm1[0, ::5] = False
        gm1[2] = False
        gn0, gn1 = gm0.shape[1], gm1.shape[1]
        gb = gm0.shape[0]
        gs = gml.self_attn[0]
        gx = gml_l0["x"]
        gqkv = F.linear(gx, gs.qkv.weight, gs.qkv.bias).contiguous()
        gkb = attention.mask_to_bias(torch.cat([gm0, gm1], 1), gb, gn0 + gn1, dev)
        gg = torch.randn(gx.shape, generator=gen).to(dev, bf16)
        a13g = (gqkv, gml_l0["cos"], gml_l0["sin"], gkb, gg, gscale, heads)
        gsp = gml_l0["splits"]
        got = attention_bwd.self_attention_bwd(*a13g, splits=gsp)
        check_outputs(f"self_attention_bwd (GML, splits {gsp})", got,
                      attention_bwd.self_attention_bwd_plain(*a13g, splits=gsp), names13, 1)
        require(bit_equal(attention_bwd.self_attention_bwd(*a13g, splits=gsp), got),
                "self_attention_bwd (GML): two launches differ")
        ms_g = cuda_ms(torch, lambda: attention_bwd.self_attention_bwd(*a13g, splits=gsp))
        # library yardstick at the splits: the backward of one SDPA call a
        # side on the rotated q, k, v with the side's key mask
        t3 = gqkv.reshape(gb, gn0 + gn1, heads, hd, 3).permute(4, 0, 2, 1, 3)
        enc = (gml_l0["cos"][:, None], gml_l0["sin"][:, None])
        sd_in = [attention.apply_rotary(enc, t3[0].float()).to(bf16),
                 attention.apply_rotary(enc, t3[1].float()).to(bf16), t3[2].contiguous()]
        g_heads = gg.reshape(gb, gn0 + gn1, heads, hd).transpose(1, 2)
        gmask = torch.cat([gm0, gm1], 1)
    with torch.enable_grad():
        sides = [(0, gn0), (gn0, gn0 + gn1)]
        sd_in = [[a[:, :, lo:hi].detach().contiguous().requires_grad_() for a in sd_in] for lo, hi in sides]
        sd_out = [sdpa(*qkv_s, attn_mask=gmask[:, None, None, lo:hi], scale=gscale)
                  for qkv_s, (lo, hi) in zip(sd_in, sides)]
        sd_g = [g_heads[:, :, lo:hi] for lo, hi in sides]
        lib_g = cuda_ms(torch, lambda: torch.autograd.grad(
            sd_out, [a for q in sd_in for a in q], sd_g, retain_graph=True))
    del sd_in, sd_out, sd_g
    bnd_g, by_g = bound_ms(gb * (gn0 + gn1) * (768 * 2 + 256 * 2 + 2 * 64 * 4 + 4 + 768 * 2 + 2 * 64 * 4 + 4),
                           10.0 * hd * gb * heads * (gn0 * gn0 + gn1 * gn1), BF16_TENSOR_FLOPS)
    rows["self_attention_bwd"].update(ms_gml_splits=ms_g, bound_gml_splits_ms=bnd_g, library_gml_splits_ms=lib_g)
    log(f"self_attention_bwd (GML, {gb} x {gsp}): {ms_g:.4f} ms against its bound {bnd_g:.4f} ms ({by_g}) "
        f"and SDPA's backward, one call a side, {lib_g:.4f} ms")
    # where kernel 13's time goes: its pack, statistics and gradient launches
    for name, fn in (("SegNetViT", lambda: attention_bwd.self_attention_bwd(*a13)),
                     ("GML", lambda: attention_bwd.self_attention_bwd(*a13g, splits=gsp))):
        log(f"self_attention_bwd ({name}) by launch (device ms a launch, torch.profiler): {json.dumps(launch_ms(torch, fn))}")
    with torch.no_grad():
        cb = gml.cross_attn[0]
        gy = gml_l0["y"]
        gqk = F.linear(gy, cb.to_qk.weight, cb.to_qk.bias).contiguous()
        gv = F.linear(gy, cb.to_v.weight, cb.to_v.bias).contiguous()
        gbias0 = attention.mask_to_bias(gm0, gb, gn0, dev)
        gbias1 = attention.mask_to_bias(gm1, gb, gn1, dev)
        a14 = (gqk, gv, gbias0, gbias1, gg, gscale, heads, gn0)
        got = attention_bwd.cross_attention_bwd(*a14)
        err = check_outputs("cross_attention_bwd", got,
                            attention_bwd.cross_attention_bwd_plain(*a14), ("dqk", "dv", "db0", "db1"), 2)
        require(bit_equal(attention_bwd.cross_attention_bwd(*a14), got), "cross_attention_bwd: two launches differ")
        qh = gqk.reshape(gb, gn0 + gn1, heads, hd).transpose(1, 2)
        vh = gv.reshape(gb, gn0 + gn1, heads, hd).transpose(1, 2)
        c_in = [qh[:, :, :gn0], qh[:, :, gn0:], vh[:, :, :gn0], vh[:, :, gn0:]]
        gh = gg.reshape(gb, gn0 + gn1, heads, hd).transpose(1, 2)
    with torch.enable_grad():
        # library yardstick: the backward of kernel 5's two SDPA calls
        c_in = [a.contiguous().requires_grad_() for a in c_in]
        q0_, q1_, v0_, v1_ = c_in
        c_out = (sdpa(q0_, q1_, v1_, attn_mask=gm1[:, None, None, :], scale=gscale),
                 sdpa(q1_, q0_, v0_, attn_mask=gm0[:, None, None, :], scale=gscale))
        lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            c_out, c_in, (gh[:, :, :gn0], gh[:, :, gn0:]), retain_graph=True))
    del c_in, c_out
    ctok = gb * (gn0 + gn1)
    bnd, by = bound_ms(ctok * (3 * 256 * 2 + 2 * 256 * 2 + 2 * 4), 14.0 * gb * heads * gn0 * gn1 * hd,
                       BF16_TENSOR_FLOPS)
    # the kernel's exponentials, a second ceiling: 2 a direction in the
    # statistics pass, 2 a visit (each pair from both sides) in the gradient pass
    exp14 = 6.0 * gb * heads * gn0 * gn1
    log(f"cross_attention_bwd: bound {bnd:.4f} ms ({by}); exponentials {exp14 / 1e9:.3f} G, "
        f"{exp14 / EXP_PER_S * 1e3:.4f} ms at {EXP_PER_S / 1e12:.2f} T/s; by launch (device ms a launch, "
        f"torch.profiler): {json.dumps(launch_ms(torch, lambda: attention_bwd.cross_attention_bwd(*a14)))}")
    rows["cross_attention_bwd"] = dict(
        name="cross_attention_bwd", route="cuda", source="pram_tpu_torch/csrc/cross_attention_bwd.cu",
        replaces="pram_tpu/ops/attention_bwd_pallas.py:274",
        launches=None, max_abs_err=err,
        ms=cuda_ms(torch, lambda: attention_bwd.cross_attention_bwd(*a14)),
        plain_ms=cuda_ms(torch, lambda: attention_bwd.cross_attention_bwd_plain(*a14), iters=3),
        bound_ms=bnd, bound_by=by, library_ms=lib_ms, exp_ms=exp14 / EXP_PER_S * 1e3,
    )
    del rec16, l0, x0, ct, qkv, msg, pm, m15, ref15, a13, a13g, a14, gml_l0, got
    phase("train_kernels", t)

    # ---- 16. the training slice: augmented steps through Trainer's step, counted
    t = time.perf_counter()

    def grad_ab():
        """One step's f32 master gradients on the batch (jitter-free
        descriptors of phase 15) by the kernel path and the plain path in
        bf16, and by the plain path in f32: per tensor max |diff| / max |ref|
        and the global relative L2 of each pair against its second member."""
        def master_grads(kernels, dtype):
            rec.use_kernels = kernels
            rec.zero_grad(set_to_none=True)
            out = cast_forward(rec, dtype, t_descs.to(dtype or torch.float32), nk16, t_m)
            seg_metrics(out["prediction"].float(), t_batch, t_cfg)[0].backward()
            return {k: p.grad.detach().clone() for k, p in rec.named_parameters()}

        g = {"kernel": master_grads(True, bf16), "plain": master_grads(False, bf16),
             "f32": master_grads(False, None)}
        rec.use_kernels = True
        rec.zero_grad(set_to_none=True)
        out = {}
        for a, b in (("kernel", "plain"), ("kernel", "f32"), ("plain", "f32")):
            ga, gb = g[a], g[b]
            rel = {k: ((ga[k] - gb[k]).abs().max() / gb[k].abs().max()).item() for k in gb}
            l2 = (sum(((ga[k] - gb[k]) ** 2).sum() for k in gb) / sum((gb[k] ** 2).sum() for k in gb)).sqrt()
            worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
            out[f"{a} vs {b}"] = dict(l2=round(l2.item(), 5), max=round(worst[0][1], 5),
                                      median=round(sorted(rel.values())[len(rel) // 2], 5),
                                      worst=[k for k, _ in worst])
        return out

    # gradient A/B at the loaded weights: one step's gradients, kernel path
    # vs plain path in bf16, each against the f32 plain path too
    ab = grad_ab()
    log(f"gradient A/B (bf16, {len(list(rec.parameters()))} tensors, max |diff| / max |ref| per tensor, "
        f"tol {GRAD_AB_TOL} kernel vs plain): {json.dumps(ab)}")
    require(ab["kernel vs plain"]["max"] <= GRAD_AB_TOL,
            "training gradients of the kernel path disagree with the plain path")

    trainer = Trainer(rec, t_cfg, log_fn=log,
                      step_fn=make_augmented_train_step(rec, t_sfd2, t_cfg, compute_dtype=bf16))
    reset_counts()
    losses = [trainer.step_fn(trainer.state, t_batch)["loss"] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = read_counts()
    train_launches = launches
    losses = torch.stack(losses).float().cpu()
    log(f"training slice launches over {TRAIN_STEPS} steps: {launches}")
    per_step = {"fused_stem": 1, "self_attention": n_layers, "residual_mlp": n_layers,
                "self_attention_bwd": n_layers, "residual_mlp_bwd": n_layers}
    for name, count in launches.items():
        want = TRAIN_STEPS * per_step.get(name, 0)
        require(count == want, f"kernel {name}: {count} launches in {TRAIN_STEPS} training steps, expected {want}")
    log(f"training losses: {[round(v, 5) for v in losses.tolist()]}")
    require(bool(torch.isfinite(losses).all()), "non-finite training loss")
    require(bool(losses[-1] < losses[0]), "the training loss did not fall over the steps")

    def timed_steps(n=8):
        """steps/s (host clock, synchronized) over n steps, and the stages'
        mean ms by CUDA events."""
        events = []

        def mark(stage):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[-1].append((stage, e))

        t_s = sync(dev)
        for _ in range(n):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append([("start", e)])
            trainer.step_fn(trainer.state, t_batch, mark=mark)
        t_e = sync(dev)
        stages = {}
        for ev in events:
            for (_, a), (stage, b) in zip(ev[:-1], ev[1:]):
                stages[stage] = stages.get(stage, 0.0) + a.elapsed_time(b) / n
        return n / (t_e - t_s), stages

    timed = sorted((timed_steps() for _ in range(3)), key=lambda r: r[0])
    sps, stages = timed[1]
    log(f"training slice on card: {sps:.3f} steps/s = {sps * tb:.1f} frames/s (median of 3 runs of 8 steps, "
        f"host clock, synchronized; runs {[round(r[0], 3) for r in timed]}); stages of a step by CUDA events "
        f"(ms, mean over the median run): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; card: {smi}")

    log(f"gradient A/B after the {TRAIN_STEPS + 24} steps: {json.dumps(grad_ab())}")
    phase("train_slice", t)

    # ---- 17. the int8 image slice's guard: bench.py's default extractor
    t = time.perf_counter()
    del trainer, rec, t_sfd2
    torch.cuda.empty_cache()
    guard8 = RenderedGuard(batch=batch, device=dev, dtype=bf16, int8=True, int8_mlp=True, int8_proj=True)
    torch.cuda.synchronize()
    log(f"int8 rendered map: {guard8.scene.map.num_points} points, {guard8.scene.map.num_frames} frames "
        f"(float guard: {image_map_points} points)")
    phase("int8_setup", t)

    # ---- 18. kernels 16-19 vs plain versions on the real inputs of one
    # uncounted int8 pipeline pass of the 32 queries
    t = time.perf_counter()
    recorded = {}

    def record(module, name):
        real = getattr(module, name)
        calls = recorded.setdefault(name, [])

        def wrapped(*a, **kw):
            calls.append((a, kw))
            return real(*a, **kw)

        setattr(module, name, wrapped)
        return module, name, real

    patched = [record(sfd2_int8, "conv3x3_int8"), record(mlp, "residual_mlp_int8"),
               record(attention, "self_attention_int8"), record(cross_attention, "cross_attention_int8")]
    try:
        guard8.pipeline(torch.Generator().manual_seed(7), q_imgs)
    finally:
        for module, name, real in patched:
            setattr(module, name, real)
    torch.cuda.synchronize()

    def first(name, pred):
        return next((a, kw) for a, kw in recorded[name] if pred(a, kw))

    with torch.no_grad():
        # kernel 16 at SegNetViT's 32 x 512 and GML's 32 x 1536 tokens: the
        # s8 instance of csrc/mlp_tile.cuh, 0 bytes spilled, two launches
        # bit-equal, timed beside its bound and the eager torch._int_mm chain
        require_no_spills(_build, ("mlp_int8.cu",))
        mlp_ms, dev_ms, chain_ms = {}, {}, {}
        for n_tok in (512, 1536):
            m8, mkw = first("residual_mlp_int8", lambda a, kw, n=n_tok: a[0].shape[1] == n)
            y8 = mlp.residual_mlp_int8(*m8, **mkw)
            err = check_scaled(f"residual_mlp_int8 ({batch} x {n_tok})", y8,
                               mlp.residual_mlp_int8_plain(*m8, **mkw), INT8_TOL)
            require(torch.equal(mlp.residual_mlp_int8(*m8, **mkw), y8),
                    f"residual_mlp_int8 ({batch} x {n_tok}): two launches differ")
            mlp_ms[n_tok] = cuda_ms(torch, lambda: mlp.residual_mlp_int8(*m8, **mkw))
            dev_ms[n_tok], dev_by = mlp_device_ms(torch, mlp.residual_mlp_int8, m8, mkw)
            c8 = (m8[0], m8[1], m8[2], m8[3], m8[4], m8[5][:, :256].contiguous(), m8[5][:, 256:].contiguous(),
                  *m8[6:])
            chain_ms[n_tok] = cuda_ms(torch, lambda: mlp_int8_chain(quant, *c8, **mkw))
            log(f"residual_mlp_int8 ({batch} x {n_tok}): {mlp_ms[n_tok]:.4f} ms a call, the kernel "
                f"{dev_ms[n_tok]:.4f} ms ({dev_by}), against its bound "
                f"{mlp_bound(batch * n_tok, True)[0]:.4f} ms; the eager torch._int_mm chain {chain_ms[n_tok]:.4f} ms")
        bnd, by = mlp_bound(batch * 1536, True)
        rows["residual_mlp_int8"] = dict(
            name="residual_mlp_int8", route="cuda", source="pram_tpu_torch/csrc/mlp_int8.cu",
            replaces="pram_tpu/ops/mlp_pallas.py:241",
            launches=None, max_abs_err=err, ms=mlp_ms[1536],
            plain_ms=cuda_ms(torch, lambda: mlp.residual_mlp_int8_plain(*m8, **mkw), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=None, library_chain_ms=chain_ms[1536],
            device_ms=dev_ms[1536], device_ms_by=dev_by, ms_16384=mlp_ms[512], device_ms_16384=dev_ms[512],
            bound_16384_ms=mlp_bound(batch * 512, True)[0],
            library_chain_16384_ms=chain_ms[512],
        )

        # kernel 17, self-attention: SegNetViT (32 x 512) and GML's splits;
        # its s8 pass alone (csrc/proj_int8.cu, on the weights in kernel 12's
        # block order, q and k rotated) against project_int8_plain, two
        # launches bit-equal, timed beside its bound and two yardsticks the
        # port never calls: torch._int_mm of the same s8 operands (the
        # product alone) and cuBLAS's F.linear of the same bf16 projection
        def pass_yardsticks(x_, wq_, ws_, b_):
            xq_ = quant.quant_rows(x_)[0].to(torch.int8).reshape(-1, 256)
            wd_ = (wq_.float() * ws_.float()[:, None]).to(bf16)
            bd_ = b_.to(bf16)
            return dict(proj_int_mm_ms=cuda_ms(torch, lambda: torch._int_mm(xq_, wq_.t())),
                        proj_linear_ms=cuda_ms(torch, lambda: F.linear(x_, wd_, bd_)))

        def count_one(fn, want_counts, what):
            reset_counts()
            fn()
            torch.cuda.synchronize()
            got = {k: v for k, v in read_counts().items() if v}
            log(f"{what}: launches of one call {got}")
            require(got == want_counts, f"{what}: one call launched {got}, expected {want_counts}")

        require_no_spills(_build, ("proj_int8.cu", "proj_bf16.cu"))
        self_ms, self_pass = {}, {}
        for label, pred in (("512", lambda a, kw: a[9] is None),
                            ("(512, 1024)", lambda a, kw: a[9] is not None)):
            s8 = first("self_attention_int8", pred)[0]
            msg8 = attention.self_attention_int8(*s8)
            err = check_scaled(f"self_attention_int8 ({batch} x {label})", msg8,
                               attention.self_attention_int8_plain(*s8), INT8_TOL)
            require(torch.equal(attention.self_attention_int8(*s8), msg8),
                    f"self_attention_int8 ({batch} x {label}): two launches differ")
            self_ms[label] = cuda_ms(torch, lambda: attention.self_attention_int8(*s8))
            xs8, wq8, ws8, b8, cos8, sin8 = s8[:6]
            order8 = attention.qkv_block_order(256, dev)
            p8 = (xs8, wq8.index_select(0, order8), ws8.float().index_select(0, order8),
                  b8.float().index_select(0, order8))
            got8 = attention.project_int8(*p8, cos8, sin8, rotary_cols=512)
            check_projection(f"s8 projection (kernel 17 self, {batch} x {label}, 768 columns, rotary)", got8,
                             attention.project_int8_plain(*p8, cos8, sin8, rotary_cols=512),
                             attention.project_int8_plain(*p8), 512)
            require(torch.equal(attention.project_int8(*p8, cos8, sin8, rotary_cols=512), got8),
                    f"s8 projection (kernel 17 self, {label}): two launches differ")
            tok8 = xs8.shape[0] * xs8.shape[1]
            p_bnd, p_by = bound_ms(tok8 * (256 * 2 + 2 * 64 * 4 + 768 * 2) + 768 * (256 + 8),
                                   2.0 * tok8 * 256 * 768, INT8_TENSOR_OPS)
            self_pass[label] = dict(
                proj_ms=cuda_ms(torch, lambda: attention.project_int8(*p8, cos8, sin8, rotary_cols=512)),
                proj_plain_epilogue_ms=cuda_ms(torch, lambda: attention.project_int8(*p8)),
                proj_bound_ms=p_bnd, **pass_yardsticks(*p8))
            log(f"s8 projection (kernel 17 self, {batch} x {label}): {self_pass[label]['proj_ms']:.4f} ms "
                f"({self_pass[label]['proj_plain_epilogue_ms']:.4f} without the rotary) against its bound "
                f"{p_bnd:.4f} ms ({p_by}); torch._int_mm {self_pass[label]['proj_int_mm_ms']:.4f} ms, "
                f"F.linear {self_pass[label]['proj_linear_ms']:.4f} ms")
        count_one(lambda: attention.self_attention_int8(*s8),
                  {"self_attention_int8": 1, "projection_int8": 1},
                  "self_attention_int8 (the s8 pass and kernel 12's rotated message pass; no rotate launch)")
        xs8, wq8, ws8, b8, cos8, sin8, kb8, sc8, heads8, splits8 = s8
        n8 = xs8.shape[1]
        hd8 = 256 // heads8
        order8 = attention.qkv_block_order(256, dev)
        qkv8 = attention.project_int8_plain(xs8, wq8.index_select(0, order8), ws8.float().index_select(0, order8),
                                            b8.float().index_select(0, order8), cos8, sin8, rotary_cols=512)
        q8, k8, v8 = (t.reshape(batch, n8, heads8, hd8).transpose(1, 2).contiguous() for t in qkv8.split(256, -1))
        side8 = torch.arange(n8, device=dev) >= splits8[0]
        am8 = (side8[:, None] == side8[None, :])[None, None] & (kb8 > -0.5)[:, None, None, :]
        lib_ms = cuda_ms(torch, lambda: sdpa(q8, k8, v8, attn_mask=am8, scale=sc8))
        tok8 = batch * n8
        s_bytes = tok8 * 256 * 2 * 2 + 768 * 256 + 768 * 4 * 2 + 2 * tok8 * 64 * 4 + tok8 * 4
        bnd, by = bound_mixed_ms(s_bytes, 2 * tok8 * 256 * 768,
                                 2 * 2 * batch * heads8 * hd8 * sum(n * n for n in splits8))
        rows["self_attention_int8"] = dict(
            name="self_attention_int8", route="cuda", source="pram_tpu_torch/csrc/proj_int8.cu",
            replaces="pram_tpu/ops/attention_pallas.py:780",
            launches=None, max_abs_err=err, ms=self_ms["(512, 1024)"],
            plain_ms=cuda_ms(torch, lambda: attention.self_attention_int8_plain(*s8), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=lib_ms, ms_32x512=self_ms["512"],
            proj_ms_32x512=self_pass["512"]["proj_ms"], **self_pass["(512, 1024)"],
        )
        by_launch = launch_ms(torch, lambda: attention.self_attention_int8(*s8),
                              want=lambda k: "proj_s8" in k)
        rows["self_attention_int8"]["proj_device_ms"] = by_launch.get("proj_s8_kernel")
        log(f"self_attention_int8: {self_ms['512']:.4f} ms at {batch} x 512, {self_ms['(512, 1024)']:.4f} ms "
            f"at {batch} x (512 + 1024); SDPA {lib_ms:.4f} ms, SDPA + F.linear "
            f"{lib_ms + self_pass['(512, 1024)']['proj_linear_ms']:.4f} ms; by launch at {batch} x (512 + "
            f"1024) (device ms a launch, torch.profiler): {json.dumps(by_launch)}")

        # kernel 17, cross-attention at GML's 32 x (512 + 1024); its s8 pass
        # alone ([to_qk | to_v] rows into qk and v) the same way
        c8 = first("cross_attention_int8", lambda a, kw: True)[0]
        cmsg8 = cross_attention.cross_attention_int8(*c8)
        err = check_scaled(f"cross_attention_int8 ({batch} x (512 + 1024))", cmsg8,
                           cross_attention.cross_attention_int8_plain(*c8), INT8_TOL)
        require(torch.equal(cross_attention.cross_attention_int8(*c8), cmsg8),
                "cross_attention_int8: two launches differ")
        count_one(lambda: cross_attention.cross_attention_int8(*c8),
                  {"cross_attention_int8": 1, "projection_int8": 1},
                  "cross_attention_int8 (the s8 pass and kernel 11's message pass)")
        xc, wqk8, wsqk8, bqk8, wv8, wsv8, bv8, bb0, bb1, csc, cheads, cn0 = c8
        cn1 = xc.shape[1] - cn0
        pc = (xc, torch.cat([wqk8, wv8]), torch.cat([wsqk8.float(), wsv8.float()]),
              torch.cat([bqk8.float(), bv8.float()]))
        gotc = torch.cat(attention.project_int8(*pc, split=256), -1)
        check_projection(f"s8 projection (kernel 17 cross, {batch} x (512 + 1024), 512 columns into qk and v)",
                         gotc, attention.project_int8_plain(*pc))
        require(torch.equal(torch.cat(attention.project_int8(*pc, split=256), -1), gotc),
                "s8 projection (kernel 17 cross): two launches differ")
        tokc = batch * (cn0 + cn1)
        p_bnd, p_by = bound_ms(tokc * (256 * 2 + 512 * 2) + 512 * (256 + 8), 2.0 * tokc * 256 * 512,
                               INT8_TENSOR_OPS)
        cross_pass = dict(proj_ms=cuda_ms(torch, lambda: attention.project_int8(*pc, split=256)),
                          proj_bound_ms=p_bnd, **pass_yardsticks(*pc))
        log(f"s8 projection (kernel 17 cross): {cross_pass['proj_ms']:.4f} ms against its bound {p_bnd:.4f} ms "
            f"({p_by}); torch._int_mm {cross_pass['proj_int_mm_ms']:.4f} ms, F.linear "
            f"{cross_pass['proj_linear_ms']:.4f} ms")
        qkc, vc = (t.reshape(batch, -1, cheads, 64).transpose(1, 2)
                   for t in attention.project_int8_plain(*pc).split(256, -1))
        qc0, qc1 = qkc[:, :, :cn0].contiguous(), qkc[:, :, cn0:].contiguous()
        vc0, vc1 = vc[:, :, :cn0].contiguous(), vc[:, :, cn0:].contiguous()
        mc0, mc1 = (bb0 > -0.5)[:, None, None, :], (bb1 > -0.5)[:, None, None, :]

        def two_sdpa8():
            sdpa(qc0, qc1, vc1, attn_mask=mc1, scale=csc)
            sdpa(qc1, qc0, vc0, attn_mask=mc0, scale=csc)

        c_bytes = 2 * tokc * 256 * 2 + 2 * 256 * 256 + 4 * 256 * 4 + tokc * 4
        bnd, by = bound_mixed_ms(c_bytes, 2 * tokc * 256 * 512, 3 * 2 * batch * cheads * 64 * cn0 * cn1)
        rows["cross_attention_int8"] = dict(
            name="cross_attention_int8", route="cuda", source="pram_tpu_torch/csrc/proj_int8.cu",
            replaces="pram_tpu/ops/attention_pallas.py:929",
            launches=None, max_abs_err=err,
            ms=cuda_ms(torch, lambda: cross_attention.cross_attention_int8(*c8)),
            plain_ms=cuda_ms(torch, lambda: cross_attention.cross_attention_int8_plain(*c8), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=cuda_ms(torch, two_sdpa8), **cross_pass,
        )
        by_launch = launch_ms(torch, lambda: cross_attention.cross_attention_int8(*c8),
                              want=lambda k: "proj_s8" in k)
        rows["cross_attention_int8"]["proj_device_ms"] = by_launch.get("proj_s8_kernel")
        log(f"cross_attention_int8: {rows['cross_attention_int8']['ms']:.4f} ms; two SDPA "
            f"{rows['cross_attention_int8']['library_ms']:.4f} ms, two SDPA + F.linear "
            f"{rows['cross_attention_int8']['library_ms'] + cross_pass['proj_linear_ms']:.4f} ms; by launch "
            f"(device ms a launch, torch.profiler): {json.dumps(by_launch)}")

        # kernel 18 on each int8 3x3 layer of one extraction, with both tails,
        # two launches bit-equal, and each layer's time beside its bound and
        # cuDNN's bf16 convolution of the same shape
        require_no_spills(_build, ("conv_int8.cu", "conv_pair.cu"))
        conv_calls = recorded["conv3x3_int8"]
        conv = torch.nn.functional.conv2d
        k_ms = p_ms = c_lib_ms = 0.0
        c_bytes = c_ops = 0.0
        worst = 0.0
        layer_ms = []
        log(f"conv3x3_int8: {len(conv_calls)} launches in one extraction")
        for li, ((xc8, wqc, sac, wsc, bc), kw) in enumerate(conv_calls):
            stride, relu, own_tail = kw["stride"], kw["relu"], kw["bf16_tail"]
            x_coff = kw.get("x_coff", 0)
            cin, cout = wqc.shape[2], wqc.shape[3]
            xin = xc8[..., x_coff:x_coff + cin]
            for tail in (own_tail, not own_tail):
                ckw = dict(stride=stride, relu=relu, bf16_tail=tail)
                got = conv_int8.conv3x3_int8(xc8, wqc, sac, wsc, bc, x_coff=x_coff, **ckw)
                ref = conv_int8.conv3x3_int8_plain(xin, wqc, sac, wsc, bc, **ckw)
                equal = (got == ref).float().mean().item()
                e = (got.float() - ref.float()).abs().max().item()
                worst = max(worst, e)
                require(equal >= CONV_EQUAL_SHARE and e <= INT8_TOL * ref.float().abs().max().item(),
                        f"conv3x3_int8 {tuple(xin.shape)} -> {cout} (stride {stride}, "
                        f"{'bf16' if tail else 'f32'} tail) disagrees with its plain version: "
                        f"{equal:.5f} equal, max abs err {e:.3e}")
                require(torch.equal(conv_int8.conv3x3_int8(xc8, wqc, sac, wsc, bc, x_coff=x_coff, **ckw), got),
                        f"conv3x3_int8 {tuple(xin.shape)} -> {cout}: two launches differ")
            own = dict(stride=stride, relu=relu, bf16_tail=own_tail)
            l_ms = cuda_ms(torch, lambda: conv_int8.conv3x3_int8(xc8, wqc, sac, wsc, bc, x_coff=x_coff, **own),
                           iters=10)
            l_plain = cuda_ms(torch, lambda: conv_int8.conv3x3_int8_plain(xin, wqc, sac, wsc, bc, **own),
                              iters=2, warmup=1)
            # yardstick: cuDNN's bf16 conv of the same shape (dequantized weights), bias and ReLU
            wf = (wqc.float() * wsc.float()).permute(3, 2, 0, 1).to(bf16).contiguous(memory_format=torch.channels_last)
            xnchw = xin.contiguous().permute(0, 3, 1, 2)
            bfb = bc.to(bf16)
            l_lib = cuda_ms(torch, lambda: torch.relu(conv(xnchw, wf, bfb, stride=stride, padding=1)), iters=10)
            b_, h_, w_ = xin.shape[:3]
            ho_, wo_ = (h_ - 1) // stride + 1, (w_ - 1) // stride + 1
            l_bytes = b_ * h_ * w_ * cin * 2 + b_ * ho_ * wo_ * cout * 2 + 9 * cin * cout + 8 * cout
            l_ops = 2.0 * b_ * ho_ * wo_ * cout * 9 * cin
            l_bnd, l_by = bound_ms(l_bytes, l_ops, INT8_TENSOR_OPS)
            k_ms, p_ms, c_lib_ms = k_ms + l_ms, p_ms + l_plain, c_lib_ms + l_lib
            c_bytes, c_ops = c_bytes + l_bytes, c_ops + l_ops
            layer_ms.append(round(l_ms, 4))
            log(f"  layer {li}: {tuple(xin.shape)} -> {cout}, stride {stride}, {'bf16' if own_tail else 'f32'} "
                f"tail: {l_ms:.4f} ms against its bound {l_bnd:.4f} ms ({l_by}, {l_ops / 1e9:.1f} G s8 "
                f"operations, {l_ops / l_ms / 1e9:.1f} T/s); cuDNN bf16 {l_lib:.4f} ms, plain {l_plain:.3f} ms; "
                f"both tails equal to the plain version, two launches bit-equal")
        bnd, by = bound_ms(c_bytes, c_ops, INT8_TENSOR_OPS)
        rows["conv3x3_int8"] = dict(
            name="conv3x3_int8", route="cuda", source="pram_tpu_torch/csrc/conv_int8.cu",
            replaces="pram_tpu/ops/conv_int8_pallas.py:269",
            launches=None, max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
            bound_ms=bnd, bound_by=by, library_ms=None, layer_ms=layer_ms, cudnn_bf16_ms=c_lib_ms,
        )
        log(f"conv3x3_int8: {k_ms:.4f} ms for the {len(conv_calls)} layers of a batch; cuDNN's bf16 "
            f"convolutions of the same shapes {c_lib_ms:.4f} ms (a footnote, not library_ms: no PyTorch "
            f"call computes the s8 function)")
        del recorded, conv_calls

        # kernel 19 on the float extractor's conv3a + conv3b at 32 x 120 x 160
        sf = load_sfd2(SFD2_W, device=dev, dtype=bf16)
        xq8 = preprocess_image(torch.from_numpy(q_imgs).to(dev)).to(bf16).contiguous()
        st = stem.fused_stem(xq8, *sf.conv1a.stem_args(), *sf.conv1b.stem_args())
        xin = sf.conv2b(sf.conv2a(st.permute(0, 3, 1, 2))).permute(0, 2, 3, 1).contiguous()
        p_args = (xin, *sf.conv3a.stem_args(), *sf.conv3b.stem_args())
        pair_out = convpair.fused_conv_pair(*p_args)
        err = check_scaled(f"fused_conv_pair ({tuple(xin.shape)})", pair_out,
                           convpair.fused_conv_pair_plain(*p_args), INT8_TOL)
        require(torch.equal(convpair.fused_conv_pair(*p_args), pair_out), "fused_conv_pair: two launches differ")
        k3a, b3a = stem.fold_bn(*sf.conv3a.stem_args()[:2], *sf.conv3a.stem_args()[2])
        k3b, b3b = stem.fold_bn(*sf.conv3b.stem_args()[:2], *sf.conv3b.stem_args()[2])
        cl = torch.channels_last
        k3a, k3b = k3a.to(bf16).contiguous(memory_format=cl), k3b.to(bf16).contiguous(memory_format=cl)
        b3a, b3b = b3a.to(bf16), b3b.to(bf16)
        xinc = xin.permute(0, 3, 1, 2)

        def cudnn_pair():
            return torch.relu(conv(torch.relu(conv(xinc, k3a, b3a, padding=1)), k3b, b3b, padding=1))

        px = xin.shape[0] * xin.shape[1] * xin.shape[2]
        bnd, by = bound_ms(px * (128 + 256) * 2 + 9 * (128 * 256 + 256 * 256) * 2 + 2 * 256 * 4,
                           2.0 * px * 9 * (128 * 256 + 256 * 256), BF16_TENSOR_FLOPS)
        rows["fused_conv_pair"] = dict(
            name="fused_conv_pair", route="cuda", source="pram_tpu_torch/csrc/conv_pair.cu",
            replaces="pram_tpu/ops/convpair_pallas.py:123",
            launches=None, max_abs_err=err,
            ms=cuda_ms(torch, lambda: convpair.fused_conv_pair(*p_args)),
            plain_ms=cuda_ms(torch, lambda: convpair.fused_conv_pair_plain(*p_args), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=cuda_ms(torch, cudnn_pair),
        )
        by_launch = launch_ms(torch, lambda: convpair.fused_conv_pair(*p_args))
        log(f"fused_conv_pair: {rows['fused_conv_pair']['ms']:.4f} ms against its bound {bnd:.4f} ms ({by}); "
            f"cuDNN's pair {rows['fused_conv_pair']['library_ms']:.4f} ms; by launch (device ms a launch, "
            f"torch.profiler): {json.dumps(by_launch)}")
        del sf, xq8, st, xin, p_args, xinc, pair_out
    phase("int8_kernels", t)

    # ---- 19. the int8 image slice, counted
    t = time.perf_counter()
    reset_counts()
    metrics8 = guard8.recall(n_queries=batch, noise=True, seed=11)
    torch.cuda.synchronize()
    int8_launches = read_counts()
    log(f"int8 image slice launches: {int8_launches}")
    want = {name: image_launches[name] for name in ("ransac_score", "gn_polish", "sinkhorn", "refine_nn",
                                                      "fused_stem", "nms")}
    n_rec, n_gml = guard8.rec.config.n_layers, guard8.gml.config.n_layers
    want.update(residual_mlp_int8=n_rec + 2 * n_gml, self_attention_int8=n_rec + n_gml,
                cross_attention_int8=n_gml, projection_int8=n_rec + 2 * n_gml, conv3x3_int8=14)
    for name, count in int8_launches.items():
        require(count == want.get(name, 0),
                f"kernel {name}: {count} launches on the int8 image slice, expected {want.get(name, 0)}")
    log(f"int8 image slice on card: {json.dumps(metrics8)}")
    require(metrics8["n_queries"] == batch, "int8 image slice did not localize every query")
    require(metrics8["recall"] == 1.0, "int8 image slice recall@5cm/5deg below 1.0")

    def one_batch8():
        guard8.pipeline(gen.manual_seed(7), q_imgs)
        torch.cuda.synchronize()

    def one_extract8():
        guard8.extract(q_imgs, 512)
        torch.cuda.synchronize()

    def one_front8():
        guard8.front(q_imgs)
        torch.cuda.synchronize()

    batch8_s, ext8_s, front8_s = median_s(one_batch8), median_s(one_extract8), median_s(one_front8)
    with torch.no_grad():
        x_dev = preprocess_image(torch.as_tensor(q_imgs).to(dev, torch.float32)).to(bf16).contiguous()
        fwd8_ms = cuda_ms(torch, lambda: guard8.sfd2(x_dev), iters=5)
    log(f"int8 image slice: batch {batch} in {batch8_s * 1e3:.2f} ms (median of 5, host clock, synchronized) "
        f"= {batch / batch8_s:.1f} queries/s; extraction {ext8_s * 1e3:.2f} ms (the int8 SFD2 forward "
        f"{fwd8_ms:.3f} ms by CUDA events), recognition {(front8_s - ext8_s) * 1e3:.2f} ms, localization "
        f"{(batch8_s - front8_s) * 1e3:.2f} ms; float image slice of this run {batch_s * 1e3:.2f} ms "
        f"(extraction {ext_s * 1e3:.2f}, recognition {(front_s - ext_s) * 1e3:.2f}, localization "
        f"{(batch_s - front_s) * 1e3:.2f}; SFD2 forward {fwd_ms:.3f} ms)")
    phase("int8_slice", t)

    # ---- 20. the int8 extractor's A/B: kernel path vs plain path, int8 vs float
    t = time.perf_counter()
    ab8 = extraction_ab_check(n_images=4, seed=13, device=dev, dtype=bf16, int8=True)
    log(f"int8 extraction A/B (bf16, kernel path vs plain path): {json.dumps(ab8)}")
    require(ab8["kpt_set_agreement"] >= AB_BF16[0] and ab8["desc_cos_min"] >= AB_BF16[1],
            f"int8 extraction A/B below {AB_BF16}")
    with torch.no_grad():
        ab_imgs, _, _ = render_views(4, 13)
        ab_x = preprocess_image(torch.from_numpy(ab_imgs).to(dev)).to(bf16)
        kw8 = dict(max_keypoints=512, conf_th=1e-4)
        f_int8 = sfd2_extract(guard8.sfd2, ab_x, **kw8)
        f_float = sfd2_extract(load_extractor(dev, bf16), ab_x, **kw8)
    vs_float = extraction_agreement(f_int8, f_float)
    log(f"int8 extractor vs float extractor (bf16, 4 views): {json.dumps(vs_float)}")
    require(vs_float["desc_cos_min"] >= INT8_FLOAT_COS,
            f"int8 extractor's descriptors below cosine {INT8_FLOAT_COS} of the float extractor's")
    del guard8
    phase("int8_ab", t)

    # ---- 21. refinement by matching, auto refinement and the adaptive step
    t = time.perf_counter()

    def gml_inputs():
        """The GML slice's batch on the card with its recognition logits."""
        d = descs.to(dev, bf16)
        logits = model(d, nk.to(dev), mask.to(dev))["prediction"].float()[:, :, :n_class]
        return (Camera(cam_params.to(dev), cam_size.to(dev)), kpts.to(dev), scores.to(dev), d, mask.to(dev),
                logits)

    match_cfg = dataclasses.replace(gml_cfg, refinement_method="matching")
    m_runs = {}
    with torch.no_grad():
        g_in = gml_inputs()
        # (1) localize_batch with refinement by matching, the scene's 4 covisible frames
        mloc = make_localizer(dev, gml_fn, match_cfg)
        reset_counts()
        mres = mloc.localize_batch(torch.Generator().manual_seed(7), *g_in)
        torch.cuda.synchronize()
        m_runs["matching"] = read_counts()
        m_recall, mq_err, mt_err = recall_of(mres)
        for name in ("self_attention", "residual_mlp", "cross_attention", "sinkhorn"):
            require(m_runs["matching"][name] > 0, f"kernel {name} was not launched by refinement by matching")
        require(m_runs["matching"]["ransac_score"] == 2 and m_runs["matching"]["gn_polish"] == 2
                and m_runs["matching"]["sinkhorn"] == 2 and m_runs["matching"]["refine_nn"] == 0,
                "refinement by matching launched other kernels than its path's")
        require(m_recall >= grecall_gpu - 1.0 / batch, "refinement by matching: recall below the GML slice's")
        m_batch_s = median_s(lambda: (mloc.localize_batch(torch.Generator().manual_seed(7), *g_in),
                                      torch.cuda.synchronize()))
        log(f"GML slice with refinement by matching (covisible frames 4): recall@5cm/5deg {m_recall:.4f} (max error "
            f"{mq_err.max().item():.4f} deg, {mt_err.max().item():.5f} m), localization {m_batch_s * 1e3:.2f} ms a "
            f"batch of {batch} (median of 5, recognition aside); launches {m_runs['matching']}")
        # (2) auto refinement: trust 64 inliers (the default), then none
        aloc = make_localizer(dev, gml_fn, gml_cfg)
        for trust in (64, 10**6):
            reset_counts()
            ares = aloc.localize_batch_auto_refine(torch.Generator().manual_seed(7), *g_in, trust_inliers=trust)
            torch.cuda.synchronize()
            m_runs[f"auto_{trust}"] = read_counts()
            a_recall = recall_of(ares)[0]
            reran = bool((ares.initial_num_inliers < trust).any())
            want = (4, 4, 3, 1) if reran else (2, 2, 1, 1)
            got_n = tuple(m_runs[f"auto_{trust}"][k] for k in ("ransac_score", "gn_polish", "sinkhorn", "refine_nn"))
            log(f"auto refinement (trust {trust}): rerun {reran}, recall@5cm/5deg {a_recall:.4f}; kernels 3, 4, 6, 7 "
                f"launched {got_n}; launches {m_runs[f'auto_{trust}']}")
            require(got_n == want, f"auto refinement (trust {trust}) launched kernels 3, 4, 6, 7 {got_n}, not {want}")
            require(a_recall >= grecall_gpu - 1.0 / batch, "auto refinement: recall below the GML slice's")
        # the adaptive step at seg_k = 10 (bench.py's value_adaptive)
        k10 = make_localizer(dev, gml_fn, dataclasses.replace(gml_cfg, seg_k=10))
        reset_counts()
        dres = k10.localize_batch_adaptive(torch.Generator().manual_seed(7), *g_in)
        torch.cuda.synchronize()
        m_runs["adaptive"] = read_counts()
        require(bool(dres.success.all()), "adaptive step: phase 1 failed a query")
        require(tuple(m_runs["adaptive"][k] for k in ("ransac_score", "gn_polish", "sinkhorn", "refine_nn"))
                == (2, 2, 1, 1), "adaptive step: the full sweep ran or kernels are missing")
        d_recall = recall_of(dres)[0]
        ad_s = median_s(lambda: (k10.localize_batch_adaptive(torch.Generator().manual_seed(7), *g_in),
                                 torch.cuda.synchronize()))
        k1_s = median_s(lambda: (aloc.localize_batch(torch.Generator().manual_seed(7), *g_in),
                                 torch.cuda.synchronize()))
        k10_s = median_s(lambda: (k10.localize_batch(torch.Generator().manual_seed(7), *g_in),
                                  torch.cuda.synchronize()))
        log(f"adaptive step (seg_k 10): recall@5cm/5deg {d_recall:.4f}, localization {ad_s * 1e3:.2f} ms a batch; "
            f"the seg_k 1 step {k1_s * 1e3:.2f} ms, the full seg_k 10 sweep {k10_s * 1e3:.2f} ms (median of 5, "
            f"recognition aside); launches {m_runs['adaptive']}")
        del mloc, aloc, k10, g_in

    # (3) refine_matching_core at the configs' operating point: C = 20
    # covisible frame tables a query (configs/*.yaml covisibility_frame),
    # the frames of a 24-frame scene sharing the most points with it, 20 x
    # 512 = 10240 stacked correspondences and 640 GML problems a batch
    rng21 = np.random.RandomState(21)
    mscene = make_synthetic_scene(
        rng21, n_cluster=16, points_per_cluster=400, n_ref_frames=24, desc_dim=128, width=width,
        height=height, max_kp_per_frame=1024, max_ref_points=2048,
    )
    mqs = [mscene.render_query(rng21, noise_px=0.3, max_kpts=n_kpts) for _ in range(batch)]
    n_covis = 20
    fpi = mscene.map.frame_point_idx
    covis = []
    for q in mqs:
        seen = set(q["point_idx"][q["mask"] & (q["point_idx"] >= 0)].tolist())
        overlap = np.array([len(seen.intersection(row[row >= 0].tolist())) for row in fpi])
        covis.append(np.argsort(-overlap, kind="stable")[:n_covis])
    covis = torch.from_numpy(np.stack(covis))

    def mstack(key, dtype=np.float32):
        return torch.from_numpy(np.stack([q[key] for q in mqs]).astype(dtype))

    core_cfg = LocConfig(**loc_kw)

    mdmaps = {}

    def matching_core(device, match_fn, queries=slice(None), generator=None, triplets=None):
        if device not in mdmaps:
            mdmaps[device] = to_device(mscene.map, device, desc_dtype=bf16)
        b_ = len(range(batch)[queries])
        tabs = gather_vrf_tables(mdmaps[device], covis[queries].to(device))
        return refine_matching_core(
            match_fn, Camera(cam_params[queries].to(device), cam_size[queries].to(device)),
            mstack("keypoints")[queries].to(device), mstack("scores")[queries].to(device),
            mstack("descriptors")[queries].to(device, bf16), mstack("mask", bool)[queries].to(device),
            torch.ones(b_, n_covis, dtype=torch.bool, device=device), tabs, core_cfg, generator, triplets)

    stage_s = {}

    def timed_stage(name, fn):
        def wrapped(*a, **kw):
            t_s = sync(dev)
            out = fn(*a, **kw)
            stage_s.setdefault(name, []).append(sync(dev) - t_s)
            return out
        return wrapped

    originals = (gpnp._sample_triplets, gpnp.p3p_grunert, pnp.ransac_score, pnp.gn_polish)
    gpnp._sample_triplets = timed_stage("noise draw and triplets", gpnp._sample_triplets)
    gpnp.p3p_grunert = timed_stage("P3P", gpnp.p3p_grunert)
    pnp.ransac_score = timed_stage("kernel 3", pnp.ransac_score)
    pnp.gn_polish = timed_stage("kernel 4", pnp.gn_polish)
    try:
        with torch.no_grad():
            reset_counts()
            core_out = matching_core(dev, timed_stage("GML matcher", gml_fn), generator=torch.Generator().manual_seed(9))
            torch.cuda.synchronize()
            m_runs["matching_core_c20"] = read_counts()
            for _ in range(3):
                t_b = sync(dev)
                matching_core(dev, timed_stage("GML matcher", gml_fn), generator=torch.Generator().manual_seed(9))
                stage_s.setdefault("total", []).append(sync(dev) - t_b)
    finally:
        gpnp._sample_triplets, gpnp.p3p_grunert, pnp.ransac_score, pnp.gn_polish = originals
    require(m_runs["matching_core_c20"]["ransac_score"] == 1 and m_runs["matching_core_c20"]["gn_polish"] == 1
            and m_runs["matching_core_c20"]["sinkhorn"] == 1, "refine_matching_core at C = 20: kernels 3, 4, 6 not "
            "launched once each")
    Rm, tm, nm, okm, pim, _ = core_out
    mq_err, mt_err = compute_pose_error(rotmat2qvec(Rm).cpu(), tm.cpu(), mstack("qvec"), mstack("tvec"))
    c20_recall = float((okm.cpu() & (mt_err < 0.05) & (mq_err < 5.0)).float().mean())
    gt_pt = mstack("point_idx", np.int64)
    assigned = pim.cpu() >= 0
    c20_precision = float((pim.cpu() == gt_pt)[assigned].float().mean()) if assigned.any() else 0.0
    stages = {k: round(sorted(v[-3:])[1] * 1e3, 3) for k, v in stage_s.items()}
    log(f"refine_matching_core, {batch} queries x {n_covis} frames ({batch * n_covis} GML problems of {n_kpts} x "
        f"{mscene.map.frame_point_idx.shape[1]} tokens, {n_covis * n_kpts} stacked correspondences a query): "
        f"recall@5cm/5deg {c20_recall:.4f}, match precision {c20_precision:.4f} ({int(assigned.sum()) / batch:.1f} "
        f"assigned keypoints a query), inliers median {nm.float().median().item():.0f}; ms by stage (synchronized "
        f"host clock, median of 3): {json.dumps(stages)}; launches {m_runs['matching_core_c20']}")
    require(bool(torch.isfinite(tm).all()) and c20_recall >= 31 / 32, "refine_matching_core at C = 20: recall below 31/32")

    # (4) the first 2 queries on the card and on the card machine's CPU, the
    # card's triplets fed to both
    drawn = []

    def recording_triplets(*a):
        drawn.append(originals[0](*a))
        return drawn[-1]

    gpnp._sample_triplets = recording_triplets
    try:
        with torch.no_grad():
            sub = slice(0, 2)
            card = matching_core(dev, gml_fn, sub, torch.Generator().manual_seed(3))
            t_cpu = time.perf_counter()
            gml_cpu = load_gml(gml_weights, GMLConfig(), device="cpu", dtype=bf16)
            cpu = matching_core("cpu", make_gml_match_fn(gml_cpu, gml_cpu.config.match_threshold), sub,
                                triplets=drawn[0].cpu())
    finally:
        gpnp._sample_triplets = originals[0]
    dq, dt = compute_pose_error(rotmat2qvec(card[0]).cpu(), card[1].cpu(), rotmat2qvec(cpu[0]), cpu[1])
    both = card[3].cpu() & cpu[3]
    log(f"refine_matching_core at C = 20 on the CPU: 2 queries in {time.perf_counter() - t_cpu:.1f} s; card vs CPU: "
        f"success {card[3].tolist()} vs {cpu[3].tolist()}, inliers {card[2].tolist()} vs {cpu[2].tolist()}, pose diff "
        f"max {dq[both].max().item() if both.any() else 0:.4f} deg, {dt[both].max().item() if both.any() else 0:.5f} m")
    require(bool(torch.equal(card[3].cpu(), cpu[3])), "refine_matching_core: success differs card vs CPU")
    require(bool((dq[both] < SLICE_R_TOL_DEG).all() and (dt[both] < SLICE_T_TOL).all()),
            "refine_matching_core: pose differs card vs CPU")
    del gml_cpu, core_out, card, cpu, mdmaps
    rows["ransac_score"]["matching"] = dict(
        launches=m_runs, recall_matching=m_recall, recall_c20=c20_recall, precision_c20=c20_precision,
        stages_c20_ms=stages, localization_ms=dict(matching=m_batch_s * 1e3, adaptive=ad_s * 1e3,
                                                   seg_k1=k1_s * 1e3, seg_k10=k10_s * 1e3))
    phase("matching", t)

    # ---- 22. the two serving CLIs through main(argv), counted; the online CLI's inputs stay for phase 32
    t = time.perf_counter()
    online_root = tempfile.TemporaryDirectory(prefix="pram_online_")
    cli_runs = run_cli_phase(
        torch, np, dev, bf16, scene, queries, grecall_gpu, weights, gml_weights, reset_counts, read_counts,
        Path(online_root.name),
    )
    online_inputs = cli_runs.pop("online_inputs")
    for r in rows.values():
        r["launches_cli"] = {path: run["launches"][r["name"]] for path, run in cli_runs.items()}
    log(f"cli: {json.dumps({k: {kk: vv for kk, vv in v.items() if kk != 'launches'} for k, v in cli_runs.items()})}")
    phase("cli", t)

    # ---- 23. GML matcher training through cli.train_synthetic_gml.main, counted
    t = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="pram_gml_") as tmp:
        gml_train = run_gml_train_phase(torch, np, dev, bf16, reset_counts, read_counts,
                                        Path(tmp) / "gml_synthetic_torch.pt")
    bd = gml_train["breakdown"]
    log(f"gml_train step breakdown on a copy of the trained model (ms a step; stages by CUDA events, median of 3 "
        f"runs of 10 steps, runs {[round(v, 3) for v in bd['runs_ms']]} ms by host clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in bd["stages"].items())
        + f"; device time a step {bd['device_ms_per_step']:.3f} ms by torch.profiler, by kernel: "
        + json.dumps({k: round(v, 4) for k, v in list(bd["by_kernel"].items())[:24]})
        + f"; the Sinkhorn's forward (kernel 6) {gml_train['sinkhorn']['forward_ms']:.4f} ms and its recomputed "
        f"backward {gml_train['sinkhorn']['recompute_backward_ms']:.4f} ms; card: {smi}")
    k14 = gml_train["k14"]
    rows["cross_attention_bwd"].update(ms_gml_train=k14["ms"], plain_ms_gml_train=k14["plain_ms"],
                                       bound_gml_train_ms=k14["bound_ms"], max_abs_err_gml_train=k14["max_abs_err"],
                                       shape_gml_train=k14["shape"])
    log(f"cross_attention_bwd on the GML training path ({k14['shape']}): {k14['ms']:.4f} ms a call, plain "
        f"{k14['plain_ms']:.4f} ms, bound {k14['bound_ms']:.4f} ms ({k14['bound_by']})")
    log(f"gml_train: {json.dumps({k: v for k, v in gml_train.items() if k not in ('breakdown', 'k14')})}")
    phase("gml_train", t)

    # ---- 24. recognition training through cli.train.main, counted
    t = time.perf_counter()
    train_cli = run_train_cli_phase(torch, np, scene, reset_counts, read_counts, root)
    for name, run in train_cli.items():
        log(f"{name} CLI: {run['steps']} steps in {run['seconds']:.2f} s ({run['steps'] / run['seconds']:.3f} "
            f"steps/s, host clock, the loader, checkpoints and the first step's warm-up included), epoch losses "
            f"{run['epoch_losses']}, files {run['files']}")
    phase("train_cli", t)

    # ---- 25. path A: the Aachen front end (images -> SFD2 -> SegNetViT nc513 -> AdaGML)
    t = time.perf_counter()
    torch.cuda.empty_cache()
    front = run_aachen_front_phase(torch, np, dev, bf16, a_scene, r_scene, a_cfg, ada_w, ada_fn, reset_counts,
                                   read_counts)
    phase("aachen_front", t)

    # ---- 26. path B: GML at the Aachen shape, and cli.inference at the Aachen config
    t = time.perf_counter()
    torch.cuda.empty_cache()
    gml_b = run_aachen_gml_phase(torch, np, dev, bf16, gml, gml_weights, a_scene, a_queries, a_inputs, a_cfg,
                                 aachen_outcome, a_layout, cli_cpu, reset_counts, read_counts)
    phase("aachen_gml", t)

    # ---- 27. every padded wrapper off its tile; the online CLI at 1000 keypoints (run in phase 22)
    t = time.perf_counter()
    shapes = run_shapes_phase(torch, np, dev, bf16, ada_w, ada_inputs[0], reset_counts, read_counts)
    log(f"online CLI at --max_keypoints 1000 (phase 22's inputs): {json.dumps(cli_runs['online_1000'])}")
    phase("shapes", t)

    # ---- 28. the SuperPoint path: SuperPoint -> SegNet -> GM / mutual NN -> Localizer
    t = time.perf_counter()
    torch.cuda.empty_cache()
    sp_path = run_superpoint_phase(torch, np, dev, bf16, _build, reset_counts, read_counts)
    log(f"superpoint path: {json.dumps({k: v for k, v in sp_path.items() if k != 'kernels'})}")
    phase("superpoint", t)

    # ---- 29. the second family through the CLIs' builders: cli.inference with segnet + gm, the
    # superpoint-n4096 extractor, build_compressor, RetNet
    t = time.perf_counter()
    torch.cuda.empty_cache()
    sg_cli = run_segnet_gm_cli_phase(torch, np, dev, bf16, scene, queries, reset_counts, read_counts)
    log(f"segnet + gm CLI: {json.dumps(sg_cli)}")
    phase("segnet_gm_cli", t)

    # ---- 30. map building: triangulation and cli.build_map on the card from the port's SFD2 features,
    # the built map localized through kernels 1-9, the card's build against the CPU's, the scale timings
    t = time.perf_counter()
    torch.cuda.empty_cache()
    mapping = run_mapping_phase(torch, np, dev, bf16, reset_counts, read_counts, gml_kernels + ("fused_stem", "nms"))
    world_inputs = mapping.pop("world")
    mapping["scale"] = mapping_scale_timings(torch, dev)
    log(f"mapping: {json.dumps({k: v for k, v in mapping.items() if k != 'localization'})}; card: {smi}")
    phase("mapping", t)

    # ---- 31. the hloc file pipeline through the CLIs' main(argv): features and matches to h5,
    # triangulation and the map from h5, the queries on the built map and through run_localizer
    t = time.perf_counter()
    torch.cuda.empty_cache()
    hloc = run_hloc_phase(torch, np, dev, bf16, world_inputs, reset_counts, read_counts,
                          gml_kernels + ("fused_stem", "nms"))
    log(f"hloc: {json.dumps({k: v for k, v in hloc.items() if k not in ('localization', 'kernels')})}; card: {smi}")
    phase("hloc", t)

    # ---- 32. the runtime remainder: JPEG input, the online CLI's viewer, the torch reconstruction
    # script, the backward kernels off their tiles inside training
    t = time.perf_counter()
    torch.cuda.empty_cache()
    runtime = run_runtime_phase(torch, np, dev, bf16, root, online_inputs, cli_runs["online"]["mean_ms_after_first"],
                                world_inputs, scene, reset_counts, read_counts, gml_kernels + ("fused_stem", "nms"))
    del world_inputs
    online_root.cleanup()
    log(f"runtime: {json.dumps({k: v for k, v in runtime.items() if k not in ('online', 'script', 'train')})}; "
        f"online {json.dumps({k: v for k, v in runtime['online'].items() if k != 'runs'})}; script "
        f"{json.dumps({k: v for k, v in runtime['script'].items() if k != 'localization'})}; card: {smi}")
    for name in gml_kernels + ("fused_stem", "nms", "self_attention_bwd", "cross_attention_bwd", "residual_mlp_bwd"):
        require(runtime["launches"].get(name, 0) > 0, f"runtime: kernel {name} was not launched in phase 32")
    phase("runtime", t)

    wide = gml_b["kernels"]["sinkhorn_wide"]
    rows["sinkhorn_wide"] = dict(
        name="sinkhorn_wide", route="cuda", source="pram_tpu_torch/csrc/sinkhorn.cu",
        replaces="pram_tpu/ops/sinkhorn_pallas.py:70", launches=gml_b["launches"]["sinkhorn_wide"],
        library_ms=None, **{k: v for k, v in wide.items()},
    )
    for r in rows.values():
        name = r["name"]
        r["launches_aachen_front"] = {k: run["launches"][name] for k, run in front["runs"].items()}
        r["launches_aachen_gml"] = gml_b["launches"][name]
        r["launches_aachen_cli"] = gml_b["cli"]["launches"][name]
        r["launches_shapes"] = shapes["launches"][name]
        r["launches_online_1000"] = cli_runs["online_1000"]["launches"][name]
        r["launches_superpoint"] = {k: run["launches"][name] for k, run in sp_path["paths"].items()}
        r["launches_segnet_gm_cli"] = sg_cli["inference"]["launches"][name]
        r["launches_mapping"] = mapping["localization"]["launches"][name]
        r["launches_hloc"] = hloc["launches"][name]
        r["launches_runtime"] = runtime["launches"][name]
        if name in hloc["kernels"]:
            r["hloc"] = hloc["kernels"][name]
        if name in sp_path["kernels"]:
            r["superpoint"] = sp_path["kernels"][name]
        for path, got in (("aachen_front", front["kernels"]), ("aachen_gml", gml_b["kernels"])):
            if name in got and name != "sinkhorn_wide":
                r[path] = got[name]
    log(f"aachen front: {json.dumps({k: v for k, v in front.items() if k != 'kernels'})}")
    log(f"aachen GML: {json.dumps({k: v for k, v in gml_b.items() if k != 'kernels'})}")

    table = []
    for name in ("self_attention", "residual_mlp", "ransac_score", "gn_polish",
                 "cross_attention", "sinkhorn", "refine_nn", "fused_stem", "nms",
                 "self_attention_qkv", "cross_attention_packed", "self_attention_qkv_blocked",
                 "self_attention_bwd", "cross_attention_bwd", "residual_mlp_bwd",
                 "residual_mlp_int8", "self_attention_int8", "cross_attention_int8", "conv3x3_int8",
                 "fused_conv_pair", "sinkhorn_wide"):
        r = rows[name]
        # kernels 1-7 counted on the GML slice, 8-9 on the image slice, 10-12
        # on the AdaGML slice (12 is on no path), 13 and 15 on the training
        # slice, 14 on GML training, 16-19 on the int8 image slice (19 is on
        # no path)
        r["launches_gml_train"] = gml_train["launches"][name]
        r["launches_train_cli"] = train_cli["train"]["launches"][name]
        if name == "sinkhorn_wide":
            pass  # path B's (phase 26)
        elif name == "cross_attention_bwd":
            r["launches"] = gml_train["launches"][name]
        elif name in gml_kernels:
            r["launches"] = gml_launches[name]
        elif name in ("fused_stem", "nms"):
            r["launches"] = image_launches[name]
        elif name in train_kernels:
            r["launches"] = train_launches[name]
        elif name in int8_kernels:
            r["launches"] = int8_launches[name]
        else:
            r["launches"] = ada_launches[name]
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"{name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {r['launches']} launches")
        table.append(r)

    log(f"phases (s): {json.dumps(PHASES)}; total {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
