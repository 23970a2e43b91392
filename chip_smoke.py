#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA Hopper card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives the port (pointcloud_bridge_tpu_torch), never JAX, in phases;
any failure raises and exits non-zero:

1. require CUDA, print the card (nvidia-smi name and power limit), turn
   TF32 off for matmuls and cuDNN;
2. build the CUDA kernels from csrc/ (timed, with the ptxas report);
3. hold each kernel against its plain PyTorch version on the card at every
   shape that the PointNet++ SSG forward and the BriStruNet forward give it
   (B=4, 4096 points; BriStruNet: FPS 4096->1024->512->128, ball query (one
   scan a level for both radii) and group at K=16 and K=32 over two radii a
   level with 3, 256 and 512 feature
   channels, interpolation at k=4, the exact k-NN kernel at its three
   shapes): FPS, ball query, group and k-NN bit-identical, interpolation
   within 1e-5; median times of both from CUDA events, summed a path,
   beside the least time the card could take (bytes over 3.35 TB/s or
   operations over 67 TFLOP/s float32, whichever is larger) and, where one
   PyTorch call computes the same function, that call's time. FPS (K1)
   also at the SSG levels at B=16, from a [B] start, over duplicated points
   and a row of one point, at N no multiple of 32 (one warp and several),
   npoint = N, npoint > N and N = 16384 (the cap); each timed K1 case adds
   ns and cycles a step at the SM clock that nvidia-smi reads meanwhile,
   beside the one-SM issue floor (12 instructions a point over 128 lanes a
   cycle). Ball query (K2) also at the SSG levels at B=16, over empty balls,
   K > N (duplicate points among them), N no multiple of 32, N = 16384 (a
   ring of staged tiles), radius 0 over duplicate points and one scan of
   three radii over N = 9000 (a ring) and of two where the smaller radius
   asks for more points, each output held to its own radius; the exact k-NN
   (K5), indices and distances, also at N=S=4096 k=32 at B=16 (the serve's
   batch), N = 16384 with k = 64 (a ring of staged tiles), S != N, k = N, N
   no multiple of 32, and k = 1, 32, 40 and 64 on an integer grid (ties);
   K5 also at DGCNN's xyz graphs (N = S = 4096, k = 20 and 64, B = 4 and
   16); K5c, k-NN over C channels, indices and distances bit-identical, at
   DGCNN's conv2-conv4 shapes (C = 64, N = S = 4096, k = 20 and 64, B = 4
   and 16, three launches a forward), then at C = 5, 6, 67, 128 and 3, N
   no multiple of its tile, S != N, rows off 16-byte alignment, integer
   features (ties), duplicate points and k = N, and at the edges of a warp
   of Q queries at every Q (S = 1, Q - 1 and 4097, B = 1 with S < Q, k = 1
   and 64, C = 67 and 128, queries off 16-byte alignment);
   each timed K2, K5 and K5c case adds its issue floor (9 instructions a
   pair scanned, 3C for K5c, over 128 lanes an SM a cycle at the SM clock
   that nvidia-smi reads meanwhile). Interpolation (K4) also at the SSG levels at B=16, D=131, a
   feature view 4 bytes off alignment, S=2 with k=2, ties on an integer grid
   and S=2000, each case with the kept selection (indices bit for bit,
   weights within 1e-6) and the same output with and without it. The group
   kernel (K3) also at the SSG levels at B=16 (the serve's batch), at
   widths 3, 4 and 16, over empty balls, N = 1, 35 rows a batch and indices
   out of range, the same bits twice, and with its two ways to store side
   by side. Each timed K1, K2, K3, K4 and K5 case adds the split of its
   time: device time a call of the kernel and of the library call (a CUDA
   graph of 20 calls between two events) and the wrapper's host time a call
   (1000 calls). Then K1-K4 at every shape that the PointNet++ MSG family's
   forwards give them at B=4 (pointnet2_msg with 9 channels: FPS 4096 ->
   1024 -> 256 -> 64 -> 16, one ball-query scan a level of two radii with K
   16 and 32, groups of widths 12, 99, 259 and 515, interpolation fp4-fp1 of
   1024, 256, 256 and 128 channels; pointnet2_sem_seg's four SSG levels;
   the classifiers' 4096 -> 512 -> 128 with three radii and K up to 128 for
   pointnet2_cls_msg), each timed with the split of its time, then their
   edge cases (compare_msg_family_kernels): FPS with one warp and past N, a
   scan where one radius finds nothing and the other everything, K > N, K =
   128 at S = 16, 128, 512 and 1024, groups at K = 128 and over padded
   balls, D = 1024 from S = 16 at B = 1 and 16;
3b. the backward kernels against their plain versions at the SSG train
   shapes (B=4): group backward (K3b: sa2, sa3) and interpolation backward
   (fp3, fp2, fp1, on the selection the forward kernel saved), within 1e-5
   of max|plain|; median times of both; K3b also timed, with the split of
   its time, at the SSG train step's shapes at B=16 and at those of a
   BriStruNet backward (sa1-sa3, K=16 and 32 with 3, 256 and 512 channels),
   and held with the xyz channels (c0 = 0, c1 = 3), output widths 1, 4 and
   16, empty balls, N = 1, K = 64 and 35 rows a batch; interpolation
   backward (K4b) on the selection the forward kernel keeps, timed with the
   split of its time and of index_add_'s at the SSG train step's shapes
   (k=3) and the BriStruNet train step's (k=4, up to 1024 channels), both
   at B=4 and B=16, and held, not timed, with every query on one source
   (S=2 with k=2; N=4096 with every slot on one row), sources that no query
   chose (exactly 0), D = 1, 3, 131 and 1024, a g view 4 bytes off 16-byte
   alignment, S = 16384, N * k around the 4096-entry windows and k = 1..4,
   each case the same bits from one call to the next; both also at the
   pointnet2_msg train step's shapes (K3b at sa2-sa4, C = 96, 256, 512 at K
   16 and 32; K4b at fp4-fp1, D = 1024 from S = 16 down to 128 from 1024),
   timed, and K3b at K = 128 and over padded balls, K4b at D = 1024, S = 16
   at B = 1 and 16 (compare_msg_family_backward);
3c. the flash-attention kernel against the plain attention at every shape
   that the PTv3 family gives it at B=4 x 4096 (the windows of level 0 folded
   to [16,1024,2,32], the global levels [4,1024,4,32] and [4,256,8,32], the
   flat model's [4,4096,2,192] and [4,4096,6,64]), on the strided slices of a
   packed qkv projection of LayerNorm output, at ragged lengths (65, 129 and
   4095 among them: no multiple of a tile height) and with q and k scaled
   until the largest score is 55, where the error of a product goes into an
   exponent; within 2e-5 * max(1, max|plain|); times beside two bounds, the
   tensor cores in 3xTF32 (the fastest route at float32 accuracy) and
   float32 FMAs, and beside F.scaled_dot_product_attention;
3d. the two attention-backward kernels (dq, which also writes delta; dk and
   dv) against the plain backward at the shapes of 3c, within the same band;
   the forward's log-sum-exp within 1e-5 of torch.logsumexp (1e-6 of itself
   where it is large) and its output bit-identical with and without it; each
   backward kernel the same bits from one call to the next; the plain
   backward against autograd;
   times beside the bound and beside the backward of
   F.scaled_dot_product_attention;
3e. the bf16 flash-attention kernels (forward; dq with delta; dk and dv)
   against attention_plain and attention_backward_plain in bf16 on bf16
   packed-qkv views, at the shapes the bf16 paths give them (the
   configs/train_ptv3_big_prod.yaml microbatch [4,4096,6,64]; ptv3 and
   ptv3_moe [4,4096,2,192]; ptv3_pooled's three levels), then at ragged N,
   N = 1, D = 96 to 256, scores of 55, contiguous q, k, v, a row stride
   padded by 8 elements, a view and a gradient off 16-byte alignment; bands
   in bf16 roundings (eps = 2^-8) scaled by the plain values: O within
   2 eps * max|plain|, dq, dk, dv within 4 eps * max|plain|, the rms of
   each error within eps * rms(plain), lse 1e-5 relative, each backward
   kernel the same bits from call to call; times beside the bound over the dense bf16 tensor rate
   (989 TFLOP/s) and F.scaled_dot_product_attention in bf16;
3f. K7, the neighbour reduction of DGCNN's restructured EdgeConv, against
   edge_reduce_plain on the card at the shapes the DGCNN forwards and train
   steps give it (B=4 and 16, N = S = 4096, k = 20 with F = 64 and 128, k =
   64 with F = 64 and 128; the train steps' with the moments and the ties)
   on a K5 graph of a uniform cloud: the max, the min and the ties bit for
   bit (the ties also against tie_counts_plain, and counting them changes
   no other output), the moments within 1e-6 * max(1, max|plain|) (their
   bit-identity printed: the plain version folds in the kernel's order);
   then K7b (sort, rank and fold with no per-edge tensor) at the train
   steps' shapes, bit for bit against the plain per-edge gradients folded
   in K3b's order (group_backward_order), within 1e-5 of max|plain| of
   scatter_add_'s fold and of torch's
   autograd of the reductions, the same bits on a second call; both on an
   integer grid (ties: the cotangent of a max held by several slots splits
   evenly), in eval mode (no moments), at F = 24, 3, 66 and 256, k = 1,
   S != N, S = 12000 (K7b's fold from device memory), indices past N and a
   y 4 bytes off 16-byte alignment. Times (event, device, host) at every
   shape beside the bound (idx, y once and the outputs over 3.35 TB/s)
   and, for K7, index_points + amax + amin in PyTorch; with --dgcnn or
   --edge the first design of both (probes/k7_probe.py) timed before and
   after each in braces;
4. the SSG forward at B=4 x 4096 on the card against the same model on the
   CPU (plain versions), logits within 2e-4; every forward kernel must have
   been launched; forward time and points/s;
5. serve 48 blocks of two synthetic bridge scenes written as LAS through
   BlockDataset.from_files and run_block_inference, once to warm up and
   once with the launch counters reset just before and read just after;
   wall time and points/s;
6. one SSG train step (forward, weighted CE, backward) at B=4 x 4096 on the
   card against the same step on the CPU: first with the BatchNorms frozen
   (every gradient leaf within 1e-3 of its max|g|), then in train mode:
   loss within 1e-5 relative, updated BatchNorm statistics within 1e-4 of
   max|stat|, every gradient leaf compared (see check_train_step for the
   bands and why), and all six kernels launched;
7. two epochs of training through the port's CLI (train_cli.main) on the
   two LAS scenes, validating on one of them, with the launch counters
   reset just before and read just after; finite losses, best_model and
   latest_checkpoint written, a reload of latest_checkpoint gives the
   trained model's eval logits exactly; steady-state train step at batch
   16 (ms, points/s), peak device memory and device time by kernel family;
8. the BriStruNet forward at full width, B=4 x 4096, random weights and
   BatchNorm statistics, on the card against the CPU (plain versions):
   logits within 2e-4; exactly 3 FPS, 3 ball-query (both radii of a level
   in one scan), 6 group, 3 interpolation and 3 k-NN launches and no
   backward kernel; forward time,
   points/s, and device time by kernel family from one torch.profiler run;
9. serve through the inference CLI (infer_cli.main) from checkpoints:
   BriStruNet in ``blocks`` mode (once in a fresh interpreter, the cold
   start; then in this one a first call and a warm one with the launch
   counters reset just before and read just after) and in ``scene``
   mode (2 votes a scene, counters likewise), and PointNet++ SSG in
   ``blocks`` mode from the checkpoint phase 7 trained; wall and points/s,
   the CSVs and the printed metric lines checked; one scene once more
   through whole_scene_vote_predict for the split of its phase timings.

10. the ptv3_pooled forward at the benched configuration (dims 64/128/256,
   encoder depths 2/2/6, decoder depths 1/1, strides 4/4, windows of 1024),
   B=4 x 4096, on the card against the CPU: logits within 2e-4; exactly 12
   flash-attention launches and no other kernel; forward time, points/s and
   device time by kernel family;
11. the flat ptv3 forward at its default width (384 wide, 2 heads of 192,
   global attention over 4096 points; 4 of its 8 blocks), B=4,
   against the CPU: logits within 2e-4, exactly 4 flash-attention
   launches; the forward time of the 4 blocks and, on the card alone, of
   the registry's 8;
12. serve ptv3_pooled (the registry's default model) through infer_cli.main
   from a checkpoint the script writes: ``blocks`` over the 48 blocks and
   ``scene`` with 2 votes, counters reset just before and read just after:
   the flash-attention kernel and no other; CSVs, exported LAS and printed
   lines checked; wall and points/s;
13. one ptv3_pooled train step (forward, weighted CE, backward; dropout 0) at
   the benched configuration, B=4 x 4096, on the card against the CPU: loss
   within 1e-5 relative, train-mode logits within 2e-4, head_bn statistics
   within 1e-4 of max|stat|, every gradient leaf present, finite, non-zero
   and within 1e-3 * max|g| + 1e-7; exactly 12 launches of the forward and
   of each backward kernel and no other kernel; milliseconds a step;
14. two epochs of ptv3_pooled (the registry's default model) at batch 16
   through train_cli.main, checked as in 7, then ``infer_cli blocks`` serving
   the checkpoint that run wrote; the steady-state train step at the benched
   configuration at batch 16 (ms, points/s trained, peak device memory,
   device time by kernel family); one epoch each from
   configs/train_ptv3_pooled.yaml and configs/train_ptv3.yaml through
   ``--config``;
15. one flat ptv3 train step at its default width (4 blocks), B=4 x 4096,
   against the CPU at the same batch, checked as in 13: exactly 4 launches
   a kernel;
16. one BriStruNet train step at full width, B=4 x 4096, dropout 0, with the
   loss of configs/train_bristrunet.yaml (bridge_structure, alpha 80,
   rel_margin 0.3), on the card against the CPU, checked as in 6 (frozen
   BatchNorms first; in train mode both sides take the class weights of the
   CPU step's predictions, a step function of the argmax): exactly 3 FPS, 3
   ball-query, 6 group, 3 interpolation, 3 k-NN, 6 group-backward and 3
   interpolation-backward launches; milliseconds a step;
17. two epochs of BriStruNet at batch 16 through train_cli.main with
   ``--config configs/train_bristrunet.yaml`` (bridge_structure loss,
   weighted block sampling, the plateau scheduler, Adam), checked as in 7,
   the batch-16 step timed and profiled by kernel family, then
   ``infer_cli blocks`` serving the checkpoint that run wrote;
18. the DGCNN (k = 20) and DGCNNGlobal (k = 64) forwards at full width,
   B=4 x 4096, random weights and BatchNorm statistics, on the card (in its
   default EdgeConv form, the restructured one) against the CPU in the same
   form (PCB_EDGECONV_FAST=1): exactly 1 K5, 3 K5c and 4 K7 launches; each
   of the four graphs the card built (recorded by wrapping the port's knn
   and knn_set where models/dgcnn.py calls them, ``GraphTap``) bit for bit
   against knn_plain on the card on that stage's own input; the CPU forward
   with the card's graphs replayed,
   logits within 2e-4 (conv2-conv4 build their graphs on features from
   GEMMs, which the card and the CPU round differently, and a near tie at
   the k-th neighbour may swap); then without the replay, the picks that
   differ stage by stage with their gaps to the k-th distance; forward
   time, points/s and device time by kernel family;
19. one DGCNN train step at full width, B=4 x 4096, on the card against
   the CPU, both in the restructured form, checked as in 6, the CPU taking
   the card's graphs of the same mode: exactly 1 K5, 3 K5c, 4 K7 and 4 K7b
   launches (K7b sorts and folds on its own: no K3b);
   milliseconds a step;
20. two epochs of DGCNN at batch 16 through train_cli.main with
   ``--config configs/train_dgcnn.yaml``, checked as in 7, the batch-16
   step timed (ms, points/s, peak memory) and profiled, then ``infer_cli
   blocks`` serving the checkpoint that run wrote, and once more with
   ``--from-snapshot``: the run's code snapshot builds its own kernels under
   <exp>/code_snapshot/build/, K5, K5c and K7 launch from it (its own
   counters), and its CSVs equal the first serve's; all in the card's
   default EdgeConv form, the restructured one;
21. the pointnet2_msg forward at full width, B=4 x 4096, with 9 feature
   channels in the Partsize column order (bench.py's shape), random weights
   and BatchNorm statistics, on the card against the CPU: logits within
   2e-4, exactly 4 FPS, 4 ball-query, 8 group and 4 interpolation launches;
   forward time, points/s and device time by kernel family;
22. the pointnet2_sem_seg forward (colours; 4/4/4/4 launches) and both
   classifiers with xyz alone (in_features=0, their default) and with
   colours (pointnet2_cls_ssg 2/2/2, pointnet2_cls_msg 2/2/6 launches of
   FPS, ball query and group), B=4 x 4096, on the card against the CPU:
   logits within 2e-4, launches exact; forward time and points/s;
23. one pointnet2_msg train step as configs/train_partsize_msg.yaml builds
   it (colours), B=4 x 4096, dropout 0, weighted CE, on the card against
   the CPU, checked as in 6: the forward's launches and exactly 6 group
   backward (sa2-sa4, two radii each) and 4 interpolation backward;
   milliseconds a step;
24. two epochs of configs/train_partsize_msg.yaml (the sol loss, step
   decay, Adam) at batch 16 x 4096 through train_cli.main, checked as in 7,
   the batch-16 step timed (ms, points/s, peak memory) and profiled, then
   ``infer_cli blocks --model pointnet2_msg`` serving the checkpoint that
   run wrote, warm, with exactly the forward's launches a batch;
25. ptv3_moe at the registry's width (384, 8 experts, top 2, every other
   block MoE; 4 of its 8 blocks, MoE in blocks 1 and 3), B=4 x
   4096: the eval forward on the card against the CPU with the card's
   expert picks replayed there (RoutingTap), logits within 2e-4, exactly 4
   flash-attention launches, a pick that differs without the replay a tie
   within 1e-4; one train step against the CPU checked as 15; two epochs
   through train_cli at the defaults (8 blocks), the batch-16 step timed
   (peak memory) and profiled, then ``infer_cli blocks --model ptv3_moe``
   on that checkpoint;
26. the options of ptv3 and ptv3_pooled: stream_dtype and compute_dtype
   bfloat16 forwards (ptv3 at its default width, ptv3_pooled at the benched
   depths), B=4, against the same weights in float32 on the card and
   against the CPU's bf16 plain path at B=1 (logits within 0.1 of float32,
   the JAX package's own contract, and within 2e-2 * max(1, max|logits|) of
   the CPU; argmax agreement 0.97), every Dense of a block giving bf16,
   exactly 8 and 12 bf16 forward launches; remat=True on a ptv3_pooled step with dropout giving
   remat=False's loss, logits and gradients bit for bit (24 forward, 12 of
   each backward launches, peak memory of both); one ptv3 bf16-stream train
   step, 8 launches of each bf16 kernel;
27. configs/train_ptv3_big_prod.yaml through train_cli.main as the file
   stands, two epochs; its checkpoint reloaded through the config's
   model_extra gives the same logits; the batch-16 step (4 microbatches of
   4) timed, profiled, with its launches (96 bf16 forward, 48 of each
   backward) and peak memory, then without remat;
28. the five PointNet names (pointnet, pointnet_seg, pointnet_global,
   pointnet_sem_seg with colours, pointnet_cls on xyz alone) at full width,
   B=4 x 4096, on the card against the CPU: logits within 2e-4, no kernel
   launch; pointnet's device time by kernel family;
29. one pointnet train step against the CPU, checked as in 6;
30. two epochs of configs/train_pointnet.yaml (CE, plateau) through
   train_cli.main, checked as in 7, the batch-16 step timed and profiled,
   then ``infer_cli blocks --model pointnet`` on that checkpoint;
31. the enhanced_pointnet2_ssg forwards with use_attention off (profiled)
   and on, B=4 x 4096, against the CPU: logits within 2e-4, exactly 3 FPS,
   3 ball-query, 3 group, 3 interpolation and 1 k-NN launches (3 k-NN with
   attention);
32. a train step of each against the CPU (every Dropout at p = 0 on both
   copies), checked as in 6: 3 group backward (4 with attention, where
   BoundaryAwareModule's gather goes through IndexPoints) and 3
   interpolation backward;
33. ``infer_cli blocks --model enhanced_pointnet2_ssg`` from a checkpoint
   written here;
34. the forwards of randlanet, randlanet_ss, spg and spt at the registry's
   widths, B=4 x 4096, on the card against the CPU, the card's discrete
   picks replayed on the CPU (``PickTap``: randlanet_ss's re-weighted
   k-NN, the superpoint models' k-means partition, SPG's three top-k and
   SPT's centroid graph), each of the card's calls first held to its
   plain path on the card on the same inputs (equal picks) and to the CPU
   on those inputs (a pick that differs within 1e-4 of its row's
   boundary): logits within 2e-4, exactly 4 K5 and 4 K3 (randlanet; 8 K3
   for randlanet_ss, whose re-weighted k-NN gathers its 2k candidates),
   1 K1 (spg), 1 K1, 1 K5 and 8 group-backward launches (spt's segment
   sums); profiled;
35. a train step of each against the CPU (every Dropout at p = 0 on both
   copies), checked as in 6, the CPU on the card's picks of the same mode
   (held as in 34), no gradient on SPG's pooling scores alone:
   12 group-backward launches (randlanet, randlanet_ss: kept features,
   neighbour features and upsampling sources), 2 (spg's poolings), 21
   (spt: its 8 segment sums, the backward of x_j, x_i and the softmax
   denominator a layer and of the points' superpoint logits);
36. two epochs of configs/train_randlanet.yaml through train_cli.main,
   checked as in 7, the batch-16 step timed and profiled, then ``infer_cli
   blocks --model randlanet`` on that checkpoint;
37. spg and spt (no recipe): the batch-16 step at the registry's defaults
   timed and profiled, then ``infer_cli blocks`` from a checkpoint written
   here;
38. multi-step dispatch (train.steps_per_dispatch = 4) at batch 16 for
   pointnet2_ssg (weighted CE), the pointnet2_msg and BriStruNet recipes
   and the benched ptv3_pooled: from one saved state, 4 eager steps and one
   dispatch of train/loop.py::MultiTrainStep (a CUDA graph of the 4 steps:
   warm-up, state restored in place, capture, replay), both on the
   capturable Adam that path takes, EMA 0.999, dropout on the trainer's
   generator; the losses, accuracies, parameters, buffers, Adam moments and
   step, EMA and generator states after held with torch.equal, the kernels
   of one replay (counted at the capture) equal to the eager steps'; then
   host ms a step in turns (the steps_per_dispatch = 1 step, the eager steps
   on the capturable Adam, the graph; median and spread of 6 dispatches),
   device busy ms and idle share (torch.profiler), the replay alone between
   two events, and peak device memory, eager and graph;
39. configs/train_partsize_msg.yaml with train: {steps_per_dispatch: 4,
   ema_decay: 0.999} two epochs through train_cli --device cuda at batch 5
   (graphs of 4 train steps and of 4 validation batches on the EMA weights,
   single steps for the ragged tails), against the same copy at
   steps_per_dispatch 1: bit for bit where that run takes the capturable
   Adam too; on the eager Adam, which rounds its bias corrections
   otherwise, losses within 2% and accuracies within 5% relative and every
   weight within 2 * 3.17 * lr * steps (what two Adam runs can drift apart).
40. the deck-measurement chain (measure/wl_iden.py) on the card at the two
   deck scans' sizes, 63,885 and 103,718 points (``measured_deck``: a
   40 x 9 m deck, 2% misclassified points): process_bridge_deck, then LOF
   at the adaptive parameters and DBSCAN on the isolation forest's output,
   with the launch counters reset just before and read just after (K5
   alone, once a neighbour search); every stage (voxel, RANSAC, the
   isolation forest, LOF, the host tail, adaptive LOF, DBSCAN) against the
   port's CPU path on the CPU's input of it: outputs equal, LOF's mask but
   for points whose negative outlier factor lies within 1e-6 of offset_
   (counted and printed); lengths and widths within 1e-6 relative; two card
   runs bit-identical; each stage's wall and device-busy time (and K5's
   part), the chain's wall; then each K5 call of the main path held against
   knn_plain on 2,048 of its queries and timed at its own shape (the deck
   paths of the summary);
41. examples/full_pipeline.py on the card (pointnet2_ssg at sa_npoints
   256/64/16, 8 epochs at 8 steps a dispatch on three 40,000-point scenes,
   the test scene voted 3 times, exported as LAS, its deck measured), the
   counters reset just before and read just after (K1-K4, K3b, K4b, K5):
   each stage's wall, the vote's OA and mIoU, the measured deck against the
   ground truth beside the chain's own error on the ground-truth deck; it
   fails on a NaN or a relative error above FULL_PIPELINE_MAX_ERROR (the
   JAX example's error on the same scenes, 0.1089, plus 0.04);
42. the port's tools: (a) a seeded pointnet2_ssg and a seeded
   pointnet2_msg saved as a reference training run saves them
   ({"model_state_dict": ..., "epoch": 7, "class_avg_iou": ...}; their
   parameter names are the reference's), imported by tools/import_ckpt.py
   (scalars and weights checked) and served by ``infer_cli blocks
   --device cuda`` from the imported checkpoint (K1-K4 launched), its
   confusion matrix and the imported model's predictions equal to the
   seeded model's on the card; (b) six programs exported by
   utils/export.py at B=1 x 4096 (pointnet2_ssg, pointnet2_msg,
   bristrunet, dgcnn, dgcnn_global, the benched ptv3_pooled in float32 and
   with a bf16 stream), each saved, loaded and run on the card: the graph
   names the pcb:: ops it must (dgcnn and dgcnn_global pcb::edge_reduce,
   K7), the output equals the eager forward (torch.equal; for the two
   DGCNNs a condition, for the others reported),
   every kernel's counter rises by exactly what one eager forward adds,
   and the loaded program and the eager forward are timed (CUDA events);
   the seven together launch K1-K5, K5c, K7 and both attention forwards; (c)
   tools/debug_module.py's smoke_test of pointnet2_ssg at B = 1, 2, 4, 8 x
   4096 (points/s from CUDA events, peak MiB allocated), failing on any
   batch size's error; (d) the superpoint pipeline's host modules
   (data/superpoints.py with its DBSCAN, data/completion.py, ops/avs.py) on
   one synthetic scene, with scikit-learn absent.
43. the parallel layer, part 1 (``run_parallel_phases``): dp, its K = 4
   graph, FSDP2 and tp at a world of one, two gloo ranks on this card.
44. the parallel layer, part 2 (``run_parallel2_phases``), two gloo ranks
   on this card, each check held to the single-rank step, each step's
   gradients within a limit of its own (``PAR2_GRAD_LIMITS``): (a) ring attention at flat ptv3's shapes (B = 4, N = 4096 split in
   two) against one K6 call and one K6b pair over the whole N, K6 and K6b
   launched P = 2 times each; (b) sp train steps of flat ptv3 (the ring)
   and SSG (queries sliced) at B = 4 x 4096; (c) pp, two stages of flat
   ptv3, M = 2; (d) ep, ptv3_moe on a 1 x 2 mesh; (e) the whole-scene vote
   over a mesh of two, its predictions the single-rank vote's. Phases
   3c/3d hold K6/K6b at the ring's N/2 shapes first.
45. dgcnn (its recipe's loss) and dgcnn_global in both EdgeConv forms on
   the card (PCB_EDGECONV_FAST=0 and 1), with --dgcnn the restructured one
   also on PR 23's K7 and K7b (probes/k7_probe.py), run after phase 20: the
   B=4 x 4096 forward in turns (literal, restructured, restructured,
   literal; with --dgcnn literal, PR 23's, restructured, restructured, PR
   23's, literal; ms, device-busy ms, K5c's and K7's ms) with each form's
   launches exact; the batch-16 train step eager and as a
   steps_per_dispatch: 4 graph replay (phase 38's checks and numbers: the
   replay's bits against 4 eager steps, ms, idle share, peak MiB); then one
   train-mode EdgeConv forward at B = 16, N = 4096, k = 64, C = F = 64 in
   each form, the restructured one raising the allocator's peak by less
   than one [16, 4096, 64, 64] float32 tensor (1.07 GB); and one forward
   and backward at dgcnn_global's conv4 (B = 16, C = 64, F = 128, k = 64),
   K7b's raising the peak by less than a quarter of PR 23's per-edge
   scratch (537 MB; with --dgcnn also on PR 23's design).
46. bench/ on the card, after phase 41: (a) convergence_parity's run_port at
   the JAX module's configuration (SSG, B = 4 x 512, SA 128/64/16, 25 steps
   x 6 epochs of Adam, seeds 0-2, every curve printed): the launches of one
   train step and of one eval forward counted alone; seed 0 twice, the same
   curve, losses and final parameters bit for bit, its launches exactly 150
   train steps' and 24 eval forwards' (K1-K4, K3b, K4b); then seed 0's
   first 8 steps at dropout 0 on the card and on the CPU in this process
   from the same init, the losses within FLOAT32_LOSS_BANDS relative (1e-5
   at step 1, 2e-4 at step 2, then four times the largest gap measured
   between float32 runs), the CPU at 1 thread printed beside; (b) eva_model's
   evaluate_model over pointnet2_ssg, dgcnn_k32 and ptv3_win_bf16 at full
   width, B = 4 x 4096, and its save_results_csv: no row with an error,
   device_peak_mb > 0, params equal to the CPU build's, each row's
   launches exactly its forwards' and train steps' as counted around one
   of each alone; the rows and the CSV printed under the card's name and
   power limit. Phases 3 (K5 and K5c at k = 32), 3e (the bf16 kernels at
   [32,512,2,192], forward and train), 3f (K7 and K7b at k = 32, F = 64 and
   128) and 3g (K1-K4, K3b and K4b at the convergence run's shapes) hold
   every kernel at these shapes first.
Phase 3 also holds K5 at the measurement chain's shapes (B = 1, N = S =
63,885 and 103,718 at k = 31, 51 and 5, and k = 1 from a tenth of the
points to the rest), each launch's rows of 2,048 random queries bit for bit
against knn_plain on those queries (the plain version's distances of a
whole deck would not fit the card), timed whole beside the plain version
on the sample.
Phase 3 holds K5, K3 and K1 at these models' shapes first (K5 over
randlanet's levels at B=4 and 16, at randlanet_ss's 2k, at k = 9 over 4096
points and over 81 centroids; K3 over both models' levels; K1 4096 -> 81),
and phase 3b K3b at every gather of a
randlanet train step and at SPT's segment sums.

Every single-step train phase (6, 13, 15, 16, 19, 23, 25, 26, 29, 32, 35)
runs its card step twice from the same state (weights, BatchNorm buffers,
batch, generators) and fails if the loss or any gradient leaf differs
(torch.equal). Phase 3b holds K3b bit for bit to
ops/grouping.py::group_backward_order, the kernel's order of adds in plain
PyTorch, at every case.

``python3 chip_smoke.py --grouping`` runs phases 1 and 2 and the K3 and
K3b cases of phases 3 and 3b alone, then K3b's variants
(probes/k3b_probe.py); ``--train-steps`` every single-step train phase,
each run twice, the leaves that differ printed before it fails;
``--pointnet`` phases 28-33 (``--interp-backward`` the K4b cases of
phase 3b, then K4b's designs side by side, pointcloud_bridge_tpu_torch/
probes/k4b_probe.py; ``--attention`` phases 3c and 3d;
``--sampling`` the K1 and K4 cases of phase 3, then each kernel's launch
choices side by side: FPS by threads a row, interpolation by lanes a query;
``--neighbours`` the K2, K5 and K5c cases of phase 3, then their launch
choices side by side: warps a block and queries a warp, K5's row staged
as a ring of tiles, and K5c's grid of warps, queries a warp and tiles with
the plan's pick beside the fastest, then K5c's first design (a warp a
query) and the kernel in turns, probes/k2_k5_probe.py ``compare_k5c``;
``--measure`` K5's deck cases of phase 3 and phases 40-41;
``--tools`` phase 42 alone; ``--export-all`` exports, loads and runs every
registry name at B=1 x 4096 on the card beside its eager forward (the
classifiers with the colours as features) and fails on a name that neither
exports nor raises NotImplementedError; ``--host-us`` the host microseconds
a call of the four entry points farthest_point_sample, query_ball_point,
group_points and three_nn_interpolate where the card is faster than the
host (run it from another tree's root to compare two trees);
``--large-scene`` examples/large_scene_stream.py at 5M points (pointnet2_ssg
quick-trained 4 epochs on 300k points, 3 votes: end-to-end points/s,
coverage, OA, mIoU and the vote's phase split);
``--eva`` eva_model's whole DEFAULT_ZOO (14 rows) on the card, checked as
phase 46b, the CSV in results_torch/;
``--attention-bf16`` phase 3e; ``--k5c-exit`` K5c's early exit on the
features DGCNN's graphs are built over, ``probe_knn_c_exit`` of the same probe; ``--dgcnn`` the K2, K5 and
K5c cases of phase 3, phase 3f and phases 18-20 and 45; ``--edge`` phase 3f
alone, then K7b's parts (sort, rank, fold) and sort splits, the staged K7
(probes/k7_staged.cu) and both kernels with a part taken out
(probes/k7_probe.py; ``--edge probes`` the probes alone); ``--edge ties``
the two ways to give K7b its ties, K7 counting them online against a row
pass of K7b's own (probes/k7b_rows.cu), beside K7b and PR 23's design at
the train shapes of phase 3f; ``--edge-split``
the first K7b split into its per-edge pass, K3b's sort and K3b's fold, and
the longest buckets of the graphs of seeded DGCNN forwards; ``--msg`` the MSG family's cases of
phases 3 and 3b and phases 21-24; ``--zoo`` the cases of RandLA-Net and the
superpoint models in phases 3 and 3b and phases 34-37; ``--graphs`` phase
38 for every other model with a step phase or a recipe (the DGCNN,
PointNet and RandLA-Net recipes, enhanced_pointnet2_ssg, randlanet_ss with a
sampling generator, spg, spt, ptv3, ptv3_moe and ptv3 with a bf16 stream),
then one train step of each phase-38 model under
utils/determinism.py::set_random_seed(deterministic=True), the ops that warn
for want of a deterministic CUDA form listed), and prints no result line.

The line before the last is the per-kernel JSON summary. A kernel's row
holds one path's numbers together: ``launches`` of one BriStruNet forward at
B=4 (phase 8; of one SSG train step, phase 6, for its backward kernels; of
one DGCNN forward, phase 18, for K5c and K7; of one DGCNN train step,
phase 19, for K7b, beside the train flavour of K7 there (moments, ties); of
one ptv3_pooled forward, phase 10,
for the flash-attention kernel; of one
ptv3_pooled train step, phase 13, for the attention-backward kernels) beside
``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` summed over exactly
those launches' shapes (phases 3, 3b, 3c, 3d), and for K1-K5, K3b and K4b
the device times ``device_ms`` and ``library_device_ms`` (null for the
other kernels and where no library call exists), for K2 and K5 the issue
floor ``issue_floor_ms`` (and K5c; null for the others); ``paths`` has the same for
the other passes (the BriStruNet train step, phase 16, among them for K3b
and K4b; the four forwards of the MSG family, phases 21-22, and the
pointnet2_msg train step, phase 23; for the bf16 attention kernels the
configs/train_ptv3_big_prod.yaml step at batch 16, phase 27, beside the
bf16 forwards of ptv3 and ptv3_pooled, phase 26), and
``launches_by_path`` the counts of the serves and the training runs through
the CLIs (and of phase 46: ``convergence_seed0``, ``eva_<row>``). A
``[wall]`` line after each group of phases gives the seconds since the
build began. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import gc
import importlib.util
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pointcloud_bridge_tpu_torch import infer_cli, losses, train_cli
from pointcloud_bridge_tpu_torch.bench import convergence_parity as conv_bench
from pointcloud_bridge_tpu_torch.bench import eva_model as eva_bench
from pointcloud_bridge_tpu_torch.data import BlockDataset, scene_labelweights, write_las
from pointcloud_bridge_tpu_torch.data.dataset import _load_scene
from pointcloud_bridge_tpu_torch.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu_torch.infer import run_block_inference, whole_scene_vote_predict
from pointcloud_bridge_tpu_torch.measure import wl_iden
from pointcloud_bridge_tpu_torch.config import Config, LossConfig
from pointcloud_bridge_tpu_torch.models import dgcnn as dgcnn_models
from pointcloud_bridge_tpu_torch.probes import k7_probe
from pointcloud_bridge_tpu_torch.models import randlanet as randla_models
from pointcloud_bridge_tpu_torch.models import spg as spg_models
from pointcloud_bridge_tpu_torch.models import spt as spt_models
from pointcloud_bridge_tpu_torch.models import (
    BatchNorm,
    Dense,
    Dropout,
    MultiScaleSetAbstraction,
    get_model,
)
from pointcloud_bridge_tpu_torch.ops import core as core_ops
from pointcloud_bridge_tpu_torch.ops import edge as edge_ops
from pointcloud_bridge_tpu_torch.ops import (
    _kernels,
    attention,
    grouping,
    interpolate,
    sampling,
)
from pointcloud_bridge_tpu_torch.train import loop as train_loop
from pointcloud_bridge_tpu_torch.train import (
    MultiTrainStep,
    make_optimizer,
    make_train_step,
    set_lr,
)
from pointcloud_bridge_tpu_torch.train.loop import (
    TRAIN_KEYS,
    StepState,
    ema_update,
    loss_fn_for,
    model_generators,
)
from pointcloud_bridge_tpu_torch.utils.determinism import set_random_seed
from pointcloud_bridge_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

ROOT = Path(__file__).resolve().parent
SEED = 0
B = 4
N = 4096
NUM_CLASSES = 5
REPS = 20
LOGIT_TOL = 2e-4  # PARITY.md §7's band for torch-vs-JAX logits
INTERP_TOL = 1e-5
BWD_TOL = 1e-5  # of max|plain|: the kernels add in another order than scatter_add_
ATTN_TOL = 2e-5  # of max(1, max|plain|): the online softmax re-associates the sums
FORWARD_KERNELS = ("fps", "ball_query", "group", "interpolate")
SSG_BACKWARD_KERNELS = ("group_bwd", "interp_bwd")
ATTN_BACKWARD_KERNELS = ("flash_attn_bwd_dq", "flash_attn_bwd_dkv")
BACKWARD_KERNELS = SSG_BACKWARD_KERNELS + ATTN_BACKWARD_KERNELS + ("edge_reduce_bwd",)


def only(**launches) -> dict:
    """Launch counts with every kernel at 0 but the named ones."""
    return dict.fromkeys((k.name for k in _kernels.KERNELS), 0) | launches


def attention_launches(n: int) -> dict:
    """A train step with n attention calls: n launches of the forward kernel
    and of each backward kernel, and no other kernel."""
    return only(flash_attn=n, flash_attn_bwd_dq=n, flash_attn_bwd_dkv=n)


# launches of one BriStruNet forward: an FPS a level, one ball-query scan a
# level for its two radii, a group a radius, an interpolation a decoder
# level, a k-NN in bri_enc, geometric2 and geometric3
BRISTRUNET_LAUNCHES = only(fps=3, ball_query=3, group=6, interpolate=3, knn=3)
# launches of one forward of the PointNet++ MSG family: an FPS and a
# ball-query scan a level (every radius of a level in one scan), a group a
# radius, an interpolation a decoder level; the MSG train step adds a group
# backward a radius of sa2-sa4 (sa1 groups the inputs, which need no
# gradient) and an interpolation backward a decoder level
MSG_LAUNCHES = only(fps=4, ball_query=4, group=8, interpolate=4)
MSG_STEP_LAUNCHES = MSG_LAUNCHES | {"group_bwd": 6, "interp_bwd": 4}
SEM_SEG_LAUNCHES = only(fps=4, ball_query=4, group=4, interpolate=4)
CLS_SSG_LAUNCHES = only(fps=2, ball_query=2, group=2)
CLS_MSG_LAUNCHES = only(fps=2, ball_query=2, group=6)
# launches of one DGCNN or DGCNNGlobal forward in the restructured EdgeConv
# form, the card's default: K5 over xyz in conv1, K5c over 64 channels in
# conv2-conv4, K7 (the neighbour reduction) in each EdgeConv
DGCNN_LAUNCHES = only(knn=1, knn_c=3, edge_reduce=4)
# a train step adds K7b in each EdgeConv (y = x W_a carries a gradient in
# conv1 too), which sorts and folds on its own (the first design folded
# its per-edge gradients with K3b)
DGCNN_STEP_LAUNCHES = DGCNN_LAUNCHES | {"edge_reduce_bwd": 4}
# the literal form (PCB_EDGECONV_FAST=0): the k-NN kernels alone, and in a
# step index_points' backward (IndexPoints, K3b) at the three EdgeConvs
# whose input carries a gradient
DGCNN_LITERAL_LAUNCHES = only(knn=1, knn_c=3)
DGCNN_LITERAL_STEP_LAUNCHES = DGCNN_LITERAL_LAUNCHES | {"group_bwd": 3}
# the PointNet family runs no kernel of the port
POINTNET_NAMES = ("pointnet", "pointnet_seg", "pointnet_global", "pointnet_sem_seg",
                  "pointnet_cls")
# enhanced_pointnet2_ssg: its positional encoding's knn_set, SSG's three
# levels; with use_attention geometric1's knn_set and boundary1's k-NN over
# l1. A train step adds a group backward a level (sa1's features carry the
# encoding's gradient), an interpolation backward a decoder level and, with
# use_attention, boundary1's gather of l1's features (IndexPoints)
ENHANCED_LAUNCHES = only(fps=3, ball_query=3, group=3, interpolate=3, knn=1)
ENHANCED_ATTN_LAUNCHES = ENHANCED_LAUNCHES | {"knn": 3}
ENHANCED_STEP_LAUNCHES = ENHANCED_LAUNCHES | {"group_bwd": 3, "interp_bwd": 3}
ENHANCED_ATTN_STEP_LAUNCHES = ENHANCED_ATTN_LAUNCHES | {"group_bwd": 4, "interp_bwd": 3}
# sa1's features: the colours and the positional encoding's 6 channels
ENHANCED_SA1_FEATURES = 3 + 6
# flat ptv3 in phases 11 and 15 (its forward and train step against the CPU,
# whose global attention over 4096 points costs the host seconds a block): 4
# of its 8 blocks, the registry's width; a block repeats the same shapes
FLAT_DEPTH = 4
# a plain version that takes this long a call or longer (FPS's loop, the
# deck-sized k-NN) is timed over SLOW_PLAIN_REPS calls after the check's own
# first call, not REPS after 3 of warm-up
SLOW_PLAIN_S, SLOW_PLAIN_REPS = 0.05, 5
# the benched ptv3_pooled (configs/train_ptv3_pooled.yaml): an attention a block
POOLED_BENCHED = dict(dims=(64, 128, 256), enc_depths=(2, 2, 6), dec_depths=(1, 1),
                      strides=(4, 4), window_size=1024)
# the card's peaks for the bound: HBM3 bytes/s and float32 FLOP/s outside the
# tensor cores (NVIDIA H100 SXM data sheet, at the full 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12
# float32-grade work on the tensor cores: three TF32 passes a product (3xTF32)
# at 495 TFLOP/s dense; the least of the routes at float32 accuracy, which
# bounds the attention kernels
PEAK_FLOPS_3XTF32 = 495e12 / 3


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median milliseconds of fn() over reps, each bracketed by CUDA events
    (so a short kernel's time includes its host launch)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Median device milliseconds a call: ``calls`` calls of fn captured in
    one CUDA graph (allocations, memsets and ctypes launches on the current
    stream are captured like any other work), the graph replayed between two
    CUDA events, divided by ``calls``. Where capture fails, the device
    self-time of ``calls`` calls from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError as exc:
        print(f"  CUDA graph capture failed ({exc}); device time from torch.profiler")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(getattr(ev, "self_device_time_total", None) or ev.self_cuda_time_total
                   for ev in prof.key_averages()) / 1e3 / calls
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def host_us(fn, calls: int = 1000, rounds: int = 5, warmup: int = 20) -> float:
    """Host microseconds a call: perf_counter around ``calls`` calls with no
    synchronise (after a warm-up), the median of ``rounds`` such runs (the
    host's cores are shared, and single runs spread widely). Where the
    device is the slower, the launch queue fills and this reads the device's
    pace instead."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item() if a.numel() else 0.0


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


SSG, BRISTRUNET, TRAIN = "ssg_forward", "bristrunet_forward", "ssg_train_step"
BRISTRUNET_TRAIN = "bristrunet_train_step"
PTV3_POOLED, PTV3 = "ptv3_pooled_forward", "ptv3_forward"
PTV3_POOLED_TRAIN, PTV3_TRAIN = "ptv3_pooled_train_step", "ptv3_train_step"
DGCNN, DGCNN_GLOBAL = "dgcnn_forward", "dgcnn_global_forward"
DGCNN_TRAIN = "dgcnn_train_step"
# the sweep's rows that no other phase runs (phase 46b): dgcnn_global at
# k = 32, ptv3 in bf16 on Morton windows of 512
DGCNN_K32, DGCNN_K32_TRAIN = "dgcnn_k32_forward", "dgcnn_k32_train_step"
PTV3_WIN_BF16, PTV3_WIN_BF16_TRAIN = "ptv3_win_bf16_forward", "ptv3_win_bf16_train_step"
# SSG at the convergence run's size (phase 46a): B = 4, N = 512
CONV, CONV_TRAIN = "convergence_forward", "convergence_train_step"
MSG, MSG_TRAIN = "pointnet2_msg_forward", "pointnet2_msg_train_step"
# flat ptv3's sequence-parallel step over two ranks (phase 44b): its ring
# blocks' forward, and the train step of one rank
SP_RING, SP_RING_TRAIN = "sp_ptv3_ring_forward", "sp_ptv3_ring_train_step"
SEM_SEG, CLS_SSG, CLS_MSG = ("pointnet2_sem_seg_forward", "pointnet2_cls_ssg_forward",
                             "pointnet2_cls_msg_forward")
# the path whose numbers stand in a kernel's own row of the summary
# (BriStruNet's forward for the kernels not named here)
ROW_PATH = {"group_bwd": TRAIN, "interp_bwd": TRAIN, "knn_c": DGCNN, "edge_reduce": DGCNN,
            "edge_reduce_bwd": DGCNN_TRAIN, "flash_attn": PTV3_POOLED,
            "flash_attn_bwd_dq": PTV3_POOLED_TRAIN, "flash_attn_bwd_dkv": PTV3_POOLED_TRAIN,
            "flash_attn_bf16": "ptv3_big_prod_train_step",
            "flash_attn_bwd_dq_bf16": "ptv3_big_prod_train_step",
            "flash_attn_bwd_dkv_bf16": "ptv3_big_prod_train_step"}
# the kernels that a train step's path holds rows of: its backward kernels
# (its forward kernels' shapes stand under the forward's path), and for
# DGCNN's K7 in its train-mode flavour (the moments and the ties) beside
# K7b, whose time includes its sort, rank and fold
TRAIN_PATH_KERNELS = {path: SSG_BACKWARD_KERNELS
                      for path in (TRAIN, BRISTRUNET_TRAIN, MSG_TRAIN, "randlanet_train_step")}
TRAIN_PATH_KERNELS[DGCNN_TRAIN] = ("edge_reduce", "edge_reduce_bwd")
TRAIN_PATH_KERNELS[DGCNN_K32_TRAIN] = ("edge_reduce", "edge_reduce_bwd")
TRAIN_PATH_KERNELS[CONV_TRAIN] = SSG_BACKWARD_KERNELS
SUMS = ("ms", "plain_ms", "bytes_ms", "ops_ms", "bound_ms", "fma_bound_ms")
# None unless measured: the library call's event time (cases with a library
# call), device times from a CUDA graph and host time (cases with ``split``),
# and the instruction-issue floor (K2 and K5, ``add``)
SPLIT_SUMS = ("library_ms", "device_ms", "library_device_ms", "host_us", "issue_ms")


class Results:
    """Per-kernel comparison results. A case at a shape that a path gives
    the kernel is timed and adds to that path's sums, so a path's sums are
    over exactly the launches of one forward (or one train step) at B=4."""

    def __init__(self):
        self.err = dict.fromkeys((k.name for k in _kernels.KERNELS), 0.0)
        # path -> kernel -> sums; a side path (a batch of 16, a backward that
        # is not run as a pass here) is printed by ``print_sums`` alone
        self.sums = {}
        self.order_exact = 0  # K3b cases bit-identical to group_backward_order

    def total(self, path: str, name: str) -> dict:
        return self.sums.setdefault(path, {}).setdefault(
            name, dict.fromkeys(SUMS, 0.0) | dict.fromkeys(SPLIT_SUMS) | {"cases": 0})

    def check(self, name, label, kernel_fn, plain_fn, exact, paths=(), scaled=None,
              work=None, library_fn=None, times=1, peak_flops=PEAK_FLOPS, split=False):
        """exact: bit-identical (a tuple: one flag an output); else within
        INTERP_TOL (rtol and atol), or
        with scaled=(tol, floor) within tol * max(floor, max|plain|). The
        functions return a tensor or a tuple of tensors. ``paths`` names the
        paths that give the kernel this shape, ``times`` in one pass; such a
        case is timed and needs ``work`` = (bytes, operations) of the
        function on these inputs: each input read once, each output written
        once, and the arithmetic the function needs on this data. A case
        with ``work`` and no path is timed too. ``library_fn`` is the one
        PyTorch call that computes the same function, timed beside the
        kernel. ``peak_flops`` is the rate of the fastest route that keeps the
        function's accuracy; the bound over float32 FMAs stands beside it.
        ``split`` adds the device time a call of the kernel and of the
        library call (``device_ms``) and the kernel wrapper's host time
        (``host_us``) beside the event times."""
        got = kernel_fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain_fn()
        torch.cuda.synchronize()
        plain_first_s = time.perf_counter() - t0
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, ok = 0.0, len(got) == len(want)
        flags = exact if isinstance(exact, tuple) else (exact,) * len(want)
        for g, w, bits in zip(got, want, flags):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(
                    f"{name} {label}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}"
                )
            e = max_abs_err(g, w)
            err = max(err, e)
            if bits:
                ok &= torch.equal(g, w)
            elif scaled:
                ok &= e <= scaled[0] * max(scaled[1], w.abs().max().item())
            else:
                ok &= torch.allclose(g, w, rtol=INTERP_TOL, atol=INTERP_TOL)
        if not ok:
            raise AssertionError(f"{name} {label}: kernel disagrees, max |err| {err}")
        self.err[name] = max(self.err[name], err)
        line = f"{name:18s} {label:34s} max|err| {err:.3g}"
        if work:
            bytes_ms = work[0] / PEAK_BYTES_S * 1e3
            ops_ms = work[1] / peak_flops * 1e3
            plain_ms = (time_ms(plain_fn, reps=SLOW_PLAIN_REPS, warmup=0)
                        if plain_first_s >= SLOW_PLAIN_S else time_ms(plain_fn))
            case = {"ms": time_ms(kernel_fn), "plain_ms": plain_ms,
                    "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
                    "fma_bound_ms": max(bytes_ms, work[1] / PEAK_FLOPS * 1e3)}
            line += (f"  kernel {case['ms']:.4f} ms  plain {case['plain_ms']:.4f} ms  bound "
                     f"{case['bound_ms']:.5f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'})")
            if peak_flops != PEAK_FLOPS:
                line += f"  over FMAs {case['fma_bound_ms']:.5f} ms"
            if library_fn is not None:
                case["library_ms"] = time_ms(library_fn)
                line += f"  library {case['library_ms']:.4f} ms"
            if split:
                case["device_ms"] = device_ms(kernel_fn)
                # about 0.1 s of calls a round (1000 for a kernel of 0.1 ms or
                # less): where the device is the slower, this reads its pace
                case["host_us"] = host_us(kernel_fn, calls=int(
                    min(1000, max(20, 100 / max(case["device_ms"], 1e-6)))))
                line += f"  | device: kernel {case['device_ms']:.4f} ms"
                if library_fn is not None:
                    case["library_device_ms"] = device_ms(library_fn)
                    line += f"  library {case['library_device_ms']:.4f} ms"
                line += f"  | host {case['host_us']:.1f} us a call"
            self.record(name, case, paths, times)
            if paths:
                line += f"  [{times} x " + ", ".join(paths) + "]"
        print(line, flush=True)
        return case if work else None

    def record(self, name: str, case: dict, paths, times: int = 1) -> None:
        """Add a timed case (SUMS and whichever SPLIT_SUMS it has) to each
        path's sums, ``times`` launches of it a pass."""
        for path in paths:
            total = self.total(path, name)
            total["cases"] += times
            for key in SUMS:
                total[key] += times * case[key]
            for key in SPLIT_SUMS:
                if key in case:
                    total[key] = (total[key] or 0.0) + times * case[key]

    def row(self, name: str, path: str, launches: int) -> dict:
        """The numbers of one kernel on one path, as the summary prints
        them; the path must have given the kernel a case a launch."""
        total = self.total(path, name)
        if total["cases"] != launches:
            raise AssertionError(f"{name} on {path}: {launches} launches a pass, but "
                                 f"{total['cases']} shapes were held against the plain version")
        return {"launches": launches, "ms": total["ms"], "plain_ms": total["plain_ms"],
                "bound_ms": total["bound_ms"], "fma_bound_ms": total["fma_bound_ms"],
                "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations",
                "library_ms": total["library_ms"], "device_ms": total["device_ms"],
                "library_device_ms": total["library_device_ms"],
                "issue_floor_ms": total["issue_ms"]}

    def add(self, name: str, paths, key: str, value: float) -> None:
        """Add a number found after the cases ran (the issue floor at the
        clock read meanwhile) to each path's sum of ``key``."""
        for path in paths:
            total = self.total(path, name)
            total[key] = (total[key] or 0.0) + value

    def print_sums(self, name: str, paths) -> None:
        """One line a path: the kernel's sums over the path's timed cases."""
        for path in paths:
            t = self.total(path, name)
            host = "" if t["host_us"] is None else f", host {t['host_us'] / t['cases']:.1f} us a call"
            floor = "" if t["issue_ms"] is None else f", issue floor {t['issue_ms']:.5f} ms"
            print(f"{name:18s} sum over {path} ({t['cases']} launches): event {t['ms']:.4f} ms, "
                  f"device {t['device_ms']} ms, bound {t['bound_ms']:.5f} ms{floor}, plain "
                  f"{t['plain_ms']:.4f} ms, library event {t['library_ms']} ms, device "
                  f"{t['library_device_ms']} ms{host}", flush=True)


def compare_kernels(dev: torch.device) -> Results:
    """Phase 3: each kernel against its plain version at the shapes that
    the SSG forward and the BriStruNet forward give it (B=4)."""
    rng = np.random.default_rng(SEED)
    res = Results()
    compare_fps_kernel(dev, res, rng)

    # K3 group at the levels of both models, then its own cases (batch 16,
    # widths, empty balls, ragged row counts)
    compare_group_kernel(dev, res, rng)
    compare_interp_kernel(dev, res, rng)
    # K2 ball query and K5 exact k-NN
    compare_neighbour_kernels(dev, res, rng)
    # K1-K4 at the shapes of the PointNet++ MSG family
    compare_msg_family_kernels(dev, res, rng)
    # K1 and K5 at the shapes of RandLA-Net and the superpoint models
    compare_zoo_kernels(dev, res, rng)
    # K5 at the deck-measurement chain's shapes
    compare_measure_knn(dev, res, rng)
    return res


# (N, S, K, radius, C) of each grouping call of a pass: the three SA levels
# of SSG, then those of BriStruNet at both radii (K=16 at the small one,
# K=32 at the large); the SSG train step's backward runs at SSG's sa2 and sa3
SSG_LEVELS = ((4096, 1024, 32, 0.1, 3), (1024, 256, 32, 0.2, 128), (256, 64, 32, 0.4, 256))
BRISTRUNET_LEVELS = tuple(
    (n, s, k, r, c)
    for n, s, radii, c in ((4096, 1024, (0.1, 0.2), 3), (1024, 512, (0.2, 0.4), 256),
                           (512, 128, (0.4, 0.8), 512))
    for r, k in zip(radii, (16, 32)))
# (N, S, ((radius, K), ...)) of each ball-query launch of a pass: SSG's
# levels, one radius each; BriStruNet's, both radii of a level in one scan
SSG_BALLS = tuple((n, s, ((r, k),)) for n, s, k, r, _ in SSG_LEVELS)
BRISTRUNET_BALLS = tuple((n, s, tuple((r, k) for n2, s2, k, r, _ in BRISTRUNET_LEVELS
                                      if (n2, s2) == (n, s)))
                         for n, s in dict.fromkeys((n, s) for n, s, *_ in BRISTRUNET_LEVELS))
# side paths: timed and summed on lines of their own, no pass of this script
SSG_B16, TRAIN_B16 = "ssg_forward_b16", "ssg_train_step_b16"
DGCNN_B16, DGCNN_GLOBAL_B16 = "dgcnn_forward_b16", "dgcnn_global_forward_b16"
DGCNN_TRAIN_B16, DGCNN_GLOBAL_TRAIN_B16 = "dgcnn_train_step_b16", "dgcnn_global_train_step_b16"
BRISTRUNET_TRAIN_B16 = "bristrunet_train_step_b16"


def check_group(res: Results, label, xyz, centers, idx, feats, paths=(), timed=False) -> None:
    b, n, _ = xyz.shape
    _, s, k = idx.shape
    c = 0 if feats is None else feats.shape[2]
    work = library = None
    if timed:
        work = (nbytes(xyz, centers, idx, feats) + b * s * k * (3 + c) * 4, 3 * b * s * k)
        if c:  # the feature channels only, on a ready int64 index
            flat = idx.reshape(b, -1, 1).clamp(0, n - 1).long().expand(-1, -1, c).contiguous()
            library = lambda: torch.gather(feats, 1, flat)  # noqa: E731
    first = grouping.group_cuda(xyz, centers, idx, feats)
    if not torch.equal(first, grouping.group_cuda(xyz, centers, idx, feats)):
        raise AssertionError(f"group {label}: the bits differ from one call to the next")
    res.check("group", label,
              lambda: grouping.group_cuda(xyz, centers, idx, feats),
              lambda: grouping.group_plain(xyz, centers, idx, feats), True, paths,
              work=work, library_fn=library, split=timed)


def compare_group_kernel(dev: torch.device, res: Results, rng) -> None:
    """K3 against group_plain, bit for bit, at every level of SSG and
    BriStruNet at B=4 (on ball-query indices), SSG's
    levels at B=16, then widths 3, 4 and 16 (C = 0, 1, 13), empty balls,
    N = 1, row counts that are no multiple of a lane group, indices out of
    range on both sides, and the same bits from one call to the next. The
    timed cases carry the split of their time (``split``)."""

    def cloud(b, n):
        return torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    def level(paths, b, n, s, k, r, c):
        xyz = cloud(b, n)
        centers = xyz[:, :s].contiguous()
        idx = grouping.ball_query_cuda(r, k, xyz, centers)
        check_group(res, f"B={b} N={n} S={s} K={k} C={c}", xyz, centers, idx,
                    normal(b, n, c), paths, timed=True)

    for lv in SSG_LEVELS:
        level((SSG,), B, *lv)
    for lv in BRISTRUNET_LEVELS:
        level((BRISTRUNET,), B, *lv)
    for lv in SSG_LEVELS:
        level((SSG_B16,), 16, *lv)
    # enhanced_pointnet2_ssg's sa1: the colours and the 6 positional
    # channels beside the relative xyz, width 12
    level((), B, 4096, 1024, 32, 0.1, ENHANCED_SA1_FEATURES)
    res.print_sums("group", (SSG, BRISTRUNET, SSG_B16))

    # the kernel's two ways to store, each bit for bit: the warp's tile
    # staged in shared memory and written with 16-byte stores (the default)
    # against 4-byte stores straight from the lanes, at the models' widths
    # (6, 131, 259, 515: no row is 16-byte aligned) and at 4 and 16
    for n, s, k, r, c in ((4096, 1024, 32, 0.1, 3), (1024, 256, 32, 0.2, 128),
                          (1024, 512, 32, 0.4, 256), (512, 128, 32, 0.8, 512),
                          (1024, 256, 32, 0.2, 1), (1024, 256, 32, 0.2, 13)):
        xyz = cloud(B, n)
        centers = xyz[:, :s].contiguous()
        idx = grouping.ball_query_cuda(r, k, xyz, centers)
        feats = normal(B, n, c)
        want = grouping.group_plain(xyz, centers, idx, feats)
        times = {True: [], False: []}
        for staged in (True, False, False, True):
            def run(staged=staged):
                return grouping.group_cuda(xyz, centers, idx, feats, staged=staged)
            if not torch.equal(run(), want):
                raise AssertionError(f"group width {3 + c} staged={staged}: kernel disagrees")
            times[staged].append(device_ms(run))
        print(f"{'group':18s} stores at width {3 + c:3d} ([{B},{s},{k}]): device ms, staged tile "
              f"{times[True][0]:.4f} {times[True][1]:.4f}, 4-byte stores {times[False][0]:.4f} "
              f"{times[False][1]:.4f}", flush=True)

    xyz = cloud(B, 1024)
    centers = xyz[:, :256].contiguous()
    idx = grouping.ball_query_cuda(0.2, 32, xyz, centers)
    for c in (0, 1, 13):  # widths 3, 4 and 16
        check_group(res, f"N=1024 S=256 K=32 C={c}", xyz, centers, idx,
                    normal(B, 1024, c) if c else None)
    far = torch.full((B, 64, 3), 10.0, device=dev)
    empty = grouping.ball_query_cuda(0.1, 32, xyz, far)  # every slot N
    for c in (3, 128):
        check_group(res, f"empty balls C={c}", xyz, far, empty, normal(B, 1024, c))
    one = cloud(B, 1)
    check_group(res, "N=1 S=1 K=32 C=5", one, one,
                grouping.ball_query_cuda(0.5, 32, one, one), normal(B, 1, 5))
    # S*K = 35 a batch: no multiple of any group's rows; indices from -2 to
    # N + 2 (a miss is N, and the clamp takes both sides)
    for c in (0, 3, 13, 128, 509):
        wild = torch.from_numpy(rng.integers(-2, 1027, (3, 7, 5)).astype(np.int32)).to(dev)
        xyz3 = cloud(3, 1024)
        check_group(res, f"S=7 K=5 C={c}, indices -2..N+2", xyz3, cloud(3, 7), wild,
                    normal(3, 1024, c) if c else None)


def ball_scan_lengths(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Points each ball query must visit on this data: up to its k-th hit
    where the ball holds k (the last slot is then a hit of its own, not a
    copy of the first), else all n."""
    full = idx[..., -1] != idx[..., 0]
    return torch.where(full, idx[..., -1].long() + 1, n)


def interp_work(dst, src, f, k: int) -> tuple:
    """(bytes, operations) of an interpolation: every destination measures
    every source (8 flops and a compare), then blends k rows of D."""
    b, n, _ = dst.shape
    s, d = f.shape[1:]
    return nbytes(dst, src, f) + b * n * d * 4, 9 * b * n * s + 2 * k * b * n * d


# (B, N, npoint, paths) of each FPS call of a pass: SSG's three levels and
# BriStruNet's (the first is the same shape in both) at B=4, SSG's at B=16
FPS_LEVELS = ((B, 4096, 1024, (SSG, BRISTRUNET)), (B, 1024, 256, (SSG,)),
              (B, 256, 64, (SSG,)), (B, 1024, 512, (BRISTRUNET,)), (B, 512, 128, (BRISTRUNET,)),
              (16, 4096, 1024, (SSG_B16,)), (16, 1024, 256, (SSG_B16,)),
              (16, 256, 64, (SSG_B16,)))
# instructions a point a step that csrc/fps.cu issues (a distance: 3
# subtractions, 3 multiplications, 2 additions; a min, a compare, two
# selects) and the float32 lanes of one SM a cycle: a row's step cannot take
# fewer than N * 12 / 128 cycles on its one SM
FPS_INSTRUCTIONS = 12
SM_LANES = 128
# (N, S, D) of each interpolation of a pass: the three FP levels of SSG (k=3)
# and of BriStruNet (k=4); the sources are a subset of the destinations
SSG_INTERP = ((256, 64, 512), (1024, 256, 256), (4096, 1024, 128))
BRISTRUNET_INTERP = ((512, 128, 1024), (1024, 512, 256), (4096, 1024, 256))


class SmClock:
    """``nvidia-smi``'s clocks.sm every 50 ms from a background process while
    the block runs; ``mhz`` is the highest reading, the clock under load."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
             "-lms", "50", "-i", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        readings = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
        self.mhz = max(readings) if readings else float("nan")


def check_fps(res: Results, label, xyz, npoint, start, paths=(), timed=False):
    b, n, _ = xyz.shape
    # a step is a distance (8 flops), a min and a compare of each point
    work = (nbytes(xyz, start) + b * npoint * 4, 10 * b * npoint * n) if timed else None
    return res.check("fps", label, lambda: sampling.fps_cuda(xyz, npoint, start),
                     lambda: sampling.fps_plain(xyz, npoint, start), True, paths,
                     work=work, split=timed)


def compare_fps_kernel(dev: torch.device, res: Results, rng) -> None:
    """K1 against fps_plain, bit for bit: the SA levels of SSG and BriStruNet
    at B=4 and SSG's at B=16, timed three ways (events; device time from a
    CUDA graph; host time a call), with ns and cycles a step at the SM clock
    that nvidia-smi reads meanwhile and beside the one-SM issue floor; then a
    [B] start, duplicated points, a row of equal points, N no multiple of 32
    (one warp and several), npoint = N, npoint > N and N = 16384, the cap."""

    def cloud(b, n):
        return torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)

    timed = []
    with SmClock() as clock:
        for b, n, npoint, paths in FPS_LEVELS:
            got = check_fps(res, f"B={b} {n}->{npoint}", cloud(b, n), npoint,
                            torch.zeros(b, dtype=torch.int32, device=dev), paths, timed=True)
            timed.append((b, n, npoint, paths, got["device_ms"]))
    sums = {}
    for b, n, npoint, paths, ms in timed:
        floor_ms = npoint * n * FPS_INSTRUCTIONS / SM_LANES / (clock.mhz * 1e3)
        ns = ms * 1e6 / npoint
        print(f"{'fps':18s} B={b} {n}->{npoint}: device {ms:.4f} ms, {ns:.1f} ns = "
              f"{ns * clock.mhz / 1e3:.0f} cycles a step at {clock.mhz:.0f} MHz; one-SM issue "
              f"floor {floor_ms:.4f} ms", flush=True)
        for path in paths:
            t = sums.setdefault(path, [0.0, 0, 0.0])
            t[0], t[1], t[2] = t[0] + ms, t[1] + npoint, t[2] + floor_ms
    for path, (ms, steps, floor_ms) in sums.items():
        print(f"{'fps':18s} {path}: {steps} steps, device {ms:.4f} ms, "
              f"{ms * 1e6 / steps:.1f} ns a step, one-SM issue floor {floor_ms:.4f} ms "
              f"(clocks.sm {clock.mhz:.0f} MHz)", flush=True)
    res.print_sums("fps", (SSG, BRISTRUNET, SSG_B16))

    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    start = torch.from_numpy(rng.integers(0, 4096, B).astype(np.int32)).to(dev)
    check_fps(res, "4096->1024 start [B]", cloud(B, 4096), 1024, start)
    grid = torch.from_numpy(rng.integers(0, 8, (B, 4096, 3)).astype(np.float32)).to(dev)
    check_fps(res, "4096->256 duplicated points", grid, 256, zero)
    same = cloud(B, 4096)
    same[1] = 0.5
    check_fps(res, "4096->256, row 1 one point 4096 times", same, 256, zero)
    for n, npoint in ((1000, 300), (200, 50), (33, 33), (2048, 2048), (100, 300)):
        check_fps(res, f"{n}->{npoint}", cloud(B, n), npoint, zero)
    start = torch.from_numpy(rng.integers(0, 16384, B).astype(np.int32)).to(dev)
    check_fps(res, "16384->2500 (the cap), start [B]", cloud(B, 16384), 2500, start)


def check_interp(res: Results, label, dst, src, f, k, paths=(), timed=False) -> None:
    out, idx, w = interpolate.interpolate_cuda(dst, src, f, k, True)
    _, pidx, pw = interpolate.interpolate_plain(dst, src, f, k, True)
    if not torch.equal(idx, pidx) or not torch.allclose(w, pw, rtol=1e-6, atol=1e-7):
        raise AssertionError(f"interpolate {label}: kept selection differs from plain")
    if not torch.equal(out, interpolate.interpolate_cuda(dst, src, f, k)[0]):
        raise AssertionError(f"interpolate {label}: keep on and off give other outputs")
    res.check("interpolate", label, lambda: interpolate.interpolate_cuda(dst, src, f, k)[0],
              lambda: interpolate.interpolate_plain(dst, src, f, k)[0], False, paths,
              work=interp_work(dst, src, f, k) if timed else None, split=timed)


def compare_interp_kernel(dev: torch.device, res: Results, rng) -> None:
    """K4 against interpolate_plain: the output within INTERP_TOL, and with
    ``keep`` the kept indices bit for bit and the weights within 1e-6, the
    output the same bits with ``keep`` on and off. The FP levels of SSG (k=3)
    and BriStruNet (k=4) at B=4 and SSG's at B=16, timed three ways (events;
    device time from a CUDA graph; host time a call); then D=131, a feature
    view 4 bytes off 16-byte alignment, S=2 with k=2 (fewer sources than a
    lane group), exact ties on an integer grid and S=2000 (two staged tiles)."""

    def cloud(b, n):
        return torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    for b, paths, k, levels in ((B, (SSG,), 3, SSG_INTERP), (B, (BRISTRUNET,), 4, BRISTRUNET_INTERP),
                                (16, (SSG_B16,), 3, SSG_INTERP)):
        for n, s, d in levels:
            dst = cloud(b, n)
            check_interp(res, f"B={b} N={n} S={s} D={d} k={k}", dst, dst[:, :s].contiguous(),
                         normal(b, s, d), k, paths, timed=True)
    res.print_sums("interpolate", (SSG, BRISTRUNET, SSG_B16))

    dst = cloud(B, 1024)
    src = dst[:, :256].contiguous()
    check_interp(res, "N=1024 S=256 D=131 k=3", dst, src, normal(B, 256, 131), 3)
    flat = normal(B * 256 * 256 + 1)
    view = flat[1:].view(B, 256, 256)  # contiguous, 4 bytes past 16-byte alignment
    check_interp(res, "N=1024 S=256 D=256 k=3, feats 4 bytes off", dst, src, view, 3)
    check_interp(res, "N=1000 S=2 D=64 k=2", cloud(B, 1000), cloud(B, 2), normal(B, 2, 64), 2)
    grid = torch.from_numpy(rng.integers(0, 5, (B, 2048, 3)).astype(np.float32)).to(dev)
    for k in (4, 1):
        check_interp(res, f"integer grid (ties) N=2048 S=512 D=64 k={k}", grid,
                     grid[:, ::4].contiguous(), normal(B, 512, 64), k)
    check_interp(res, "N=300 S=2000 D=64 k=3", cloud(B, 300), cloud(B, 2000),
                 normal(B, 2000, 64), 3)


def fps_with(xyz, npoint: int, start, threads: int) -> torch.Tensor:
    """csrc/fps.cu at ``threads`` threads a row (and the points a thread
    that N then takes), in place of the wrapper's choice."""
    b, n, _ = xyz.shape
    out = torch.empty(b, npoint, dtype=torch.int32, device=xyz.device)
    plan = sampling._fps_plan(b, n, npoint, threads, sampling._pow2_at_least(-(-n // threads)))
    _kernels.FPS.launch(xyz.data_ptr(), start.data_ptr(), out.data_ptr(), plan,
                        *_kernels.stream_args(xyz))
    return out


def interp_with(dst, src, f, k: int, lanes: int) -> torch.Tensor:
    """csrc/interp.cu at ``lanes`` lanes a query, in place of the wrapper's
    choice."""
    b, n, _ = dst.shape
    s, d = f.shape[1:]
    out = torch.empty(b, n, d, device=dst.device)
    plan = interpolate._interp_plan(b, n, s, d, k, d % 4 == 0,
                                    interpolate._sm_count(dst.get_device()), lanes)
    _kernels.INTERPOLATE.launch(dst.data_ptr(), src.data_ptr(), f.data_ptr(), out.data_ptr(),
                                None, None, plan, *_kernels.stream_args(dst))
    return out


def compare_sampling_designs(dev: torch.device) -> None:
    """The launch choices of K1 and K4 side by side, device ms a call (CUDA
    graph), each result held to the plain version: FPS at every block size
    from one warp to 1024 threads that keeps <= 16 points a thread, at the
    model levels; interpolation at 4, 8, 16 and 32 lanes a query, at the model
    levels at B=4 and SSG's at B=16."""
    rng = np.random.default_rng(SEED + 3)
    for b, n, npoint, _ in FPS_LEVELS:
        xyz = torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)
        zero = torch.zeros(b, dtype=torch.int32, device=dev)
        want = sampling.fps_plain(xyz, npoint, zero)
        line = []
        for threads in (32, 64, 128, 256, 512, 1024):
            if threads > max(32, n) or -(-n // threads) > 16:
                continue
            if not torch.equal(fps_with(xyz, npoint, zero, threads), want):
                raise AssertionError(f"fps B={b} {n}->{npoint} at {threads} threads: disagrees")
            line.append(f"{threads}: {device_ms(lambda: fps_with(xyz, npoint, zero, threads)):.4f}")
        chosen = sampling.fps_launch(n)[0]
        print(f"{'fps':18s} B={b} {n}->{npoint} device ms by threads a row (chosen {chosen}): "
              + ", ".join(line), flush=True)
    for b, k, levels in ((B, 3, SSG_INTERP), (B, 4, BRISTRUNET_INTERP), (16, 3, SSG_INTERP)):
        for n, s, d in levels:
            dst = torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)
            src = dst[:, :s].contiguous()
            f = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)).to(dev)
            want = interpolate.interpolate_cuda(dst, src, f, k)[0]
            line = []
            for lanes in (4, 8, 16, 32):
                if not torch.equal(interp_with(dst, src, f, k, lanes), want):
                    raise AssertionError(f"interpolate B={b} N={n} S={s}: {lanes} lanes disagree")
                line.append(f"{lanes}: {device_ms(lambda: interp_with(dst, src, f, k, lanes)):.4f}")
            print(f"{'interpolate':18s} B={b} N={n} S={s} D={d} k={k} device ms by lanes a query "
                  f"(chosen {interpolate.interp_lanes(b * n)}): " + ", ".join(line), flush=True)


# (N, k) of each k-NN call of a BriStruNet forward, all self-queries:
# bri_enc, geometric2, geometric3; and the side path of its first at the
# serve's batch of 16
BRISTRUNET_KNN = ((4096, 32), (512, 16), (128, 16))
KNN_B16 = "knn_b16"
# (B, k, path) of the k-NN calls of a DGCNN forward (k = 20) and a
# DGCNNGlobal one (k = 64; k = 32 in the sweep's dgcnn_k32 row), N = S =
# 4096: one K5 over xyz and three K5c over conv2-conv4's 64 channels; at
# B = 16, the serve's and the recipe's batch
DGCNN_KNN = ((B, 20, (DGCNN,)), (B, 64, (DGCNN_GLOBAL,)), (16, 20, (DGCNN_B16,)),
             (16, 64, (DGCNN_GLOBAL_B16,)), (B, 32, (DGCNN_K32,)))
# instructions a pair that K2 and K5 cannot go below: a distance (8 rounded
# operations, no contraction) and its compare
NEIGHBOUR_INSTRUCTIONS = 9


def issue_floor_ms(pairs: int, mhz: float, per_pair: int = NEIGHBOUR_INSTRUCTIONS) -> float:
    """The least time the card's float32 lanes take to issue ``per_pair``
    instructions for each pair (NEIGHBOUR_INSTRUCTIONS for K2 and K5, 3C
    for K5c): 128 lanes an SM a cycle."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pairs * per_pair / (SM_LANES * sms * mhz * 1e3)


def knn_c_instructions(c: int) -> int:
    """What K5c cannot go below a pair: a distance over C channels (C
    subtractions, C multiplications, C - 1 additions, each rounded) and its
    compare."""
    return 3 * c


def check_ball(res: Results, label, balls, xyz, centers, paths=(), timed=False):
    """K2 at each (radius, K) of ``balls`` over the same points: one launch
    (ops.grouping.ball_query_radii_cuda), or one a radius where the
    package has no such launch (a parent's)."""
    b, n, _ = xyz.shape
    work = None
    if timed:
        # a scan goes on until its last radius has K hits
        pairs = int(torch.stack([ball_scan_lengths(grouping.ball_query_plain(r, k, xyz, centers),
                                                    n) for r, k in balls]).amax(0).sum())
        work = (nbytes(xyz, centers) + sum(b * centers.shape[1] * k * 4 for _, k in balls),
                9 * pairs)
    if hasattr(grouping, "ball_query_radii_cuda"):
        def kernel():
            return tuple(grouping.ball_query_radii_cuda(balls, xyz, centers))
    else:
        def kernel():
            return tuple(grouping.ball_query_cuda(r, k, xyz, centers) for r, k in balls)
    got = res.check("ball_query", label, kernel,
                    lambda: tuple(grouping.ball_query_plain(r, k, xyz, centers)
                                  for r, k in balls), True, paths, work=work, split=timed)
    return (pairs, got) if timed else None


def compare_neighbour_kernels(dev: torch.device, res: Results, rng) -> None:
    """K2 against ball_query_plain and K5 against knn_plain, bit for bit
    (K5: indices and distances). Timed three ways (events; device time from
    a CUDA graph; host time a call) beside two bounds, the FMA-rate bound
    and the issue floor at the SM clock that nvidia-smi reads meanwhile: K2
    at the SA levels of SSG and BriStruNet at B=4 and SSG's at B=16 (points
    scanned up to each query's K-th hit), K5 at BriStruNet's three shapes
    and its first at B=16. Then K2 over empty balls, K > N, N no multiple of
    32, N = 16384 (a ring of tiles) and radius 0 over duplicate points; K5
    at N = 16384 with k = 64 (a ring of tiles), S != N, k = N, and k = 1,
    32, 40 and 64 on an integer grid (ties). K5 and K5c at DGCNN's shapes
    (N = S = 4096, k = 20 and 64, B = 4 and 16; K5c over 64 channels,
    three launches a forward, beside 3C instructions a pair); then K5c at
    C = 5, 6, 67, 128 and 3, N no multiple of its tile, S != N, rows off
    16-byte alignment, integer features (ties), duplicate points, k = N and
    the edges of a warp of Q queries."""

    def cloud(b, n):
        return torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)

    def grid(b, n, side):
        return torch.from_numpy(rng.integers(0, side, (b, n, 3)).astype(np.float32)).to(dev)

    def knn_case(label, xyz, query, k, paths=(), timed=False):
        b, n, _ = xyz.shape
        s = query.shape[1]
        work = library = None
        if timed:
            work = (nbytes(xyz, query) + b * s * k * 8, 9 * b * s * n)
            # two calls, so an orientation and no yardstick of one call
            library = lambda: (torch.cdist(query, xyz) ** 2).topk(k, largest=False)  # noqa: E731
        got = res.check("knn", label, lambda: grouping.knn_cuda(xyz, query, k),
                        lambda: grouping.knn_plain(xyz, query, k), True, paths, work=work,
                        library_fn=library, split=timed)
        return (b * s * n, got) if timed else None

    def knn_c_case(label, xyz, query, k, paths=(), timed=False, times=1, launch=None):
        """K5c against knn_plain, indices and distances bit for bit; timed
        beside 3C operations a pair and cdist + topk. ``launch`` = (warps,
        queries a warp) in place of the plan's."""
        b, n, c = xyz.shape
        s = query.shape[1]
        work = library = None
        if timed:
            work = (nbytes(xyz, query) + b * s * k * 8, knn_c_instructions(c) * b * s * n)
            library = lambda: (torch.cdist(query, xyz) ** 2).topk(k, largest=False)  # noqa: E731
        if launch:
            label += f" at {launch[0]}x{launch[1]}"

            def kernel():
                return knn_c_with(xyz, query, k, *launch)
        else:
            def kernel():
                return grouping.knn_c_cuda(xyz, query, k)
        got = res.check("knn_c", label, kernel, lambda: grouping.knn_plain(xyz, query, k), True,
                        paths, work=work, library_fn=library, split=timed, times=times)
        return (b * s * n, got) if timed else None

    def features(b, n, c, side=0):
        """Normal features, or integers in [0, side) (exact distances, ties)."""
        a = rng.integers(0, side, (b, n, c)) if side else rng.normal(size=(b, n, c))
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    timed = []
    with SmClock() as clock:
        for b, paths, levels in ((B, (SSG,), SSG_BALLS), (B, (BRISTRUNET,), BRISTRUNET_BALLS),
                                 (16, (SSG_B16,), SSG_BALLS)):
            for n, s, balls in levels:
                xyz = cloud(b, n)
                label = f"B={b} N={n} S={s} " + " and ".join(f"K={k} r={r}" for r, k in balls)
                got = check_ball(res, label, balls, xyz, xyz[:, :s].contiguous(), paths, timed=True)
                timed.append(("ball_query", label, paths, NEIGHBOUR_INSTRUCTIONS, *got))
        for b, paths, (n, k) in [(B, (BRISTRUNET,), nk) for nk in BRISTRUNET_KNN] + [
                (16, (KNN_B16,), BRISTRUNET_KNN[0])] + [
                (b, paths, (N, k)) for b, k, paths in DGCNN_KNN]:
            xyz = cloud(b, n)
            timed.append(("knn", f"B={b} N=S={n} k={k}", paths, NEIGHBOUR_INSTRUCTIONS,
                          *knn_case(f"B={b} N=S={n} k={k}", xyz, xyz, k, paths, timed=True)))
        # K5c at DGCNN's conv2-conv4 (64 channels), three launches a forward
        for b, k, paths in DGCNN_KNN:
            x = features(b, N, 64)
            label = f"B={b} N=S={N} C=64 k={k}"
            timed.append(("knn_c", label, paths, knn_c_instructions(64),
                          *knn_c_case(label, x, x, k, paths, timed=True, times=3)))
    for name, label, paths, per_pair, pairs, got in timed:
        floor_ms = issue_floor_ms(pairs, clock.mhz, per_pair)
        res.add(name, paths, "issue_ms", floor_ms * (3 if name == "knn_c" else 1))
        print(f"{name:18s} {label}: device {got['device_ms']:.4f} ms, {pairs} pairs, issue floor "
              f"{floor_ms:.5f} ms at {clock.mhz:.0f} MHz ({got['device_ms'] / floor_ms:.1f}x)",
              flush=True)
    # enhanced_pointnet2_ssg (phases 31-33), held here before any model phase
    # runs them: its positional encoding's knn_set over the input cloud at
    # N=S=4096, k=16 (B=4 and the serve's 16), BoundaryAwareModule's ordered
    # k-NN and geometric1's knn_set over l1 at N=S=1024, k=16
    for b, n in ((B, 4096), (16, 4096), (B, 1024)):
        xyz = cloud(b, n)
        knn_case(f"enhanced B={b} N=S={n} k=16", xyz, xyz, 16, timed=True)
    res.print_sums("ball_query", (SSG, BRISTRUNET, SSG_B16))
    res.print_sums("knn", (BRISTRUNET, KNN_B16, DGCNN, DGCNN_GLOBAL, DGCNN_B16, DGCNN_GLOBAL_B16,
                           DGCNN_K32))
    res.print_sums("knn_c", (DGCNN, DGCNN_GLOBAL, DGCNN_B16, DGCNN_GLOBAL_B16, DGCNN_K32))

    xyz = cloud(B, 4096)
    check_ball(res, "empty balls", ((0.1, 32),), xyz, torch.full((B, 64, 3), 10.0, device=dev))
    small = cloud(B, 16)
    check_ball(res, "K=32 > N=16", ((0.5, 32),), small, small[:, :8].contiguous())
    dup = grid(B, 40, 2)  # 40 points on 8 sites
    check_ball(res, "K=64 > N=40, duplicate points", ((0.5, 64),), dup, dup[:, :10].contiguous())
    xyz = cloud(B, 1000)
    check_ball(res, "N=1000 S=300 K=32 r=0.15", ((0.15, 32),), xyz, cloud(B, 300))
    xyz = cloud(B, 16384)
    check_ball(res, "N=16384 S=1024 K=32 r=0.05", ((0.05, 32),), xyz, xyz[:, ::16].contiguous())
    dup = grid(B, 4096, 6)
    check_ball(res, "radius 0 over duplicate points K=16", ((0.0, 16),), dup,
               dup[:, :512].contiguous())
    # one scan of three radii, a ring of tiles among them, and of two where
    # the smaller radius asks for more points
    xyz = cloud(B, 9000)
    check_ball(res, "N=9000 S=700 three radii", ((0.05, 8), (0.1, 16), (0.2, 64)), xyz,
               xyz[:, :700].contiguous())
    xyz = cloud(B, 1000)
    check_ball(res, "N=1000 S=256 K=64 r=0.1 and K=4 r=0.3", ((0.1, 64), (0.3, 4)), xyz,
               xyz[:, :256].contiguous())

    xyz = cloud(B, 16384)
    knn_case("N=16384 S=1000 k=64", xyz, cloud(B, 1000), 64)
    xyz, query = cloud(B, 3001), cloud(B, 1000)
    for k in (64, 33):
        knn_case(f"N=3001 S=1000 k={k}", xyz, query, k)
    tiny = cloud(B, 64)
    knn_case("k = N = 64", tiny, cloud(B, 7), 64)
    ties = grid(B, 2048, 6)
    for k in (64, 40, 32, 1):
        knn_case(f"integer grid (ties) N=S=2048 k={k}", ties, ties, k)

    # K5c: other widths (the runtime-C paths, four channels a copy or one),
    # N no multiple of the tile, S != N, ties, duplicates, k = N, C = 3
    for c in (5, 6, 67, 128, 3):
        x = features(B, 1000, c)
        knn_c_case(f"C={c} N=S=1000 k=20", x, x, 20)
    x = features(B, 4000, 64)  # 10 tiles of 384 and one of 160
    knn_c_case("C=64 N=4000 S=1000 k=64", x, features(B, 1000, 64), 64)
    knn_c_case("C=64 N=4000 S=700 k=33", x, x[:, ::5].contiguous(), 33)
    x = features(B, 16384, 64)
    knn_c_case("C=64 N=16384 S=512 k=20", x, x[:, :512].contiguous(), 20)
    view = features(1, B * 1000 * 64 + 1, 1).reshape(-1)[1:].view(B, 1000, 64)
    knn_c_case("C=64 rows off 16-byte alignment (4-byte copies)", view, view, 20)
    for c, k in ((64, 20), (64, 64), (6, 64), (5, 1)):
        g = features(B, 2048, c, side=3)
        knn_c_case(f"integer grid (ties) C={c} N=S=2048 k={k}", g, g, k)
    dup = features(B, 64, 64).repeat(1, 32, 1)  # 2048 points on 64 sites
    knn_c_case("C=64 duplicate points N=S=2048 k=40", dup, dup, 40)
    tiny = features(B, 64, 64)
    knn_c_case("C=64 k = N = 64", tiny, features(B, 7, 64), 64)
    knn_c_case("C=6 k = N = 37", features(B, 37, 6), features(B, 300, 6), 37)

    # the edges of a warp of Q queries, at every Q K5c is compiled for (at
    # 32 warps a block): S = 1, Q - 1, 4097 (a last block of one query),
    # B = 1 with S < Q, at k = 1 and 64 over N = 4096 points of 64 channels; C = 67 (4-byte staging), C = 128 (C read from the plan);
    # queries off 16-byte alignment beside aligned points
    x = features(B, N, 64)
    for queries in grouping.KNN_C_QUERIES:
        launch = (32, queries)
        shapes = dict.fromkeys((b, s) for b, s in ((B, 1), (B, queries - 1), (1, queries - 1),
                                                   (B, 4097)) if s >= 1)
        for b, s in shapes:
            query = features(b, s, 64)
            for k in (1, 64):
                knn_c_case(f"C=64 B={b} N={N} S={s} k={k}", x[:b], query, k, launch=launch)
        for c in (67, 128):
            y = features(B, 1000, c)
            knn_c_case(f"C={c} N=1000 S=300 k=20", y, y[:, :300].contiguous(), 20,
                       launch=launch)
        flat = features(1, B * 300 * 64 + 1, 1).reshape(-1)
        off = flat[1:].view(B, 300, 64)  # 4 bytes past 16-byte alignment
        knn_c_case("C=64 queries off 16-byte alignment N=4096 S=300 k=20", x, off, 20,
                   launch=launch)


def knn_with(xyz, k: int, warps=None, tile=None) -> tuple:
    """csrc/knn.cu self-query at ``warps`` a block and ``tile`` points a
    staged tile, in place of the wrapper's plan -> (d2, idx)."""
    b, n, _ = xyz.shape
    idx = torch.empty(b, n, k, dtype=torch.int32, device=xyz.device)
    d2 = torch.empty(b, n, k, device=xyz.device)
    plan = grouping._knn_plan(b, n, n, k, _kernels.sm_count(xyz.get_device()), warps, tile)
    _kernels.KNN.launch(xyz.data_ptr(), xyz.data_ptr(), idx.data_ptr(), d2.data_ptr(), plan,
                        *_kernels.stream_args(xyz))
    return d2, idx


def knn_c_with(xyz, query, k: int, warps: int, queries: int, tile=None) -> tuple:
    """K5c at ``warps`` a block of ``queries`` a warp and ``tile`` points a
    staged tile (None: the most that fits), in place of the wrapper's plan
    -> (d2, idx)."""
    b, n, c = xyz.shape
    s = query.shape[1]
    idx = torch.empty(b, s, k, dtype=torch.int32, device=xyz.device)
    d2 = torch.empty(b, s, k, device=xyz.device)
    plan = grouping._knn_c_plan(b, n, s, k, c, _kernels.sm_count(xyz.get_device()),
                                c % 4 == 0 and xyz.data_ptr() % 16 == 0, warps, tile, queries)
    _kernels.KNN_C.launch(xyz.data_ptr(), query.data_ptr(), idx.data_ptr(), d2.data_ptr(), plan,
                          *_kernels.stream_args(xyz))
    return d2, idx


# K5c's launches side by side at DGCNN's shapes: (warps, queries a warp,
# points a tile or None for the most that fits); 128-point tiles let two
# blocks share an SM. Q = 4 and 8 are the probe's (k2_k5_probe.py).
KNN_C_GRID = ((32, 1, None), (32, 2, None), (32, 2, 128), (16, 2, None), (16, 2, 128))
# ... and at fewer queries, where the plan's choice between one and two
# queries a warp is made: (B, S, k) over N = 4096, the rows a last partial
# batch leaves (B = 1 to 3, S = 4096) and a few hundred queries
KNN_C_SMALL = ((1, 4096, 20), (1, 4096, 64), (2, 4096, 20), (2, 4096, 64), (3, 4096, 20),
               (1, 1024, 20), (1, 256, 20), (2, 64, 20))
KNN_C_SMALL_GRID = ((32, 1, None), (32, 2, None), (16, 1, None), (16, 2, None), (16, 2, 128),
                    (8, 1, None), (8, 2, None), (8, 2, 128), (4, 1, None), (4, 2, None))


def ball_with(balls, xyz, centers, warps: int, queries: int) -> list:
    """csrc/ballq.cu for the (radius, K) of ``balls`` (up to three) at
    ``warps`` a block and ``queries`` a warp, in place of the wrapper's
    plan."""
    b, n, _ = xyz.shape
    s = centers.shape[1]
    outs = [torch.empty(b, s, k, dtype=torch.int32, device=xyz.device) for _, k in balls]
    plan = grouping._ball_plan(b, n, s, balls, _kernels.sm_count(xyz.get_device()), warps,
                               queries)
    ptrs = [o.data_ptr() for o in outs] + [None] * (grouping.BALL_MAX_RADII - len(outs))
    _kernels.BALL_QUERY.launch(xyz.data_ptr(), centers.data_ptr(), *ptrs, plan,
                               *_kernels.stream_args(xyz))
    return outs


def compare_neighbour_designs(dev: torch.device) -> None:
    """The launch choices of K2, K5 and K5c side by side, device ms a call
    (CUDA graph), each result held to the plain version: K5 at 4, 8, 16 and
    32 warps a block and with its row staged as a ring of 1024-point tiles;
    K5c over KNN_C_GRID (warps, queries a warp, tile) at DGCNN's shapes and
    over KNN_C_SMALL_GRID at KNN_C_SMALL's, the plan's pick beside the
    fastest; K2
    at 1 and 4 queries a warp and 4-32 warps a block; at the model levels of
    both (B=4) and at B=16; then BriStruNet's levels as one scan of both
    radii against a launch a radius."""
    rng = np.random.default_rng(SEED + 5)
    sms = _kernels.sm_count(0)

    def cloud(b, n):
        return torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)

    for b, (n, k) in [(B, nk) for nk in BRISTRUNET_KNN] + [(16, BRISTRUNET_KNN[0])]:
        xyz = cloud(b, n)
        want = grouping.knn_plain(xyz, xyz, k)
        line = []
        for warps, tile in [(w, None) for w in (4, 8, 16, 32)] + [(None, 1024)]:
            def run(warps=warps, tile=tile):
                return knn_with(xyz, k, warps, tile)
            got = run()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"knn B={b} N={n} at {warps} warps, tile {tile}: disagrees")
            line.append(f"{'plan, ring 1024' if tile else warps}: {device_ms(run):.4f}")
        print(f"{'knn':18s} B={b} N=S={n} k={k} device ms by warps a block (chosen "
              f"{grouping.neighbour_launch(b, n, sms)}): " + ", ".join(line), flush=True)
    knn_c_shapes = [(b, N, k, KNN_C_GRID) for b, k, _ in DGCNN_KNN]
    knn_c_shapes += [(b, s, k, KNN_C_SMALL_GRID) for b, s, k in KNN_C_SMALL]
    for b, s, k, grid in knn_c_shapes:
        x = torch.from_numpy(rng.normal(size=(b, N, 64)).astype(np.float32)).to(dev)
        query = x[:, :s].contiguous()
        want = grouping.knn_plain(x, query, k)
        times = {}
        for warps, queries, tile in grid:
            def run(warps=warps, queries=queries, tile=tile):
                return knn_c_with(x, query, k, warps, queries, tile)
            got = run()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"knn_c B={b} k={k} at {warps}x{queries} tile {tile}: "
                                     "disagrees")
            tile = tile or grouping.knn_c_tile(N, 64, warps, queries)
            times[(warps, queries, tile)] = device_ms(run, reps=5)
        plan = grouping._knn_c_plan(b, N, s, k, 64, sms, True)
        chosen = tuple(dict(zip(grouping.KNN_C_PLAN, plan))[f] for f in ("warps", "queries", "tile"))
        best = min(times, key=times.get)
        print(f"{'knn_c':18s} B={b} N={N} S={s} C=64 k={k} device ms by warps x queries a warp, "
              f"tile: " + ", ".join(f"{w}x{q} {tl}: {ms:.4f}" for (w, q, tl), ms in times.items())
              + f"; the plan's {chosen[0]}x{chosen[1]} {chosen[2]}"
              + (f" {times[chosen]:.4f}" if chosen in times else "")
              + f", the fastest {best[0]}x{best[1]} {best[2]} {times[best]:.4f}", flush=True)
        del x, want
    for b, levels in ((B, SSG_BALLS), (B, BRISTRUNET_BALLS), (16, SSG_BALLS)):
        for n, s, balls in levels:
            xyz = cloud(b, n)
            centers = xyz[:, :s].contiguous()
            want = [grouping.ball_query_plain(r, k, xyz, centers) for r, k in balls]
            line = []
            for queries in (1, 4):
                for warps in (4, 8, 16, 32):
                    def run(warps=warps, queries=queries):
                        return ball_with(balls, xyz, centers, warps, queries)
                    if not all(map(torch.equal, run(), want)):
                        raise AssertionError(f"ball query B={b} N={n} S={s}: {warps} x {queries} "
                                             "disagrees")
                    line.append(f"{warps}x{queries}: {device_ms(run):.4f}")
            queries = grouping.ball_queries_a_warp(b, s, sms)
            print(f"{'ball_query':18s} B={b} N={n} S={s} {balls} device ms by warps x queries a "
                  f"warp (chosen {grouping.neighbour_launch(b, s, sms, queries)}x{queries}): "
                  + ", ".join(line), flush=True)
            if len(balls) > 1:
                def apart():
                    return [grouping.ball_query_cuda(r, k, xyz, centers) for r, k in balls]
                if not all(map(torch.equal, apart(), want)):
                    raise AssertionError(f"ball query B={b} N={n} S={s}: a launch a radius "
                                         "disagrees")
                one = device_ms(lambda: grouping.ball_query_radii_cuda(balls, xyz, centers))
                print(f"{'ball_query':18s} B={b} N={n} S={s} {balls}: one scan {one:.4f} ms, a "
                      f"launch a radius {device_ms(apart):.4f} ms (device, together)", flush=True)


# (N, S, ((radius, K), ...), C) of each set-abstraction level of a forward
# of the MSG family at B=4 x 4096: pointnet2_msg with 9 feature channels
# (phase 21), pointnet2_sem_seg with colours, the classifiers with xyz alone
# (their registry default); one ball-query scan and one FPS a level, a group
# a radius
MSG_SA = ((4096, 1024, ((0.05, 16), (0.1, 32)), 9), (1024, 256, ((0.1, 16), (0.2, 32)), 96),
          (256, 64, ((0.2, 16), (0.4, 32)), 256), (64, 16, ((0.4, 16), (0.8, 32)), 512))
SEM_SEG_SA = ((4096, 1024, ((0.1, 32),), 3), (1024, 256, ((0.2, 32),), 64),
              (256, 64, ((0.4, 32),), 128), (64, 16, ((0.8, 32),), 256))
CLS_SSG_SA = ((4096, 512, ((0.2, 32),), 0), (512, 128, ((0.4, 64),), 128))
CLS_MSG_SA = ((4096, 512, ((0.1, 16), (0.2, 32), (0.4, 128)), 0),
              (512, 128, ((0.2, 32), (0.4, 64), (0.8, 128)), 320))
MSG_FAMILY_SA = ((MSG, MSG_SA), (SEM_SEG, SEM_SEG_SA), (CLS_SSG, CLS_SSG_SA),
                 (CLS_MSG, CLS_MSG_SA))
# (N, S, D) of each interpolation (k=3), fp4 to fp1; the MSG train step's
# interpolation backward runs at MSG's, its group backward at sa2-sa4
MSG_INTERP = ((64, 16, 1024), (256, 64, 256), (1024, 256, 256), (4096, 1024, 128))
SEM_SEG_INTERP = ((64, 16, 512), (256, 64, 256), (1024, 256, 256), (4096, 1024, 128))


def compare_msg_family_kernels(dev: torch.device, res: Results, rng) -> None:
    """Phase 3, the MSG family's cases: K1, K2 and K3 bit for bit and K4
    within INTERP_TOL at every shape that the pointnet2_msg,
    pointnet2_sem_seg, pointnet2_cls_ssg and pointnet2_cls_msg forwards give
    them at B=4 x 4096 (MSG_FAMILY_SA, MSG_INTERP, SEM_SEG_INTERP), each
    timed three ways (events; device time from a CUDA graph; host time a
    call) beside its bound and summed a path; then their edge cases: FPS
    64 -> 16 (one warp) and npoint > N (512 -> 1024, 64 -> 100); a scan of
    two radii where one finds no point and the other every point, centres
    in and out of the cloud; K > N (N = 20 at K 16 and 32, N = 100 at K up
    to 128); three radii with K = 128 at S = 16, 128 and 512 and at B=16
    with S = 1024 (four queries a warp); groups of widths 12, 99, 259 and
    515 at K = 128 and at K 16 and 32 over balls the padding fills;
    interpolation of D = 1024 from S = 16 at B = 1 and 16 and of D = 515."""

    def cloud(b, n):
        return torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    def zeros(b):
        return torch.zeros(b, dtype=torch.int32, device=dev)

    for path, levels in MSG_FAMILY_SA:
        for n, s, balls, c in levels:
            xyz = cloud(B, n)
            check_fps(res, f"B={B} {n}->{s}", xyz, s, zeros(B), (path,), timed=True)
            centers = xyz[:, :s].contiguous()
            check_ball(res, f"B={B} N={n} S={s} " + " and ".join(f"K={k} r={r}" for r, k in balls),
                       balls, xyz, centers, (path,), timed=True)
            feats = normal(B, n, c) if c else None
            for (r, k), idx in zip(balls, grouping.ball_query_radii_cuda(balls, xyz, centers)):
                check_group(res, f"B={B} N={n} S={s} K={k} r={r} C={c}", xyz, centers, idx,
                            feats, (path,), timed=True)
    for path, levels in ((MSG, MSG_INTERP), (SEM_SEG, SEM_SEG_INTERP)):
        for n, s, d in levels:
            dst = cloud(B, n)
            check_interp(res, f"B={B} N={n} S={s} D={d} k=3", dst, dst[:, :s].contiguous(),
                         normal(B, s, d), 3, (path,), timed=True)
    for name in ("fps", "ball_query", "group"):
        res.print_sums(name, [path for path, _ in MSG_FAMILY_SA])
    res.print_sums("interpolate", (MSG, SEM_SEG))

    # K1: one warp at 64 -> 16 from a [B] start; npoint > N, where the plain
    # version takes index 0 again once every point is taken
    start = torch.from_numpy(rng.integers(0, 64, B).astype(np.int32)).to(dev)
    check_fps(res, "64->16 start [B]", cloud(B, 64), 16, start)
    for n, npoint in ((512, 1024), (64, 100), (1000, 1024)):
        check_fps(res, f"{n}->{npoint} (npoint > N)", cloud(B, n), npoint, zeros(B))

    # K2: no hit at one radius beside every point at the other, in one scan,
    # over centres in and out of the cloud; K > N; K = 128 at three radii
    xyz = cloud(B, 256)
    centers = torch.cat([xyz[:, :32], xyz[:, :32] + 3.0], dim=1).contiguous()
    check_ball(res, "N=256 S=64 r=0.05 K=16 (half out of the cloud) and r=8 K=32",
               ((0.05, 16), (8.0, 32)), xyz, centers)
    far = torch.full((B, 16, 3), 1.6, device=dev)
    check_ball(res, "N=64 S=16 r=0.4 K=16 (no hit) and r=3 K=32 (every point)",
               ((0.4, 16), (3.0, 32)), cloud(B, 64), far)
    small = cloud(B, 20)
    check_ball(res, "K=16 and 32 > N=20", ((0.4, 16), (0.8, 32)), small,
               small[:, :8].contiguous())
    small = cloud(B, 100)
    check_ball(res, "K=32, 64 and 128 > N=100", ((0.2, 32), (0.4, 64), (0.8, 128)), small,
               small[:, :50].contiguous())
    for b, n, s in ((B, 4096, 16), (B, 4096, 128), (B, 4096, 512), (B, 512, 128),
                    (16, 4096, 1024)):
        xyz = cloud(b, n)
        check_ball(res, f"B={b} N={n} S={s} K=16, 32 and 128",
                   ((0.1, 16), (0.2, 32), (0.4, 128)), xyz, xyz[:, :s].contiguous())

    # K3 at the MSG family's widths (12, 99, 259, 515; 3 and 323) at K = 128,
    # and at K 16 and 32 over balls the padding fills
    xyz = cloud(B, 1024)
    centers = xyz[:, :128].contiguous()
    idx128 = grouping.ball_query_cuda(0.3, 128, xyz, centers)
    for c in (9, 96, 256, 512, 0, 320):
        check_group(res, f"N=1024 S=128 K=128 C={c}", xyz, centers, idx128,
                    normal(B, 1024, c) if c else None)
    xyz = cloud(B, 64)
    centers = xyz[:, :16].contiguous()
    balls = ((0.4, 16), (0.8, 32))
    for (r, k), idx in zip(balls, grouping.ball_query_radii_cuda(balls, xyz, centers)):
        check_group(res, f"sa4 N=64 S=16 K={k} r={r} C=512 (padded balls)", xyz, centers, idx,
                    normal(B, 64, 512))

    # K4: D = 1024 from S = 16 at B = 1 and 16 (the serve's batch), D = 515
    for b in (1, 16):
        dst = cloud(b, 64)
        check_interp(res, f"B={b} N=64 S=16 D=1024 k=3", dst, dst[:, :16].contiguous(),
                     normal(b, 16, 1024), 3)
    check_interp(res, "N=256 S=16 D=515 k=3", cloud(B, 256), cloud(B, 16), normal(B, 16, 515), 3)


def compare_msg_family_backward(dev: torch.device, res: Results, rng) -> None:
    """Phase 3b, the MSG family's cases: K3b within BWD_TOL * max|plain| at
    the MSG train step's group backward (sa2-sa4, both radii: C = 96, 256,
    512 at K 16 and 32) and K4b on the kept selection at its four
    interpolations (D = 1024 from S = 16 to 128 from 1024), timed with the
    split of their time beside index_add_; then K3b at K = 128 over C = 320
    and 96 and over balls the padding fills, and K4b at D = 1024, S = 16 at
    B = 1 and 16, each the same bits from one call to the next."""

    def cloud(b, n):
        return torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    for n, s, balls, c in MSG_SA[1:]:
        xyz = cloud(B, n)
        centers = xyz[:, :s].contiguous()
        for (r, k), idx in zip(balls, grouping.ball_query_radii_cuda(balls, xyz, centers)):
            check_group_bwd(res, f"g [{B},{s},{k},{3 + c}] -> [{B},{n},{c}] r={r}",
                            normal(B, s, k, 3 + c), idx, n, 3, 3 + c, (MSG_TRAIN,), timed=True)
    for n, s, d in MSG_INTERP:
        dst = cloud(B, n)
        idx, w = kept_selection(dst, dst[:, :s].contiguous(), 3)
        check_interp_bwd(res, f"g [{B},{n},{d}] -> [{B},{s},{d}] k=3", normal(B, n, d), idx, w,
                         s, (MSG_TRAIN,), timed=True)
    res.print_sums("group_bwd", (MSG_TRAIN,))
    res.print_sums("interp_bwd", (MSG_TRAIN,))

    xyz = cloud(B, 512)
    centers = xyz[:, :128].contiguous()
    for r, c in ((0.8, 320), (0.2, 96)):
        idx = grouping.ball_query_cuda(r, 128, xyz, centers)
        check_group_bwd(res, f"K=128 r={r} C={c}", normal(B, 128, 128, 3 + c), idx, 512, 3,
                        3 + c)
    xyz = cloud(B, 64)
    idx = grouping.ball_query_cuda(0.4, 32, xyz, xyz[:, :16].contiguous())  # padded balls
    check_group_bwd(res, "sa4 N=64 S=16 K=32 r=0.4 C=512 (padded balls)",
                    normal(B, 16, 32, 515), idx, 64, 3, 515)
    for b in (1, 16):
        dst = cloud(b, 64)
        idx, w = kept_selection(dst, dst[:, :16].contiguous(), 3)
        check_interp_bwd(res, f"B={b} N=64 S=16 D=1024 k=3", normal(b, 64, 1024), idx, w, 16)


def compare_backward_kernels(dev: torch.device, res: Results) -> None:
    """Phase 3b: the backward kernels against their plain versions at the
    train steps' shapes."""
    rng = np.random.default_rng(SEED + 1)
    compare_group_backward(dev, res, rng)
    compare_interp_backward(dev, res, rng)
    compare_msg_family_backward(dev, res, rng)
    compare_zoo_backward(dev, res, rng)


def kept_selection(dst, src, k: int) -> tuple:
    """The selection the forward kernel keeps for the backward, held to the
    plain one (indices exact, weights within 1e-6) -> (idx, w)."""
    f = torch.zeros(*src.shape[:2], 4, device=src.device)
    _, idx, w = interpolate.interpolate_cuda(dst, src, f, k, True)
    _, pidx, pw = interpolate.interpolate_plain(dst, src, f, k, True)
    if not torch.equal(idx, pidx) or not torch.allclose(w, pw, rtol=1e-6, atol=1e-7):
        raise AssertionError(f"interpolate N={dst.shape[1]} S={src.shape[1]}: kept selection "
                             "differs from plain")
    return idx, w


def check_interp_bwd(res: Results, label, g, idx, w, s, paths=(), timed=False,
                     deterministic: bool = True) -> torch.Tensor:
    b, n, d = g.shape
    k = idx.shape[2]
    kernel = lambda: interpolate.interpolate_backward_cuda(g, idx, w, s)  # noqa: E731
    if deterministic and not torch.equal(kernel(), kernel()):
        raise AssertionError(f"interp_bwd {label}: two calls give other bits")
    work = library = None
    if timed:
        # library: one index_add_ of rows that are weighted already,
        # zeroing included, on a ready index
        rows = (w.unsqueeze(-1) * g.unsqueeze(2)).reshape(-1, d)
        offs = torch.arange(b, device=g.device).view(b, 1, 1) * s
        flat = (idx.long() + offs).reshape(-1)
        acc = torch.empty((b * s, d), device=g.device)
        work = (nbytes(g, idx, w) + b * s * d * 4, 2 * k * b * n * d)
        library = lambda: acc.zero_().index_add_(0, flat, rows)  # noqa: E731
    res.check("interp_bwd", label, kernel,
              lambda: interpolate.interpolate_backward_plain(g, idx, w, s),
              False, paths, scaled=(BWD_TOL, 0.0), work=work, library_fn=library,
              split=timed)
    return kernel()


def compare_interp_backward(dev: torch.device, res: Results, rng,
                            deterministic: bool = True) -> None:
    """K4b against interpolate_backward_plain within BWD_TOL * max|plain|
    (the plain version adds with atomics in its own order), on the selection
    the forward kernel keeps: the FP levels of the SSG train step (k=3) and
    of the BriStruNet train step (k=4, D up to 1024) at B=4 and B=16, timed
    three ways (events; device time from a CUDA graph; host time a call)
    beside the bytes bound and index_add_ of pre-weighted rows; then held,
    not timed: every query on one source (S=2 with k=2; N=4096 with every
    slot on one row, the longest list), sources that no query chose (their
    rows exactly 0), D = 1, 3, 131 and 1024, a g view 4 bytes off 16-byte
    alignment, S = 16384, N * k around the 4096-entry windows and k = 1..4.
    With ``deterministic`` every case must give the same bits from one call
    to the next (the kernel adds each row in a fixed order); the parent's
    kernel, timed under these cases, is called with it off."""

    def cloud(b, n):
        return torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    def case(*args, **kwargs):
        return check_interp_bwd(res, *args, deterministic=deterministic, **kwargs)

    for b, k, levels, path in ((B, 3, SSG_INTERP, TRAIN), (16, 3, SSG_INTERP, TRAIN_B16),
                               (B, 4, BRISTRUNET_INTERP, BRISTRUNET_TRAIN),
                               (16, 4, BRISTRUNET_INTERP, BRISTRUNET_TRAIN_B16)):
        for n, s, d in levels:
            dst = cloud(b, n)
            idx, w = kept_selection(dst, dst[:, :s].contiguous(), k)
            case(f"g [{b},{n},{d}] -> [{b},{s},{d}] k={k}", normal(b, n, d), idx, w, s, (path,),
                 timed=True)
    res.print_sums("interp_bwd", (TRAIN, TRAIN_B16, BRISTRUNET_TRAIN, BRISTRUNET_TRAIN_B16))

    # every query on both sources of S = 2; every slot of N = 4096 on row 1
    dst = cloud(B, 4096)
    idx, w = kept_selection(dst, cloud(B, 2), 2)
    case("N=4096 S=2 D=64 k=2", normal(B, 4096, 64), idx, w, 2)
    one = torch.ones(B, 4096, 4, dtype=torch.int32, device=dev)
    case("N=4096 S=8 D=128 k=4, every slot on row 1", normal(B, 4096, 128), one,
         torch.rand(B, 4096, 4, device=dev), 8)
    # every fourth source chosen: the others must be exactly 0
    picked = torch.from_numpy(rng.integers(0, 64, (B, 1024, 3)).astype(np.int32) * 4).to(dev)
    df = case("N=1024 S=256 D=128 k=3, every 4th row chosen", normal(B, 1024, 128), picked,
              torch.rand(B, 1024, 3, device=dev), 256)
    unchosen = torch.ones(B, 256, dtype=torch.bool, device=dev)
    unchosen.scatter_(1, picked.reshape(B, -1).long(), False)
    if df[unchosen].abs().max() != 0:
        raise AssertionError("interp_bwd: a source that no query chose is not 0")
    dst = cloud(B, 1024)
    src = dst[:, :256].contiguous()
    for k in (1, 2, 3, 4):
        idx, w = kept_selection(dst, src, k)
        for d in (1, 3, 131, 1024) if k == 3 else (64,):
            case(f"N=1024 S=256 D={d} k={k}", normal(B, 1024, d), idx, w, 256)
    idx, w = kept_selection(dst, src, 3)
    view = normal(B * 1024 * 256 + 1)[1:].view(B, 1024, 256)  # 4 bytes past alignment
    case("N=1024 S=256 D=256 k=3, g 4 bytes off", view, idx, w, 256)
    wide = torch.from_numpy(rng.integers(0, 16384, (B, 6000, 3)).astype(np.int32)).to(dev)
    case("N=6000 S=16384 D=32 k=3, random rows", normal(B, 6000, 32), wide,
         torch.rand(B, 6000, 3, device=dev), 16384)
    for n, k in ((4095, 1), (2048, 2), (4097, 1), (1365, 3), (1025, 4)):  # N * k near 4096
        dst = cloud(B, n)
        idx, w = kept_selection(dst, dst[:, :100].contiguous(), k)
        case(f"N={n} S=100 D=36 k={k} (N * k = {n * k})", normal(B, n, 36), idx, w, 100)


def check_group_bwd(res: Results, label, g, idx, n, c0, c1, paths=(), timed=False,
                    times: int = 1) -> None:
    """K3b at one case: the same bits from one call to the next and as
    ``group_backward_order`` (the kernel's fold order in plain PyTorch),
    then within BWD_TOL * max|plain| of ``group_backward_plain``; ``times``
    launches of a pass at this shape."""
    b, s, k, _ = g.shape
    got = grouping.group_backward_cuda(g, idx, n, c0, c1)
    if not torch.equal(got, grouping.group_backward_cuda(g, idx, n, c0, c1)):
        raise AssertionError(f"group_bwd {label}: two calls give other bits")
    order = grouping.group_backward_order(g, idx, n, c0, c1)
    if not torch.equal(got, order):
        raise AssertionError(f"group_bwd {label}: not the bits of the order emulation, "
                             f"max|err| {max_abs_err(got, order):.3g}")
    res.order_exact += 1
    work = library = None
    if timed:
        # library: one index_add_ over the batch-flattened rows (zeroing
        # included, as in the kernel's time), on a ready index and slice
        rows = g[..., c0:c1].reshape(-1, c1 - c0).contiguous()
        offs = torch.arange(b, device=g.device).view(b, 1, 1) * n
        flat = (idx.clamp(0, n - 1).long() + offs).reshape(-1)
        acc = torch.empty((b * n, c1 - c0), device=g.device)
        work = (nbytes(rows, idx) + b * n * (c1 - c0) * 4, b * s * k * (c1 - c0))
        library = lambda: acc.zero_().index_add_(0, flat, rows)  # noqa: E731
    res.check("group_bwd", label,
              lambda: grouping.group_backward_cuda(g, idx, n, c0, c1),
              lambda: grouping.group_backward_plain(g, idx, n, c0, c1),
              False, paths, scaled=(BWD_TOL, 0.0), work=work, library_fn=library,
              split=timed, times=times)


def compare_group_backward(dev: torch.device, res: Results, rng) -> None:
    """K3b bit for bit against group_backward_order and the same bits call
    to call, and against group_backward_plain within BWD_TOL * max|plain|
    (check_group_bwd): the feature channels of g [B,S,K,3+C] -> [B,N,C] over ball-query indices
    (repeats and all) at the SSG train step's sa2 and sa3 at B=4 and B=16 and
    at the six levels of a BriStruNet backward (all timed, with the split of
    their time); then the xyz channels (c0 = 0, with and without features),
    output widths 1, 4 and 16 (the aligned vector path at 4 and 16), empty
    balls, N = 1, K = 64 (a trailing run that starts in the first 32 slots
    and one that starts after them), and 35 rows a batch over indices from
    -2 to N + 2."""

    def cloud(b, n):
        return torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    def level(paths, b, n, s, k, r, c):
        xyz = cloud(b, n)
        idx = grouping.ball_query_cuda(r, k, xyz, xyz[:, :s].contiguous())
        g = normal(b, s, k, 3 + c)
        check_group_bwd(res, f"g [{b},{s},{k},{3 + c}] -> [{b},{n},{c}]", g, idx, n, 3, 3 + c,
                        paths, timed=True)

    for lv in SSG_LEVELS[1:]:
        level((TRAIN,), B, *lv)
    for lv in SSG_LEVELS[1:]:
        level((TRAIN_B16,), 16, *lv)
    for lv in BRISTRUNET_LEVELS:
        level((BRISTRUNET_TRAIN,), B, *lv)
    res.print_sums("group_bwd", (TRAIN, TRAIN_B16, BRISTRUNET_TRAIN))

    xyz = cloud(B, 1024)
    idx = grouping.ball_query_cuda(0.2, 32, xyz, xyz[:, :256].contiguous())
    for c, c0, c1 in ((16, 0, 19), (16, 0, 3), (1, 0, 4), (13, 0, 16), (1, 3, 4), (128, 0, 131)):
        check_group_bwd(res, f"g [{B},256,32,{3 + c}] channels [{c0},{c1})",
                        normal(B, 256, 32, 3 + c), idx, 1024, c0, c1)
    far = torch.full((B, 64, 3), 10.0, device=dev)
    empty = grouping.ball_query_cuda(0.1, 32, xyz, far)  # every slot N
    for c, c0 in ((16, 0), (128, 3)):
        check_group_bwd(res, f"empty balls C={c} channels [{c0},{3 + c})",
                        normal(B, 64, 32, 3 + c), empty, 1024, c0, 3 + c)
    one = cloud(B, 1)
    check_group_bwd(res, "N=1 S=1 K=32 C=8", normal(B, 1, 32, 11),
                    grouping.ball_query_cuda(0.5, 32, one, one), 1, 0, 11)
    # K=64: a ball of 0.1 holds a few points of 1024 (its run starts early),
    # one of 0.3 most of 64 (its run starts late or not at all)
    for r in (0.1, 0.3):
        idx64 = grouping.ball_query_cuda(r, 64, xyz, xyz[:, :128].contiguous())
        check_group_bwd(res, f"K=64 r={r} C=128", normal(B, 128, 64, 131), idx64, 1024, 3, 131)
    for c, c0 in ((3, 0), (13, 3), (128, 3), (128, 0)):
        wild = torch.from_numpy(rng.integers(-2, 1027, (3, 7, 5)).astype(np.int32)).to(dev)
        check_group_bwd(res, f"S=7 K=5 C={c} channels [{c0},{3 + c}), indices -2..N+2",
                        normal(3, 7, 5, 3 + c), wild, 1024, c0, 3 + c)
    # enhanced_pointnet2_ssg's sa1, whose features carry a gradient (the
    # positional encoding's), width 12
    level((), B, 4096, 1024, 32, 0.1, ENHANCED_SA1_FEATURES)
    # index_points' backward (IndexPoints): DGCNN's edge features at k = 20
    # and 64 over its graphs' shape, B=4, C=64, and BoundaryAwareModule's
    # over l1 (N = 1024, k = 16, C = 128); idx viewed as [B, N, k]
    for n, k, c in ((N, 20, 64), (N, 64, 64), (1024, 16, 128)):
        x = cloud(B, n)
        graph = grouping.knn(x, k=k)
        check_group_bwd(res, f"index_points [{B},{n},{k},{c}] -> [{B},{n},{c}]",
                        normal(B, n, k, c), graph, n, 0, c, timed=True)
    print(f"group_bwd: {res.order_exact} cases bit-identical to group_backward_order and "
          "the same bits call to call", flush=True)


# ------------------------------------------------------------------ phase 3f
# (B, k, F, launches a pass, path, moments) of K7's calls: the four
# EdgeConvs (F = 64, 64, 64, 128) of a dgcnn (k = 20) and a dgcnn_global
# (k = 64) forward at B = 4, and of the dgcnn train step (with the moments);
# at B = 16 the recipes' train steps; the sweep's dgcnn_k32 row (dgcnn_global
# at k = 32, B = 4), its forward and train step
EDGE_CASES = (
    (B, 20, 64, 3, DGCNN, False), (B, 20, 128, 1, DGCNN, False),
    (B, 64, 64, 3, DGCNN_GLOBAL, False), (B, 64, 128, 1, DGCNN_GLOBAL, False),
    (B, 20, 64, 3, DGCNN_TRAIN, True), (B, 20, 128, 1, DGCNN_TRAIN, True),
    (16, 20, 64, 3, DGCNN_TRAIN_B16, True), (16, 20, 128, 1, DGCNN_TRAIN_B16, True),
    (16, 64, 64, 3, DGCNN_GLOBAL_TRAIN_B16, True),
    (B, 32, 64, 3, DGCNN_K32, False), (B, 32, 128, 1, DGCNN_K32, False),
    (B, 32, 64, 3, DGCNN_K32_TRAIN, True), (B, 32, 128, 1, DGCNN_K32_TRAIN, True),
)
# (B, k, F) of the train shapes that --edge-split splits the first K7b at
EDGE_SPLIT_CASES = tuple((b, k, f) for b in (B, 16) for k in (20, 64) for f in (64, 128))
# K7b against its plain version (scatter_add_'s order) within this share of
# max|plain|, as K3b; against the plain version in K3b's order bit for bit
EDGE_BWD_TOL = BWD_TOL


def edge_inputs(dev, rng, b: int, k: int, f: int, n: int = N, s: int = N, grid: int = 0):
    """y [b, n, f] (normal, or integers in [0, grid): ties) and the k-NN
    graph [b, s, k] of a uniform cloud's first s points over its n (K5, as
    conv1 builds it: neighbours near in memory as in the model)."""
    a = rng.integers(0, grid, (b, n, f)) if grid else rng.normal(size=(b, n, f))
    y = torch.from_numpy(a.astype(np.float32)).to(dev)
    xyz = torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)
    return y, grouping.knn(xyz, xyz[:, :s].contiguous(), k)


def edge_work(y, idx, outs: int) -> tuple:
    """(bytes, operations) of K7: idx, y once and ``outs`` float outputs of
    4 bytes an element (the ties are not counted: they pass from K7 to K7b
    and the function needs neither their write nor their read); a compare
    each for the max and the min, an add and a multiply-add for the
    moments, a slot and channel."""
    b, s, k = idx.shape
    f = y.shape[2]
    return nbytes(y, idx) + outs * b * s * f * 4, b * s * k * f * (2 if outs == 2 else 5)


# The first design of K7 and K7b (probes/k7_probe.py), timed before and after
# the kernel at each timed case where FIRST_DESIGN_TURNS (--dgcnn, --edge):
# path -> kernel -> its sums, printed in braces
FIRST_DESIGN = {}
FIRST_DESIGN_TURNS = False


def first_design_times(fn, split: bool) -> dict:
    """Event ms and, with ``split``, device ms of the first design."""
    return {"ms": time_ms(fn)} | ({"device_ms": device_ms(fn)} if split else {})


def record_first_design(name: str, path: str, times: int, before: dict, after: dict) -> None:
    """Add the first design's turns before and after a timed case to its path's sums."""
    total = FIRST_DESIGN.setdefault(path, {}).setdefault(
        name, {"cases": 0, "ms": [0.0, 0.0], "device_ms": [0.0, 0.0]})
    total["cases"] += times
    for turn, got in enumerate((before, after)):
        for key, value in got.items():
            total[key][turn] += times * value
    line = f"event {before['ms']:.4f}, {after['ms']:.4f} ms"
    if "device_ms" in before:
        line += f", device {before['device_ms']:.4f}, {after['device_ms']:.4f} ms"
    print(f"{name:18s}   {{the first design, before and after: {line}}}", flush=True)


def check_edge_reduce(res: Results, label, y, idx, moments: bool, path=None, times=1,
                      split=False) -> None:
    """K7 against edge_reduce_plain on the same inputs: the max, the min and
    the ties bit for bit, the moments within 1e-6 * max(1, max|plain|) (the
    plain version folds the slots in the kernel's order: how many came out
    bit-identical is printed), with and without the ties (a train step's
    K7, with the moments, counts them); timed where ``path`` is a pass's,
    beside the gather and amax and amin of PyTorch (three calls) and, in
    braces, the first design (probes/k7_probe.py) where FIRST_DESIGN_TURNS."""
    kernel = functools.partial(edge_ops.edge_reduce_cuda, y, idx, moments, moments)
    plain = functools.partial(edge_ops.edge_reduce_plain, y, idx, moments, moments)
    got, want = kernel(), plain()
    other = edge_ops.edge_reduce_cuda(y, idx, moments, not moments)
    torch.cuda.synchronize()
    same = [torch.equal(g, w) for g, w in zip(got, want)]
    counted = got if moments else other
    if not all(torch.equal(a, b) for a, b in zip(got, other)):
        raise AssertionError(f"edge_reduce {label}: counting the ties changed an output")
    if not torch.equal(counted[-1], edge_ops.tie_counts_plain(y, idx, got[0], got[1])):
        raise AssertionError(f"edge_reduce {label}: ties differ from tie_counts_plain")

    def library():
        g = core_ops.index_points(y, idx)
        return g.amax(dim=2), g.amin(dim=2)

    timed = path is not None
    turns = timed and FIRST_DESIGN_TURNS
    first = functools.partial(k7_probe.edge_reduce_first, y, idx, moments)
    before = first_design_times(first, split) if turns else None
    res.check("edge_reduce", f"{label}{' moments, ties' if moments else ''}", kernel,
              plain, (True, True, False, False, True)[:len(got)], (path,)
              if timed else (), scaled=(1e-6, 1.0),
              work=edge_work(y, idx, 4 if moments else 2) if timed else None,
              library_fn=library if timed else None, times=times, split=split)
    if turns:
        record_first_design("edge_reduce", path, times, before, first_design_times(first, split))
    sums = f"; s1, s2 bit-identical to the plain fold: {same[2]}, {same[3]}" if moments else ""
    print(f"{'edge_reduce':18s} {label}: ties bit for bit against tie_counts_plain{sums}",
          flush=True)


def check_edge_reduce_bwd(res: Results, label, y, idx, moments: bool, rng, path=None, times=1,
                          split=False, autograd=False) -> None:
    """K7b (and the K3b fold it calls) against the plain backward: bit for
    bit against the per-edge gradients folded in K3b's order
    (group_backward_order), within EDGE_BWD_TOL of max|plain| of scatter_add_'s
    fold (timed where ``path`` is a pass's), the same bits on a second call;
    with ``autograd`` within EDGE_BWD_TOL against torch's autograd of
    index_points, amax, amin and the means."""
    *outs, ties = edge_ops.edge_reduce_cuda(y, idx, moments, True)
    cots = tuple(torch.from_numpy(rng.normal(size=tuple(outs[0].shape)).astype(np.float32))
                 .to(y.device) for _ in outs)
    args = (y, idx, outs[0], outs[1]) + cots
    kernel = functools.partial(edge_ops.edge_reduce_backward_cuda, *args, ties=ties)
    first, second = kernel(), kernel()
    ordered = grouping.group_backward_order(edge_ops.edge_grads_plain(*args), idx, y.shape[1], 0,
                                            y.shape[2])
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError(f"edge_reduce_bwd {label}: two calls differ")
    if not torch.equal(first, ordered):
        raise AssertionError(f"edge_reduce_bwd {label}: differs from the plain per-edge "
                             f"gradients in K3b's order by {max_abs_err(first, ordered)}")
    timed = path is not None
    b, s, k = idx.shape
    f = y.shape[2]
    # bytes: y, idx, mx, mn and the cotangents read once, the gradient
    # written once (not the ties, which pass from K7 to K7b)
    work = (nbytes(y, idx, *args[2:]) + y.numel() * 4, b * s * k * f * 8)
    turns = timed and FIRST_DESIGN_TURNS
    slow = functools.partial(k7_probe.edge_reduce_backward_first, *args)
    before = first_design_times(slow, split) if turns else None
    route = "staged" if edge_ops.edge_fold_staged(s) else "from device memory"
    res.check("edge_reduce_bwd", f"{label}{' moments' if moments else ''} ({route})", kernel,
              functools.partial(edge_ops.edge_reduce_backward_plain, *args), False,
              (path,) if timed else (), scaled=(EDGE_BWD_TOL, 0.0),
              work=work if timed else None, times=times, split=split)
    if turns:
        record_first_design("edge_reduce_bwd", path, times, before, first_design_times(slow, split))
    line = "the same bits twice, bit for bit against the plain order"
    if autograd:
        ya = y.detach().clone().requires_grad_(True)
        g = core_ops._gather(ya, idx)
        ref = (g.amax(dim=2), g.amin(dim=2), g.mean(dim=2), (g * g).mean(dim=2))[:len(outs)]
        sum((r * c).sum() for r, c in zip(ref, cots)).backward()
        err = max_abs_err(first, ya.grad)
        if err > EDGE_BWD_TOL * ya.grad.abs().max().item():
            raise AssertionError(f"edge_reduce_bwd {label}: {err} from torch's autograd")
        line += f"; max|err| {err:.3g} against torch's autograd of the reductions"
    print(f"{'edge_reduce_bwd':18s} {label}: {line}", flush=True)


def compare_edge_kernels(dev: torch.device, res: Results, rng) -> None:
    """Phase 3f: K7 and K7b against their plain versions at the shapes of
    the DGCNN forwards and train steps (EDGE_CASES), on an integer grid
    (ties in most rows), and at the edges of their launch (one float a
    lane, two chunks of channels, k = 1, S != N, indices past N, a view
    off 16-byte alignment)."""
    for b, k, f, times, path, moments in EDGE_CASES:
        y, idx = edge_inputs(dev, rng, b, k, f)
        label = f"B={b} N=S={N} k={k} F={f}"
        check_edge_reduce(res, label, y, idx, moments, path, times, split=True)
        if moments:
            check_edge_reduce_bwd(res, label, y, idx, True, rng, path, times, split=True,
                                  autograd=(b, k, f) == (B, 20, 64))
    y, idx = edge_inputs(dev, rng, 2, 20, 64, grid=4)
    check_edge_reduce(res, "integer grid (ties) B=2 k=20 F=64", y, idx, True)
    check_edge_reduce_bwd(res, "integer grid (ties) B=2 k=20 F=64", y, idx, True, rng,
                          autograd=True)
    check_edge_reduce_bwd(res, "eval mode B=4 k=20 F=64", *edge_inputs(dev, rng, B, 20, 64),
                          False, rng, autograd=True)
    for label, b, k, f, n, s in (("F=24 (a float a lane)", 2, 8, 24, 1000, 1000),
                                 ("F=3", 2, 8, 3, 1000, 1000),
                                 ("F=66 (2 chunks of 2 a lane)", 2, 20, 66, 1000, 1000),
                                 ("F=256 (2 chunks of 4 a lane)", 2, 20, 256, 1000, 1000),
                                 ("k=1", 2, 1, 64, 1000, 1000),
                                 ("S=700 of N=1000, k=40", 2, 40, 64, 1000, 700),
                                 # K7b's fold from device memory (S rows of
                                 # records past a block's shared memory)
                                 ("N=S=12000 (K7b unstaged)", 1, 20, 66, 12000, 12000)):
        y, idx = edge_inputs(dev, rng, b, k, f, n, s)
        check_edge_reduce(res, label, y, idx, True)
        check_edge_reduce_bwd(res, label, y, idx, True, rng)
    y, idx = edge_inputs(dev, rng, 2, 20, 64, 1000, 1000)
    idx[:, ::7, 3] = 1000  # past N: read as point N - 1, as index_points clamps
    check_edge_reduce(res, "indices past N", y, idx, True)
    check_edge_reduce_bwd(res, "indices past N", y, idx, True, rng)
    view = torch.empty(2 * 1000 * 64 + 1, device=dev)[1:].view(2, 1000, 64)
    view.copy_(y)
    if edge_ops.edge_vec(64, view) != 1:
        raise AssertionError("edge reduce: a view off 16-byte alignment must take a float a lane")
    check_edge_reduce(res, "y 4 bytes off 16-byte alignment", view, idx, True)
    check_edge_reduce_bwd(res, "y 4 bytes off 16-byte alignment", view, idx, True, rng)
    res.print_sums("edge_reduce", (DGCNN, DGCNN_GLOBAL, DGCNN_TRAIN, DGCNN_TRAIN_B16,
                                   DGCNN_GLOBAL_TRAIN_B16, DGCNN_K32, DGCNN_K32_TRAIN))
    res.print_sums("edge_reduce_bwd", (DGCNN_TRAIN, DGCNN_TRAIN_B16, DGCNN_GLOBAL_TRAIN_B16,
                                       DGCNN_K32_TRAIN))
    for path, kernels in FIRST_DESIGN.items():
        for name, t in kernels.items():
            print(f"{name:18s} sum over {path} ({t['cases']} launches), the first design before "
                  f"and after the kernel: {{event {t['ms'][0]:.4f}, {t['ms'][1]:.4f} ms, device "
                  f"{t['device_ms'][0]:.4f}, {t['device_ms'][1]:.4f} ms}}", flush=True)


def packed_qkv_maker(dev: torch.device, seed: int, dtype=torch.float32):
    """-> make(n, h, d, fold=1, b=B): q, k and v [b * fold, n / fold, h, d]
    as PointAttention makes them, the strided slices of one packed qkv
    projection (row stride 3*h*d) of LayerNorm output, in ``dtype``;
    ``fold`` is the number of windows a cloud, folded into the batch by a
    reshape of those views."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)

    def make(n, h, d, fold=1, b=B):
        c = h * d
        x = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dev)
        qkv = Dense(c, 3 * c, generator=gen).to(dev)
        with torch.no_grad():
            out = qkv(torch.nn.functional.layer_norm(x, (c,))).to(dtype)
        views = out.reshape(b, n, 3, h, d).unbind(2)
        q, k, v = (t.reshape(b * fold, n // fold, h, d) for t in views)
        if n > fold and q.stride(1) != 3 * c:
            raise AssertionError(f"packed qkv [{b * fold},{n // fold},{h},{d}]: not a view")
        return q, k, v

    return make


def large_scores(q, k, v):
    """q and k scaled by one factor so that max|q . k / sqrt(D)| is
    LARGE_SCORE; -> (q, k, v, the largest scaled score as measured)."""
    f = (LARGE_SCORE / attention._scores(q, k).abs().max().item()) ** 0.5
    q, k = q * f, k * f
    top = attention._scores(q, k).abs().max().item()
    if top < 50.0:
        raise AssertionError(f"large-magnitude case: max|S| {top}")
    return q, k, v, top


# (label, n, h, d, fold, batch, the forward paths that give the kernel this
# shape, how often a pass, timed) of phases 3c and 3d. ptv3_pooled at 4096
# points: level 0 in four windows of 1024 (2 heads), level 1 (1024 points, 4
# heads) and level 2 (256 points, 8 heads) global; the benched depths run
# them 3, 3 and 6 times a pass. Flat ptv3: global attention over 4096 points,
# its default 2 heads of 192 (FLAT_DEPTH blocks a pass in phases 11 and 15)
# and the 6 heads of 64 of the wider config. Then ragged lengths (no multiple of the 64-row tile), one
# row, the serve's batch 16, the other head widths.
ATTENTION_CASES = (
    ("[16,1024,2,32] level 0 windows", 4096, 2, 32, 4, B, PTV3_POOLED, 3, True),
    ("[4,1024,4,32] level 1", 1024, 4, 32, 1, B, PTV3_POOLED, 3, True),
    ("[4,256,8,32] level 2", 256, 8, 32, 1, B, PTV3_POOLED, 6, True),
    ("[4,4096,2,192] flat ptv3", 4096, 2, 192, 1, B, PTV3, FLAT_DEPTH, True),
    ("[4,4096,6,64] flat ptv3, 6 heads", 4096, 6, 64, 1, B, None, 1, True),
    # a ring block of flat ptv3's sequence parallelism over two ranks
    # (phase 44): each of the 8 blocks' attention is P = 2 calls at N/2
    ("[4,2048,2,192] ring block, N/2", 2048, 2, 192, 1, B, SP_RING, 16, True),
    ("[4,200,2,32] ragged", 200, 2, 32, 1, B, None, 1, False),
    ("[4,1000,4,32] ragged", 1000, 4, 32, 1, B, None, 1, False),
    ("[4,1,2,32] one row", 1, 2, 32, 1, B, None, 1, False),
    ("[64,1024,2,32] batch 16 windows", 4096, 2, 32, 4, 16, None, 1, False),
) + tuple((f"[2,333,2,{d}] ragged", 333, 2, d, 1, 2, None, 1, False)
          for d in (96, 128, 160, 224, 256)
) + tuple((f"[2,{n},2,{d}] ragged", n, 2, d, 1, 2, None, 1, False)
          # one past a 64-row tile, one past two, one short of the last
          for d in (32, 192) for n in (65, 129, 4095))
# the large-magnitude case: q and k of [4,1024,2,192] scaled so that the
# largest scaled score is LARGE_SCORE, where the error of a split product
# shows (a score's error goes into the exponent)
LARGE_SCORE = 55.0
TRAIN_PATH_OF = {PTV3_POOLED: PTV3_POOLED_TRAIN, PTV3: PTV3_TRAIN, SP_RING: SP_RING_TRAIN}


def compare_attention_kernel(dev: torch.device, res: Results) -> None:
    """Phase 3c: the flash-attention kernel against the plain attention at
    the shapes the PTv3 family gives it at B=4 x 4096 (ATTENTION_CASES), on
    packed-qkv views."""
    packed_qkv = packed_qkv_maker(dev, SEED + 2)

    def case(label, q, k, v, paths=(), times=1, timed=True):
        b, n, h, d = q.shape
        work = (4 * nbytes(q), 4 * b * h * n * n * d) if timed else None
        # the library call takes [B, H, N, D]: the same memory, transposed views
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        res.check("flash_attn", label,
                  lambda: attention.attention_cuda(q, k, v),
                  lambda: attention.attention_plain(q, k, v), False, paths,
                  scaled=(ATTN_TOL, 1.0), work=work, times=times, peak_flops=PEAK_FLOPS_3XTF32,
                  library_fn=lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))

    for label, n, h, d, fold, b, path, times, timed in ATTENTION_CASES:
        case(label, *packed_qkv(n, h, d, fold, b), (path,) if path else (), times, timed)
    for d in (32, 192):
        q, k, v, top = large_scores(*packed_qkv(1024, 2, d))
        case(f"[4,1024,2,{d}] max|S| {top:.1f}", q, k, v, timed=False)
    # a contiguous tensor passes too, and the result is contiguous [B,N,H,D]
    q, k, v = (t.contiguous() for t in packed_qkv(130, 2, 64))
    out = attention.attention(q, k, v)
    want = attention.attention_plain(q, k, v)
    if not out.is_contiguous() or max_abs_err(out, want) > ATTN_TOL * max(1.0, want.abs().max().item()):
        raise AssertionError("flash_attn contiguous [4,130,2,64]: kernel disagrees")


def compare_attention_backward(dev: torch.device, res: Results) -> None:
    """Phase 3d: the two attention-backward kernels against
    attention_backward_plain at the shapes of phase 3c, on packed-qkv views
    and a random cotangent: each of dq, delta, dk, dv within ATTN_TOL *
    max(1, max|plain|) (no atomics: the sums are re-associated, and the same
    from run to run). Beside it: the forward's lse within 1e-5 of
    torch.logsumexp, its output bit-identical with and without lse,
    attention_backward_plain against autograd through attention_plain, and
    the Function's gradient reaching a packed projection. A timed case also
    times the forward with lse and, as the library call, the backward alone
    of F.scaled_dot_product_attention in float32 on a kept graph (dq alone,
    dk and dv alone, and all three beside the two kernels together). The
    bound counts the products a function cannot do without: S, dP and dS . k
    for dq (6 B H N^2 D operations), S, dP, P^T . do and dS^T . q for dk and
    dv (8), five for all three (10)."""
    packed_qkv = packed_qkv_maker(dev, SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    def band(name, label, got, want):
        err = max_abs_err(got, want)
        if err > ATTN_TOL * max(1.0, want.abs().max().item()):
            raise AssertionError(f"{name} {label}: max |err| {err}")
        return err

    def case(label, q, k, v, paths, times, timed):
        b, n, h, d = q.shape
        g = normal(b, n, h, d)

        # the forward with lse: the same output bit for bit, lse as logsumexp
        out, lse = attention.attention_cuda(q, k, v, need_lse=True)
        if not torch.equal(out, attention.attention_cuda(q, k, v)):
            raise AssertionError(f"flash_attn {label}: writing lse changed the output")
        want_out = attention.attention_plain(q, k, v)
        want_lse = torch.logsumexp(attention._scores(q, k), dim=-1)
        want_delta = (want_out * g).sum(-1).transpose(1, 2).contiguous()
        lse_err = max_abs_err(lse, want_lse)
        # float32 is spaced 3.8e-6 apart at 55: a large lse is held to 1e-6 of itself
        if lse_err > max(1e-5, 1e-6 * want_lse.abs().max().item()):
            raise AssertionError(f"flash_attn {label}: lse differs from logsumexp by {lse_err}")

        def plain_backward():
            return attention.attention_backward_plain(q, k, v, want_out, want_lse, g)

        # the plain backward against autograd through the plain forward
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(attention.attention_plain(*leaves), leaves, g)
        plain_err = max(band("attention_backward_plain vs autograd", label, got, want)
                        for got, want in zip(plain_backward(), auto))
        print(f"{'attention':18s} {label:34s} lse max|err| {lse_err:.3g}  plain backward vs "
              f"autograd max|err| {plain_err:.3g}", flush=True)
        del leaves, auto

        size, ops, stats = nbytes(q), b * h * n * n * d, nbytes(lse)
        work, library = {}, {}
        if timed:
            work = {"fwd": (4 * size + stats, 4 * ops), "dq": (6 * size + 2 * stats, 6 * ops),
                    "dkv": (6 * size + 2 * stats, 8 * ops)}
            # the library call takes [B, H, N, D]: the same memory, transposed views
            qt, kt, vt = (t.transpose(1, 2).requires_grad_() for t in (q, k, v))
            lib_out, gt = sdpa(qt, kt, vt), g.transpose(1, 2)
            library = {name: (lambda wrt=wrt: torch.autograd.grad(lib_out, wrt, gt,
                                                                 retain_graph=True))
                       for name, wrt in (("dq", (qt,)), ("dkv", (kt, vt)),
                                         ("all", (qt, kt, vt)))}
            res.check("flash_attn", label + " +lse",
                      lambda: attention.attention_cuda(q, k, v, need_lse=True),
                      lambda: (attention.attention_plain(q, k, v),
                               torch.logsumexp(attention._scores(q, k), dim=-1)),
                      False, paths, scaled=(ATTN_TOL, 1.0), work=work["fwd"], times=times,
                      peak_flops=PEAK_FLOPS_3XTF32, library_fn=lambda: sdpa(qt, kt, vt))
        dq, delta = attention.attention_backward_dq_cuda(q, k, v, out, lse, g)
        # the same bits from run to run: no atomics, a fixed order of sums
        again = (attention.attention_backward_dq_cuda(q, k, v, out, lse, g)
                 + attention.attention_backward_dkv_cuda(q, k, v, lse, delta, g)
                 + attention.attention_backward_dkv_cuda(q, k, v, lse, delta, g))
        for name, a, b2 in (("dq", dq, again[0]), ("delta", delta, again[1]),
                            ("dk", again[2], again[4]), ("dv", again[3], again[5])):
            if not torch.equal(a, b2):
                raise AssertionError(f"flash_attn_bwd {label}: {name} differs from run to run")
        del dq, again
        res.check("flash_attn_bwd_dq", label,
                  lambda: attention.attention_backward_dq_cuda(q, k, v, out, lse, g),
                  lambda: (plain_backward()[0], want_delta),
                  False, paths, scaled=(ATTN_TOL, 1.0), work=work.get("dq"), times=times,
                  peak_flops=PEAK_FLOPS_3XTF32, library_fn=library.get("dq"))
        res.check("flash_attn_bwd_dkv", label,
                  lambda: attention.attention_backward_dkv_cuda(q, k, v, lse, delta, g),
                  lambda: plain_backward()[1:],
                  False, paths, scaled=(ATTN_TOL, 1.0), work=work.get("dkv"), times=times,
                  peak_flops=PEAK_FLOPS_3XTF32, library_fn=library.get("dkv"))
        if timed:
            both = time_ms(lambda: attention.attention_backward_cuda(q, k, v, out, lse, g))
            bytes_s = (10 * size + 2 * stats) / PEAK_BYTES_S
            bound = max(bytes_s, 10 * ops / PEAK_FLOPS_3XTF32) * 1e3
            fma_bound = max(bytes_s, 10 * ops / PEAK_FLOPS) * 1e3
            print(f"{'attention':18s} {label:34s} dq, dk and dv together: kernels {both:.4f} ms"
                  f"  bound {bound:.5f} ms  over FMAs {fma_bound:.5f} ms  library backward "
                  f"{time_ms(library['all']):.4f} ms", flush=True)

    for label, n, h, d, fold, b, path, times, timed in ATTENTION_CASES:
        case(label, *packed_qkv(n, h, d, fold, b),
             (TRAIN_PATH_OF[path],) if path else (), times, timed)
    for d in (32, 192):
        q, k, v, top = large_scores(*packed_qkv(1024, 2, d))
        case(f"[4,1024,2,{d}] max|S| {top:.1f}", q, k, v, (), 1, False)

    # through the Function: the gradient that reaches a packed projection
    # through the three views and a window fold, against the plain version's
    x = normal(2, 256, 3 * 64)
    g = normal(4, 128, 2, 32)
    grads = []
    for fn in (attention.attention, attention.attention_plain):
        leaf = x.clone().requires_grad_()
        q, k, v = (t.reshape(4, 128, 2, 32) for t in leaf.reshape(2, 256, 3, 2, 32).unbind(2))
        grads.append(torch.autograd.grad(fn(q, k, v), leaf, g)[0])
    err = band("attention Function", "gradient of a packed qkv", *grads)
    print(f"{'attention':18s} {'Function on a folded packed qkv':34s} max|err| {err:.3g}",
          flush=True)


# the bf16 flavours of K6 and K6b (phase 3e): bands in bf16 roundings,
# eps = 2^-8 (the spacing of bf16 is eps to 2 eps of a value, a rounding is
# within half of it), scaled by the plain version's own values: a result
# that rounds to the neighbouring bf16 of the plain one parts by one
# spacing, at most 2 eps * max|plain|
BF16_EPS = 2.0 ** -8
BF16_OUT_TOL = 2 * BF16_EPS  # of max|plain|: O, one spacing at its largest value
BF16_GRAD_TOL = 4 * BF16_EPS  # of max|plain|: dq, dk, dv, two spacings
BF16_RMS_TOL = BF16_EPS  # of the plain's root mean square: the error's, every output
# absolute, beside both: the float32 noise of dS = P (dP - delta) where the
# two nearly cancel (at N = 1 they cancel exactly, and dq and dk are that
# noise, ~1e-7 at inputs of unit scale)
BF16_ATOL = 2.0 ** -20
BF16_LSE_TOL = 1e-5  # relative: lse is float32 from exact bf16 products
# dense bf16 tensor-core rate of the H100 SXM at 700 W (NVIDIA data sheet)
PEAK_FLOPS_BF16 = 989e12
# paths of the bf16 kernels: the configs/train_ptv3_big_prod.yaml step
# (batch 16 as 4 microbatches of 4, 12 blocks of 6 heads of 64, remat: the
# forward kernel runs twice a block and microbatch, the backward once), the
# bf16-stream forwards of ptv3 (8 blocks, 2 heads of 192) and ptv3_pooled
PROD_TRAIN = "ptv3_big_prod_train_step"
PTV3_BF16, POOLED_BF16 = "ptv3_bf16_forward", "ptv3_pooled_bf16_forward"
PROD_DEPTH, PROD_ACCUM = 12, 4
# (label, n, h, d, fold, batch, [(path, forward launches a pass, backward
# launches a pass)], timed) of phase 3e
ATTENTION_BF16_CASES = (
    ("[4,4096,6,64] prod microbatch", 4096, 6, 64, 1, B,
     [(PROD_TRAIN, 2 * PROD_DEPTH * PROD_ACCUM, PROD_DEPTH * PROD_ACCUM)], True),
    ("[4,4096,2,192] ptv3, ptv3_moe", 4096, 2, 192, 1, B, [(PTV3_BF16, 8, 0)], True),
    # the sweep's ptv3_win_bf16 row: 8 blocks of 2 heads of 192 on Morton
    # windows of 512 (8 a cloud, folded into the batch); its forward and
    # train step
    ("[32,512,2,192] ptv3_win_bf16 windows", 4096, 2, 192, 8, B,
     [(PTV3_WIN_BF16, 8, 0), (PTV3_WIN_BF16_TRAIN, 8, 8)], True),
    ("[16,1024,2,32] pooled level 0 windows", 4096, 2, 32, 4, B, [(POOLED_BF16, 3, 0)], True),
    ("[4,1024,4,32] pooled level 1", 1024, 4, 32, 1, B, [(POOLED_BF16, 3, 0)], True),
    ("[4,256,8,32] pooled level 2", 256, 8, 32, 1, B, [(POOLED_BF16, 6, 0)], True),
    ("[4,200,2,32] ragged", 200, 2, 32, 1, B, [], False),
    ("[4,1000,4,64] ragged", 1000, 4, 64, 1, B, [], False),
    ("[4,1,2,32] one row", 1, 2, 32, 1, B, [], False),
    ("[2,333,2,256] ragged, D=256", 333, 2, 256, 1, 2, [], False),
) + tuple((f"[2,{n},2,{d}] ragged", n, 2, d, 1, 2, [], False)
          for d in (96, 128, 160, 224) for n in (65, 4095))


def compare_attention_bf16(dev: torch.device, res: Results) -> None:
    """Phase 3e: the bf16 flash-attention kernels (forward; dq and delta;
    dk and dv) against attention_plain and attention_backward_plain in bf16
    at the shapes the bf16 paths give them (ATTENTION_BF16_CASES), on bf16
    packed-qkv views: O within BF16_OUT_TOL * max|plain|, dq, dk, dv within
    BF16_GRAD_TOL * max|plain|, each also with the root mean square of its
    error within BF16_RMS_TOL of the plain's (both bands plus BF16_ATOL);
    lse within 1e-5 relative of torch.logsumexp over the float32 scores,
    delta within ATTN_TOL * max(1, max|plain|); each backward kernel the
    same bits from one call to the next. Then every row stride and
    alignment that the checks accept: contiguous q, k, v, a row stride
    padded by 8 elements, and a view off 16-byte alignment (copied by the
    wrapper), with a gradient off alignment too (copied by
    attention_backward_cuda, refused by the kernels' wrappers). A timed case times the
    kernels beside the bound (4 B H N^2 D operations forward, 6 for dq, 8
    for dk and dv, over the dense bf16 tensor rate; the bytes over 3.35
    TB/s) and beside F.scaled_dot_product_attention in bf16, forward and its
    backward on a kept graph."""
    packed_qkv = packed_qkv_maker(dev, SEED + 5, torch.bfloat16)
    rng = np.random.default_rng(SEED + 5)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def band(name, label, got, want, tol):
        """-> (max|err|, max|err| over its band, rms(err) over its band)."""
        err = max_abs_err(got, want)
        diff = got.float() - want.float()
        rms_err = diff.square().mean().sqrt().item()
        rms = want.float().square().mean().sqrt().item()
        bands = (tol * want.abs().max().item() + BF16_ATOL, BF16_RMS_TOL * rms + BF16_ATOL)
        if not (err <= bands[0] and rms_err <= bands[1]):  # NaN fails too
            raise AssertionError(f"{name} {label}: max |err| {err} (band {bands[0]}), "
                                 f"rms(err) {rms_err} (band {bands[1]})")
        return err, err / bands[0], rms_err / bands[1]

    def case(label, q, k, v, paths=(), timed=False):
        b, n, h, d = q.shape
        g = torch.from_numpy(rng.normal(size=(b, n, h, d)).astype(np.float32)).to(dev)
        g = g.to(torch.bfloat16)
        out, lse = attention.attention_cuda(q, k, v, need_lse=True)
        if out.dtype != torch.bfloat16 or not torch.equal(out, attention.attention_cuda(q, k, v)):
            raise AssertionError(f"flash_attn_bf16 {label}: writing lse changed the output")
        want_out, scores = attention._forward_plain(q, k, v)
        want_lse = torch.logsumexp(scores, dim=-1)
        del scores
        out_err = band("flash_attn_bf16", label, out, want_out, BF16_OUT_TOL)
        lse_err = (lse - want_lse).abs().div(want_lse.abs().clamp(min=1.0)).max().item()
        if lse_err > BF16_LSE_TOL:
            raise AssertionError(f"flash_attn_bf16 {label}: lse differs by {lse_err} relative")
        # delta of the kernel's own output, which the dq kernel reads
        want_delta = (out.float() * g.float()).sum(-1).transpose(1, 2).contiguous()
        dq, delta = attention.attention_backward_dq_cuda(q, k, v, out, lse, g)
        dk, dv = attention.attention_backward_dkv_cuda(q, k, v, lse, delta, g)
        again = (attention.attention_backward_dq_cuda(q, k, v, out, lse, g)
                 + attention.attention_backward_dkv_cuda(q, k, v, lse, delta, g))
        for name, a, b2 in (("dq", dq, again[0]), ("delta", delta, again[1]),
                            ("dk", dk, again[2]), ("dv", dv, again[3])):
            if not torch.equal(a, b2):
                raise AssertionError(f"flash_attn_bwd_bf16 {label}: {name} differs from run to run")
        del again
        want = attention.attention_backward_plain(q, k, v, out, lse, g)
        errs = [band(f"flash_attn_bwd_bf16 {name}", label, got, w, BF16_GRAD_TOL)
                for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)]
        del want
        delta_err = max_abs_err(delta, want_delta)
        if delta_err > ATTN_TOL * max(1.0, want_delta.abs().max().item()):
            raise AssertionError(f"flash_attn_bwd_dq_bf16 delta {label}: max |err| {delta_err}")
        print(f"{'attention bf16':18s} {label:34s} max|err| [of its band, rms(err) of its "
              "band]: " + ", ".join(f"{name} {e[0]:.3g} [{e[1]:.3f}, {e[2]:.3f}]" for name, e in
                                    zip(("O", "dq", "dk", "dv"), [out_err] + errs))
              + f"; lse rel {lse_err:.3g}, delta {delta_err:.3g}", flush=True)
        if not timed:
            return
        size, ops, stats = nbytes(q), b * h * n * n * d, nbytes(lse)
        qt, kt, vt = (t.transpose(1, 2).requires_grad_() for t in (q, k, v))
        lib_out, gt = sdpa(qt, kt, vt), g.transpose(1, 2)

        def lib_grad(*wrt):
            return lambda: torch.autograd.grad(lib_out, wrt, gt, retain_graph=True)

        for path, fwd_times, bwd_times in paths or [(None, 1, 1)]:
            pp = (path,) if path else ()
            need_lse = bool(bwd_times) and path is not None
            res.check("flash_attn_bf16", label + (" +lse" if need_lse else ""),
                      lambda: attention.attention_cuda(q, k, v, need_lse=need_lse),
                      lambda: attention.attention_plain(q, k, v) if not need_lse else (
                          attention.attention_plain(q, k, v),
                          torch.logsumexp(attention._scores(q.float(), k.float()), dim=-1)),
                      False, pp, scaled=(BF16_OUT_TOL, 0.0),
                      work=(4 * size + (stats if need_lse else 0), 4 * ops), times=fwd_times,
                      peak_flops=PEAK_FLOPS_BF16, library_fn=lambda: sdpa(qt, kt, vt))
            bp = pp if bwd_times else ()
            bt = bwd_times or 1
            res.check("flash_attn_bwd_dq_bf16", label,
                      lambda: attention.attention_backward_dq_cuda(q, k, v, out, lse, g)[0],
                      lambda: attention.attention_backward_plain(q, k, v, out, lse, g)[0],
                      False, bp, scaled=(BF16_GRAD_TOL, 0.0),
                      work=(6 * size + 2 * stats, 6 * ops), times=bt,
                      peak_flops=PEAK_FLOPS_BF16, library_fn=lib_grad(qt))
            res.check("flash_attn_bwd_dkv_bf16", label,
                      lambda: attention.attention_backward_dkv_cuda(q, k, v, lse, delta, g),
                      lambda: attention.attention_backward_plain(q, k, v, out, lse, g)[1:],
                      False, bp, scaled=(BF16_GRAD_TOL, 0.0),
                      work=(6 * size + 2 * stats, 8 * ops), times=bt,
                      peak_flops=PEAK_FLOPS_BF16, library_fn=lib_grad(kt, vt))
            # device time a call: 20 calls in a CUDA graph between two events
            dev_ms = {
                "flash_attn_bf16": (device_ms(
                    lambda: attention.attention_cuda(q, k, v, need_lse=need_lse)), fwd_times, pp),
                "flash_attn_bwd_dq_bf16": (device_ms(
                    lambda: attention.attention_backward_dq_cuda(q, k, v, out, lse, g)), bt, bp),
                "flash_attn_bwd_dkv_bf16": (device_ms(
                    lambda: attention.attention_backward_dkv_cuda(q, k, v, lse, delta, g)), bt, bp),
            }
            for name, (ms, times, on) in dev_ms.items():
                res.add(name, on, "device_ms", times * ms)
            # host time a call: checks, three or four tensor maps encoded, launch
            host = {
                "flash_attn_bf16": host_us(
                    lambda: attention.attention_cuda(q, k, v, need_lse=need_lse), calls=200),
                "flash_attn_bwd_dq_bf16": host_us(
                    lambda: attention.attention_backward_dq_cuda(q, k, v, out, lse, g), calls=200),
                "flash_attn_bwd_dkv_bf16": host_us(
                    lambda: attention.attention_backward_dkv_cuda(q, k, v, lse, delta, g),
                    calls=200),
            }
            print(f"{'attention bf16':18s} {label:34s} device ms a call: " + ", ".join(
                f"{name} {ms:.4f}" for name, (ms, _, _) in dev_ms.items()) + "; host us a call: "
                + ", ".join(f"{name} {us:.1f}" for name, us in host.items()), flush=True)
        both = time_ms(lambda: attention.attention_backward_cuda(q, k, v, out, lse, g))
        bound = max((10 * size + 2 * stats) / PEAK_BYTES_S, 10 * ops / PEAK_FLOPS_BF16) * 1e3
        print(f"{'attention bf16':18s} {label:34s} dq, dk and dv together: kernels {both:.4f} ms"
              f"  bound {bound:.5f} ms  library backward "
              f"{time_ms(lib_grad(qt, kt, vt)):.4f} ms", flush=True)

    for label, n, h, d, fold, b, paths, timed in ATTENTION_BF16_CASES:
        case(label, *packed_qkv(n, h, d, fold, b), paths, timed)
    q, k, v, top = large_scores(*(t.float() for t in packed_qkv(1024, 2, 192)))
    case(f"[4,1024,2,192] max|S| {top:.1f}", *(t.to(torch.bfloat16) for t in (q, k, v)))
    # every layout the checks accept: contiguous; a row stride of H*D + 8
    # (rows 16 bytes apart, read in place); a view 2 bytes off 16-byte
    # alignment (copied by the wrapper)
    q, k, v = (t.contiguous() for t in packed_qkv(130, 2, 64))
    case("[4,130,2,64] contiguous", q, k, v)
    wide = torch.from_numpy(rng.normal(size=(3, B, 130, 2 * 64 + 8)).astype(np.float32))
    wide = wide.to(dev, torch.bfloat16)
    q, k, v = (t[..., :128].unflatten(-1, (2, 64)) for t in wide)
    if q.stride(1) != 136:
        raise AssertionError("padded rows: not a view")
    case("[4,130,2,64] row stride 136", q, k, v)
    flat = torch.from_numpy(rng.normal(size=(3, B * 130 * 128 + 1)).astype(np.float32))
    flat = flat.to(dev, torch.bfloat16)
    q, k, v = (t[1:].view(B, 130, 2, 64) for t in flat)
    if q.data_ptr() % 16 == 0:
        raise AssertionError("misaligned view: aligned")
    case("[4,130,2,64] 2 bytes off alignment", q, k, v)
    # a gradient 2 bytes off alignment: the Function's backward copies it,
    # the kernels' wrappers refuse it
    out, lse = attention.attention_cuda(q, k, v, need_lse=True)
    g_flat = torch.from_numpy(rng.normal(size=B * 130 * 128 + 1).astype(np.float32))
    g_off = g_flat.to(dev, torch.bfloat16)[1:].view(B, 130, 2, 64)
    if g_off.data_ptr() % 16 == 0:
        raise AssertionError("misaligned gradient: aligned")
    for wrapper in (lambda: attention.attention_backward_dq_cuda(q, k, v, out, lse, g_off),
                    lambda: attention.attention_backward_dkv_cuda(q, k, v, lse, lse, g_off)):
        try:
            wrapper()
        except ValueError:
            pass
        else:
            raise AssertionError("attention backward: a gradient off alignment was taken")
    got = attention.attention_backward_cuda(q, k, v, out, lse, g_off)
    want = attention.attention_backward_cuda(q, k, v, out, lse, g_off.clone())
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("attention backward: a gradient off alignment changed the result")
    print(f"{'attention bf16':18s} {'[4,130,2,64] gradient off alignment':34s} refused by the "
          "wrappers, copied by the Function: the same bits", flush=True)
    # mixed types raise
    try:
        attention.attention(q, k.float(), v)
    except TypeError:
        pass
    else:
        raise AssertionError("attention: bf16 q with float32 k did not raise")


def randomize_bn(model: torch.nn.Module, gen: torch.Generator) -> None:
    """BatchNorm affine and statistics away from the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.num_features
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))


def make_dataset(data_dir: Path) -> BlockDataset:
    """Two synthetic 200k-point bridge scenes as LAS -> 4096-point blocks."""
    data_dir.mkdir(parents=True, exist_ok=True)
    files = []
    for s in (0, 1):
        xyz, rgb, labels = toy_bridge_scene(200_000, seed=s)
        path = data_dir / f"bridge_{s}.las"
        write_las(str(path), xyz, rgb, labels)
        files.append(str(path))
    return BlockDataset.from_files(files, num_points=N, num_classes=NUM_CLASSES)


def counts_all_launched(where: str, kernels) -> dict:
    counts = _kernels.launch_counts()
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{where}: kernels never launched: {missing} ({counts})")
    return counts


def pre_bn_biases(model, xyz, rgb) -> set:
    """The biases that feed a BatchNorm: those of each layer whose output is
    a BatchNorm's input, found by one forward with hooks. In train mode the
    batch mean takes such a bias out again, so its gradient is exactly 0 and
    any float32 value of it is rounding noise."""
    made, fed, hooks = {}, set(), []
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp: fed.add(made.get(id(inp[0])))))
        elif isinstance(getattr(m, "bias", None), torch.nn.Parameter):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: made.__setitem__(id(out), name)))
    dev = next(model.parameters()).device
    training = model.training
    model.eval()  # no BatchNorm statistic moves
    try:
        with torch.no_grad():
            model(xyz.to(dev), rgb.to(dev))
    finally:
        model.train(training)
        for h in hooks:
            h.remove()
    return {f"{layer}.bias" for layer in fed - {None}}


def loss_and_grads(model, xyz, rgb, labels, cw, loss_fn=None):
    """One forward (in the model's mode) and backward on model's device ->
    (loss, {name: grad}, logits); the gradients are cleared on the model.
    The loss is weighted CE, or ``loss_fn(logits, labels, xyz, cw)`` as
    train/loop.py::loss_fn_for builds it."""
    dev = next(model.parameters()).device
    xyz = xyz.to(dev)
    logits = model(xyz, rgb.to(dev))
    if loss_fn is None:
        loss = losses.weighted_cross_entropy(logits, labels.to(dev), cw.to(dev))
    else:
        loss = loss_fn(logits, labels.to(dev), xyz, cw.to(dev))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads, logits.detach()


# A train step run twice from the same state must give the same bits: the
# loss and every gradient leaf, compared with torch.equal. ``--train-steps``
# sets REPEAT_REPORT_ONLY, so that every phase prints its count before the
# script fails; otherwise a leaf that differs fails its phase at once.
REPEAT_REPORT_ONLY = False
REPEAT_DIFFERS: list = []


def step_state(model: torch.nn.Module) -> tuple:
    """What a train step reads besides its batch: the weights and BatchNorm
    statistics (a copy of the state_dict), torch's CPU and CUDA generators
    and every Dropout's own generator."""
    gens = [m.generator.get_state() for m in model.modules()
            if isinstance(m, Dropout) and m.generator is not None]
    return (copy.deepcopy(model.state_dict()), torch.get_rng_state(),
            torch.cuda.get_rng_state_all(), gens)


def restore_state(model: torch.nn.Module, state: tuple) -> None:
    sd, cpu_rng, cuda_rng, gens = state
    model.load_state_dict(sd)
    torch.set_rng_state(cpu_rng)
    torch.cuda.set_rng_state_all(cuda_rng)
    own = [m.generator for m in model.modules()
           if isinstance(m, Dropout) and m.generator is not None]
    for g, st in zip(own, gens):
        g.set_state(st)


def check_same_bits(label: str, model: torch.nn.Module, state: tuple, first: tuple,
                    run) -> None:
    """Run the step ``run() -> (loss, {name: grad}, ...)`` again from
    ``state`` (``step_state`` taken before the run that gave ``first``) and
    hold the loss and every gradient leaf to ``first`` with torch.equal:
    prints how many leaves differ and the first few names."""
    restore_state(model, state)
    second = run()
    torch.cuda.synchronize()
    loss_same = torch.equal(first[0], second[0])
    differ = [name for name, g in first[1].items()
              if (g is None) != (second[1][name] is None)
              or (g is not None and not torch.equal(g, second[1][name]))]
    print(f"{label}: run twice from the same state: loss {'the same' if loss_same else 'differs'}"
          f" ({first[0].item():.9g}, {second[0].item():.9g}), {len(differ)} of "
          f"{len(first[1])} gradient leaves differ{': ' + ', '.join(differ[:6]) if differ else ''}",
          flush=True)
    if loss_same and not differ:
        return
    REPEAT_DIFFERS.append((label, loss_same, differ))
    if not REPEAT_REPORT_ONLY:
        raise AssertionError(f"{label}: a second run from the same state differs: loss "
                             f"{'same' if loss_same else 'differs'}, leaves {differ[:6]}")


def unreached_faults(grads: dict, cpu_grads: dict, unreached: tuple) -> list:
    """The leaves that no gradient reaches, by name prefix in ``unreached``
    (SPG's pooling scores, which pick nodes and weigh nothing): None on
    both devices; every other leaf must have a gradient on both."""
    faults = []
    for name, want in cpu_grads.items():
        got, none = grads[name], name.startswith(unreached) if unreached else False
        if none and (got is not None or want is not None):
            faults.append(f"{name}: a gradient where none reaches")
        elif not none and (got is None or want is None):
            faults.append(f"{name}: no gradient on the {'card' if got is None else 'CPU'}")
    return faults


def gradient_faults(grads: dict, cpu_grads: dict, zero: tuple = (),
                    zero_bound: float = 0.0, unreached: tuple = ()) -> tuple:
    """The card's gradient leaves against the CPU's, element by element:
    each present (but the ``unreached``, absent on both devices), finite,
    within 1e-3 * max|g_leaf| + 1e-7 and not all zero where the CPU's is
    not. The leaves named in ``zero`` have a gradient that
    is exactly 0, so any float32 value of it is rounding noise: both sides
    must keep it below ``zero_bound``. -> (faults, (worst share of a leaf's
    band, its name), (worst relative L2, its name))."""
    faults, worst, rel_l2 = unreached_faults(grads, cpu_grads, unreached), (0.0, ""), (0.0, "")
    for name, want in cpu_grads.items():
        got = grads[name]
        if got is None or want is None:  # counted by unreached_faults
            continue
        if not torch.isfinite(got).all():
            faults.append(f"{name}: gradient {got if got is None else 'not finite'}")
            continue
        got, want = got.double().cpu(), want.double()
        err, size = (got - want).abs().max().item(), want.abs().max().item()
        on_card = got.abs().max().item()
        if name in zero:
            if max(size, on_card) > zero_bound:
                faults.append(f"{name}: a gradient that is exactly 0 reads {size:.3g} on the "
                              f"CPU and {on_card:.3g} on the card")
            continue
        if err > 1e-3 * size + 1e-7 or (size > 0 and on_card == 0):
            faults.append(f"{name}: max|err| {err:.3g}, max|g| {size:.3g}, on the card "
                          f"max|g| {on_card:.3g}")
        worst = max(worst, (err / (1e-3 * size + 1e-7), name))
        rel_l2 = max(rel_l2, ((got - want).norm().item() / max(want.norm().item(), 1e-30), name))
    return faults, worst, rel_l2


def check_frozen_bn_gradients(model, cpu_model, xyz, rgb, labels, cw, loss_fn=None,
                              label: str = "frozen-BN gradients",
                              unreached: tuple = ()) -> None:
    """Phases 6a and 16a: the gradient of the same loss with the BatchNorms
    frozen (eval mode), on the card and on the CPU. Without the batch
    statistics the step is well conditioned, so every leaf is held element
    by element within 1e-3 * max|g_leaf| + 1e-7 and the loss within 1e-5
    relative: a gradient lost or misplaced by a backward kernel shows here."""
    model.eval()
    cpu_model.eval()
    cpu_loss, cpu_grads, _ = loss_and_grads(cpu_model, xyz, rgb, labels, cw, loss_fn)
    loss, grads, _ = loss_and_grads(model, xyz, rgb, labels, cw, loss_fn)
    torch.cuda.synchronize()
    loss_rel = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    faults, worst, rel_l2 = gradient_faults(grads, cpu_grads, unreached=unreached)
    print(f"{label}: loss {loss.item():.7f} (CPU {cpu_loss.item():.7f}, rel "
          f"{loss_rel:.3g}); over {len(cpu_grads)} leaves the worst max|err| is at "
          f"{worst[0]:.3g} of its band ({worst[1]}), the worst relative L2 "
          f"{rel_l2[0]:.3g} ({rel_l2[1]})", flush=True)
    if loss_rel > 1e-5 or faults:
        raise AssertionError(f"{label}: loss rel {loss_rel:.3g}; " + "; ".join(faults))


def check_train_step(model, cpu_model, xyz, rgb, labels, cw, loss_fn=None,
                     launches: dict = None, label: str = "train step",
                     zero_below: float = 0.0,
                     needed: tuple = FORWARD_KERNELS + SSG_BACKWARD_KERNELS,
                     unreached: tuple = ()) -> dict:
    """Phases 6 and 16: one train-mode forward and backward on the card
    (kernels) and on the CPU (plain versions) from the same weights and
    batch; every kernel of ``needed`` launched and, with ``launches``,
    exactly those launches of each kernel. With
    ``zero_below``, a bias whose gradient on the CPU step stays below that
    share of its layer weight's max|g| is held as an exactly zero one too:
    one that the batch statistics take out through a sum or a gate, not
    straight in front of a BatchNorm.

    Bands. The loss within 1e-5 relative, the updated BatchNorm statistics
    within 1e-4 * max|stat| + 1e-7. Gradients cannot be held element by
    element: at initialisation the 17 train-mode BatchNorms in sequence
    amplify float32 rounding so far that two CPU runs of this very step
    with 4 and 3 threads (another GEMM blocking) differ by up to 10% of
    max|g| on a leaf, by up to 6% in relative L2, with cosine down to
    0.9985; the JAX package's own float32 step is 1-8% of max|g| from its
    float64 step (tests/test_torch_train.py). So each leaf is held in
    aggregate, at about three times that spread: relative L2 <= 0.2 and
    cosine >= 0.98; a leaf that is nonzero on the CPU must be nonzero on
    the card (a lost gradient gives relative L2 1 and cosine 0). The conv
    biases that feed a BatchNorm have an exactly zero gradient: both sides
    must keep it below 1e-3 * max|g| of the same conv's weight
    (``pre_bn_biases`` finds them). Phase 6a and the kernels' own phases 3
    and 3b hold element by element. Every leaf has a gradient on both
    devices, but those whose names start with one of ``unreached``, which
    have none on either.
    """
    pre_bn = pre_bn_biases(model, xyz, rgb)
    cpu_model.train()
    t0 = time.perf_counter()
    cpu_loss, cpu_grads, _ = loss_and_grads(cpu_model, xyz, rgb, labels, cw, loss_fn)
    cpu_s = time.perf_counter() - t0
    model.train()
    state = step_state(model)
    _kernels.reset_launch_counts()
    loss, grads, _ = loss_and_grads(model, xyz, rgb, labels, cw, loss_fn)
    torch.cuda.synchronize()
    counts = counts_all_launched(label, needed)
    check_same_bits(label, model, state, (loss, grads),
                    lambda: loss_and_grads(model, xyz, rgb, labels, cw, loss_fn))
    if launches is not None and counts != launches:
        raise AssertionError(f"{label}: launches {counts}, expected {launches}")
    if not torch.isfinite(loss):
        raise AssertionError(f"{label}: loss {loss.item()}")
    loss_rel = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    if loss_rel > 1e-5:
        raise AssertionError(f"{label}: loss {loss.item()} vs CPU {cpu_loss.item()}")
    pre_bn |= {name for name, g in cpu_grads.items() if name.endswith(".bias")
               and g is not None and cpu_grads.get(name[:-4] + "weight") is not None
               and g.abs().max() < zero_below * cpu_grads[name[:-4] + "weight"].abs().max()}

    # every leaf is measured and printed first, then held to its band
    rows, biases = [], []
    faults = unreached_faults(grads, cpu_grads, unreached)
    for name, got in grads.items():
        if got is None or cpu_grads[name] is None:  # counted by unreached_faults
            continue
        want = cpu_grads[name].double()
        got = got.double().cpu()
        if not torch.isfinite(got).all():
            faults.append(f"non-finite gradient for {name}")
            continue
        if name in pre_bn:
            bound = 1e-3 * cpu_grads[name[:-4] + "weight"].abs().max().item()
            size = max(got.abs().max().item(), want.abs().max().item())
            biases.append((size / bound, name))
            continue
        if want.abs().max() > 0 and got.abs().max() == 0:
            faults.append(f"zero gradient for {name} on the card")
            continue
        rows.append({
            "name": name,
            "max_err": ((got - want).abs().max() / want.abs().max()).item(),
            "rel_l2": ((got - want).norm() / want.norm()).item(),
            "cos": (got.ravel() @ want.ravel() / (got.norm() * want.norm())).item(),
        })
    rows.sort(key=lambda r: -r["max_err"])
    for r in rows[:6]:
        print(f"  grad {r['name']:28s} max|err|/max|g| {r['max_err']:.3e} "
              f"rel L2 {r['rel_l2']:.3e} cosine {r['cos']:.8f}")
    faults += [f"{r['name']} gradient relative L2 {r['rel_l2']:.3g}, cosine {r['cos']:.6f}"
               for r in rows if r["rel_l2"] > 0.2 or r["cos"] < 0.98]
    faults += [f"{name} gradient {frac:.3g} of its zero bound" for frac, name in biases if frac > 1]

    cpu_bufs = dict(cpu_model.named_buffers())
    stat_err = (0.0, "")
    for name, buf in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            continue
        want = cpu_bufs[name].double()
        err = (buf.double().cpu() - want).abs().max().item() / want.abs().max().item()
        if err > 1e-4:
            faults.append(f"{name} {err:.3g} of max|stat| from the CPU")
        stat_err = max(stat_err, (err, name))
    worst = lambda key, sign=1: max(rows, key=lambda r: sign * r[key])  # noqa: E731
    print(f"{label}: B={B} N={N} loss {loss.item():.7f} (CPU {cpu_loss.item():.7f}, "
          f"rel {loss_rel:.3g}); gradients over {len(rows)} leaves: worst max|err|/max|g| "
          f"{worst('max_err')['max_err']:.4g}, worst relative L2 {worst('rel_l2')['rel_l2']:.4g} "
          f"({worst('rel_l2')['name']}), worst cosine {worst('cos', -1)['cos']:.6f}; "
          f"{len(biases)} zero-gradient biases at {max(biases)[0]:.3g} of their bound; "
          f"{sum(g is None for g in grads.values())} leaves no gradient reaches; "
          f"BatchNorm statistics worst {stat_err[0]:.3g} of max|stat| ({stat_err[1]}); "
          f"launches {counts}; "
          f"CPU reference step {cpu_s:.2f} s (host)", flush=True)
    if faults:
        raise AssertionError(f"{label}: " + "; ".join(faults))
    return counts


def batch_of(ds: BlockDataset) -> tuple:
    """The first B blocks of ds on the CPU: (xyz, rgb, labels, the dataset's
    class weights)."""
    xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32))
    rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32))
    labels = torch.from_numpy(ds.labels[:B].astype(np.int64))
    return xyz, rgb, labels, losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES))


def check_ssg_train_step(ds: BlockDataset, dev: torch.device) -> dict:
    """Phase 6: one SSG train step on the card against the CPU (dropout 0,
    weighted CE with the dataset's class weights), frozen BatchNorms first
    -> the step's launch counts."""
    gen = torch.Generator().manual_seed(SEED + 6)
    model = get_model("pointnet2_ssg", NUM_CLASSES, generator=gen, dropout_rate=0.0)
    randomize_bn(model, gen)
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    xyz, rgb, labels, cw = batch_of(ds)
    check_frozen_bn_gradients(model, cpu_model, xyz, rgb, labels, cw)
    return check_train_step(model, cpu_model, xyz, rgb, labels, cw)


def run_train_steps(ds: BlockDataset, dev: torch.device) -> None:
    """Every single-step train phase (6, 13, 15, 16, 19, 23, 25b, 26c and
    the steps of the PointNet family, enhanced_pointnet2_ssg, RandLA-Net
    and the superpoint models) in turn,
    each run twice from the same state; ``--train-steps`` runs them alone
    with REPEAT_REPORT_ONLY set and fails at the end if any differed."""
    no_dropout = dict(drop_rate=0.0, head_drop_rate=0.0)
    check_ssg_train_step(ds, dev)
    check_attention_train_step(
        "ptv3_pooled train step",
        seeded_model("ptv3_pooled", SEED + 13, **no_dropout, **POOLED_BENCHED), ds, dev,
        attention_launches(12))
    check_attention_train_step(
        "ptv3 train step", seeded_model("ptv3", SEED + 15, **no_dropout), ds, dev,
        attention_launches(8))
    check_bristrunet_train_step(ds, dev)
    check_dgcnn_train_step(ds, dev)
    check_msg_train_step(ds, dev)
    check_moe_train_step(ds, dev)
    check_bf16_train_step(ds, dev)
    check_pointnet_train_step(ds, dev)
    for use_attention in (False, True):
        check_enhanced_train_step(ds, dev, use_attention)
    for i, (name, _, _, launches) in enumerate(ZOO):
        check_zoo_train_step(name, ds, dev, launches, SEED + 350 + i)


def no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    """p = 0 on every Dropout of ``model`` (the test's own doing: the JAX
    enhanced_pointnet2_ssg gives no way to set its attention blocks' rate)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def check_pointnet_phases(ds: BlockDataset, data_dir: Path, dev: torch.device) -> dict:
    """Phases 28-30, the PointNet family (no kernel of the port runs): 28
    the five registry names' forwards at B=4 x 4096 against the CPU (logits
    within 2e-4, no launch; ``pointnet`` profiled), the classifier on xyz
    alone; 29 one ``pointnet`` train step against the CPU (dropout 0,
    frozen BatchNorms first, then train mode as phase 6, run twice from the
    same state); 30 two epochs of configs/train_pointnet.yaml through
    train_cli.main (CE, the plateau schedule), the batch-16 step timed and
    profiled, and ``infer_cli blocks --model pointnet`` on its checkpoint
    -> launch counts by path."""
    none = only()
    for name in POINTNET_NAMES:
        cls = name == "pointnet_cls"
        forward_against_cpu(f"{name} forward",
                            seeded_model(name, SEED + 28, **({"in_features": 0} if cls else {})),
                            ds, dev, none, profile=name == "pointnet",
                            features=None if cls else "colors",
                            out_shape=(B, NUM_CLASSES) if cls else (B, N, NUM_CLASSES))
    by_path = {"pointnet_train_step": check_pointnet_train_step(ds, dev)}
    by_path["pointnet_train_cli"], exp_dir = train_through_cli(
        "train pointnet (configs/train_pointnet.yaml)", "pointnet", (), data_dir, dev,
        profile=True, recipe=ROOT / "configs" / "train_pointnet.yaml")
    try:
        by_path["pointnet_serve_trained"] = serve_blocks(
            "serve trained pointnet blocks", "pointnet", exp_dir, (), data_dir, len(ds), dev)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    if by_path["pointnet_serve_trained"] != none:
        raise AssertionError(f"serve trained pointnet blocks: {by_path['pointnet_serve_trained']}")
    return by_path


def check_pointnet_train_step(ds: BlockDataset, dev: torch.device) -> dict:
    """Phase 29: one ``pointnet`` train step at full width, B=4 x 4096,
    random weights and BatchNorm statistics, dropout 0, weighted CE, on the
    card against the CPU, checked as phase 6 (frozen BatchNorms first, then
    train mode, run twice from the same state), no launch -> the counts."""
    model = seeded_model("pointnet", SEED + 29, dropout_rate=0.0)
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    xyz, rgb, labels, cw = batch_of(ds)
    check_frozen_bn_gradients(model, cpu_model, xyz, rgb, labels, cw,
                              label="pointnet frozen-BN gradients")
    counts = check_train_step(model, cpu_model, xyz, rgb, labels, cw, None, only(),
                              "pointnet train step", zero_below=1e-4, needed=())
    step_ms = time_ms(lambda: loss_and_grads(model, xyz, rgb, labels, cw), reps=10)
    print(f"pointnet train step: forward and backward {step_ms:.3f} ms, "
          f"{B * N / step_ms * 1e3:.0f} points/s", flush=True)
    return counts


def check_enhanced_train_step(ds: BlockDataset, dev: torch.device, use_attention: bool) -> dict:
    """One enhanced_pointnet2_ssg train step at full width, B=4 x 4096,
    random weights and BatchNorm statistics, every Dropout at p = 0 on both
    copies, weighted CE, on the card against the CPU, checked as phase 6
    (frozen BatchNorms first, then train mode, run twice from the same
    state), with exactly its launches -> those launch counts."""
    label = f"enhanced_pointnet2_ssg train step, use_attention={use_attention}"
    model = no_dropout(seeded_model("enhanced_pointnet2_ssg", SEED + 32,
                                    use_attention=use_attention))
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    xyz, rgb, labels, cw = batch_of(ds)
    check_frozen_bn_gradients(model, cpu_model, xyz, rgb, labels, cw,
                              label=label.replace("train step", "frozen-BN gradients"))
    launches = ENHANCED_ATTN_STEP_LAUNCHES if use_attention else ENHANCED_STEP_LAUNCHES
    counts = check_train_step(model, cpu_model, xyz, rgb, labels, cw, None, launches, label,
                              zero_below=1e-4, needed=("knn",) + FORWARD_KERNELS
                              + SSG_BACKWARD_KERNELS)
    step_ms = time_ms(lambda: loss_and_grads(model, xyz, rgb, labels, cw), reps=10)
    print(f"{label}: forward and backward {step_ms:.3f} ms, "
          f"{B * N / step_ms * 1e3:.0f} points/s", flush=True)
    return counts


def check_enhanced_phases(ds: BlockDataset, data_dir: Path, dev: torch.device) -> tuple:
    """Phases 31-33, enhanced_pointnet2_ssg at the registry's width: 31 the
    forwards with use_attention off (profiled) and on at B=4 x 4096 against
    the CPU, logits within 2e-4, exactly their launches; 32 a train step of
    each against the CPU; 33 ``infer_cli blocks --model
    enhanced_pointnet2_ssg`` from a checkpoint written here -> (launch
    counts of one forward by path, launch counts of the steps and the
    serve by path)."""
    forward_against_cpu("enhanced_pointnet2_ssg forward",
                        seeded_model("enhanced_pointnet2_ssg", SEED + 31), ds, dev,
                        ENHANCED_LAUNCHES)
    forward_against_cpu("enhanced_pointnet2_ssg forward, use_attention=True",
                        seeded_model("enhanced_pointnet2_ssg", SEED + 31, use_attention=True),
                        ds, dev, ENHANCED_ATTN_LAUNCHES, profile=False)
    by_path = {"enhanced_train_step": check_enhanced_train_step(ds, dev, False),
               "enhanced_attention_train_step": check_enhanced_train_step(ds, dev, True)}
    ckpt = data_dir / "enhanced_checkpoint"
    save_checkpoint(str(ckpt), {"model": seeded_model("enhanced_pointnet2_ssg",
                                                      SEED + 33).state_dict(), "epoch": 0})
    label = "serve enhanced_pointnet2_ssg blocks"
    counts = serve_blocks(label, "enhanced_pointnet2_ssg", ckpt,
                          tuple(k for k, v in ENHANCED_LAUNCHES.items() if v), data_dir,
                          len(ds), dev)
    batches = -(-len(ds) // 16)
    if counts != {k: batches * v for k, v in ENHANCED_LAUNCHES.items()}:
        raise AssertionError(f"{label}: launches {counts}, {batches} batches")
    by_path["enhanced_serve_blocks"] = counts
    return {"enhanced_forward": ENHANCED_LAUNCHES,
            "enhanced_attention_forward": ENHANCED_ATTN_LAUNCHES}, by_path


def run_train_cli(label: str, data_dir: Path, args: list, epochs: int, launched: tuple) -> tuple:
    """train_cli.main on the two LAS scenes of data_dir, validating on the
    second, with the launch counters reset just before and read just after
    -> (its result, wall seconds, launch counts, which must cover
    ``launched`` and nothing else, peak device memory of the run). Finite
    losses and both checkpoints are checked; the caller removes the
    experiment directory."""
    val_dir = data_dir / "val"
    val_dir.mkdir(exist_ok=True)
    shutil.copy(data_dir / "bridge_1.las", val_dir / "bridge_1.las")
    _kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_cli.main([
        "--train-dir", str(data_dir), "--val-dir", str(val_dir), *args,
        "--num-epochs", str(epochs), "--case", "chip_smoke", "--device", "cuda",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    exp_dir = Path(out["exp_dir"]).resolve()
    try:
        counts = counts_all_launched(label, launched)
        if counts != only(**{k: counts[k] for k in launched}):
            raise AssertionError(f"{label}: another kernel ran ({counts})")
        hist = out["history"]
        if [r["epoch"] for r in hist] != list(range(1, epochs + 1)):
            raise AssertionError(f"{label}: epochs {[r['epoch'] for r in hist]}")
        for r in hist:
            for key in ("train_loss", "val_loss", "val_acc", "val_miou"):
                if not np.isfinite(r[key]):
                    raise AssertionError(f"{label}: epoch {r['epoch']} {key} = {r[key]}")
        for name in ("best_model", "latest_checkpoint"):
            if not (exp_dir / name).is_file():
                raise AssertionError(f"{label}: {name} not written")
    except BaseException:
        shutil.rmtree(exp_dir, ignore_errors=True)
        raise
    return out, wall, counts, torch.cuda.max_memory_allocated()


def train_through_cli(label: str, model_name: str, launched: tuple, data_dir: Path,
                      dev: torch.device, step_model: torch.nn.Module = None,
                      profile: bool = False, recipe: Path = None) -> tuple:
    """Phases 7, 14 and 17: two epochs of ``model_name`` (the registry's
    default model) at batch 16 through train_cli.main -> (launch counts of
    exactly that run, the experiment directory, which the caller removes).
    A reload of latest_checkpoint must give the trained model's eval logits
    exactly. Then the steady-state train step at batch 16 (Adam, weighted
    CE) on the reloaded model, or on ``step_model`` where the timed
    configuration is another than the default one; with ``profile`` its
    device time by kernel family. With ``recipe`` (a config of configs/),
    the run and the timed step take that config's loss, sampling and
    schedule (``--config``), the data directories and the epochs as flags."""
    args = (["--config", str(recipe)] if recipe else
            ["--model", model_name, "--num-classes", str(NUM_CLASSES), "--num-points", str(N),
             "--batch-size", "16", "--loss", "weighted_ce", "--scheduler", "cosine"])
    loss_cfg = Config.from_yaml(str(recipe)).loss if recipe else LossConfig(name="weighted_ce")
    out, wall, counts, train_mem = run_train_cli(label, data_dir, args, 2, launched)
    exp_dir = Path(out["exp_dir"]).resolve()
    hist = out["history"]
    try:
        # a reload of latest_checkpoint gives the trained model's logits
        model = out["model"]
        ds = BlockDataset.from_files([str(data_dir / "bridge_0.las")], num_points=N,
                                     num_classes=NUM_CLASSES)
        xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:16], np.float32)).to(dev)
        rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:16], np.float32)).to(dev)
        labels = torch.from_numpy(ds.labels[:16].astype(np.int64)).to(dev)
        reloaded = get_model(model_name, NUM_CLASSES).to(dev)
        reloaded.load_state_dict(
            restore_checkpoint(str(exp_dir / "latest_checkpoint"), map_location=dev)["model"])
        model.eval()
        reloaded.eval()
        with torch.inference_mode():
            same = torch.equal(model(xyz, rgb), reloaded(xyz, rgb))
        if not same:
            raise AssertionError(f"{label}: the reloaded checkpoint gives other logits")

        # steady-state train step at batch 16
        del model, out["model"]
        step_model = reloaded if step_model is None else step_model.to(dev)
        opt = make_optimizer(step_model.parameters())
        step = make_train_step(step_model, loss_cfg, opt)
        cw = out["class_weights"]
        batch = {"points": xyz, "colors": rgb, "labels": labels}
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: step(batch, 1e-4, cw), reps=20, warmup=5)
        step_mem = torch.cuda.max_memory_allocated()
    except BaseException:
        shutil.rmtree(exp_dir, ignore_errors=True)
        raise
    epoch_s = [round(r["epoch_time_s"], 4) for r in hist]
    print(f"{label}: 2 epochs through train_cli in {wall:.2f} s wall (epochs {epoch_s} s), "
          f"train loss {[round(r['train_loss'], 4) for r in hist]}, val OA "
          f"{[round(r['val_acc'], 4) for r in hist]}, launches {counts}, peak device memory "
          f"{train_mem / 2**20:.1f} MiB; reloaded latest_checkpoint: eval logits identical",
          flush=True)
    print(f"{label} step: batch 16 x {N} {step_ms:.3f} ms, {16 * N / step_ms * 1e3:.0f} "
          f"points/s trained, peak device memory {step_mem / 2**20:.1f} MiB", flush=True)
    if profile:
        profile_by_family(f"{label} step", "step", lambda: step(batch, 1e-4, cw))
    return counts, exp_dir


# the final LayerNorm's bias and head_fc1's: a constant shift of head_bn's input
PRE_BN_BIASES = ("norm.bias", "head_fc1.bias")


def check_attention_train_step(label: str, model: torch.nn.Module, ds: BlockDataset,
                               dev: torch.device, launches: dict, tap=None) -> float:
    """Phases 13 and 15: one train-mode forward and backward (weighted CE,
    dropout 0) of a PTv3 model at B=4 x 4096 on the card against the same
    model on the CPU (plain versions), from the same weights and batch.

    Bands: the loss within 1e-5 relative, the train-mode logits within 2e-4,
    the head's BatchNorm statistics within 1e-4 * max|stat|, exactly
    ``launches`` of each kernel; every gradient leaf present, finite,
    non-zero and within 1e-3 * max|g_leaf| + 1e-7 of the CPU's, element by
    element: the family has LayerNorms and one BatchNorm at the very end, so
    nothing amplifies float32 rounding as the SSG step's BatchNorms do. The
    two biases that feed that BatchNorm (PRE_BN_BIASES) shift every row of
    its input alike, the batch mean takes them out again and their gradient
    is exactly 0: both sides must keep it below 1e-3 * max|g| of
    head_fc1.weight. With ``tap`` (RoutingTap), the card's step runs first
    and the CPU takes its expert picks. -> the milliseconds of one forward
    and backward on the card."""
    cpu_model = copy.deepcopy(model).train()
    model.to(dev).train()
    xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32))
    rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32))
    labels = torch.from_numpy(ds.labels[:B].astype(np.int64))
    cw = losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES))
    recorder = tap(model) if tap else None
    state = step_state(model)
    _kernels.reset_launch_counts()
    loss, grads, logits = loss_and_grads(model, xyz, rgb, labels, cw)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    picks = dict(recorder.picks) if recorder is not None else None
    check_same_bits(label, model, state, (loss, grads),
                    lambda: loss_and_grads(model, xyz, rgb, labels, cw))
    if recorder is not None:
        if any(not torch.equal(picks[k], recorder.picks[k]) for k in picks):
            raise AssertionError(f"{label}: the second run picked other experts")
    report = recorder.replay(cpu_model) if recorder is not None else None
    t0 = time.perf_counter()
    cpu_loss, cpu_grads, cpu_logits = loss_and_grads(cpu_model, xyz, rgb, labels, cw)
    cpu_s = time.perf_counter() - t0
    if report is not None:
        print(f"{label}: picks that the CPU's router would make otherwise (count, largest "
              f"probability gap): {report}", flush=True)
        if sorted(report) != sorted(recorder.picks) or any(g > 1e-4 for _, g in report.values()):
            raise AssertionError(f"{label}: a pick differs beyond a tie: {report}")
    if counts != launches:
        raise AssertionError(f"{label}: launches {counts}, expected {launches}")
    loss_rel = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    logit_err = max_abs_err(logits.cpu(), cpu_logits)
    faults = []
    if not loss_rel <= 1e-5:
        faults.append(f"loss {loss.item()} vs CPU {cpu_loss.item()}")
    if not logit_err <= LOGIT_TOL:
        faults.append(f"train-mode logits differ from the CPU's by {logit_err}")
    grad_faults, worst, _ = gradient_faults(
        grads, cpu_grads, PRE_BN_BIASES, 1e-3 * cpu_grads["head_fc1.weight"].abs().max().item())
    faults += grad_faults
    if not all(g.abs().max() > 0 for name, g in cpu_grads.items() if name not in PRE_BN_BIASES):
        faults.append("a gradient leaf is all zero on the CPU")
    stat_err = 0.0
    for name, want in cpu_model.head_bn.named_buffers():
        if name != "num_batches_tracked":
            got = getattr(model.head_bn, name)
            stat_err = max(stat_err, max_abs_err(got.cpu(), want) / want.abs().max().item())
    if stat_err > 1e-4:
        faults.append(f"head_bn statistics {stat_err:.3g} of max|stat| from the CPU")
    print(f"{label}: B={B} N={N} loss {loss.item():.7f} (CPU {cpu_loss.item():.7f}, rel "
          f"{loss_rel:.3g}), train-mode logits max|err| {logit_err:.3g}; over {len(cpu_grads)} "
          f"gradient leaves the worst max|err| is at {worst[0]:.3g} of its band ({worst[1]}; "
          f"the two zero gradients before head_bn apart); "
          f"head_bn statistics {stat_err:.3g} of max|stat|; launches {counts}; CPU reference "
          f"step {cpu_s:.2f} s (host)", flush=True)
    if faults:
        raise AssertionError(f"{label}: " + "; ".join(faults))
    step_ms = time_ms(lambda: loss_and_grads(model, xyz, rgb, labels, cw), reps=10)
    print(f"{label}: forward and backward {step_ms:.3f} ms, "
          f"{B * N / step_ms * 1e3:.0f} points/s", flush=True)
    return step_ms


def train_ptv3_through_cli(data_dir: Path, n_blocks: int, dev: torch.device) -> dict:
    """Phase 14: train ptv3_pooled through train_cli.main (the registry's
    default model, which infer_cli restores), serve the checkpoint it wrote
    through ``infer_cli blocks``, time the batch-16 step at the benched
    configuration, and run one epoch from each of the family's two configs
    as a user would (``--config``, the data directories and the epochs as
    flags) -> launch counts by path."""
    trained = ("flash_attn",) + ATTN_BACKWARD_KERNELS
    step_model = seeded_model("ptv3_pooled", SEED + 14, **POOLED_BENCHED)
    by_path = {}
    by_path["ptv3_pooled_train_cli"], exp_dir = train_through_cli(
        "train ptv3_pooled", "ptv3_pooled", trained, data_dir, dev, step_model, profile=True)
    try:
        by_path["ptv3_pooled_serve_trained"] = serve_blocks(
            "serve trained ptv3_pooled blocks", "ptv3_pooled", exp_dir, ("flash_attn",),
            data_dir, n_blocks, dev)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    if by_path["ptv3_pooled_serve_trained"] != only(flash_attn=8 * -(-n_blocks // 16)):
        raise AssertionError(f"serve trained ptv3_pooled blocks: launches "
                             f"{by_path['ptv3_pooled_serve_trained']}")
    for name in ("ptv3_pooled", "ptv3"):
        out, wall, counts, mem = run_train_cli(
            f"train {name} from its config", data_dir,
            ["--config", str(ROOT / "configs" / f"train_{name}.yaml")], 1, trained)
        shutil.rmtree(out["exp_dir"], ignore_errors=True)
        r = out["history"][0]
        by_path[f"{name}_train_config"] = counts
        print(f"train {name} from configs/train_{name}.yaml: 1 epoch in {wall:.2f} s wall "
              f"(epoch {r['epoch_time_s']:.2f} s), train loss {r['train_loss']:.4f}, val OA "
              f"{r['val_acc']:.4f}, launches {counts}, peak device memory "
              f"{mem / 2**20:.1f} MiB", flush=True)
        del out
    return by_path


def bristrunet_step_launches(model: torch.nn.Module) -> dict:
    """Launches of one BriStruNet train step: its forward's, a group
    backward a radius of every set-abstraction level (each groups features
    that carry a gradient) and an interpolation backward a decoder level."""
    radii = sum(len(m.radius_list) for m in model.modules()
                if isinstance(m, MultiScaleSetAbstraction))
    return BRISTRUNET_LAUNCHES | {"group_bwd": radii,
                                  "interp_bwd": BRISTRUNET_LAUNCHES["interpolate"]}


def check_bristrunet_train_step(ds: BlockDataset, dev: torch.device) -> dict:
    """Phase 16: one BriStruNet train step at full width, B=4 x 4096, random
    weights and BatchNorm statistics moved off the identity, dropout 0, the
    recipe's loss (configs/train_bristrunet.yaml: bridge_structure, alpha 80,
    rel_margin 0.3, with its class weights) on the card against the CPU,
    checked as phase 6 checks SSG's step, with exactly the step's launches
    of each kernel -> those launch counts."""
    model = seeded_model("bristrunet", SEED + 16, dropout_rate=0.0)
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32))
    rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32))
    labels = torch.from_numpy(ds.labels[:B].astype(np.int64))
    cw = losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES))
    recipe = Config.from_yaml(str(ROOT / "configs" / "train_bristrunet.yaml")).loss
    loss_fn = loss_fn_for(recipe)
    launches = bristrunet_step_launches(model)
    print(f"BriStruNet train step: the model groups {launches['group_bwd']} feature sets that "
          f"carry a gradient (two radii a level): {launches['group_bwd']} group backward "
          "launches expected", flush=True)
    check_frozen_bn_gradients(model, cpu_model, xyz, rgb, labels, cw, loss_fn,
                              "BriStruNet frozen-BN gradients")

    # The recipe's class weights are a step function of the argmax
    # predictions (losses.bridge_structure_weights): in train mode the
    # BatchNorms spread the rounding of the logits to ~1e-4, a point whose
    # top two logits lie closer than that may flip, and one flip moves the
    # loss by ~1e-5. So both sides of the train-mode step take the class
    # weights of the CPU step's predictions (from a forward of a copy), and
    # the recipe's loss as each side computes it is printed beside.
    with torch.no_grad():
        cpu_logits = copy.deepcopy(cpu_model).train()(xyz, rgb)
        card_logits = copy.deepcopy(model).train()(xyz.to(dev), rgb.to(dev)).cpu()
    weights = losses.bridge_structure_weights(cpu_logits.argmax(-1), labels, xyz, recipe.alpha,
                                              recipe.rel_margin)
    flips = int((cpu_logits.argmax(-1) != card_logits.argmax(-1)).sum())
    own = [loss_fn(lg, labels, xyz, cw).item() for lg in (card_logits, cpu_logits)]
    print(f"BriStruNet train step: train-mode logits max|err| "
          f"{max_abs_err(card_logits, cpu_logits):.3g}, {flips} of {B * N} argmax predictions "
          f"differ; the recipe's loss with each side's own class weights {own[0]:.7f} (CPU "
          f"{own[1]:.7f}, rel {abs(own[0] - own[1]) / own[1]:.3g})", flush=True)

    def fixed_weights(logits, lbl, _xyz, _cw):
        return losses.weighted_cross_entropy(logits, lbl, weights.to(logits.device),
                                             label_smoothing=0.2)

    # 47 of its 59 biases have an exactly zero gradient in train mode (the
    # JAX package's float64 step gives them at most 1e-13 of their weight's,
    # the others 0.07 and more; tests/test_torch_bristrunet_train.py): 40
    # straight in front of a BatchNorm and 7 whose shift reaches one through
    # a sum, found by their CPU gradient below 1e-4 of their weight's
    counts = check_train_step(model, cpu_model, xyz, rgb, labels, cw, fixed_weights, launches,
                              "BriStruNet train step", zero_below=1e-4)
    step_ms = time_ms(lambda: loss_and_grads(model, xyz, rgb, labels, cw, loss_fn), reps=10)
    print(f"BriStruNet train step: forward and backward {step_ms:.3f} ms, "
          f"{B * N / step_ms * 1e3:.0f} points/s", flush=True)
    return counts


def train_bristrunet_through_cli(data_dir: Path, n_blocks: int, dev: torch.device,
                                 launches: dict) -> dict:
    """Phase 17: two epochs of BriStruNet at batch 16 through train_cli.main
    with configs/train_bristrunet.yaml (bridge_structure loss, weighted block
    sampling, the plateau scheduler, Adam), checked as phase 7, the batch-16
    step timed and profiled by kernel family; then ``infer_cli blocks``
    serves the checkpoint that run wrote -> launch counts by path."""
    trained = tuple(k for k, v in launches.items() if v)
    by_path = {}
    by_path["bristrunet_train_cli"], exp_dir = train_through_cli(
        "train bristrunet (configs/train_bristrunet.yaml)", "bristrunet", trained, data_dir,
        dev, profile=True, recipe=ROOT / "configs" / "train_bristrunet.yaml")
    try:
        forward = tuple(k for k, v in BRISTRUNET_LAUNCHES.items() if v)
        by_path["bristrunet_serve_trained"] = serve_blocks(
            "serve trained bristrunet blocks", "bristrunet", exp_dir, forward, data_dir,
            n_blocks, dev)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    return by_path


@contextlib.contextmanager
def edgeconv_form(fast: bool):
    """PCB_EDGECONV_FAST at 1 or 0 inside the block: the EdgeConv form that
    models/dgcnn.py takes on either device; unset after (the default: the
    restructured form on the card, the literal one on the CPU)."""
    os.environ["PCB_EDGECONV_FAST"] = "1" if fast else "0"
    try:
        yield
    finally:
        del os.environ["PCB_EDGECONV_FAST"]


class GraphTap:
    """DGCNN's four k-NN graphs, stage by stage, through a wrapper of the
    port's ``knn`` and ``knn_set`` where models/dgcnn.py calls them (the
    literal EdgeConv calls the first, the restructured one the second; the
    model has no hook for this): a forward on the card runs the port's
    search (K5, K5c) and
    records each stage's input and graph in ``card``, unless ``frozen``; a
    forward on the CPU replays the graphs the card recorded last, in the
    same order, or with ``own`` builds its own with knn_plain and records
    them in ``cpu``. For time, that knn_plain runs on the card: a fold of
    rounded elementwise operations and a stable sort, the same bits on
    either device (held on a slice by ``check_dgcnn_forward``)."""

    def __init__(self, dev: torch.device):
        self.dev, self.card, self.cpu = dev, [], []
        self.own = self.frozen = False
        self.replayed = 0

    def __enter__(self):
        self.real = {name: getattr(dgcnn_models, name) for name in ("knn", "knn_set")}
        dgcnn_models.knn = functools.partial(self.knn, self.real["knn"])
        dgcnn_models.knn_set = functools.partial(self.knn, self.real["knn_set"])
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(dgcnn_models, name, fn)

    def knn(self, real, x, k):
        if x.is_cuda:
            idx = real(x, k=k)
            if not self.frozen:
                if len(self.card) == 4:
                    self.card = []
                self.card.append((x.detach().clone(), idx))
            return idx
        if self.own:
            if len(self.cpu) == 4:
                self.cpu = []
            on_card = x.detach().to(self.dev)
            idx = grouping.knn_plain(on_card, on_card, k)[1].cpu()
            self.cpu.append((x.detach().clone(), idx))
            return idx
        stage = self.replayed % 4
        self.replayed += 1
        return self.card[stage][1].cpu()


def check_card_graphs(label: str, tap: GraphTap) -> list:
    """Each graph the card recorded against knn_plain on the card on the
    stage's own input, bit for bit (what K5 and K5c promise) -> knn_plain's
    (d2, idx) a stage."""
    out = []
    if len(tap.card) != 4:
        raise AssertionError(f"{label}: {len(tap.card)} graphs recorded, expected 4")
    for stage, (x, idx) in enumerate(tap.card):
        d2, want = grouping.knn_plain(x, x, idx.shape[-1])
        if not torch.equal(idx, want):
            raise AssertionError(f"{label}: stage {stage + 1} graph (C={x.shape[-1]}) differs "
                                 "from knn_plain on its own input")
        out.append((d2, want))
    return out


# a pick that the CPU makes otherwise than the card, on the card's inputs,
# must be a tie within this share of the row's boundary value
PICK_TIE = 1e-4


def set_gaps(card: torch.Tensor, other: torch.Tensor, values: torch.Tensor) -> tuple:
    """Rows of k picks [.., k]: the card's picks that ``other``'s rows lack,
    and each one's gap to its row's k-th value (``values`` [.., k] aligned
    with the card's picks, the k-th last), relative to that value -> (the
    mask of those picks, their gaps)."""
    missing = ~(card.unsqueeze(-1) == other.to(card.device).unsqueeze(-2)).any(-1)
    kth = values[..., -1:]
    return missing, ((values - kth).abs() / kth.abs().clamp_min(1e-30))[missing].double()


def picks_that_differ(label: str, card: list, cpu: list, plain: list) -> list:
    """Stage by stage, the picks of the card's graph that the CPU's own
    graph (no replay) lacks, with each one's gap to the k-th distance on
    the card's features, relative to that distance -> the counts."""
    counts = []
    for stage, ((x, idx), (_, own), (d2, _)) in enumerate(zip(card, cpu, plain)):
        missing, gap = set_gaps(idx, own, d2)  # [B, N, k]
        n = int(missing.sum())
        counts.append(n)
        line = (f"{label}: stage {stage + 1} (C={x.shape[-1]}, k={idx.shape[-1]}): {n} of "
                f"{idx.numel()} picks differ between the card and the CPU without the replay")
        if n:
            line += (f"; gap to the k-th distance, relative: max {gap.max().item():.3g}, median "
                     f"{gap.median().item():.3g}, min {gap.min().item():.3g}")
        print(line, flush=True)
    return counts


def check_dgcnn_forward(name: str, ds: BlockDataset, dev: torch.device, seed: int) -> dict:
    """Phase 18: ``name`` (dgcnn or dgcnn_global, full width) at B=4 x 4096,
    random weights and BatchNorm statistics, on the card against the CPU:
    the card in its default EdgeConv form, the restructured one (exactly 1
    K5, 3 K5c and 4 K7 launches), the CPU in the same form
    (PCB_EDGECONV_FAST=1); each of the card's four graphs bit for
    bit against knn_plain on its own input; the CPU forward with the card's
    graphs replayed, logits within 2e-4; then without the replay, the picks
    that differ stage by stage and their gaps to the k-th distance;
    forward ms and points/s by CUDA events, and device time by kernel
    family -> the forward's launch counts."""
    label = f"{name} forward"
    model = seeded_model(name, seed)
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    xyz_cpu = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32))
    rgb_cpu = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32))
    xyz, rgb = xyz_cpu.to(dev), rgb_cpu.to(dev)
    if "PCB_EDGECONV_FAST" in os.environ or not dgcnn_models._edgeconv_fast_default(xyz):
        raise AssertionError(f"{label}: the card's default is not the restructured EdgeConv")
    with torch.inference_mode(), GraphTap(dev) as tap:
        _kernels.reset_launch_counts()
        out = model(xyz, rgb)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        if counts != DGCNN_LAUNCHES:
            raise AssertionError(f"{label}: launches {counts}, expected {DGCNN_LAUNCHES}")
        plain = check_card_graphs(label, tap)
        # knn_plain gives the same bits on either device: a slice of conv2's
        x, idx = tap.card[1]
        k = idx.shape[-1]
        here = grouping.knn_plain(x[:1].cpu(), x[:1, :256].cpu(), k)
        there = grouping.knn_plain(x[:1], x[:1, :256], k)
        if not all(torch.equal(a, b.cpu()) for a, b in zip(here, there)):
            raise AssertionError(f"{label}: knn_plain differs between the CPU and the card")
        t0 = time.perf_counter()
        with edgeconv_form(True):
            ref = cpu_model(xyz_cpu, rgb_cpu)
        cpu_s = time.perf_counter() - t0
        if tap.replayed != 4:
            raise AssertionError(f"{label}: the CPU forward took {tap.replayed} graphs, not 4")
        out = out.cpu()
        err = max_abs_err(out, ref)
        agree = (out.argmax(-1) == ref.argmax(-1)).double().mean().item()
        print(f"{label}: logits {tuple(out.shape)} CUDA vs CPU (the card's graphs replayed) "
              f"max|err| {err:.3g} (max|logit| {ref.abs().max().item():.3g}), argmax agreement "
              f"{agree:.6f}, launches {counts}; the four graphs bit for bit against knn_plain "
              f"on the card; CPU reference forward {cpu_s:.2f} s (host)", flush=True)
        if out.shape != (B, N, NUM_CLASSES) or not torch.isfinite(out).all():
            raise AssertionError(f"{label}: logits {tuple(out.shape)} not finite")
        if not torch.allclose(out, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL):
            raise AssertionError(f"{label}: CUDA logits differ from CPU by {err}")
        tap.own = True
        with edgeconv_form(True):
            own = cpu_model(xyz_cpu, rgb_cpu)
        differ = picks_that_differ(label, tap.card, tap.cpu, plain)
        print(f"{label}: without the replay, logits max|err| {max_abs_err(out, own):.3g}, "
              f"argmax agreement {(out.argmax(-1) == own.argmax(-1)).double().mean().item():.6f}",
              flush=True)
        if differ[0]:
            raise AssertionError(f"{label}: conv1's graphs over the same xyz differ")
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(xyz, rgb))
        print(f"{label}: B={B} N={N} {fwd_ms:.3f} ms, {B * N / fwd_ms * 1e3:.0f} points/s",
              flush=True)
        profile_by_family(label, "forward", lambda: model(xyz, rgb))
    return counts


def check_dgcnn_train_step(ds: BlockDataset, dev: torch.device) -> dict:
    """Phase 19: one DGCNN train step at full width, B=4 x 4096, random
    weights and BatchNorm statistics, weighted CE with the dataset's class
    weights, on the card against the CPU, both in the restructured EdgeConv
    form (PCB_EDGECONV_FAST=1, the card's default), checked as phase 6
    checks SSG's (frozen BatchNorms first, then train mode;
    ``pre_bn_biases``), the CPU taking the card's graphs of the same mode
    (GraphTap), with exactly DGCNN_STEP_LAUNCHES -> those launch counts."""
    with edgeconv_form(True):
        return _dgcnn_train_step(ds, dev)


def _dgcnn_train_step(ds: BlockDataset, dev: torch.device) -> dict:
    model = seeded_model("dgcnn", SEED + 19)
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32))
    rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32))
    labels = torch.from_numpy(ds.labels[:B].astype(np.int64))
    cw = losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES))
    with GraphTap(dev) as tap:
        model.eval()
        with torch.no_grad():
            model(xyz.to(dev), rgb.to(dev))
        check_card_graphs("DGCNN eval-mode graphs", tap)
        tap.frozen = True
        check_frozen_bn_gradients(model, cpu_model, xyz, rgb, labels, cw,
                                  label="DGCNN frozen-BN gradients")
        # train mode: the graphs of a train-mode forward of two copies (the
        # batch statistics, not the running ones, set the features), the
        # same bits twice, which the CPU step then replays
        graphs = []
        for _ in range(2):
            tap.frozen = False
            with torch.no_grad():
                copy.deepcopy(model).train()(xyz.to(dev), rgb.to(dev))
            graphs.append([idx for _, idx in tap.card])
        if not all(map(torch.equal, *graphs)):
            raise AssertionError("DGCNN train step: two train-mode forwards built other graphs")
        check_card_graphs("DGCNN train-mode graphs", tap)
        tap.frozen, tap.replayed = True, 0
        # 3 of its 11 biases have an exactly zero gradient in train mode: 2
        # straight in front of a BatchNorm and bn5's, whose shift moves every
        # point's conv5 feature alike, passes the max over the points with
        # slope 1 and reaches point_conv.1's batch mean (the JAX package's
        # float64 step gives it 2e-15 of its weight's gradient;
        # tests/test_torch_dgcnn_train.py): found by their CPU gradient below
        # 1e-4 of their weight's
        counts = check_train_step(model, cpu_model, xyz, rgb, labels, cw, None,
                                  DGCNN_STEP_LAUNCHES, "DGCNN train step", zero_below=1e-4,
                                  needed=("knn", "knn_c", "edge_reduce", "edge_reduce_bwd"))
        if tap.replayed != 4:
            raise AssertionError(f"DGCNN train step: the CPU took {tap.replayed} graphs, not 4")
    step_ms = time_ms(lambda: loss_and_grads(model, xyz, rgb, labels, cw), reps=10)
    print(f"DGCNN train step: forward and backward {step_ms:.3f} ms, "
          f"{B * N / step_ms * 1e3:.0f} points/s", flush=True)
    return counts


def train_dgcnn_through_cli(data_dir: Path, n_blocks: int, dev: torch.device) -> dict:
    """Phase 20: two epochs of DGCNN at batch 16 x 4096 through
    train_cli.main with configs/train_dgcnn.yaml (weighted CE, Adam 1e-3,
    the plateau scheduler), checked as phase 7, the batch-16 step timed
    (ms, points/s, peak memory) and profiled by kernel family; then
    ``infer_cli blocks`` serves the checkpoint that run wrote, warm, and
    once more with ``--from-snapshot`` (serve_from_snapshot): all of it in
    the card's default EdgeConv form, the restructured one -> launch counts
    by path."""
    kernels = ("knn", "knn_c", "edge_reduce")
    by_path = {}
    by_path["dgcnn_train_cli"], exp_dir = train_through_cli(
        "train dgcnn (configs/train_dgcnn.yaml)", "dgcnn",
        kernels + ("edge_reduce_bwd",), data_dir, dev, profile=True,
        recipe=ROOT / "configs" / "train_dgcnn.yaml")
    label = "serve trained dgcnn blocks"
    try:
        counts = serve_blocks(label, "dgcnn", exp_dir, kernels, data_dir, n_blocks, dev)
        by_path["dgcnn_serve_snapshot"] = serve_from_snapshot(
            label + " from its code snapshot", "dgcnn", exp_dir, label, data_dir, dev)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    if counts != dgcnn_serve_launches(counts["knn"]):
        raise AssertionError(f"serve trained dgcnn blocks: launches {counts}")
    by_path["dgcnn_serve_trained"] = counts
    return by_path


def dgcnn_serve_launches(batches: int) -> dict:
    """The launches of ``batches`` DGCNN forwards in the restructured form."""
    return {k: batches * v for k, v in DGCNN_LAUNCHES.items()}


def serve_from_snapshot(label: str, model_name: str, exp_dir: Path, plain_label: str,
                        data_dir: Path, dev: torch.device) -> dict:
    """``infer_cli blocks --from-snapshot --device cuda`` on the run of
    ``exp_dir``: the model, its ops and their kernels come from the code
    snapshot that training wrote, a package of its own with its own launch
    counters, whose library nvcc builds under <exp>/code_snapshot/build/.
    Served twice (the first call builds); the second call's counts are read
    from the snapshot's counters and must show K5, K5c and K7 (three K5c
    and four K7 a K5) and no kernel of this package; its CSVs must equal those of
    ``plain_label``'s serve (serve_blocks) byte for byte -> the snapshot's
    launch counts."""
    out_dir = data_dir / "infer_out" / label.replace(" ", "_")
    plain_dir = data_dir / "infer_out" / plain_label.replace(" ", "_")
    argv = ["blocks", "--checkpoint", str(exp_dir), "--model", model_name,
            "--data-dir", str(data_dir), "--out-dir", str(out_dir),
            "--num-classes", str(NUM_CLASSES), "--num-points", str(N),
            "--batch-size", "16", "--device", dev.type, "--from-snapshot"]
    first, _, _ = run_cli(label, argv, GLOBAL_LINE)
    snapshot = exp_dir / "code_snapshot"
    found = [m for name, m in sys.modules.items()
             if name.startswith("pcb_snapshot_") and name.endswith(".ops._kernels")
             and Path(m.__file__).resolve().is_relative_to(snapshot.resolve())]
    if len(found) != 1:
        raise AssertionError(f"{label}: {len(found)} kernel modules loaded from {snapshot}")
    snap = found[0]
    lib = snap.library_path()
    if lib.parent != (snapshot / "build" / "pointcloud_bridge_tpu_torch").resolve() \
            or not lib.exists():
        raise AssertionError(f"{label}: the snapshot's library is {lib}")
    snap.reset_launch_counts()
    wall, lines, counts = run_cli(label, argv, GLOBAL_LINE)
    snap_counts = snap.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{label}: this package's kernels ran ({counts})")
    if not snap_counts["knn"] or snap_counts != dgcnn_serve_launches(snap_counts["knn"]):
        raise AssertionError(f"{label}: the snapshot's launches {snap_counts}")
    for name in ("confusion_matrix.csv", "metrics.csv"):
        if (out_dir / name).read_bytes() != (plain_dir / name).read_bytes():
            raise AssertionError(f"{label}: {name} differs from the plain serve's")
    print(f"{label}: {wall:.3f} s wall warm, first call {first:.3f} s (the snapshot's kernels "
          f"built into {lib.relative_to(exp_dir.resolve())}), launches from the snapshot "
          f"{snap_counts}; CSVs equal the plain serve's; {lines[-1]}", flush=True)
    return snap_counts


def kernel_family(name: str) -> str:
    """The row of PERF.md's breakdown that a device kernel's name goes to."""
    for key, family in (
        ("fps_kernel", "K1 FPS"), ("ballq_", "K2 ball query"),
        ("k7b_sort", "K7b edge reduce backward"), ("edge_bwd_", "K7b edge reduce backward"),
        ("group_kernel", "K3 group"), ("group_bwd_", "K3b group backward"),
        ("interp_kernel", "K4 interpolate"), ("interp_bwd_kernel", "K4b interpolation backward"),
        ("knn_c_kernel", "K5c k-NN over C channels"), ("knn_kernel", "K5 k-NN"),
        ("edge_reduce_bwd", "K7b edge reduce backward"), ("edge_reduce_kernel", "K7 edge reduce"),
        ("edge_reduce_staged", "K7 edge reduce"),
        ("flash_attn_bf16_kernel", "K6 flash attention (bf16)"),
        ("flash_attn_bwd_dq_bf16", "K6b flash attention backward (bf16)"),
        ("flash_attn_bwd_dkv_bf16", "K6b flash attention backward (bf16)"),
        ("flash_attn_kernel", "K6 flash attention"),
        ("flash_attn_bwd", "K6b flash attention backward"),
        ("multi_tensor", "Adam (foreach)"),
        ("gemm", "GEMMs"), ("gemv", "GEMMs"), ("cutlass", "GEMMs"), ("nvjet", "GEMMs"),
        ("batch_norm", "BatchNorm"), ("layer_norm", "LayerNorm"), ("Sort", "sort"),
        ("sort", "sort"), ("reduce", "reductions"),
        ("gather", "gather, index, cat"), ("index", "gather, index, cat"),
        ("Cat", "gather, index, cat"), ("Memcpy", "copies, memset"),
        ("Memset", "copies, memset"),
    ):
        if key in name:
            return family
    return "elementwise and other"


def profile_by_family(label: str, what: str, fn, reps: int = 10, quiet: bool = False,
                      families: dict = None) -> tuple:
    """Print the device time of one fn() by kernel family (with ``quiet``
    nothing), from one torch.profiler run over ``reps`` back-to-back calls
    -> (device busy ms, wall ms) a call; ``families``, a dict, receives the
    ms a call by family."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    families = {} if families is None else families
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:  # the attribute's name in older PyTorch
                us = ev.self_cuda_time_total
            fam = kernel_family(ev.key)
            families[fam] = families.get(fam, 0.0) + us / 1e3 / reps
    busy = sum(families.values())
    if quiet:
        return busy, wall_ms
    if busy > 0:
        print(f"{label} profile (device ms a {what}, {reps} back to back, "
              f"profiler on): busy {busy:.3f}, wall {wall_ms:.3f}, idle "
              f"{max(0.0, 1 - busy / wall_ms):.1%}")
        for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
            print(f"  {fam:28s} {ms:8.3f} ms  {ms / busy:6.1%}")
    else:
        print(f"{label} profile: the profiler recorded no device time")
    return busy, wall_ms


def forward_against_cpu(label: str, model: torch.nn.Module, ds: BlockDataset,
                        dev: torch.device, launches: dict, profile: bool = True,
                        features="colors", out_shape: tuple = (B, N, NUM_CLASSES)) -> tuple:
    """``model`` (eval mode, on the CPU) at B=4 x 4096 on the card against
    a copy on the CPU (plain versions): logits of ``out_shape`` within 2e-4,
    exactly ``launches`` of each kernel in one forward; forward time and
    points/s; device time by kernel family from one torch.profiler run ->
    (the model on the card, the forward's milliseconds). ``features`` is
    "colors" (the blocks' colours), a [B, N, C] CPU tensor or None."""
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    xyz_cpu = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32))
    if isinstance(features, str):
        features = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32))
    rgb_cpu = features
    xyz, rgb = xyz_cpu.to(dev), None if features is None else features.to(dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu_model(xyz_cpu, rgb_cpu)
        cpu_s = time.perf_counter() - t0
        _kernels.reset_launch_counts()
        out = model(xyz, rgb)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        if counts != launches:
            raise AssertionError(f"{label}: launches {counts}, expected {launches}")
        out = out.cpu()
        err = max_abs_err(out, ref)
        agree = (out.argmax(-1) == ref.argmax(-1)).double().mean().item()
        print(f"{label}: logits {tuple(out.shape)} CUDA vs CPU max|err| {err:.3g} "
              f"(max|logit| {ref.abs().max().item():.3g}), argmax agreement {agree:.6f}, "
              f"launches {counts}, CPU reference forward {cpu_s:.2f} s (host)", flush=True)
        if out.shape != out_shape or not torch.isfinite(out).all():
            raise AssertionError(f"{label}: logits {tuple(out.shape)} not finite")
        if not torch.allclose(out, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL):
            raise AssertionError(f"{label}: CUDA logits differ from CPU by {err}")
        fwd_ms = time_ms(lambda: model(xyz, rgb))
        print(f"{label}: B={B} N={N} {fwd_ms:.3f} ms, "
              f"{B * N / fwd_ms * 1e3:.0f} points/s", flush=True)
        if profile:
            profile_by_family(label, "forward", lambda: model(xyz, rgb))
    return model, fwd_ms


def time_flat_forward(ds: BlockDataset, dev: torch.device) -> float:
    """Phase 11's timed forward: flat ptv3 at the registry's 8 blocks on the
    card alone, B=4 x 4096 -> milliseconds."""
    model = seeded_model("ptv3", SEED + 11).to(dev)
    xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32)).to(dev)
    rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32)).to(dev)
    with torch.inference_mode():
        ms = time_ms(lambda: model(xyz, rgb))
    print(f"ptv3 forward (the registry's 8 blocks, on the card alone): B={B} N={N} "
          f"{ms:.3f} ms, {B * N / ms * 1e3:.0f} points/s", flush=True)
    return ms


def partsize_features(ds: BlockDataset, b: int) -> torch.Tensor:
    """The first b blocks' 9 feature channels in the Partsize column order
    [x, y, z, r, g, b, x_norm, y_norm, z_norm]: the block's coordinates,
    its colours and its coordinates scaled to [0, 1] over the block, on the
    CPU, [b, 4096, 9]."""
    xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:b], np.float32))
    rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:b], np.float32))
    lo, hi = xyz.amin(1, keepdim=True), xyz.amax(1, keepdim=True)
    return torch.cat([xyz, rgb, (xyz - lo) / (hi - lo).clamp(min=1e-9)], dim=-1).contiguous()


def check_msg_family_forwards(ds: BlockDataset, dev: torch.device) -> dict:
    """Phases 21 and 22: pointnet2_msg with 9 feature channels (bench.py's
    shape; profiled by kernel family), then pointnet2_sem_seg with colours
    and both classifiers with xyz alone and with colours, each at full
    width, B=4 x 4096, random weights and BatchNorm statistics, on the card
    against the CPU: logits within 2e-4, exactly each forward's launches;
    ms and points/s -> launch counts by path."""
    forward_against_cpu("pointnet2_msg forward (9 channels)",
                        seeded_model("pointnet2_msg", SEED + 21, in_features=9), ds, dev,
                        MSG_LAUNCHES, features=partsize_features(ds, B))
    forward_against_cpu("pointnet2_sem_seg forward", seeded_model("pointnet2_sem_seg", SEED + 22),
                        ds, dev, SEM_SEG_LAUNCHES, profile=False)
    for name, launches in (("pointnet2_cls_ssg", CLS_SSG_LAUNCHES),
                           ("pointnet2_cls_msg", CLS_MSG_LAUNCHES)):
        for in_features in (0, 3):
            forward_against_cpu(f"{name} forward, in_features={in_features}",
                                seeded_model(name, SEED + 22, in_features=in_features), ds, dev,
                                launches, profile=False,
                                features="colors" if in_features else None,
                                out_shape=(B, NUM_CLASSES))
    return {MSG: MSG_LAUNCHES, SEM_SEG: SEM_SEG_LAUNCHES, CLS_SSG: CLS_SSG_LAUNCHES,
            CLS_MSG: CLS_MSG_LAUNCHES}


def check_msg_train_step(ds: BlockDataset, dev: torch.device) -> dict:
    """Phase 23: one pointnet2_msg train step as configs/train_partsize_msg.yaml
    builds the model (colours, in_features 3), full width, B=4 x 4096,
    random weights and BatchNorm statistics, dropout 0, weighted CE with the
    dataset's class weights, on the card against the CPU, checked as phase 6
    checks SSG's (frozen BatchNorms first, then train mode; the biases in
    front of a BatchNorm held structurally, ``pre_bn_biases``), with exactly
    MSG_STEP_LAUNCHES -> those launch counts."""
    model = seeded_model("pointnet2_msg", SEED + 23, dropout_rate=0.0)
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32))
    rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32))
    labels = torch.from_numpy(ds.labels[:B].astype(np.int64))
    cw = losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES))
    check_frozen_bn_gradients(model, cpu_model, xyz, rgb, labels, cw,
                              label="pointnet2_msg frozen-BN gradients")
    counts = check_train_step(model, cpu_model, xyz, rgb, labels, cw, None, MSG_STEP_LAUNCHES,
                              "pointnet2_msg train step")
    step_ms = time_ms(lambda: loss_and_grads(model, xyz, rgb, labels, cw), reps=10)
    print(f"pointnet2_msg train step: forward and backward {step_ms:.3f} ms, "
          f"{B * N / step_ms * 1e3:.0f} points/s", flush=True)
    return counts


def train_msg_through_cli(data_dir: Path, n_blocks: int, dev: torch.device) -> dict:
    """Phase 24: two epochs of configs/train_partsize_msg.yaml (pointnet2_msg,
    the sol loss, step decay, Adam) at batch 16 x 4096 through
    train_cli.main, checked as phase 7 (the reload of latest_checkpoint
    gives the trained model's logits exactly), the batch-16 step timed (ms,
    points/s, peak memory) and profiled by kernel family; then ``infer_cli
    blocks --model pointnet2_msg`` serves the checkpoint that run wrote,
    warm, with exactly MSG_LAUNCHES a batch -> launch counts by path."""
    by_path = {}
    by_path["pointnet2_msg_train_cli"], exp_dir = train_through_cli(
        "train pointnet2_msg (configs/train_partsize_msg.yaml)", "pointnet2_msg",
        FORWARD_KERNELS + SSG_BACKWARD_KERNELS, data_dir, dev, profile=True,
        recipe=ROOT / "configs" / "train_partsize_msg.yaml")
    label = "serve trained pointnet2_msg blocks"
    try:
        counts = serve_blocks(label, "pointnet2_msg", exp_dir, FORWARD_KERNELS, data_dir,
                              n_blocks, dev)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    batches = -(-n_blocks // 16)
    if counts != {k: batches * v for k, v in MSG_LAUNCHES.items()}:
        raise AssertionError(f"{label}: launches {counts}, {batches} batches")
    by_path["pointnet2_msg_serve_trained"] = counts
    return by_path


def run_msg_family_phases(ds: BlockDataset, data_dir: Path, dev: torch.device) -> tuple:
    """Phases 21-24 on the blocks of the two synthetic scenes of data_dir ->
    (launch counts of one pass by path, launch counts of the CLI runs by
    path)."""
    passes = check_msg_family_forwards(ds, dev)
    passes[MSG_TRAIN] = check_msg_train_step(ds, dev)
    return passes, train_msg_through_cli(data_dir, len(ds), dev)


def seeded_model(name: str, seed: int, **kwargs) -> torch.nn.Module:
    """``name`` on the CPU in eval mode, weights and BatchNorm statistics
    drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    model = get_model(name, NUM_CLASSES, generator=gen, **kwargs)
    randomize_bn(model, gen)
    return model.eval()


def run_cli(label: str, argv: list, pattern: str) -> tuple:
    """infer_cli.main(argv) with its standard output kept -> (wall seconds,
    the lines that match ``pattern``, launch counts of exactly this call)."""
    buf = io.StringIO()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        infer_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    lines = [ln for ln in buf.getvalue().splitlines() if re.fullmatch(pattern, ln)]
    if not lines:
        raise AssertionError(f"{label}: no metric line in the CLI's output:\n{buf.getvalue()}")
    return wall, lines, counts


GLOBAL_LINE = r"GLOBAL mIoU=[\d.]+ OA=[\d.]+ mAcc=[\d.]+ F1=[\d.]+"


def serve_blocks(label: str, model_name: str, checkpoint: Path, launched: tuple,
                 data_dir: Path, n_blocks: int, dev: torch.device,
                 forward_kernels: tuple = (), warm: bool = True) -> dict:
    """``infer_cli blocks`` over the scenes of data_dir from ``checkpoint``,
    twice (once where not ``warm``); the second, warm call is timed and
    counted -> its launch counts, which must cover ``launched`` and no
    backward kernel but those of ``forward_kernels`` (SPT's segment sums run
    on the group-backward kernel)."""
    out_dir = data_dir / "infer_out" / label.replace(" ", "_")
    argv = ["blocks", "--checkpoint", str(checkpoint), "--model", model_name,
            "--data-dir", str(data_dir), "--out-dir", str(out_dir),
            "--num-classes", str(NUM_CLASSES), "--num-points", str(N),
            "--batch-size", "16", "--device", dev.type]
    first = run_cli(label, argv, GLOBAL_LINE)[0] if warm else float("nan")
    wall, lines, counts = run_cli(label, argv, GLOBAL_LINE)
    counts_all_launched(label, launched)
    if any(counts[k] for k in BACKWARD_KERNELS if k not in forward_kernels):
        raise AssertionError(f"{label}: a backward kernel ran ({counts})")
    cm = np.loadtxt(out_dir / "confusion_matrix.csv", delimiter=",")
    if cm.shape != (NUM_CLASSES, NUM_CLASSES) or cm.sum() != n_blocks * N:
        raise AssertionError(f"{label}: confusion matrix sums to {cm.sum()}")
    if "bridge_0.las" not in (out_dir / "metrics.csv").read_text():
        raise AssertionError(f"{label}: metrics.csv lacks the per-file rows")
    figures = len(list(out_dir.glob("*.png")))
    if not figures and importlib.util.find_spec("matplotlib"):
        raise AssertionError(f"{label}: matplotlib is installed, but no figure was drawn")
    when = f"warm, first call {first:.3f} s" if warm else "in its one call"
    print(f"{label}: {n_blocks} blocks x {N} in {wall:.3f} s wall {when} "
          f"(LAS read, blocks, checkpoint, forward, CSVs, {figures} figures), "
          f"{n_blocks * N / wall:.0f} points/s end to end, launches {counts}; {lines[-1]}",
          flush=True)
    return counts


def serve_scene(label: str, model_name: str, checkpoint: Path, launched: tuple,
                per_forward: str, data_dir: Path, dev: torch.device) -> dict:
    """``infer_cli scene``: 2 votes over each of the two scenes, predicted
    LAS exported -> the call's launch counts, which must cover ``launched``
    and no backward kernel. ``per_forward`` names a kernel and its launches a
    forward, "knn:3", from which the number of forward batches follows."""
    out_dir = data_dir / "infer_out" / label.replace(" ", "_")
    wall, lines, counts = run_cli(
        label,
        ["scene", "--checkpoint", str(checkpoint), "--model", model_name,
         "--data-dir", str(data_dir), "--out-dir", str(out_dir),
         "--num-classes", str(NUM_CLASSES), "--num-points", str(N), "--batch-size", "16",
         "--num-votes", "2", "--export-las", "--device", dev.type],
        r"OVERALL mIoU=[\d.]+ OA=[\d.]+")
    counts_all_launched(label, launched)
    kernel, each = per_forward.split(":")
    if any(counts[k] for k in BACKWARD_KERNELS) or counts[kernel] % int(each):
        raise AssertionError(f"{label}: launches {counts}")
    scene_points = 0
    for s in (0, 1):
        pts, _, pred = _load_scene(str(out_dir / f"bridge_{s}_pred.las"))
        src, _, _ = _load_scene(str(data_dir / f"bridge_{s}.las"))
        if len(pts) != len(src) or pred.min() < 0 or pred.max() >= NUM_CLASSES:
            raise AssertionError(f"{label}: bridge_{s}_pred.las has {len(pts)} "
                                 f"points of {len(src)}, labels {pred.min()}..{pred.max()}")
        scene_points += len(pts)
    print(f"{label}: 2 scenes, {scene_points} points, 2 votes in {wall:.3f} s "
          f"wall (LAS read, gridding, {counts[kernel] // int(each)} forward batches of <= 16 "
          f"blocks, LAS export), {scene_points / wall:.0f} scene points/s end to end, "
          f"launches {counts}; {lines[-1]}", flush=True)
    return counts


def serve_through_cli(data_dir: Path, ssg_exp_dir: Path, bristrunet: torch.nn.Module,
                      n_blocks: int, dev: torch.device) -> dict:
    """Phase 9: the inference CLI from checkpoints, on the card."""
    ckpt = data_dir / "bristrunet_checkpoint"
    save_checkpoint(str(ckpt), {"model": bristrunet.state_dict(), "epoch": 0})
    forward = tuple(k for k, v in BRISTRUNET_LAUNCHES.items() if v)
    by_path = {}

    # a cold start: the same serve in a fresh interpreter, through the entry
    # point as a user types it (interpreter and CUDA start-up, library loads)
    t0 = time.perf_counter()
    cold = subprocess.run(
        [sys.executable, "-m", "pointcloud_bridge_tpu_torch.infer_cli", "blocks",
         "--checkpoint", str(ckpt), "--model", "bristrunet", "--data-dir", str(data_dir),
         "--out-dir", str(data_dir / "infer_out" / "cold"), "--num-points", str(N),
         "--device", dev.type],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    cold_s = time.perf_counter() - t0
    if cold.returncode != 0 or not re.search(GLOBAL_LINE, cold.stdout):
        raise AssertionError(f"serve bristrunet blocks in a fresh process: exit "
                             f"{cold.returncode}\n{cold.stdout}\n{cold.stderr}")
    print(f"serve bristrunet blocks, a fresh process (python -m ...infer_cli): "
          f"{cold_s:.2f} s wall", flush=True)

    by_path["bristrunet_serve_blocks"] = serve_blocks(
        "serve bristrunet blocks", "bristrunet", ckpt, forward, data_dir, n_blocks, dev)
    by_path["ssg_serve_blocks_cli"] = serve_blocks(
        "serve pointnet2_ssg blocks", "pointnet2_ssg", ssg_exp_dir, FORWARD_KERNELS,
        data_dir, n_blocks, dev)
    if by_path["ssg_serve_blocks_cli"]["knn"]:
        raise AssertionError("serve pointnet2_ssg blocks: the k-NN kernel ran")
    counts = serve_scene("serve bristrunet scene", "bristrunet", ckpt, forward, "knn:3",
                         data_dir, dev)
    if counts["knn"] != counts["fps"]:
        raise AssertionError(f"serve bristrunet scene: launches {counts}")
    by_path["bristrunet_serve_scene"] = counts

    # the split of one scene's vote inference, from the function's own timers
    pts, cols, labels = _load_scene(str(data_dir / "bridge_0.las"))
    res = whole_scene_vote_predict(
        bristrunet, np.concatenate([pts, cols], axis=1), labels,
        scene_labelweights([labels], NUM_CLASSES), NUM_CLASSES, block_points=N,
        num_votes=2, batch_size=16, collect_timings=True)
    if res["pred"].shape != (len(pts),) or not (res["vote_pool"].sum(1) > 0).all():
        raise AssertionError("vote inference: a point got no vote")
    t = res["timings"]
    print("vote inference, one 200k-point scene, 2 votes, host seconds: table upload "
          f"{t['table_upload_s']:.4f}; a vote: "
          + ", ".join(f"{k[:-2]} {[round(v, 4) for v in t[k]]}"
                      for k in ("grid_s", "h2d_s", "dispatch_s", "fetch_s", "scatter_s"))
          + f"; mIoU {res['metrics']['mIoU']:.4f} (random weights)", flush=True)
    return by_path


def serve_ptv3_pooled_through_cli(data_dir: Path, n_blocks: int, dev: torch.device) -> dict:
    """Phase 12: ptv3_pooled as both CLIs build it (the registry's default
    model: encoder depths 2/2/2, 8 attention calls a forward) from a
    checkpoint written here, in ``blocks`` and in ``scene`` mode: the
    flash-attention kernel runs and no other kernel does."""
    ckpt = data_dir / "ptv3_pooled_checkpoint"
    save_checkpoint(str(ckpt), {"model": seeded_model("ptv3_pooled", SEED + 12).state_dict(),
                                "epoch": 0})
    by_path = {
        "ptv3_pooled_serve_blocks": serve_blocks(
            "serve ptv3_pooled blocks", "ptv3_pooled", ckpt, ("flash_attn",), data_dir,
            n_blocks, dev),
        "ptv3_pooled_serve_scene": serve_scene(
            "serve ptv3_pooled scene", "ptv3_pooled", ckpt, ("flash_attn",), "flash_attn:8",
            data_dir, dev),
    }
    for path, counts in by_path.items():
        if counts != only(flash_attn=counts["flash_attn"]):
            raise AssertionError(f"{path}: another kernel than flash_attn ran ({counts})")
    if by_path["ptv3_pooled_serve_blocks"]["flash_attn"] != 8 * -(-n_blocks // 16):
        raise AssertionError(f"serve ptv3_pooled blocks: launches "
                             f"{by_path['ptv3_pooled_serve_blocks']}")
    return by_path


def dgcnn_features(dev: torch.device) -> list:
    """The inputs of K5c in seeded dgcnn and dgcnn_global forwards (random
    weights and BatchNorm statistics, as phase 18 seeds them) over phase 4's
    two synthetic bridge scenes: [(label, features [B, 4096, 64], k)], conv2
    to conv4 of each, at B=4, and dgcnn's at B=16 too."""
    data_dir = ROOT / "build" / "chip_smoke_data"
    try:
        ds = make_dataset(data_dir)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    out = []
    for name, seed, k, batches in (("dgcnn", SEED + 18, 20, (4, 16)),
                                   ("dgcnn_global", SEED + 28, 64, (4,))):
        model = seeded_model(name, seed).to(dev)
        for b in batches:
            xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:b], np.float32)).to(dev)
            rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:b], np.float32)).to(dev)
            with torch.inference_mode(), GraphTap(dev) as tap:
                model(xyz, rgb)
            out += [(f"{name} B={b} conv{i + 2}", x.contiguous(), k)
                    for i, (x, _) in enumerate(tap.card[1:])]
    return out


# ------------------------------------------------------------ phases 25-27
# ptv3_moe at the registry's width, 384 (2 heads of 192), 8 experts, top 2,
# in every other block: 4 of its 8 blocks in phase 25's checks against the
# CPU (MoE in blocks 1 and 3); its train_cli run, timed step and serve take
# the registry's 8
MOE_DEPTH = 4
MOE_BLOCKS = tuple(range(1, MOE_DEPTH, 2))
PROD_CONFIG = ROOT / "configs" / "train_ptv3_big_prod.yaml"
BF16_KERNELS = ("flash_attn_bf16", "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16")
# the JAX package's own contract for a bf16 model against its float32 self
# (tests/test_models.py:160-181): logits within 0.1, argmax agreement 0.97;
# the card's bf16 model against the CPU's, the same code at the same
# precision, within the CPU tests' band for two bf16 chains (2e-2 of
# max(1, max|logits|), tests/test_torch_ptv3_options.py)
BF16_LOGIT_TOL, BF16_AGREE = 0.1, 0.97
BF16_CPU_TOL = 2e-2


class RoutingTap:
    """Records the expert picks of every MoE block of a model on the card
    and replays them on a copy on the CPU (the way GraphTap replays k-NN
    graphs): the router's float32 logits are GEMMs that the card and the
    CPU round differently, so a token whose top choices nearly tie may go
    to another expert on each. The CPU copy keeps its own router
    probabilities and gates and takes the card's picks; the picks that
    differ without the replay are reported with the gap of their
    probabilities."""

    def __init__(self, model: torch.nn.Module):
        self.picks = {}
        self.moes = {name: m for name, m in model.named_modules()
                     if type(m).__name__ == "MoEFeedForward"}
        for name, m in self.moes.items():
            m.register_forward_hook(
                lambda mod, i, o, name=name: self.picks.__setitem__(
                    name, mod.routing["sel"].cpu()))

    def replay(self, cpu_model: torch.nn.Module) -> dict:
        """Make cpu_model's MoE blocks take the recorded picks -> per block,
        the number of picks its own router would make otherwise and the
        largest probability gap among them."""
        report = {}
        for name, m in cpu_model.named_modules():
            if name not in self.moes:
                continue
            own_route = m.route

            def route(xt, own_route=own_route, name=name):
                sel, _, probs = own_route(xt)
                card = self.picks[name]
                differ = sel != card
                gaps = (probs.gather(-1, sel) - probs.gather(-1, card)).abs()[differ]
                report[name] = (int(differ.sum()), float(gaps.max()) if gaps.numel() else 0.0)
                gate = probs.gather(-1, card)
                return card, gate / gate.sum(-1, keepdim=True).clamp(min=1e-9), probs

            m.route = route
        return report


def check_moe_forward(ds: BlockDataset, dev: torch.device) -> dict:
    """Phase 25a: the ptv3_moe eval forward (MOE_DEPTH blocks) at B=4 x 4096
    on the card against the CPU, the CPU taking the card's expert picks
    (RoutingTap): logits within 2e-4, a flash-attention launch a block; a
    pick that differs without the replay must be a near tie (probabilities
    within 1e-4). -> launch counts."""
    model = seeded_model("ptv3_moe", SEED + 25, depth=MOE_DEPTH)
    cpu_model = copy.deepcopy(model)
    tap = RoutingTap(model.to(dev))
    xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32))
    rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32))
    with torch.inference_mode():
        _kernels.reset_launch_counts()
        out = model(xyz.to(dev), rgb.to(dev))
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        own = copy.deepcopy(cpu_model)(xyz, rgb)
        differ = tap.replay(cpu_model)
        ref = cpu_model(xyz, rgb)
    if counts != only(flash_attn=MOE_DEPTH):
        raise AssertionError(f"ptv3_moe forward: launches {counts}")
    if sorted(tap.picks) != [f"block{i}.moe_mlp" for i in MOE_BLOCKS]:
        raise AssertionError(f"ptv3_moe forward: MoE blocks {sorted(tap.picks)}")
    out = out.cpu()
    err, own_err = max_abs_err(out, ref), max_abs_err(out, own)
    n_differ = sum(d for d, _ in differ.values())
    print(f"ptv3_moe forward: logits {tuple(out.shape)} CUDA vs CPU with the card's picks "
          f"max|err| {err:.3g}; picks that differ without the replay (of {B * N * 2} a block): "
          f"{differ}, logits then {own_err:.3g}; launches {counts}", flush=True)
    if not torch.isfinite(out).all() or err > LOGIT_TOL:
        raise AssertionError(f"ptv3_moe forward: CUDA logits differ from the CPU's by {err}")
    if any(gap > 1e-4 for _, gap in differ.values()):
        raise AssertionError(f"ptv3_moe forward: a pick differs beyond a tie: {differ}")
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(xyz.to(dev), rgb.to(dev)))
        print(f"ptv3_moe forward: B={B} N={N} {fwd_ms:.3f} ms, "
              f"{B * N / fwd_ms * 1e3:.0f} points/s ({n_differ} picks differ)", flush=True)
        xyz_d, rgb_d = xyz.to(dev), rgb.to(dev)
        profile_by_family("ptv3_moe forward", "forward", lambda: model(xyz_d, rgb_d))
    return counts


def check_moe_train_step(ds: BlockDataset, dev: torch.device) -> dict:
    """Phase 25b: one ptv3_moe train step (MOE_DEPTH blocks, dropout 0) at
    B=4 x 4096 on the card against the CPU with the card's picks replayed,
    checked as phase 15: a launch of each float32 attention kernel a
    block."""
    model = seeded_model("ptv3_moe", SEED + 26, depth=MOE_DEPTH, drop_rate=0.0,
                         head_drop_rate=0.0)
    launches = attention_launches(MOE_DEPTH)
    check_attention_train_step("ptv3_moe train step", model, ds, dev, launches, tap=RoutingTap)
    return launches


def bf16_against(label: str, name: str, kwargs: dict, ds: BlockDataset, dev: torch.device,
                 launches: int, seed: int) -> dict:
    """Phase 26a: ``name`` with a bfloat16 option on the card against the
    same weights in float32 on the card (the JAX package's contract: logits
    within 0.1, argmax agreement 0.97) and against its plain bf16 path on
    the CPU (B=1: within BF16_CPU_TOL * max(1, max|logits|), argmax
    agreement 0.97); exactly ``launches`` of the bf16 forward kernel and no
    other kernel; every Dense of a block but the router giving bf16 on the
    card (a model that stayed float32 would pass the logit bands) -> the
    launch counts of the forward."""
    f32 = seeded_model(name, seed, **{k: v for k, v in kwargs.items()
                                      if k not in ("stream_dtype", "compute_dtype")})
    model = seeded_model(name, seed, **kwargs)
    model.load_state_dict(f32.state_dict())
    cpu_model = copy.deepcopy(model)
    f32.to(dev)
    model.to(dev)
    xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32)).to(dev)
    rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32)).to(dev)
    dense_types, hooks = {}, []
    for mod_name, m in model.named_modules():
        if (type(m).__name__ == "Dense" and "block" in mod_name
                and not mod_name.endswith("router")):
            hooks.append(m.register_forward_hook(
                lambda mod, i, o, mod_name=mod_name: dense_types.__setitem__(mod_name, o.dtype)))
    with torch.inference_mode():
        want = f32(xyz, rgb)
        _kernels.reset_launch_counts()
        got = model(xyz, rgb)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        for h in hooks:
            h.remove()
        cpu = cpu_model(xyz[:1].cpu(), rgb[:1].cpu())
        fwd_ms = time_ms(lambda: model(xyz, rgb))
        f32_ms = time_ms(lambda: f32(xyz, rgb))
    if counts != only(flash_attn_bf16=launches):
        raise AssertionError(f"{label}: launches {counts}, expected {launches} bf16")
    if not dense_types or set(dense_types.values()) != {torch.bfloat16}:
        raise AssertionError(f"{label}: the blocks' Dense layers give {dense_types}")
    faults = []
    for what, ref, out, tol in (("float32 on the card", want, got, BF16_LOGIT_TOL),
                                ("bf16 on the CPU", cpu, got[:1].cpu(), BF16_CPU_TOL * max(
                                    1.0, cpu.abs().max().item()))):
        err = max_abs_err(out, ref)
        agree = (out.argmax(-1) == ref.argmax(-1)).double().mean().item()
        print(f"{label}: against {what}: max|err| {err:.3g} (band {tol:.3g}, max|logit| "
              f"{ref.abs().max().item():.3g}), argmax agreement {agree:.6f}", flush=True)
        if not torch.isfinite(out).all() or err > tol or agree < BF16_AGREE:
            faults.append(f"{what}: max|err| {err}, argmax agreement {agree}")
    print(f"{label}: B={B} N={N} {fwd_ms:.3f} ms ({B * N / fwd_ms * 1e3:.0f} points/s), "
          f"float32 {f32_ms:.3f} ms; launches {counts}; {len(dense_types)} block Dense "
          f"layers in bf16", flush=True)
    if faults:
        raise AssertionError(f"{label}: " + "; ".join(faults))
    return counts


def check_remat_exact(ds: BlockDataset, dev: torch.device) -> dict:
    """Phase 26b: one ptv3_pooled train step at the benched configuration,
    B=4, dropout 0.1 from a generator of the card, with remat=True against
    remat=False: the same loss, logits and every gradient bit for bit, the
    generator in the same state after; the forward kernel runs twice a
    block (forward and recompute), each backward kernel once -> the remat
    step's launches."""
    runs = []
    for remat in (False, True):
        model = seeded_model("ptv3_pooled", SEED + 27, remat=remat, **POOLED_BENCHED)
        model.to(dev).train()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = gen
        xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32)).to(dev)
        rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32)).to(dev)
        labels = torch.from_numpy(ds.labels[:B].astype(np.int64))
        cw = losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES))
        _kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        loss, grads, logits = loss_and_grads(model, xyz, rgb, labels, cw)
        torch.cuda.synchronize()
        runs.append((loss, grads, logits, gen.get_state(), _kernels.launch_counts(),
                     torch.cuda.max_memory_allocated()))
    (l0, g0, o0, s0, c0, m0), (l1, g1, o1, s1, c1, m1) = runs
    same = (torch.equal(l0, l1) and torch.equal(o0, o1) and torch.equal(s0, s1)
            and all(torch.equal(g0[k], g1[k]) for k in g0))
    worst = max(max_abs_err(g0[k], g1[k]) for k in g0)
    print(f"remat ptv3_pooled step: remat=True against remat=False: identical {same} (worst "
          f"gradient max|err| {worst:.3g}); launches {c1} (without remat {c0}); peak device "
          f"memory {m1 / 2**20:.1f} MiB (without remat {m0 / 2**20:.1f} MiB)", flush=True)
    if not same:
        raise AssertionError("remat ptv3_pooled step: remat changed the step")
    if c0 != attention_launches(12) or c1 != attention_launches(12) | {"flash_attn": 24}:
        raise AssertionError(f"remat ptv3_pooled step: launches {c0}, {c1}")
    return c1


def check_bf16_train_step(ds: BlockDataset, dev: torch.device) -> dict:
    """Phase 26c: one flat ptv3 train step with the bf16 stream at its
    default width, B=4: finite loss and gradients, every parameter float32,
    exactly 8 launches of each bf16 attention kernel; the gradient against
    the float32 step of the same weights (cosine of the whole gradient)."""
    f32 = seeded_model("ptv3", SEED + 28, drop_rate=0.0, head_drop_rate=0.0).to(dev).train()
    model = seeded_model("ptv3", SEED + 28, drop_rate=0.0, head_drop_rate=0.0,
                         stream_dtype="bfloat16").to(dev).train()
    model.load_state_dict(f32.state_dict())
    xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32))
    rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32))
    labels = torch.from_numpy(ds.labels[:B].astype(np.int64))
    cw = losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES))
    want_loss, want, _ = loss_and_grads(f32, xyz, rgb, labels, cw)
    state = step_state(model)
    _kernels.reset_launch_counts()
    loss, grads, _ = loss_and_grads(model, xyz, rgb, labels, cw)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    check_same_bits("ptv3 bf16-stream train step", model, state, (loss, grads),
                    lambda: loss_and_grads(model, xyz, rgb, labels, cw))
    flat = torch.cat([grads[k].flatten() for k in want])
    ref = torch.cat([want[k].flatten() for k in want])
    cos = (flat @ ref / (flat.norm() * ref.norm())).item()
    step_ms = time_ms(lambda: loss_and_grads(model, xyz, rgb, labels, cw), reps=10)
    print(f"ptv3 bf16-stream train step: loss {loss.item():.6f} (float32 {want_loss.item():.6f}), "
          f"gradient cosine to the float32 step {cos:.6f}; launches {counts}; forward and "
          f"backward {step_ms:.3f} ms", flush=True)
    expected = only(flash_attn_bf16=8, flash_attn_bwd_dq_bf16=8, flash_attn_bwd_dkv_bf16=8)
    if counts != expected:
        raise AssertionError(f"ptv3 bf16-stream train step: launches {counts}")
    if not torch.isfinite(loss) or not torch.isfinite(flat).all() or cos < 0.99:
        raise AssertionError(f"ptv3 bf16-stream train step: loss {loss.item()}, cosine {cos}")
    return counts


def train_prod_through_cli(data_dir: Path, dev: torch.device) -> dict:
    """Phase 27: configs/train_ptv3_big_prod.yaml through train_cli.main as
    the file stands (ptv3 384 wide, 12 blocks of 6 heads, bf16 stream, remat,
    batch 16 as 4 microbatches of 4, EMA 0.999, 5 warm-up epochs) for two
    epochs; the checkpoint reloads through the trainer's own model build
    (the config's model_extra) to the same eval logits; then the batch-16
    step timed (points/s trained, peak memory) and profiled, with its
    launches, and the same step without remat -> launch counts by path."""
    out, wall, counts, mem = run_train_cli("train ptv3_big_prod", data_dir,
                                           ["--config", str(PROD_CONFIG)], 2, BF16_KERNELS)
    exp_dir = Path(out["exp_dir"]).resolve()
    cfg = Config.from_yaml(str(PROD_CONFIG))
    try:
        model = out["model"]
        ds = BlockDataset.from_files([str(data_dir / "bridge_0.las")], num_points=N,
                                     num_classes=NUM_CLASSES)
        xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:16], np.float32)).to(dev)
        rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:16], np.float32)).to(dev)
        labels = torch.from_numpy(ds.labels[:16].astype(np.int64)).to(dev)
        reloaded = get_model(cfg.model.name, cfg.model.num_classes, **cfg.model.extra).to(dev)
        reloaded.load_state_dict(
            restore_checkpoint(str(exp_dir / "latest_checkpoint"), map_location=dev)["model"])
        model.eval()
        reloaded.eval()
        with torch.inference_mode():
            same = torch.equal(model(xyz[:4], rgb[:4]), reloaded(xyz[:4], rgb[:4]))
        if not same:
            raise AssertionError("train ptv3_big_prod: the reloaded checkpoint gives other logits")
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    hist = out["history"]
    print(f"train ptv3_big_prod: 2 epochs through train_cli in {wall:.2f} s wall (epochs "
          f"{[round(r['epoch_time_s'], 4) for r in hist]} s, lr {[r['lr'] for r in hist]}), "
          f"train loss {[round(r['train_loss'], 4) for r in hist]}, val OA "
          f"{[round(r['val_acc'], 4) for r in hist]}, launches {counts}, peak device memory "
          f"{mem / 2**20:.1f} MiB; reloaded latest_checkpoint through the config's model: "
          f"eval logits identical", flush=True)
    del model, out
    by_path = {"ptv3_big_prod_train_cli": counts}
    cw = losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES)).to(dev)
    batch = {"points": xyz, "colors": rgb, "labels": labels}
    for remat in (True, False):
        extra = dict(cfg.model.extra, remat=remat)
        step_model = get_model(cfg.model.name, cfg.model.num_classes,
                               generator=torch.Generator().manual_seed(SEED), **extra).to(dev)
        step = make_train_step(step_model, cfg.loss, make_optimizer(step_model.parameters()),
                               cfg.train.accum_steps)
        step(batch, 1e-4, cw)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        step(batch, 1e-4, cw)
        torch.cuda.synchronize()
        step_counts = _kernels.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: step(batch, 1e-4, cw), reps=10, warmup=2)
        step_mem = torch.cuda.max_memory_allocated()
        tag = "remat" if remat else "no remat"
        print(f"ptv3_big_prod step ({tag}): batch 16 x {N} as {cfg.train.accum_steps} "
              f"microbatches {step_ms:.3f} ms, {16 * N / step_ms * 1e3:.0f} points/s trained, "
              f"peak device memory {step_mem / 2**20:.1f} MiB; launches {step_counts}",
              flush=True)
        want = PROD_DEPTH * PROD_ACCUM
        expected = only(flash_attn_bf16=want * (2 if remat else 1), flash_attn_bwd_dq_bf16=want,
                        flash_attn_bwd_dkv_bf16=want)
        if step_counts != expected:
            raise AssertionError(f"ptv3_big_prod step ({tag}): launches {step_counts}")
        if remat:
            by_path[PROD_TRAIN] = step_counts
            profile_by_family("ptv3_big_prod step", "step", lambda: step(batch, 1e-4, cw), reps=5)
        del step_model, step
    return by_path


# ------------------------------------------ RandLA-Net and the superpoint models

RANDLA, RANDLA_SS = "randlanet_forward", "randlanet_ss_forward"
SPG_FWD, SPT_FWD = "spg_forward", "spt_forward"
RANDLA_TRAIN = "randlanet_train_step"
ZOO_B16 = "randlanet_forward_b16"
# points a level of randlanet at N = 4096 (ratios .35, .25, .25, .25)
RANDLA_LEVELS = (1433, 358, 89, 22)
# the input features' width a level of both models
RANDLA_WIDTHS = (8, 16, 64, 128)
# randlanet_ss's levels (ratio .25) and the 2k nearest its re-weighted k-NN
# takes there (k = 16, 8, 5, 4)
RANDLA_SS_KNN = ((1024, 32), (256, 16), (64, 10), (16, 8))
SUPERPOINTS = 81  # S = max(32 or 16, N // 50) of both superpoint models at N = 4096
SPT_DEGREE = 8  # edges into a superpoint: the 9 nearest centroids, self dropped
# a forward: one K5 a level and one K3 (the neighbourhoods; randlanet_ss's
# re-weighted k-NN gathers its 2k candidates with a second); one FPS (the
# k-means seeds); SPT adds its graph's
# K5 and the segment sums of its four attention layers (the softmax
# denominator and the messages), each one launch of the group-backward kernel
RANDLANET_LAUNCHES = only(knn=4, group=4)
RANDLANET_SS_LAUNCHES = only(knn=4, group=8)
SPG_LAUNCHES = only(fps=1)
SPT_LAUNCHES = only(fps=1, knn=1, group_bwd=8)
# a train step adds the backward of every gather with a gradient: randlanet's
# and randlanet_ss's kept features (4), neighbour features (4) and upsampling
# sources (4); SPG's two poolings; SPT's x_j, x_i and the softmax
# denominator a layer and the points' superpoint logits
RANDLANET_STEP_LAUNCHES = RANDLANET_LAUNCHES | {"group_bwd": 12}
RANDLANET_SS_STEP_LAUNCHES = RANDLANET_SS_LAUNCHES | {"group_bwd": 12}
SPG_STEP_LAUNCHES = SPG_LAUNCHES | {"group_bwd": 2}
SPT_STEP_LAUNCHES = SPT_LAUNCHES | {"group_bwd": 8 + 4 * 3 + 1}
# (label, S, K, C, N) of each gather with a gradient in a randlanet step at
# B = 4: the backward K3b runs at each
RANDLA_GATHERS = (
    ("level 0 kept", 1433, 1, 8, 4096), ("level 1 kept", 358, 1, 16, 1433),
    ("level 2 kept", 89, 1, 64, 358), ("level 3 kept", 22, 1, 128, 89),
    ("level 0 neighbours", 1433, 16, 8, 1433), ("level 1 neighbours", 358, 16, 16, 358),
    ("level 2 neighbours", 89, 16, 64, 89), ("level 3 neighbours", 22, 16, 128, 22),
    ("up 22->89", 89, 2, 256, 22), ("up 89->358", 358, 2, 256, 89),
    ("up 358->1433", 1433, 2, 128, 358), ("up 1433->4096", 4096, 2, 64, 1433),
)


def zoo_knn_case(res: Results, label, xyz, query, k, paths=()) -> dict:
    """K5 against knn_plain, indices and distances bit for bit, timed with
    the split of its time beside cdist + topk."""
    b, n, _ = xyz.shape
    s = query.shape[1]
    return res.check("knn", label, lambda: grouping.knn_cuda(xyz, query, k),
                     lambda: grouping.knn_plain(xyz, query, k), True, paths,
                     work=(nbytes(xyz, query) + b * s * k * 8, NEIGHBOUR_INSTRUCTIONS * b * s * n),
                     library_fn=lambda: (torch.cdist(query, xyz) ** 2).topk(k, largest=False),
                     split=True)


def compare_zoo_kernels(dev: torch.device, res: Results, rng) -> None:
    """Phase 3, the shapes of RandLA-Net and the superpoint models, before
    any of their phases: K5 over randlanet's levels (N = S = 1433, 358, 89,
    22, k = 16) at B = 4 and 16; over randlanet_ss's at the 2k its
    re-weighted k-NN takes (k = 32, 16, 10, 8 over 1024, 256, 64, 16);
    at k = 9 over 4096 points (density-weighted sampling) and over the 81
    centroids of SPT's graph; K3 over both models' levels (the
    neighbourhoods with the level's features, randlanet_ss's 2k candidates
    without); K1 4096 -> 81 (the k-means seeds)."""
    def cloud(b, n):
        return torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)

    for b, paths in ((B, (RANDLA,)), (16, (ZOO_B16,))):
        for n in RANDLA_LEVELS:
            xyz = cloud(b, n)
            zoo_knn_case(res, f"randlanet B={b} N=S={n} k=16", xyz, xyz, 16, paths)
    for n, k in RANDLA_SS_KNN:
        xyz = cloud(B, n)
        zoo_knn_case(res, f"randlanet_ss B={B} N=S={n} k={k}", xyz, xyz, k, (RANDLA_SS,))
    xyz = cloud(B, N)
    zoo_knn_case(res, f"density sampling B={B} N=S={N} k=9", xyz, xyz, 9)
    cent = cloud(B, SUPERPOINTS)
    zoo_knn_case(res, f"spt graph B={B} N=S={SUPERPOINTS} k=9", cent, cent, 9, (SPT_FWD,))
    # K3 on K5's graphs: each level's neighbourhoods with its input features,
    # and randlanet_ss's 2k candidates about a zero centre

    def group_case(label, n, k, c, path, zero_centre=False):
        xyz = cloud(B, n)
        feats = (torch.from_numpy(rng.normal(size=(B, n, c)).astype(np.float32)).to(dev)
                 if c else None)
        check_group(res, f"{label} B={B} N=S={n} K={k} C={c}", xyz,
                    torch.zeros_like(xyz) if zero_centre else xyz,
                    grouping.knn_cuda(xyz, xyz, k)[1], feats, (path,), timed=True)

    for n, c in zip(RANDLA_LEVELS, RANDLA_WIDTHS):
        group_case("randlanet", n, 16, c, RANDLA)
    for (n, k2), c, k in zip(RANDLA_SS_KNN, RANDLA_WIDTHS, (16, 8, 5, 4)):
        group_case("randlanet_ss", n, k, c, RANDLA_SS)
        group_case("randlanet_ss candidates", n, k2, 0, RANDLA_SS, zero_centre=True)
    check_fps(res, f"k-means seeds B={B} N={N} -> {SUPERPOINTS}", cloud(B, N), SUPERPOINTS,
              torch.zeros(B, dtype=torch.int32, device=dev), (SPG_FWD, SPT_FWD), timed=True)
    res.print_sums("knn", (RANDLA, ZOO_B16, RANDLA_SS, SPT_FWD))
    res.print_sums("group", (RANDLA, RANDLA_SS))


def compare_zoo_backward(dev: torch.device, res: Results, rng) -> None:
    """Phase 3b, K3b at the shapes of the new models: every gather with a
    gradient of a randlanet train step at B = 4 (the kept features of each
    level, the neighbours' features over the level's own k-NN, each
    decoder level's two upsampling sources; 8 to 256 channels, K = 1, 16
    and 2), and SPT's segment sums (the batch as one graph of B * 81 nodes,
    8 edges into each: the softmax denominator over 8 heads and the
    messages over 128 channels, four layers a forward), each held bit for
    bit to group_backward_order and timed beside index_add_."""
    from pointcloud_bridge_tpu_torch.models.randlanet import _upsample_plan

    for label, s, k, c, n in RANDLA_GATHERS:
        if k == 1:  # the stride subset
            idx = (torch.arange(s, device=dev) * max(1, n // s) % n).view(1, s, 1)
        elif k == 2:
            idx = _upsample_plan(n, s, torch.float32, dev)[0].view(1, s, 2)
        else:
            xyz = torch.from_numpy(rng.uniform(size=(B, n, 3)).astype(np.float32)).to(dev)
            idx = grouping.knn_cuda(xyz, xyz, k)[1]
        idx = idx.expand(B, -1, -1).to(torch.int32).contiguous()
        g = torch.from_numpy(rng.normal(size=(B, s, k, c)).astype(np.float32)).to(dev)
        check_group_bwd(res, f"randlanet {label} S={s} K={k} C={c} N={n}", g, idx, n, 0, c,
                        (RANDLA_TRAIN,), timed=True)
    nodes, edges = B * SUPERPOINTS, B * SUPERPOINTS * SPT_DEGREE
    dst = torch.arange(nodes, device=dev).repeat_interleave(SPT_DEGREE).view(1, edges, 1)
    dst = dst.to(torch.int32).contiguous()
    for label, c in (("softmax denominator", 8), ("messages", 128)):
        g = torch.from_numpy(rng.normal(size=(1, edges, 1, c)).astype(np.float32)).to(dev)
        check_group_bwd(res, f"spt segment sum, {label} E={edges} C={c} S={nodes}", g, dst,
                        nodes, 0, c, (SPT_FWD,), timed=True, times=4)
    res.print_sums("group_bwd", (RANDLA_TRAIN, SPT_FWD))


def stat_knn_plain(real, xyz, k):
    """knn_stat_weighted on knn_plain and the plain gather -> (its picks,
    their weighted distances)."""
    n = xyz.shape[1]
    k = min(k, n)
    d2, idx2 = grouping.knn_plain(xyz, xyz, min(2 * k, n))
    pts = grouping.group_plain(xyz, torch.zeros_like(xyz), idx2)
    weighted = grouping.stat_weighted_distance(pts, d2)
    order = weighted.argsort(dim=-1, stable=True)[..., :k]
    return idx2.gather(-1, order).to(torch.int32), weighted.gather(-1, order)


def kmeans_plain(real, xyz, s, iters=3):
    """kmeans_partition with the plain FPS seeds -> (its partition, the
    squared distances [B, N, S] to the centroids its last round took)."""
    if iters < 2:
        raise ValueError(f"kmeans_plain: {iters} rounds, the models take 3")
    real_fps = spg_models.farthest_point_sample
    spg_models.farthest_point_sample = lambda x, m: sampling.fps_plain(
        x, m, torch.zeros(x.shape[0], dtype=torch.int32, device=x.device))
    try:
        assign = real(xyz, s, iters)[0]
        prior = real(xyz, s, iters - 1)[1]
    finally:
        spg_models.farthest_point_sample = real_fps
    return assign, core_ops.square_distance(xyz, prior)


def top_k_plain(real, scores, k):
    """top_k_nodes has no kernel -> (its picks, their scores)."""
    idx = real(scores, k)
    return idx, scores.gather(-1, idx)


def knn_picks_plain(real, xyz, k):
    """The port's knn on knn_plain -> (its picks, their squared distances)."""
    d2, idx = grouping.knn_plain(xyz, xyz, k)
    return idx, d2


class PickTap:
    """The discrete picks of a forward (a k-means partition, a top-k, a
    k-NN graph), through wrappers of the port's functions where a model
    module calls them (``sites``: (module, name, plain)). A call on the card
    runs the function and records its inputs and output, unless ``frozen``;
    a call on the CPU replays what the card recorded for that function,
    call by call in the same order (cycling, so each CPU forward takes the
    same picks). The picks come from GEMMs and reductions (the partition's
    distances, the poolings' scores, the centroids the graph is built over,
    the re-weighted k-NN's weights), which the card and the CPU round
    differently, so ``check`` holds what the card recorded: ``plain(real,
    *inputs)`` on the card (the function on the plain versions of its
    kernels) gives the same picks, and the CPU's function on the same
    inputs differs only at ties."""

    def __init__(self, sites):
        self.sites, self.real = sites, {}
        self.card = {name: [] for _, name, _ in sites}
        self.at = dict.fromkeys(self.card, 0)
        self.frozen = False

    def __enter__(self):
        for mod, name, _ in self.sites:
            self.real[name] = getattr(mod, name)
            setattr(mod, name, functools.partial(self._call, name, self.real[name]))
        return self

    def __exit__(self, *exc):
        for mod, name, _ in self.sites:
            setattr(mod, name, self.real[name])

    def start(self) -> None:
        """Record the next card forward's picks, in place of the last ones."""
        self.card = {name: [] for name in self.card}
        self.frozen = False

    def stop(self) -> None:
        """Record no more; CPU forwards replay from the first pick."""
        self.frozen = True
        self.at = dict.fromkeys(self.card, 0)

    def _call(self, name, real, *args, **kwargs):
        first = next(a for a in args if torch.is_tensor(a))
        if first.is_cuda:
            out = real(*args, **kwargs)
            if not self.frozen:
                keep = lambda t: t.detach().clone() if torch.is_tensor(t) else t  # noqa: E731
                self.card[name].append(([keep(a) for a in args], kwargs,
                                        tuple(map(keep, out)) if isinstance(out, tuple)
                                        else keep(out)))
            return out
        kept = self.card[name]
        out = kept[self.at[name] % len(kept)][2]
        self.at[name] += 1
        return tuple(t.cpu() for t in out) if isinstance(out, tuple) else out.cpu()

    def check(self, label: str) -> dict:
        """Each call the card recorded: ``plain`` on its inputs on the card
        gives the card's picks exactly; the CPU's function on the same
        inputs moved to the CPU makes the same picks but at ties, each
        pick that differs within PICK_TIE of its row's boundary (the k-th
        value of a set, the distance to the card's centroid of a
        partition) -> per site, the picks that differ and their largest
        gap."""
        report = {}
        for _, name, plain in self.sites:
            calls = self.card[name]
            if not calls:
                raise AssertionError(f"{label}: {name} recorded no call on the card")
            differ, total, worst = 0, 0, 0.0
            for at, (args, kwargs, out) in enumerate(calls):
                got = out[0] if isinstance(out, tuple) else out
                want, values = plain(self.real[name], *args, **kwargs)
                if not torch.equal(got, want.to(got.dtype)):
                    raise AssertionError(f"{label}: {name} call {at}: the card's picks differ "
                                         "from the plain path's on the card on its own inputs")
                cpu = self.real[name](*[a.cpu() if torch.is_tensor(a) else a for a in args],
                                      **kwargs)
                cpu = (cpu[0] if isinstance(cpu, tuple) else cpu).to(got.device)
                if got.dim() == values.dim():  # rows of k picks
                    missing, gaps = set_gaps(got, cpu, values)
                else:  # a partition: each point's distance to the centroid of each side
                    missing = got != cpu
                    near = values.gather(-1, got.long().unsqueeze(-1))[..., 0]
                    far = values.gather(-1, cpu.long().unsqueeze(-1))[..., 0]
                    gaps = ((far - near).abs() / near.abs().clamp_min(1e-30))[missing].double()
                differ, total = differ + int(missing.sum()), total + got.numel()
                worst = max(worst, gaps.max().item() if gaps.numel() else 0.0)
            report[name] = (differ, worst)
            print(f"{label}: {name}: {len(calls)} calls, the card's picks equal to the plain "
                  f"path's on the card; {differ} of {total} picks differ on the CPU on the "
                  f"same inputs, the largest gap to the boundary {worst:.3g} relative", flush=True)
            if worst > PICK_TIE:
                raise AssertionError(f"{label}: {name}: a pick differs on the CPU beyond a tie "
                                     f"({worst:.3g} > {PICK_TIE})")
        return report


def zoo_sites(name: str) -> list:
    """The picks to replay on the CPU for ``name``: randlanet_ss's
    re-weighted k-NN (its weights come from reductions and exp, which the
    devices round differently), SPG's partition and three top-k, SPT's
    partition and graph; none for randlanet (K5 over the same gathered
    points is bit for bit knn_plain)."""
    return {"randlanet": [],
            "randlanet_ss": [(randla_models, "knn_stat_weighted", stat_knn_plain)],
            "spg": [(spg_models, "kmeans_partition", kmeans_plain),
                    (spg_models, "top_k_nodes", top_k_plain)],
            "spt": [(spt_models, "kmeans_partition", kmeans_plain),
                    (spt_models, "knn", knn_picks_plain)]}[name]


# leaves that no gradient reaches, by name prefix: SPG's pooling scores pick
# nodes and weigh nothing (tests/test_torch_spg.py)
ZOO_UNREACHED = {"spg": ("gpool1.score", "gpool2.score")}


ZOO = (("randlanet", RANDLA, RANDLANET_LAUNCHES, RANDLANET_STEP_LAUNCHES),
       ("randlanet_ss", RANDLA_SS, RANDLANET_SS_LAUNCHES, RANDLANET_SS_STEP_LAUNCHES),
       ("spg", SPG_FWD, SPG_LAUNCHES, SPG_STEP_LAUNCHES),
       ("spt", SPT_FWD, SPT_LAUNCHES, SPT_STEP_LAUNCHES))


def check_zoo_forward(name: str, ds: BlockDataset, dev: torch.device, launches: dict,
                      seed: int) -> dict:
    """Phase 34, one model: the registry's default model at B=4 x 4096,
    random weights and BatchNorm statistics, on the card against the CPU
    with the card's picks replayed there (PickTap): logits within 2e-4,
    exactly ``launches``; the card's picks held by ``PickTap.check``;
    forward ms, points/s and device time by kernel family -> the counts."""
    label = f"{name} forward"
    model = seeded_model(name, seed)
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    xyz_cpu, rgb_cpu = batch_of(ds)[:2]
    xyz, rgb = xyz_cpu.to(dev), rgb_cpu.to(dev)
    with torch.inference_mode(), PickTap(zoo_sites(name)) as tap:
        _kernels.reset_launch_counts()
        out = model(xyz, rgb)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        if counts != launches:
            raise AssertionError(f"{label}: launches {counts}, expected {launches}")
        tap.stop()
        tap.check(label)
        t0 = time.perf_counter()
        ref = cpu_model(xyz_cpu, rgb_cpu)
        cpu_s = time.perf_counter() - t0
        out = out.cpu()
        err = max_abs_err(out, ref)
        agree = (out.argmax(-1) == ref.argmax(-1)).double().mean().item()
        print(f"{label}: logits {tuple(out.shape)} CUDA vs CPU (the card's picks replayed: "
              f"{ {k: len(v) for k, v in tap.card.items()} }) max|err| {err:.3g} (max|logit| "
              f"{ref.abs().max().item():.3g}), argmax agreement {agree:.6f}, launches {counts}, "
              f"CPU reference forward {cpu_s:.2f} s (host)", flush=True)
        if out.shape != (B, N, NUM_CLASSES) or not torch.isfinite(out).all():
            raise AssertionError(f"{label}: logits {tuple(out.shape)} not finite")
        if not torch.allclose(out, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL):
            raise AssertionError(f"{label}: CUDA logits differ from CPU by {err}")
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(xyz, rgb))
        print(f"{label}: B={B} N={N} {fwd_ms:.3f} ms, {B * N / fwd_ms * 1e3:.0f} points/s",
              flush=True)
        profile_by_family(label, "forward", lambda: model(xyz, rgb))
    return counts


def check_zoo_train_step(name: str, ds: BlockDataset, dev: torch.device, launches: dict,
                         seed: int) -> dict:
    """Phase 35, one model: one train step at the registry's width, B=4 x
    4096, every Dropout at p = 0 on both copies, weighted CE, on the card
    against the CPU, checked as phase 6 (frozen BatchNorms first, then
    train mode, run twice from the same state), the CPU taking the card's
    picks of the same mode, with exactly ``launches`` -> those counts."""
    label = f"{name} train step"
    model = no_dropout(seeded_model(name, seed))
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    xyz, rgb, labels, cw = batch_of(ds)
    with PickTap(zoo_sites(name)) as tap:
        tap.start()
        model.eval()
        with torch.no_grad():
            model(xyz.to(dev), rgb.to(dev))
        tap.stop()
        tap.check(f"{name} eval-mode picks")
        unreached = ZOO_UNREACHED.get(name, ())
        check_frozen_bn_gradients(model, cpu_model, xyz, rgb, labels, cw,
                                  label=f"{name} frozen-BN gradients", unreached=unreached)
        # train mode: the picks of a train-mode forward of a copy (the batch
        # statistics set the features that SPG's poolings score)
        tap.start()
        with torch.no_grad():
            copy.deepcopy(model).train()(xyz.to(dev), rgb.to(dev))
        tap.stop()
        tap.check(f"{name} train-mode picks")
        counts = check_train_step(model, cpu_model, xyz, rgb, labels, cw, None, launches, label,
                                  zero_below=1e-4,
                                  needed=tuple(k for k, v in launches.items() if v),
                                  unreached=unreached)
    step_ms = time_ms(lambda: loss_and_grads(model, xyz, rgb, labels, cw), reps=10)
    print(f"{label}: forward and backward {step_ms:.3f} ms, {B * N / step_ms * 1e3:.0f} "
          f"points/s", flush=True)
    return counts


def time_and_serve(name: str, data_dir: Path, n_blocks: int, dev: torch.device,
                   launches: dict, seed: int) -> dict:
    """Phase 37, one model (no recipe in either package): the batch-16 step
    at the registry's defaults (Adam, weighted CE with the scene's class
    weights) timed (ms, points/s, peak memory) and profiled by kernel
    family, then ``infer_cli blocks --model name`` from a checkpoint
    written here, with exactly ``launches`` a forward batch -> the serve's
    counts."""
    model = seeded_model(name, seed).to(dev)
    ds = BlockDataset.from_files([str(data_dir / "bridge_0.las")], num_points=N,
                                 num_classes=NUM_CLASSES)
    batch = {"points": torch.from_numpy(np.ascontiguousarray(ds.points[:16], np.float32)).to(dev),
             "colors": torch.from_numpy(np.ascontiguousarray(ds.colors[:16], np.float32)).to(dev),
             "labels": torch.from_numpy(ds.labels[:16].astype(np.int64)).to(dev)}
    cw = losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES)).to(dev)
    step = make_train_step(model, LossConfig(name="weighted_ce"),
                           make_optimizer(model.parameters()))
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(batch, 1e-4, cw), reps=20, warmup=5)
    mem = torch.cuda.max_memory_allocated()
    print(f"{name} step: batch 16 x {N} {step_ms:.3f} ms, {16 * N / step_ms * 1e3:.0f} points/s "
          f"trained, peak device memory {mem / 2**20:.1f} MiB", flush=True)
    profile_by_family(f"{name} step", "step", lambda: step(batch, 1e-4, cw))
    ckpt = data_dir / f"{name}_checkpoint"
    save_checkpoint(str(ckpt), {"model": model.state_dict(), "epoch": 0})
    label = f"serve {name} blocks"
    counts = serve_blocks(label, name, ckpt, tuple(k for k, v in launches.items() if v),
                          data_dir, n_blocks, dev, forward_kernels=("group_bwd",))
    batches = -(-n_blocks // 16)
    if counts != {k: batches * v for k, v in launches.items()}:
        raise AssertionError(f"{label}: launches {counts}, {batches} batches")
    return counts


def run_zoo_phases(ds: BlockDataset, data_dir: Path, dev: torch.device) -> tuple:
    """Phases 34-37 -> (launch counts of one forward by path, launch counts
    of the steps, the training run and the serves by path)."""
    passes, by_path = {}, {}
    for i, (name, path, launches, _) in enumerate(ZOO):
        passes[path] = check_zoo_forward(name, ds, dev, launches, SEED + 340 + i)
    for i, (name, _, _, launches) in enumerate(ZOO):
        by_path[f"{name}_train_step"] = check_zoo_train_step(name, ds, dev, launches,
                                                             SEED + 350 + i)
    passes[RANDLA_TRAIN] = by_path["randlanet_train_step"]
    # 36. configs/train_randlanet.yaml through the training CLI, then served
    by_path["randlanet_train_cli"], exp_dir = train_through_cli(
        "train randlanet (configs/train_randlanet.yaml)", "randlanet",
        ("knn", "group", "group_bwd"),
        data_dir, dev, profile=True, recipe=ROOT / "configs" / "train_randlanet.yaml")
    try:
        label = "serve trained randlanet blocks"
        counts = serve_blocks(label, "randlanet", exp_dir, ("knn", "group"), data_dir, len(ds),
                              dev)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    if counts != {k: -(-len(ds) // 16) * v for k, v in RANDLANET_LAUNCHES.items()}:
        raise AssertionError(f"{label}: launches {counts}")
    by_path["randlanet_serve_trained"] = counts
    # 37. spg and spt: the batch-16 step, then served from a checkpoint
    for i, (name, _, launches, _) in enumerate(ZOO[2:]):
        by_path[f"{name}_serve_blocks"] = time_and_serve(name, data_dir, len(ds), dev, launches,
                                                         SEED + 370 + i)
    return passes, by_path


# 38-39. multi-step dispatch (train.steps_per_dispatch): K train steps, and K
# eval batches, a CUDA graph replay
GRAPH_K = 4
GRAPH_B = 16
GRAPH_LR = 1e-3
GRAPH_EMA = 0.999


def recipe(name: str) -> tuple:
    """(model name, model_extra, loss config) of configs/<name>."""
    cfg = Config.from_yaml(str(ROOT / "configs" / name))
    return cfg.model.name, dict(cfg.model.extra), cfg.loss


WEIGHTED_CE = LossConfig(name="weighted_ce")
# phase 38: (label, model, model_extra, loss config, a RandLA-Net sampling
# generator, batch); --graphs adds GRAPH_MORE
GRAPH_STEPS = (
    ("pointnet2_ssg", "pointnet2_ssg", {}, WEIGHTED_CE, False, GRAPH_B),
    ("pointnet2_msg (configs/train_partsize_msg.yaml)", *recipe("train_partsize_msg.yaml"), False,
     GRAPH_B),
    ("bristrunet (configs/train_bristrunet.yaml)", *recipe("train_bristrunet.yaml"), False,
     GRAPH_B),
    ("ptv3_pooled (benched)", "ptv3_pooled", POOLED_BENCHED, WEIGHTED_CE, False, GRAPH_B),
)
GRAPH_MORE = (
    ("dgcnn (configs/train_dgcnn.yaml)", *recipe("train_dgcnn.yaml"), False, GRAPH_B),
    ("pointnet (configs/train_pointnet.yaml)", *recipe("train_pointnet.yaml"), False, GRAPH_B),
    ("enhanced_pointnet2_ssg", "enhanced_pointnet2_ssg", {}, WEIGHTED_CE, False, GRAPH_B),
    ("randlanet (configs/train_randlanet.yaml)", *recipe("train_randlanet.yaml"), False,
     GRAPH_B),
    ("randlanet_ss, density sampling", "randlanet_ss", {}, WEIGHTED_CE, True, GRAPH_B),
    ("spg", "spg", {}, WEIGHTED_CE, False, GRAPH_B),
    ("spt", "spt", {}, WEIGHTED_CE, False, GRAPH_B),
    ("ptv3", "ptv3", {}, WEIGHTED_CE, False, GRAPH_B),
    # batch 8: at 16 the eager step's 40.7 GB and the graph's pool of as
    # much do not fit on the card together
    ("ptv3_moe", "ptv3_moe", {}, WEIGHTED_CE, False, 8),
    ("ptv3 bf16 stream", "ptv3", {"stream_dtype": "bfloat16"}, WEIGHTED_CE, False, GRAPH_B),
    ("ptv3_pooled remat (benched)", "ptv3_pooled", dict(POOLED_BENCHED, remat=True),
     WEIGHTED_CE, False, GRAPH_B),
)


def stacked_batches(ds: BlockDataset, dev: torch.device, seed: int, b: int = GRAPH_B) -> dict:
    """GRAPH_K batches of b blocks of ds stacked [K, b, ...] on the card,
    as the trainer's group_batches and put_batch give them: a seeded
    permutation of the blocks, another after it where K * b exceeds them."""
    rng = np.random.default_rng(seed)
    want = GRAPH_K * b
    order = np.concatenate([rng.permutation(len(ds)) for _ in range(-(-want // len(ds)))])
    order = order[:want].reshape(GRAPH_K, b)
    return {"points": torch.from_numpy(np.ascontiguousarray(ds.points[order], np.float32)).to(dev),
            "colors": torch.from_numpy(np.ascontiguousarray(ds.colors[order], np.float32)).to(dev),
            "labels": torch.from_numpy(ds.labels[order].astype(np.int64)).to(dev)}


def step_outcome(model, optimizer, ema: dict, gens: list, metrics: dict) -> dict:
    """Copies of what train steps leave behind, by name: the metrics, every
    parameter and buffer, the Adam moments and step count, the EMA tensors
    and the generators' states (the trainer's Dropout generator, a sampling
    generator, torch's default one on the card)."""
    names = {id(p): k for k, p in model.named_parameters()}
    out = {f"metric {k}": v.clone() for k, v in metrics.items()}
    out |= {f"parameter {k}": p.detach().clone() for k, p in model.named_parameters()}
    out |= {f"buffer {k}": v.clone() for k, v in model.named_buffers()}
    out |= {f"adam {key} {names[id(p)]}": v.clone() for p, st in optimizer.state.items()
            for key, v in st.items() if torch.is_tensor(v)}
    out |= {f"ema {k}": v.clone() for k, v in ema.items()}
    out |= {f"generator {i}": g.get_state() for i, g in enumerate(gens)}
    out["generator cuda default"] = torch.cuda.get_rng_state(next(model.parameters()).device)
    return out


def dispatch_walls(variants: dict, rounds: int = 3) -> dict:
    """Host ms of one dispatch of each variant (name -> fn), from a
    synchronise to a synchronise, in turns A B C C B A of ``rounds``
    dispatches each (after one to warm up) -> name -> [ms, ...]."""
    for fn in variants.values():
        fn()
    walls = {name: [] for name in variants}
    order = list(variants) + list(reversed(variants))
    for name in order:
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            variants[name]()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    return walls


def check_graph_steps(label: str, name: str, extra: dict, loss_cfg, ds: BlockDataset,
                      dev: torch.device, seed: int, sampling: bool = False,
                      b: int = GRAPH_B, rounds: int = 3) -> dict:
    """Phase 38, one model: K = 4 train steps at batch b (Adam at lr 1e-3,
    the loss of ``loss_cfg`` with the blocks' class weights, EMA 0.999, the
    Dropouts on one generator as the trainer sets them, ``sampling``: a
    RandLA-Net sampling generator too), from one saved state (one eager
    step in: moments and a step count), as K eager steps and as one
    dispatch of MultiTrainStep (warm-up, restore, capture, replay), both on
    the capturable optimizer, which the multi-step path takes. Held with
    torch.equal: the K losses and accuracies, every parameter and buffer,
    the Adam moments and step, the EMA and the generators' states after; the
    kernels of one replay (counted at the capture) equal to those of the K
    eager steps. Then host ms a step in turns (the spd = 1 eager step on its
    own optimizer, the K eager steps on the capturable one, the graph),
    device busy ms a step and the idle share from torch.profiler, and peak
    device memory of each (``rounds`` dispatches of each in turns) -> the
    numbers by key."""
    t_start = time.perf_counter()
    model = seeded_model(name, seed, **extra).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    if sampling:
        model.sampling_generator = torch.Generator(device=dev).manual_seed(seed + 1)
    optimizer = make_optimizer(model.parameters(), capturable=True)
    ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    multi = MultiTrainStep(model, loss_cfg, optimizer, GRAPH_K, ema, GRAPH_EMA)
    cw = losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES)).to(dev)
    batches = stacked_batches(ds, dev, seed, b)
    slots = [{key: batches[key][i] for key in TRAIN_KEYS} for i in range(GRAPH_K)]
    set_lr(optimizer, GRAPH_LR)
    multi.run(slots[:1], cw)
    gens = model_generators(model)
    state = StepState(model, optimizer, ema, gens)

    mem = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    eager = step_outcome(model, optimizer, ema, gens, multi.run(slots, cw))
    torch.cuda.synchronize()
    eager_launches = _kernels.launch_counts()
    mem["eager"] = (torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved())
    state.restore()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph = step_outcome(model, optimizer, ema, gens, multi(batches, GRAPH_LR, cw))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    mem["graph"] = (torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved())
    (steps,) = multi.graphs.values()
    differ = [key for key, want in eager.items() if not torch.equal(want, graph[key])]
    print(f"{label}: {GRAPH_K} eager steps against one {GRAPH_K}-step graph dispatch "
          f"(capturable Adam on both): {len(differ)} of {len(eager)} tensors differ"
          f"{': ' + ', '.join(differ[:6]) if differ else ' (torch.equal)'}; losses "
          f"{[round(v, 6) for v in eager['metric loss'].tolist()]}; launches a dispatch "
          f"{ {k: v for k, v in steps.launches.items() if v} } (eager "
          f"{ {k: v for k, v in eager_launches.items() if v} }); first dispatch (warm-up step, "
          f"capture, replay) {first_s:.3f} s", flush=True)
    if differ:
        raise AssertionError(f"{label}: the graph dispatch differs from {GRAPH_K} eager steps: "
                             f"{differ[:12]}")
    if steps.launches != eager_launches:
        raise AssertionError(f"{label}: a replay launches {steps.launches}, the eager steps "
                             f"{eager_launches}")

    # the spd = 1 path: make_train_step on the eager optimizer (its own
    # state; the weights move on, which no timing minds)
    plain_opt = make_optimizer(model.parameters())
    plain_step = make_train_step(model, loss_cfg, plain_opt)

    def plain():
        for s in slots:
            plain_step(s, GRAPH_LR, cw)
            ema_update(ema, multi.params, GRAPH_EMA)

    def eager_k():
        set_lr(optimizer, GRAPH_LR)
        multi.run(slots, cw)

    variants = {"eager": plain, "eager capturable": eager_k,
                "graph": lambda: multi(batches, GRAPH_LR, cw)}
    walls = dispatch_walls(variants, rounds)
    replay_ms = time_ms(steps.graph.replay, reps=5, warmup=1) / GRAPH_K
    out = {}
    for key, fn in variants.items():
        busy, wall = profile_by_family(f"{label} {key}", f"{GRAPH_K}-step dispatch", fn, reps=1,
                                       quiet=True)
        ms = [w / GRAPH_K for w in walls[key]]
        out[key] = {"ms": statistics.median(ms), "min": min(ms), "max": max(ms),
                    "busy_ms": busy / GRAPH_K, "idle": max(0.0, 1 - busy / wall) if busy else None}
        line = (f"{label} {key}: batch {b} x {N}, {statistics.median(ms):.3f} ms a step "
                f"(median of {len(ms)} dispatches of {GRAPH_K}, {min(ms):.3f}-{max(ms):.3f}), ")
        line += (f"busy {busy / GRAPH_K:.3f} ms a step, idle {max(0.0, 1 - busy / wall):.1%} "
                 "(profiler on)" if busy else "busy not measured (the profiler saw no device time)")
        if key == "graph":
            line += f", the replay alone {replay_ms:.3f} ms a step between two events"
        if key in mem:
            alloc, reserved = mem[key]
            out[key] |= {"peak_mib": alloc / 2**20, "reserved_mib": reserved / 2**20}
            line += (f", peak device memory {alloc / 2**20:.1f} MiB allocated, "
                     f"{reserved / 2**20:.1f} MiB reserved"
                     + (" (warm-up, capture and first replay)" if key == "graph" else ""))
        print(line, flush=True)
    out["graph"]["replay_ms"] = replay_ms
    out["launches"] = {k: v for k, v in steps.launches.items() if v}
    print(f"{label}: phase 38 in {time.perf_counter() - t_start:.1f} s (host)", flush=True)
    return out


def run_graph_phases(ds: BlockDataset, dev: torch.device, models=GRAPH_STEPS) -> dict:
    """Phase 38 over ``models`` -> label -> its numbers; each model's graphs
    and their memory pools freed before the next."""
    out = {}
    for i, (label, name, extra, loss_cfg, sampling, b) in enumerate(models):
        out[label] = check_graph_steps(label, name, extra, loss_cfg, ds, dev, SEED + 380 + i,
                                       sampling, b)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 45
# the models of the two-form phase: (label, model, model_extra, loss, seed);
# dgcnn with its recipe's loss, dgcnn_global at the registry's defaults
EDGECONV_FORM_MODELS = (
    ("dgcnn (configs/train_dgcnn.yaml)", *recipe("train_dgcnn.yaml"), SEED + 450),
    ("dgcnn_global", "dgcnn_global", {}, WEIGHTED_CE, SEED + 451),
)
# a [16, 4096, 64, 64] float32 tensor: what one restructured EdgeConv
# forward at B = 16, k = 64, F = 64 must raise the allocator's peak by less
EDGE_PEAK_LIMIT = 16 * N * 64 * 64 * 4
# dgcnn_global's conv4 at the batch-16 step (B = 16, C = 64, F = 128, k =
# 64): one train-mode EdgeConv forward and backward on K7 and K7b must raise
# the peak by less than a quarter of the first design's per-edge scratch [B, N, k, F]
EDGE_BWD_SHAPE = (16, 64, 128, 64)
EDGE_BWD_PEAK_LIMIT = 16 * N * 64 * 128 * 4 // 4
# phase 45's EdgeConv forms: (label, restructured, the first K7 and K7b)
EDGECONV_FORMS = (("literal", False, False), ("restructured", True, False),
                  ("restructured on the first K7, K7b", True, True))


@contextlib.contextmanager
def edgeconv_design(first: bool):
    """ops/edge.py's K7 and K7b wrappers inside the block: the port's, or
    with ``first`` the first design's (probes/k7_probe.py), whose launches no counter
    of the package sees."""
    saved = k7_probe.use_first_design(edge_ops) if first else None
    try:
        yield
    finally:
        if saved:
            k7_probe.restore(edge_ops, saved)


def edgeconv_peak(dev: torch.device, fast: bool, shape=(16, 64, 64, 64), backward=False,
                  first=False) -> int:
    """Bytes that one train-mode EdgeConv (B, C, F, k = ``shape``, N = 4096,
    its autograd graph kept) raises the allocator's peak by, in the given
    form (and, with ``first``, on the first K7 and K7b), after a first call
    has warmed its plans: the forward, and with ``backward`` the backward
    of sum(out * cot) too."""
    b, c, f, k = shape
    gen = torch.Generator().manual_seed(SEED + 452)
    conv = dgcnn_models.EdgeConv(c, f, k, gen).to(dev)
    bn = BatchNorm(f).to(dev).train()
    x = torch.randn(b, N, c, generator=gen).to(dev).requires_grad_(backward)
    cot = torch.randn(b, N, f, generator=gen).to(dev) if backward else None

    def run():
        out = conv(x, bn)
        if backward:
            out.backward(cot)
        return out

    with edgeconv_form(fast), edgeconv_design(first):
        run()
        torch.cuda.synchronize()
        conv.zero_grad(set_to_none=True)
        x.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def form_forward(label: str, name: str, seed: int, ds: BlockDataset, dev: torch.device,
                 fast: bool, first: bool = False) -> dict:
    """The B=4 x 4096 eval forward of ``name`` in one EdgeConv form (with
    ``first`` on the first K7): its launches (DGCNN_LAUNCHES, or
    DGCNN_LITERAL_LAUNCHES where no K7 of the package runs), ms by CUDA
    events, device-busy ms and K5c's and K7's ms from one torch.profiler run."""
    model = seeded_model(name, seed).to(dev)
    xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32)).to(dev)
    rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32)).to(dev)
    want = DGCNN_LAUNCHES if fast and not first else DGCNN_LITERAL_LAUNCHES
    with edgeconv_form(fast), edgeconv_design(first), torch.inference_mode():
        _kernels.reset_launch_counts()
        model(xyz, rgb)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected {want}")
        ms = time_ms(lambda: model(xyz, rgb))
        fams = {}
        busy, wall = profile_by_family(label, "forward", lambda: model(xyz, rgb), quiet=True,
                                       families=fams)
    k5c = fams.get("K5c k-NN over C channels", 0.0)
    return {"ms": ms, "busy_ms": busy, "idle": max(0.0, 1 - busy / wall) if busy else None,
            "k5c_ms": k5c, "k5c_share": k5c / busy if busy else None,
            "k7_ms": fams.get("K7 edge reduce", 0.0), "families": fams}


def compare_edgeconv_forms(ds: BlockDataset, dev: torch.device) -> dict:
    """Phase 45: dgcnn and dgcnn_global in both EdgeConv forms on the card
    (PCB_EDGECONV_FAST=0 and 1), where FIRST_DESIGN_TURNS the restructured
    one also on the first K7 and K7b (probes/k7_probe.py): the B=4 x 4096
    forward in turns (literal, restructured, restructured, literal, or
    literal, the first, restructured, restructured, the first, literal: ms,
    device-busy ms, K5c's share); the batch-16 train step eager and as a
    steps_per_dispatch: 4 graph replay (phase 38's check_graph_steps: the
    replay's bits against 4 eager steps; ms, idle share, peak MiB); then the
    allocator's peak of one train-mode EdgeConv forward at B = 16, k = 64,
    F = 64 in each form, the restructured one under EDGE_PEAK_LIMIT, and of
    one forward and backward at dgcnn_global's conv4 (EDGE_BWD_SHAPE),
    under EDGE_BWD_PEAK_LIMIT (and on the first design where
    FIRST_DESIGN_TURNS) -> the numbers by model and form."""
    t_start = time.perf_counter()
    out = {}
    forms = EDGECONV_FORMS if FIRST_DESIGN_TURNS else EDGECONV_FORMS[:2]
    order = (0, 2, 1, 1, 2, 0) if FIRST_DESIGN_TURNS else (0, 1, 1, 0)
    for label, name, extra, loss_cfg, seed in EDGECONV_FORM_MODELS:
        turns = [form_forward(f"{name} {forms[i][0]} forward", name, seed, ds, dev,
                              *forms[i][1:]) for i in order]
        for i, (form, fast, first) in enumerate(forms):
            mine = [t for t, j in zip(turns, order) if j == i]
            fwd = {key: statistics.median(t[key] for t in mine)
                   for key in ("ms", "busy_ms", "k5c_ms", "k7_ms")}
            fwd["k5c_share"] = fwd["k5c_ms"] / fwd["busy_ms"] if fwd["busy_ms"] else None
            times = ", ".join(f"{t['ms']:.3f}" for t in mine)
            print(f"{name} {form} forward: B={B} N={N} {times} ms (in turns), busy "
                  f"{fwd['busy_ms']:.3f} ms, K5c {fwd['k5c_ms']:.3f} ms "
                  f"({fwd['k5c_share'] or 0:.1%} of busy), K7 {fwd['k7_ms']:.3f} ms; by family "
                  f"{ {k: round(v, 4) for k, v in mine[0]['families'].items()} }", flush=True)
            with edgeconv_form(fast), edgeconv_design(first):
                step = check_graph_steps(f"{label} {form}", name, extra, loss_cfg, ds, dev, seed,
                                         rounds=2)
            out[f"{name} {form}"] = {"forward": fwd, "step": step}
            gc.collect()
            torch.cuda.empty_cache()
    peaks = {form: edgeconv_peak(dev, fast) for form, fast in (("literal", False),
                                                               ("restructured", True))}
    print(f"one train-mode EdgeConv forward at B=16 N={N} C=F=64 k=64: peak +"
          f"{peaks['restructured'] / 2**20:.1f} MiB restructured, +"
          f"{peaks['literal'] / 2**20:.1f} MiB literal (limit "
          f"{EDGE_PEAK_LIMIT / 2**20:.1f} MiB, one [16, 4096, 64, 64] float32 tensor)",
          flush=True)
    if peaks["restructured"] >= EDGE_PEAK_LIMIT:
        raise AssertionError(f"the restructured EdgeConv raised the peak by "
                             f"{peaks['restructured']} bytes")
    mine = edgeconv_peak(dev, True, EDGE_BWD_SHAPE, True)
    first = edgeconv_peak(dev, True, EDGE_BWD_SHAPE, True, True) if FIRST_DESIGN_TURNS else None
    b, c, f, k = EDGE_BWD_SHAPE
    beside = f" {{the first design: +{first / 2**20:.1f} MiB}}" if first is not None else ""
    print(f"one train-mode EdgeConv forward and backward at B={b} N={N} C={c} F={f} k={k} "
          f"(dgcnn_global's conv4), restructured: peak +{mine / 2**20:.1f} MiB{beside} (limit "
          f"{EDGE_BWD_PEAK_LIMIT / 2**20:.1f} MiB, a quarter of the first design's per-edge "
          f"scratch)", flush=True)
    if mine >= EDGE_BWD_PEAK_LIMIT:
        raise AssertionError(f"K7b's EdgeConv forward and backward raised the peak by {mine} "
                             f"bytes")
    out["edgeconv_peak_bytes"] = peaks
    out["edgeconv_backward_peak_bytes"] = {"K7, K7b": mine, "the first K7, K7b": first}
    print(f"phase 45 in {time.perf_counter() - t_start:.1f} s (host)", flush=True)
    return out


def multistep_recipe(data_dir: Path, spd: int) -> Path:
    """A copy of configs/train_partsize_msg.yaml with train:
    {steps_per_dispatch: spd, ema_decay: 0.999}."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "train_partsize_msg.yaml").read_text())
    cfg["train"] = dict(cfg.get("train") or {}, steps_per_dispatch=spd, ema_decay=GRAPH_EMA)
    path = data_dir / f"train_partsize_msg_spd{spd}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


# batch 5: 48 training blocks give 9 batches an epoch (two dispatches of 4
# and a single step), 24 validation blocks 5 (one dispatch, one padded step)
MULTISTEP_BATCH = 5


def train_multistep_through_cli(data_dir: Path, n_blocks: int, dev: torch.device) -> dict:
    """Phase 39: configs/train_partsize_msg.yaml with steps_per_dispatch 4
    and EMA 0.999, two epochs through train_cli --device cuda at batch 5
    (CUDA graphs of 4 train steps and of 4 validation batches on the EMA
    weights, the ragged tails as single steps), against the same copy at
    steps_per_dispatch 1, and against it again with the capturable
    optimizer forced on the single-step run: that pair must agree bit for
    bit (history and weights), the first within the band of the CPU
    tests' JAX comparison (the optimizers round their bias corrections
    apart, and Adam's sign steps carry a rounding on to lr): train losses
    within 2% and accuracies within 5% relative, every weight element
    within 2 * 3.17 * lr * steps, the most two Adam runs can move it apart
    -> launch counts of the spd 4 run, its graphs' replays included."""
    label = "train pointnet2_msg, steps_per_dispatch 4"
    args = lambda spd: ["--config", str(multistep_recipe(data_dir, spd)),  # noqa: E731
                        "--batch-size", str(MULTISTEP_BATCH)]
    runs, walls = {}, {}
    steps = 2 * (n_blocks // MULTISTEP_BATCH)
    lr = Config.from_yaml(str(ROOT / "configs" / "train_partsize_msg.yaml")).train.learning_rate
    made = train_loop.make_optimizer
    for key, spd, capturable in (("spd4", 4, True), ("spd1", 1, False),
                                 ("spd1 capturable", 1, True)):
        if capturable and spd == 1:
            train_loop.make_optimizer = lambda params, wd, _: made(params, wd, True)
        try:
            out, walls[key], counts, mem = run_train_cli(f"{label} ({key})", data_dir, args(spd),
                                                         2, FORWARD_KERNELS + SSG_BACKWARD_KERNELS)
        finally:
            train_loop.make_optimizer = made
        shutil.rmtree(out["exp_dir"], ignore_errors=True)
        runs[key] = (out, counts, mem)
    out4, counts4, mem4 = runs["spd4"]
    graphs = out4["graph_launches"]
    if not graphs or not all(graphs[k] for k in FORWARD_KERNELS + SSG_BACKWARD_KERNELS):
        raise AssertionError(f"{label}: the graphs' replays launched {graphs}")
    faults = []
    for key in ("spd1", "spd1 capturable"):
        out1 = runs[key][0]
        keys = [k for k in out4["history"][0] if k != "epoch_time_s"]
        hist = [(k, r4[k], r1[k]) for r4, r1 in zip(out4["history"], out1["history"]) for k in keys]
        sd4, sd1 = out4["model"].state_dict(), out1["model"].state_dict()
        same = [k for k in sd4 if torch.equal(sd4[k], sd1[k])]
        params = dict(out4["model"].named_parameters())
        apart = {k: (sd4[k].double() - sd1[k].double()).abs().max().item() for k in params}
        worst = max(apart.items(), key=lambda kv: kv[1])
        rel = lambda k: max(abs(a - b) / max(abs(b), 1e-12)  # noqa: E731
                            for name, a, b in hist if name == k)
        print(f"{label} against {key}: history {sum(a == b for _, a, b in hist)} of {len(hist)} "
              f"values equal (at most {rel('train_loss'):.3g} relative apart in train loss, "
              f"{rel('val_loss'):.3g} in validation loss, {rel('train_acc'):.3g} and "
              f"{rel('val_acc'):.3g} in accuracy), weights {len(same)} of {len(sd4)} tensors "
              f"equal, the largest element {worst[1]:.3g} apart ({worst[0]}); walls "
              f"{walls['spd4']:.2f} s and {walls[key]:.2f} s", flush=True)
        if key == "spd1 capturable":
            if len(same) != len(sd4) or any(a != b for _, a, b in hist):
                faults.append(f"{key}: not bit for bit")
        elif (max(rel("train_loss"), rel("val_loss")) > 0.02
              or max(rel("train_acc"), rel("val_acc")) > 0.05
              or worst[1] > 2 * 3.17 * lr * steps):
            faults.append(f"{key}: outside the band: {worst}")
    print(f"{label}: launches {counts4} eager (single steps and each graph's warm-up step), "
          f"{graphs} by the graphs' replays; peak device memory {mem4 / 2**20:.1f} MiB "
          f"(spd 1: {runs['spd1'][2] / 2**20:.1f} MiB)", flush=True)
    if faults:
        raise AssertionError(f"{label}: " + "; ".join(faults))
    return {k: counts4[k] + graphs[k] for k in counts4}


def determinism_warnings(ds: BlockDataset, dev: torch.device) -> dict:
    """--graphs: one train step of each phase-38 model under
    set_random_seed(deterministic=True) (warn-only), the warnings of ops
    without a deterministic CUDA form collected -> model -> the warnings'
    first lines. Deterministic mode is turned off again after."""
    import warnings

    found = {}
    try:
        for i, (label, name, extra, loss_cfg, _, _) in enumerate(GRAPH_STEPS + GRAPH_MORE):
            set_random_seed(SEED + 390 + i, deterministic=True)
            model = seeded_model(name, SEED + 390 + i, **extra).to(dev)
            step = make_train_step(model, loss_cfg, make_optimizer(model.parameters()))
            batch = {k: v[0] for k, v in stacked_batches(ds, dev, SEED + 390 + i).items()}
            cw = losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES)).to(dev)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                step(batch, GRAPH_LR, cw)
                torch.cuda.synchronize()
            found[label] = sorted({str(w.message).splitlines()[0][:160] for w in caught
                                   if "deterministic" in str(w.message)})
            print(f"determinism, {label}: {len(found[label])} ops warn: {found[label]}",
                  flush=True)
            del model, step
    finally:
        set_random_seed(SEED, deterministic=False)
    return found



# ---------------------------------------------------------------- measurement

# the point counts of the two deck scans the JAX package's measurement
# chain was timed on (benchmark_results/measure_timing.json)
MEASURE_DECKS = (63_885, 103_718)
MEASURE_PATHS = tuple(f"deck_measure_{n}" for n in MEASURE_DECKS)
# queries of a deck-sized K5 call held against the plain version (the plain
# version's [S, N] distances of a whole deck would not fit the card)
KNN_SAMPLE = 2048
# LOF's k + 1 at the chain's default, at the adaptive parameters' largest
# n_neighbors (50) and DBSCAN's min_samples; the k = 1 search of DBSCAN's
# border points over the core points
MEASURE_KNN_K = (31, 51, 5)
# a near tie of LOF's negative outlier factor with offset_: the card and the
# CPU may order a pair of neighbours at the k-th distance differently
LOF_NEAR = 1e-6
# the deck measured by examples.full_pipeline: the JAX example's relative
# error on the same five scenes was 0.1089 (examples/full_pipeline.py on a
# CPU, measured 18.45 x 5.07 m against 20.00 x 5.90 m); the port trains
# another model from another initialisation, hence 0.04 of slack
FULL_PIPELINE_MAX_ERROR = 0.15


def measured_deck(n: int, seed: int, length: float = 40.0, width: float = 9.0) -> np.ndarray:
    """A predicted deck scan of n points [n, 3] float64: a 40 x 9 m deck with
    1% longitudinal slope and 2% crossfall, 1 cm noise, 2% misclassified
    points within 1.5 m of its footprint and 2 m of its height, rotated in
    plane, in a site frame 35 m up. (Georeferenced xy would break the
    JAX package's minimum_bounding_rectangle, whose candidate edges pair x
    with y: ROADMAP.md Queue 3.)"""
    rng = np.random.default_rng(seed)
    n_out = n // 50
    m = n - n_out
    u, v = rng.uniform(0, length, m), rng.uniform(0, width, m)
    z = 0.01 * u - 0.02 * np.abs(v - width / 2) + rng.normal(0, 0.01, m)
    out = np.stack([rng.uniform(-1.5, length + 1.5, n_out), rng.uniform(-1.5, width + 1.5, n_out),
                    rng.uniform(-2, 2, n_out)], 1)
    pts = np.concatenate([np.stack([u, v, z], 1), out])[rng.permutation(n)]
    a = 0.3 + 0.2 * seed
    c, s = np.cos(a), np.sin(a)
    pts[:, :2] = pts[:, :2] @ np.array([[c, -s], [s, c]]).T
    return pts + np.array([-length / 2, -width / 2, 35.0])


def knn_sampled_case(res: Results, label: str, xyz: torch.Tensor, query: torch.Tensor, k: int,
                     rng, paths=(), reps: int = 5) -> dict:
    """K5 at a deck's shape: one launch over all S queries, its rows of
    KNN_SAMPLE random queries held bit for bit against knn_plain on those
    queries; the kernel timed whole, the plain version on the sample (its
    time scaled by S / sample in the sums), beside the bound (each input
    read once, the outputs written once; 9 operations a pair)."""
    b, n, _ = xyz.shape
    s = query.shape[1]
    pick = torch.from_numpy(np.sort(rng.choice(s, min(s, KNN_SAMPLE), replace=False))).to(
        xyz.device)
    sub = query[:, pick].contiguous()

    def full():
        return grouping.knn_cuda(xyz, query, k)

    res.check("knn", f"{label} ({len(pick)} queries held)",
              lambda: tuple(t[:, pick] for t in full()),
              lambda: grouping.knn_plain(xyz, sub, k), True)
    bytes_ms = (nbytes(xyz, query) + b * s * k * 8) / PEAK_BYTES_S * 1e3
    ops_ms = 9 * b * s * n / PEAK_FLOPS * 1e3
    plain_sample_ms = time_ms(lambda: grouping.knn_plain(xyz, sub, k), reps=reps, warmup=1)
    case = {"ms": time_ms(full, reps=reps, warmup=1),
            "plain_ms": plain_sample_ms * s / len(pick),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "fma_bound_ms": max(bytes_ms, ops_ms)}
    res.record("knn", case, paths)
    print(f"{'knn':18s} {label}: kernel {case['ms']:.3f} ms, plain {plain_sample_ms:.3f} ms on "
          f"{len(pick)} queries ({case['plain_ms']:.1f} ms scaled to {s}), bound "
          f"{case['bound_ms']:.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'}), "
          f"{case['bound_ms'] / case['ms']:.1%} of it" + (f" [{', '.join(paths)}]" if paths else ""),
          flush=True)
    return case


def compare_measure_knn(dev: torch.device, res: Results, rng) -> None:
    """Phase 3, K5 at the measurement chain's shapes: B = 1, N = S = 63,885
    and 103,718 (the two deck scans' sizes; points of ``measured_deck``,
    centred, float32) at k = 31 (LOF at its default), 51 (LOF at the
    adaptive parameters' largest) and 5 (DBSCAN's core test), then k = 1
    from a tenth of the points to the rest (DBSCAN's border search over the
    core points)."""
    for n, seed in zip(MEASURE_DECKS, (1, 2)):
        pts = measured_deck(n, seed)
        xyz = torch.from_numpy((pts - pts.mean(0)).astype(np.float32))[None].to(dev)
        for k in MEASURE_KNN_K:
            knn_sampled_case(res, f"deck B=1 N=S={n} k={k}", xyz, xyz, k, rng)
        border = np.zeros(n, bool)
        border[rng.choice(n, n // 10, replace=False)] = True
        core = xyz[:, torch.from_numpy(~border).to(dev)].contiguous()
        rest = xyz[:, torch.from_numpy(border).to(dev)].contiguous()
        knn_sampled_case(res, f"deck core N={core.shape[1]} S={rest.shape[1]} k=1", core, rest,
                         1, rng)


class KnnTap:
    """Records the inputs of every K5 call that measure/wl_iden.py makes
    (its ``knn_with_distance``) while the block runs."""

    def __enter__(self):
        self.calls, self.orig = [], wl_iden.knn_with_distance

        def record(xyz, query=None, k=20):
            self.calls.append((xyz.clone(), (xyz if query is None else query).clone(), k))
            return self.orig(xyz, query, k)

        wl_iden.knn_with_distance = record
        return self

    def __exit__(self, *exc):
        wl_iden.knn_with_distance = self.orig


def deck_dimensions(x: np.ndarray) -> np.ndarray:
    """The chain's host tail: projection, edge trim, MBR, refined sides."""
    trimmed = wl_iden.detect_and_trim_edges(wl_iden.project_to_plane(x))
    length, width = wl_iden.calculate_dimensions(
        trimmed, wl_iden.minimum_bounding_rectangle(trimmed))
    return np.array([max(length, width), min(length, width)])


def measure_stages(device) -> list:
    """process_bridge_deck's chain at its defaults, stage by stage, then the
    adaptive LOF and DBSCAN (eps 1.0, min_samples 5, the chain's defaults)
    on the isolation forest's output -> [(stage, fn, the stage whose output
    it takes, -1 for the deck)]."""
    hp = wl_iden.default_hyperparams()
    return [
        ("voxel (host)", lambda x: wl_iden.data_voxel(x, hp["voxel_size"]), -1),
        ("ransac", lambda x: wl_iden.ransac_plane_fit(
            x, hp["ransac_max_trials"], hp["ransac_residual_threshold"], device), 0),
        ("isolation_forest", lambda x: wl_iden.isolation_forest_outlier_removal(
            x, hp["isolation_forest_contamination"], device), 1),
        ("lof", lambda x: wl_iden.lof_outlier_removal(
            x, hp["lof_n_neighbors"], hp["lof_contamination"], device), 2),
        ("trim, MBR, sides (host)", deck_dimensions, 3),
        ("adaptive LOF", lambda x: wl_iden.lof_outlier_removal(x, device=device), 2),
        ("dbscan", lambda x: wl_iden.dbscan_outlier_removal(x, 1.0, 5, device), 2),
    ]


def device_busy(fn) -> tuple:
    """One fn() under torch.profiler -> (its result, device busy ms, K5's ms
    of it, wall ms)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = knn = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            ms = (ev.self_cuda_time_total if us is None else us) / 1e3
            busy += ms
            knn += ms if "knn_kernel" in ev.key else 0.0
    return out, busy, knn, wall


# torch.profiler on the card's machine now and then returns a session with
# some of its device events missing (run 3 of PR 19: a LOF stage read 0.094
# ms busy with no K5 kernel, its neighbours 3-6 ms); a profiled stage runs
# this many sessions and keeps the largest reading
PROFILE_TRIES = 3


def run_stages(pts: np.ndarray, device, profile: bool = False) -> tuple:
    """Each stage of ``measure_stages`` once (profiled: PROFILE_TRIES times,
    the first call's output kept) -> (outputs, [(wall ms, device busy ms, K5
    ms)] a stage; busy and K5 None unless profiled)."""
    outs, times = [], []
    for name, fn, src in measure_stages(device):
        x = pts if src < 0 else outs[src]
        if profile:
            readings = [device_busy(lambda: fn(x)) for _ in range(PROFILE_TRIES)]
            out = readings[0][0]
            _, busy, knn, wall = max(readings, key=lambda r: r[1])
        else:
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x)
            if device != "cpu":
                torch.cuda.synchronize()
            wall, busy, knn = (time.perf_counter() - t0) * 1e3, None, None
        outs.append(out)
        times.append((wall, busy, knn))
    return outs, times


def check_measurement_chain(dev: torch.device, res: Results) -> dict:
    """Phase 40: the deck-measurement chain (measure/wl_iden.py) on the card
    at both deck sizes: counted through its entry points, stage by stage
    against the port's CPU path on the same inputs and draws and against a
    second card run, timed. Returns the launches of each deck's main path
    (by MEASURE_PATHS)."""
    counts = {}
    rng = np.random.default_rng(SEED + 40)
    for n, seed, path in zip(MEASURE_DECKS, (1, 2), MEASURE_PATHS):
        pts = measured_deck(n, seed)
        stages = measure_stages("cuda")
        hp = wl_iden.default_hyperparams()
        # the main path through the entry points a user calls, counted:
        # process_bridge_deck (its first call: the first deck's also builds
        # the native voxel library), then LOF at the adaptive parameters and
        # DBSCAN on the isolation forest's output (voxel, RANSAC and the
        # forest launch no kernel)
        _kernels.reset_launch_counts()
        with KnnTap() as tap:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            length, width, trimmed, rect = wl_iden.process_bridge_deck(pts, device="cuda")
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            forest = wl_iden.isolation_forest_outlier_removal(wl_iden.ransac_plane_fit(
                wl_iden.data_voxel(pts, hp["voxel_size"]), hp["ransac_max_trials"],
                hp["ransac_residual_threshold"], "cuda"), hp["isolation_forest_contamination"],
                "cuda")
            wl_iden.lof_outlier_removal(forest, device="cuda")
            wl_iden.dbscan_outlier_removal(forest, 1.0, 5, "cuda")
            torch.cuda.synchronize()
        c = _kernels.launch_counts()
        if c["knn"] != len(tap.calls) or c["knn"] < 4 or any(
                v for name, v in c.items() if name != "knn"):
            raise AssertionError(f"measure {n}: launches {c}, {len(tap.calls)} K5 calls recorded")
        counts[path] = c
        # warm: the chain's wall, then each stage's, then each stage profiled
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = wl_iden.process_bridge_deck(pts, device="cuda")
        torch.cuda.synchronize()
        chain_ms = (time.perf_counter() - t0) * 1e3
        card, card_times = run_stages(pts, "cuda")
        card2, busy_times = run_stages(pts, "cuda", profile=True)
        for (name, _, _), a, b in zip(stages, card, card2):
            if not np.array_equal(a, b):
                raise AssertionError(f"measure {n}: stage {name} differs between two card runs")
        if (again[0], again[1]) != (length, width) or not (
                np.array_equal(again[2], trimmed) and np.array_equal(again[3], rect)):
            raise AssertionError(f"measure {n}: process_bridge_deck differs between two card runs")
        if not np.array_equal(card[2], forest):
            raise AssertionError(f"measure {n}: the forest's output differs between two card runs")
        # the CPU path; each card stage on the CPU's input of it
        cpu, cpu_times = run_stages(pts, "cpu")
        near = 0
        for (name, fn, src), want in zip(stages, cpu):
            x = pts if src < 0 else cpu[src]
            if name == "lof":
                pct = 100.0 * hp["lof_contamination"]
                nof_card = wl_iden.lof_negative_outlier_factor(x, hp["lof_n_neighbors"],
                                                               "cuda").cpu()
                nof_cpu = wl_iden.lof_negative_outlier_factor(x, hp["lof_n_neighbors"], "cpu")
                offset = wl_iden.np_percentile(nof_cpu, pct)
                band = (nof_cpu - offset).abs() <= LOF_NEAR * abs(offset)
                near = int(band.sum())
                differ = (nof_card < wl_iden.np_percentile(nof_card, pct)) != (nof_cpu < offset)
                if (differ & ~band).any():
                    raise AssertionError(f"measure {n}: LOF masks differ off the threshold")
                if not near and not np.array_equal(fn(x), want):
                    raise AssertionError(f"measure {n}: LOF differs from the CPU path")
            elif not np.array_equal(fn(x), want):
                raise AssertionError(f"measure {n}: stage {name} differs from the CPU path")
        cpu_dims = wl_iden.process_bridge_deck(pts, device="cpu")[:2]
        rel = max(abs(length - cpu_dims[0]) / cpu_dims[0], abs(width - cpu_dims[1]) / cpu_dims[1])
        if not np.isfinite([length, width]).all() or rel > 1e-6:
            raise AssertionError(f"measure {n}: card {length} x {width}, CPU {cpu_dims}")
        print(f"measure {n} points: {length:.4f} x {width:.4f} m (CPU path {cpu_dims[0]:.4f} x "
              f"{cpu_dims[1]:.4f}, relative difference {rel:.2e}); "
              + " -> ".join(str(len(o)) for o in card[:4])
              + f" points; {near} LOF points within {LOF_NEAR:g} of offset_; two card runs "
              f"bit-identical; K5 launches {c['knn']}", flush=True)
        for (name, _, _), (wall, _, _), (_, busy, knn), (cpu_wall, _, _) in zip(
                stages, card_times, busy_times, cpu_times):
            print(f"  stage {name:24s} card wall {wall:9.3f} ms, device busy {busy:8.3f} ms "
                  f"(K5 {knn:7.3f}) | CPU path wall {cpu_wall:9.3f} ms", flush=True)
        chain = busy_times[:5]  # the stages of process_bridge_deck
        busy, knn = sum(t[1] for t in chain), sum(t[2] for t in chain)
        print(f"  process_bridge_deck wall {first_ms:.1f} ms (first call), {chain_ms:.1f} ms "
              f"(warm); its stages' device busy {busy:.3f} ms ("
              + (f"{busy / chain_ms:.1%} of the warm wall), K5 {knn:.3f} ms of it "
                 f"({knn / busy:.1%})" if busy > 0 else "the profiler recorded no device time)"),
              flush=True)
        # each K5 call of the main path held against the plain version and
        # timed at its own shape: the path's sums
        for xyz, query, k in tap.calls:
            knn_sampled_case(res, f"measure {n} N={xyz.shape[1]} S={query.shape[1]} k={k}",
                             xyz, query, k, rng, paths=(path,))
    return counts


def run_full_pipeline(dev: torch.device) -> dict:
    """Phase 41: examples/full_pipeline.py on the card, counted: SSG trained
    at 8 steps a dispatch, the test scene voted, exported and its deck
    measured. Returns its launch counts."""
    from pointcloud_bridge_tpu_torch.examples import full_pipeline

    workdir = ROOT / "build" / "full_pipeline"
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = full_pipeline.run(str(workdir), "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts_all_launched("full pipeline", FORWARD_KERNELS + SSG_BACKWARD_KERNELS
                                     + ("knn",))
        r, m = out["row"], out["metrics"]
        numbers = [r[k] for k in ("length_raw", "width_raw", "length_pred", "width_pred",
                                  "relative_error")] + [m["OA"], m["mIoU"]]
        if not np.isfinite(numbers).all():
            raise AssertionError(f"full pipeline: {numbers}")
        if r["relative_error"] > FULL_PIPELINE_MAX_ERROR:
            raise AssertionError(f"full pipeline: deck error {r['relative_error']:.4f} above "
                                 f"{FULL_PIPELINE_MAX_ERROR}")
        # the chain's own error: the ground-truth deck measured as predicted
        raw = full_pipeline_gt_deck(workdir)
        floor = wl_iden.run_wl_identification([("gt", raw, raw)],
                                              hyperparams=full_pipeline.MEASURE_HYPERPARAMS)[0]
        print(f"full pipeline: {wall:.1f} s ({', '.join(f'{k} {v:.2f}' for k, v in out['walls'].items())}); "
              f"best val OA {out['best_val_acc']:.4f}; vote OA {m['OA']:.4f} mIoU {m['mIoU']:.4f}; "
              f"deck GT {r['length_raw']:.3f} x {r['width_raw']:.3f} m from {out['raw_deck_points']} "
              f"points, measured {r['length_pred']:.3f} x {r['width_pred']:.3f} m from "
              f"{out['pred_deck_points']}, relative error {r['relative_error']:.4f} (band "
              f"{FULL_PIPELINE_MAX_ERROR}; the chain on the ground-truth deck: "
              f"{floor['length_pred']:.3f} x {floor['width_pred']:.3f} m, "
              f"{floor['relative_error']:.4f}); launches {counts}", flush=True)
        return counts
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def full_pipeline_gt_deck(workdir: Path) -> np.ndarray:
    """The test scene's ground-truth deck points, as full_pipeline reads them."""
    from pointcloud_bridge_tpu_torch.examples.full_pipeline import DECK_CLASS

    pts, _, labels = _load_scene(str(workdir / "test" / "scene20.las"))
    return pts[labels == DECK_CLASS]


def run_large_scene(dev: torch.device) -> None:
    """``--large-scene``: examples/large_scene_stream.py at 5M points
    (pointnet2_ssg, 4 quick-train epochs on 300k points, 3 votes), its
    end-to-end points/s, coverage, OA and mIoU."""
    from pointcloud_bridge_tpu_torch.examples import large_scene_stream

    workdir = ROOT / "build" / "large_scene"
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        _kernels.reset_launch_counts()
        art = large_scene_stream.run(5_000_000, "pointnet2_ssg", workdir=str(workdir),
                                     device="cuda")
        counts = counts_all_launched("large scene", FORWARD_KERNELS + SSG_BACKWARD_KERNELS)
        if not np.isfinite([art["oa"], art["miou"], art["end_to_end_pts_per_s"]]).all():
            raise AssertionError(f"large scene: {art}")
        print(f"large scene: {art['n_points']} points, 3 votes in {art['wall_s']:.2f} s: "
              f"{art['end_to_end_pts_per_s']:.0f} points/s end to end, coverage "
              f"{art['coverage']:.4f}, OA {art['oa']:.4f}, mIoU {art['miou']:.4f}; quick-train "
              f"{art['train_s']:.1f} s; launches {counts}", flush=True)
        print("large scene phases: " + json.dumps(art["phases"]), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def import_and_serve(label: str, name: str, seed: int, ds: BlockDataset, data_dir: Path,
                     dev: torch.device) -> dict:
    """42a: a seeded ``name`` saved as a reference training run saves it,
    imported by tools/import_ckpt.py, served by ``infer_cli blocks`` from
    the imported checkpoint -> the serve's launch counts."""
    from pointcloud_bridge_tpu_torch.tools import import_ckpt

    model = seeded_model(name, seed)
    work = data_dir / "import" / name
    work.mkdir(parents=True, exist_ok=True)
    pth, exp = work / "best_model.pth", work / "exp"
    torch.save({"model_state_dict": model.state_dict(), "epoch": 7,
                "class_avg_iou": 0.625}, pth)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        import_ckpt.main(["--model", name, "--torch-ckpt", str(pth), "--out", str(exp)])
    import_s = time.perf_counter() - t0
    ckpt = restore_checkpoint(str(exp / "best_model"))
    if (ckpt["epoch"], ckpt["class_avg_iou"], ckpt["source_torch"]) != (7, 0.625,
                                                                        str(pth.resolve())):
        scalars = {k: v for k, v in ckpt.items() if k != "model"}
        raise AssertionError(f"{label}: checkpoint scalars {scalars}")
    want = model.state_dict()
    if set(ckpt["model"]) != set(want) or any(
            not torch.equal(ckpt["model"][k].to(v.dtype), v) for k, v in want.items()):
        raise AssertionError(f"{label}: imported weights differ from the saved ones")
    counts = serve_blocks(label, name, exp, FORWARD_KERNELS, data_dir, len(ds), dev, warm=False)
    served_cm = np.loadtxt(data_dir / "infer_out" / label.replace(" ", "_")
                           / "confusion_matrix.csv", delimiter=",")
    imported = get_model(name, NUM_CLASSES)
    imported.load_state_dict(ckpt["model"], strict=True)
    got = run_block_inference(imported.to(dev).eval(), ds, NUM_CLASSES, batch_size=16)
    eager = run_block_inference(model.to(dev), ds, NUM_CLASSES, batch_size=16)
    if not np.array_equal(got["predictions"], eager["predictions"]):
        raise AssertionError(f"{label}: the imported model's predictions differ from the "
                             "seeded model's")
    if not np.array_equal(served_cm, eager["global"]["Confusion_Matrix"]):
        raise AssertionError(f"{label}: infer_cli's confusion matrix differs from the seeded "
                             "model's")
    print(f"{label}: import {import_s:.3f} s (host), {len(ds)} blocks served, predictions and "
          f"the CLI's confusion matrix equal to the seeded model's, OA "
          f"{eager['global']['OA']:.4f}", flush=True)
    return counts


# 42b: the exported programs (label, registry name, model options), which
# launch every forward kernel between them
EXPORTS = (
    ("pointnet2_ssg", "pointnet2_ssg", {}),
    ("pointnet2_msg", "pointnet2_msg", {}),
    ("bristrunet", "bristrunet", {}),
    ("dgcnn", "dgcnn", {}),
    ("dgcnn_global", "dgcnn_global", {}),
    ("ptv3_pooled", "ptv3_pooled", POOLED_BENCHED),
    ("ptv3_pooled bf16 stream", "ptv3_pooled", dict(POOLED_BENCHED, stream_dtype="bfloat16")),
)
# the ops each program's graph must name (ops/_kernels.py custom_op)
EXPORT_OPS = {
    "pointnet2_ssg": ("fps", "ball_query", "group", "interpolate"),
    "pointnet2_msg": ("fps", "ball_query_radii", "group", "interpolate"),
    "bristrunet": ("fps", "ball_query_radii", "group", "interpolate", "knn"),
    "dgcnn": ("knn", "knn_c", "edge_reduce"),
    "dgcnn_global": ("knn", "knn_c", "edge_reduce"),
    "ptv3_pooled": ("attention",),
    "ptv3_pooled bf16 stream": ("attention",),
}
# the programs whose output must equal the eager forward's (torch.equal)
EXPORT_EQUAL = ("dgcnn", "dgcnn_global")
# the classifiers read xyz alone by default; exported with the colours
EXPORT_KWARGS = {name: {"in_features": 3}
                 for name in ("pointnet2_cls_ssg", "pointnet2_cls_msg", "pointnet_cls")}


def graph_ops(program: torch.nn.Module) -> list:
    """The pcb:: ops a loaded program's graph calls."""
    return sorted({str(node.target).split(".")[1] for node in program.graph.nodes
                   if node.op == "call_function" and str(node.target).startswith("pcb.")})


def export_and_run(label: str, model: torch.nn.Module, xyz: torch.Tensor, rgb: torch.Tensor,
                   workdir: Path, need_ops=(), equal: bool = False) -> tuple:
    """Export ``model`` (on the card) at xyz's shape, save, load, run the
    program and the eager forward, each with the counters reset just
    before -> (program launches, eager launches, line of numbers). Fails
    where the graph lacks an op of ``need_ops``, the launches differ or the
    outputs differ beyond LOGIT_TOL, with ``equal`` at all (an exact match
    is reported as such)."""
    from pointcloud_bridge_tpu_torch.utils.export import export_program, load_program

    path = workdir / (label.replace(" ", "_") + ".pt2")
    with torch.inference_mode():
        _kernels.reset_launch_counts()
        want = model(xyz, rgb)
        torch.cuda.synchronize()
        eager_counts = _kernels.launch_counts()
    t0 = time.perf_counter()
    export_program(model, None, str(path), *xyz.shape[:2], rgb.shape[2])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = load_program(str(path))
    load_s = time.perf_counter() - t0
    ops = graph_ops(program)
    if any(op not in ops for op in need_ops):
        raise AssertionError(f"export {label}: the graph calls {ops}, not all of {need_ops}")
    with torch.inference_mode():
        _kernels.reset_launch_counts()
        got = program(xyz, rgb)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        if counts != eager_counts:
            raise AssertionError(f"export {label}: the program launched {counts}, the eager "
                                 f"forward {eager_counts}")
        err = max_abs_err(got.float(), want.float())
        same = torch.equal(got, want)
        if got.shape != want.shape or not torch.isfinite(got).all() or (not same and (
                equal or err > LOGIT_TOL * max(1.0, want.abs().max().item()))):
            raise AssertionError(f"export {label}: output {tuple(got.shape)} differs from the "
                                 f"eager forward by {err}")
        prog_ms = time_ms(lambda: program(xyz, rgb), reps=10)
        eager_ms = time_ms(lambda: model(xyz, rgb), reps=10)
    agreement = ("equal to the eager forward (torch.equal)" if same
                 else f"max|err| {err:.3g} against the eager forward")
    line = (f"export {label}: {path.stat().st_size / 2**20:.1f} MiB, export {export_s:.2f} s, "
            f"load {load_s:.2f} s (host); graph ops {ops}; output {agreement}; "
            f"loaded program {prog_ms:.3f} ms, eager forward {eager_ms:.3f} ms a call "
            f"(B={xyz.shape[0]} x {xyz.shape[1]}); launches {counts}")
    return counts, eager_counts, line


def check_exports(ds: BlockDataset, dev: torch.device, workdir: Path) -> dict:
    """42b: the seven required programs -> their launch counts by label."""
    xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:1], np.float32)).to(dev)
    rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:1], np.float32)).to(dev)
    by_label = {}
    for i, (label, name, kwargs) in enumerate(EXPORTS):
        model = seeded_model(name, SEED + 420 + i, **kwargs).to(dev)
        by_label[f"export_{label.replace(' ', '_')}"], _, line = export_and_run(
            label, model, xyz, rgb, workdir, EXPORT_OPS[label], label in EXPORT_EQUAL)
        print(line, flush=True)
        del model
    launched = {k for counts in by_label.values() for k, v in counts.items() if v}
    need = {"fps", "ball_query", "group", "interpolate", "knn", "knn_c", "edge_reduce",
            "flash_attn", "flash_attn_bf16"}
    if not need <= launched:
        raise AssertionError(f"exports: no loaded program launched {sorted(need - launched)}")
    return by_label


def export_all(dev: torch.device) -> None:
    """``--export-all``: every registry name exported, loaded and run at B=1
    x 4096 beside its eager forward (export_and_run's checks); a name that
    raises NotImplementedError is listed, any other failure fails."""
    from pointcloud_bridge_tpu_torch.models.registry import MODEL_REGISTRY

    workdir = ROOT / "build" / "export_all"
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    xyz = torch.from_numpy(rng.uniform(size=(1, N, 3)).astype(np.float32)).to(dev)
    rgb = torch.from_numpy(rng.uniform(size=(1, N, 3)).astype(np.float32)).to(dev)
    failed, refused = [], []
    try:
        for i, name in enumerate(sorted(MODEL_REGISTRY)):
            model = seeded_model(name, SEED + 500 + i, **EXPORT_KWARGS.get(name, {})).to(dev)
            try:
                _, _, line = export_and_run(name, model, xyz, rgb, workdir)
                print(line, flush=True)
            except NotImplementedError as exc:
                refused.append((name, str(exc)))
                print(f"export {name}: not exported ({exc})", flush=True)
            except Exception as exc:  # every other failure is one
                failed.append(name)
                print(f"export {name}: FAILED {type(exc).__name__}: {exc}", flush=True)
            del model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"export-all: {len(MODEL_REGISTRY) - len(failed) - len(refused)} of "
          f"{len(MODEL_REGISTRY)} names exported and ran, refused {refused}, failed {failed}",
          flush=True)
    if failed:
        raise SystemExit(1)


def check_debug_module(dev: torch.device) -> dict:
    """42c: tools/debug_module.py's smoke_test of pointnet2_ssg at B = 1, 2,
    4 and 8 x 4096 on the card; any batch size's error fails."""
    from pointcloud_bridge_tpu_torch.tools import debug_module

    _kernels.reset_launch_counts()
    res = debug_module.smoke_test("pointnet2_ssg", NUM_CLASSES, N, (1, 2, 4, 8),
                                  device=dev.type)
    counts = counts_all_launched("debug_module", FORWARD_KERNELS)
    errors = {k: v for k, v in res.items() if k.endswith("_error")}
    if errors or res["output_shape"] != (1, N, NUM_CLASSES):
        raise AssertionError(f"debug_module: {res}")
    print("debug_module: " + json.dumps(res), flush=True)
    return counts


def run_host_modules() -> None:
    """42d: the superpoint pipeline's host modules on one synthetic scene,
    with scikit-learn absent (the card's machine has none)."""
    from pointcloud_bridge_tpu_torch.data import completion, superpoints
    from pointcloud_bridge_tpu_torch.ops import avs_adapt_voxel_size, avs_net_sample_indices

    t0 = time.perf_counter()
    xyz, rgb, labels = toy_bridge_scene(10_000, seed=42)
    normals = superpoints.compute_normals_host(xyz)
    sp_labels, sp_features = superpoints.generate_superpoints(xyz, rgb, normals, min_points=10,
                                                              eps=0.3)
    edge_index, edge_attr = superpoints.build_graph(sp_features)
    pts, cols, labs = completion.complete_scene(xyz, rgb, labels, voxel_size=0.1)
    idx, voxel = avs_net_sample_indices(xyz[None, :4096], 1024, rng=np.random.default_rng(0))
    wall = time.perf_counter() - t0
    count = int(sp_labels.max()) + 1
    if (sp_labels.shape != (len(xyz),) or count < 1 or sp_features.shape != (count, 16)
            or not np.isfinite(sp_features).all() or edge_index.shape[0] != 2
            or len(pts) < len(xyz) or idx.shape != (1, 1024) or not voxel > 0
            or "sklearn" in sys.modules):
        raise AssertionError(f"host modules: {count} superpoints {sp_features.shape}, "
                             f"{len(pts)} completed points, AVS {idx.shape} at {voxel}")
    print(f"host modules: {len(xyz)} points -> {count} superpoints "
          f"({int((sp_labels < 0).sum())} noise), graph of {edge_index.shape[1]} edges, "
          f"completion {len(xyz)} -> {len(pts)} points, AVS 4096 -> 1024 at voxel "
          f"{voxel:.4f} (adapted {avs_adapt_voxel_size(xyz[None, :4096], 1024):.4f}); "
          f"{wall:.2f} s (host), scikit-learn not imported", flush=True)


def run_tool_phases(ds: BlockDataset, data_dir: Path, dev: torch.device) -> dict:
    """Phase 42 -> launch counts by path (the imported serves, the six
    exported programs, debug_module)."""
    t0 = time.perf_counter()
    by_path = {}
    for label, name, seed in (("serve imported pointnet2_ssg", "pointnet2_ssg", SEED + 42),
                              ("serve imported pointnet2_msg", "pointnet2_msg", SEED + 43)):
        by_path[label.replace(" ", "_")] = import_and_serve(label, name, seed, ds, data_dir, dev)
    workdir = data_dir / "export"
    workdir.mkdir(parents=True, exist_ok=True)
    by_path |= check_exports(ds, dev, workdir)
    by_path["debug_module_pointnet2_ssg"] = check_debug_module(dev)
    run_host_modules()
    print(f"phase 42: {time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


def entry_point_host_us(dev: torch.device) -> None:
    """``--host-us``: host microseconds a call of the four public entry
    points the models call (the eager path: farthest_point_sample,
    query_ball_point, group_points, three_nn_interpolate) at B=1, N=256 and
    16 centres, where the card is faster than the host, so that the time is
    the host's path; 5 rounds of 2000 calls each, the median."""
    rng = np.random.default_rng(SEED)
    xyz = torch.from_numpy(rng.uniform(size=(1, 256, 3)).astype(np.float32)).to(dev)
    feats = torch.from_numpy(rng.uniform(size=(1, 256, 16)).astype(np.float32)).to(dev)
    centres = xyz[:, :16].contiguous()
    idx = grouping.query_ball_point(0.2, 16, xyz, centres)
    calls = {
        "fps": lambda: sampling.farthest_point_sample(xyz, 16),
        "ball_query": lambda: grouping.query_ball_point(0.2, 16, xyz, centres),
        "group": lambda: grouping.group_points(xyz, centres, idx, feats),
        "interpolate": lambda: interpolate.three_nn_interpolate(xyz, centres, feats[:, :16]),
    }
    with torch.inference_mode():
        got = {k: host_us(fn, calls=2000) for k, fn in calls.items()}
        dev_us = {k: device_ms(fn) * 1e3 for k, fn in calls.items()}
    print("entry point host us a call: " + ", ".join(
        f"{k} {v:.2f} (device {dev_us[k]:.2f})" for k, v in got.items()), flush=True)


# ----------------------------------------------------------- 43. the parallel layer

PAR_B = 16  # the recipe's batch


def par_batch(ds: BlockDataset, rows: slice = slice(0, PAR_B)) -> dict:
    """Blocks ``rows`` of ds as a host batch (the trainer's keys)."""
    return {"points": np.ascontiguousarray(ds.points[rows], np.float32),
            "colors": np.ascontiguousarray(ds.colors[rows], np.float32),
            "labels": ds.labels[rows].astype(np.int32), "mask": np.ones(len(ds.points[rows]), bool)}


def par_model(dev: torch.device, axis=None) -> torch.nn.Module:
    """SSG at the registry's widths, its weights and statistics drawn from
    a seed, dropout 0 (as phase 6: a rank draws the masks of its own rows,
    which the single-device step draws otherwise)."""
    return no_dropout(seeded_model("pointnet2_ssg", SEED + 43, axis_name=axis)).to(dev)


def grads_after(step, model, *args) -> tuple:
    """(loss, {name: gradient copy}) of one step (plain SGD at lr 0: the
    weights stay, only the BatchNorm statistics move)."""
    m = step(*args)
    return m["loss"].detach().clone(), {k: p.grad.detach().clone()
                                        for k, p in model.named_parameters()}


def hold_to_single(label: str, got: tuple, want: tuple, pre_bn: set, l2_limit: float = 0.2,
                   cos_limit: float = 0.98) -> str:
    """A parallel step's loss and gradients against the single-device
    step's on the same batch and weights: the loss within 1e-5 relative,
    each gradient leaf relative L2 <= ``l2_limit`` and cosine >=
    ``cos_limit`` (by default phase 6's band: float32 through 17
    train-mode BatchNorms; sync-BN takes flax's E[x^2] - E[x]^2, torch's
    BatchNorm another arithmetic); the biases that feed a BatchNorm
    (``pre_bn``), whose gradient is exactly zero, below 1e-3 of their
    layer weight's max|g| on both sides."""
    loss_rel = abs(got[0].item() - want[0].item()) / abs(want[0].item())
    worst_l2, worst_cos, faults = 0.0, 1.0, []
    bits = got[0].item() == want[0].item() and all(
        torch.equal(g, want[1][k]) for k, g in got[1].items())
    for k, g in got[1].items():
        w = want[1][k].double()
        if k in pre_bn:
            bound = 1e-3 * want[1][k[:-4] + "weight"].abs().max().item()
            if max(g.abs().max().item(), w.abs().max().item()) > bound:
                faults.append(f"{k} above its zero bound {bound:.3g}")
            continue
        if w.norm() == 0:
            continue
        g = g.double()
        l2 = ((g - w).norm() / w.norm()).item()
        cos = (g.ravel() @ w.ravel() / (g.norm() * w.norm() + 1e-300)).item()
        worst_l2, worst_cos = max(worst_l2, l2), min(worst_cos, cos)
        if l2 > l2_limit or cos < cos_limit:
            faults.append(f"{k} rel L2 {l2:.3g} cosine {cos:.6f}")
    if loss_rel > 1e-5:
        faults.append(f"loss {got[0].item()} vs {want[0].item()}")
    print(f"{label}: loss {got[0].item():.7f} (single-device {want[0].item():.7f}, rel "
          f"{loss_rel:.3g}, limit 1e-05), gradients worst relative L2 {worst_l2:.4g} (limit "
          f"{l2_limit:g}), worst cosine {worst_cos:.8f} (limit {cos_limit:.8f}), "
          f"{'the same bits' if bits else 'not the same bits'} as the single-device step",
          flush=True)
    if faults:
        raise AssertionError(f"{label}: " + "; ".join(faults[:6]))
    return "the same bits" if bits else "within the band"


RECORDED = (("fps", sampling, "fps_cuda", lambda a, out: [(sampling.fps_plain(*a), out)]),
            ("ball_query", grouping, "ball_query_radii_cuda",
             lambda a, out: [(grouping.ball_query_plain(r, k, a[1], a[2]), o)
                             for (r, k), o in zip(a[0], out)]),
            ("group", grouping, "group_cuda", lambda a, out: [(grouping.group_plain(*a[:4]), out)]),
            ("interpolate", interpolate, "interpolate_cuda",
             lambda a, out: [(interpolate.interpolate_plain(*a)[0], out[0])]),
            ("group_backward", grouping, "group_backward_cuda",
             lambda a, out: [(grouping.group_backward_plain(*a), out)]),
            ("interpolate_backward", interpolate, "interpolate_backward_cuda",
             lambda a, out: [(interpolate.interpolate_backward_plain(*a), out)]))


def kernels_at_rows(model, batch: dict, cw, dev, label: str) -> None:
    """Every kernel call of one SSG train step on ``batch`` (the sharded
    shapes) recorded at its wrapper and held against its plain version on
    the same inputs: integer outputs equal, float outputs within 1e-5 of
    the plain output's max."""
    calls = []
    saved = {}
    for name, mod, attr, plain in RECORDED:
        fn = saved[(mod, attr)] = getattr(mod, attr)

        def wrapped(*a, _fn=fn, _name=name, _plain=plain, **kw):
            out = _fn(*a, **kw)
            calls.append((_name, _plain, a, out))
            return out
        setattr(mod, attr, wrapped)
    try:
        x, c = batch["points"].to(dev), batch["colors"].to(dev)
        loss = losses.weighted_cross_entropy(model.train()(x, c), batch["labels"].to(dev), cw)
        loss.backward()
        model.zero_grad(set_to_none=True)
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
    seen = {}
    for name, plain, a, out in calls:
        for want, got in plain(a, out):
            if want.dtype.is_floating_point:
                err = max_abs_err(got, want) / max(want.abs().max().item(), 1e-30)
                ok = err <= 1e-5
            else:
                err, ok = float((got != want).sum()), torch.equal(got, want)
            if not ok:
                raise AssertionError(f"{label}: {name} at {tuple(a[-1].shape) if torch.is_tensor(a[-1]) else ''}"
                                     f" differs from its plain version ({err})")
            seen[name] = seen.get(name, 0) + 1
    missing = [n for n, *_ in RECORDED if n not in seen]
    if missing:
        raise AssertionError(f"{label}: no call of {missing}")
    print(f"{label}: every kernel call of one step held against its plain version {seen}",
          flush=True)


def par_world(tmp: Path, name: str, dev: torch.device) -> None:
    """A world of one over NCCL on ``dev``, its store a new file."""
    import torch.distributed as dist
    from datetime import timedelta

    store = dist.FileStore(str(tmp / f"store_{name}"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=timedelta(seconds=120), device_id=dev)


def gloo_rank_main(rank: int, tmp: str) -> None:
    """``--gloo-rank R DIR``: one of phase 43d's two ranks, both on cuda:0,
    joined over gloo: the dp step on its 8 blocks of the saved batch."""
    import torch.distributed as dist
    from datetime import timedelta

    from pointcloud_bridge_tpu_torch.parallel import make_dp_train_step, make_mesh, shard_batch

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.library()
    saved = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(tmp) / "store_gloo2"), 2),
                            rank=rank, world_size=2, timeout=timedelta(seconds=120))
    try:
        mesh = make_mesh(2)
        model = par_model(dev, "data")
        model.load_state_dict(saved["state"])
        step = make_dp_train_step(model, Config().loss, torch.optim.SGD(model.parameters(), 0.0),
                                  mesh)
        local = shard_batch(saved["batch"], mesh, device=dev)
        cw = saved["cw"].to(dev)
        _kernels.reset_launch_counts()
        out = grads_after(step, model, local, 0.0, cw)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        ms = time_ms(lambda: step(local, 0.0, cw), reps=5, warmup=1)
        torch.save({"loss": out[0].cpu(), "grads": {k: v.cpu() for k, v in out[1].items()},
                    "counts": counts, "ms": ms}, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_parallel_phases(ds: BlockDataset, dev: torch.device, card: str) -> dict:
    """Phase 43, the parallel layer (parallel/), at SSG's registry width,
    batch 16 x 4096, float32, TF32 off: (a) a world of one over NCCL, the
    dp train step against the single-device step (plain SGD at lr 0, the
    same weights, batch and Dropout generator), the gradient all-reduce
    bit-transparent, the step's bits repeated; (b) make_dp_multi_train_step
    at K = 4 as one CUDA-graph replay with its NCCL all-reduces captured,
    equal to four eager dp steps; (c) FSDP2 at world 1 and tp on a 1 x 1
    mesh, one step each against the single-device step; (d) two ranks on
    this card over gloo (both cuda:0), each kernel call of one B = 8 step
    held against its plain version, then the dp step at 8 blocks a rank
    against the single-process batch-16 step -> launch counts by path."""
    import tempfile

    import torch.distributed as dist

    from pointcloud_bridge_tpu_torch.parallel import (
        make_2d_mesh, make_dp_multi_train_step, make_dp_train_step, make_fsdp_mesh,
        make_fsdp_train_step, make_mesh, make_tp_train_step, shard_batch)
    from pointcloud_bridge_tpu_torch.parallel.train_step import all_reduce_bucket_
    from pointcloud_bridge_tpu_torch.train.loop import batch_to_device

    t_start = time.perf_counter()
    loss_cfg = Config().loss
    cw = losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES)).to(dev)
    host = par_batch(ds)
    batch = batch_to_device(host, dev)
    by_path = {}
    tmp = Path(tempfile.mkdtemp(prefix="pcb_parallel_"))
    try:
        single = par_model(dev)
        state0 = copy.deepcopy(single.state_dict())
        sgd_step = make_train_step(single, loss_cfg, torch.optim.SGD(single.parameters(), 0.0))
        _kernels.reset_launch_counts()
        want = grads_after(sgd_step, single, batch, 0.0, cw)
        pre_bn = pre_bn_biases(single, batch["points"], batch["colors"])
        single_ms = time_ms(lambda: sgd_step(batch, 0.0, cw), reps=5, warmup=1)

        # (a) a world of one over NCCL
        par_world(tmp, "dp", dev)
        try:
            mesh = make_mesh(1)
            group = mesh.get_group("data")
            grads = [g.clone() for g in want[1].values()]
            all_reduce_bucket_(grads, group)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(grads, want[1].values())):
                raise AssertionError("43a: the gradient all-reduce changed bits at a world of one")
            nbytes_g = sum(g.numel() * g.element_size() for g in grads)
            ar_ms = time_ms(lambda: all_reduce_bucket_(grads, group), reps=20, warmup=3)
            print(f"43a all-reduce: SSG's {sum(g.numel() for g in grads):,} float32 gradients "
                  f"({nbytes_g / 1e6:.2f} MB) in one flat bucket over NCCL at a world of one: "
                  f"{ar_ms:.4f} ms, bit-transparent (torch.equal before and after) [{card}]",
                  flush=True)

            dp = par_model(dev, "data")
            dp.load_state_dict(state0)
            dp_step = make_dp_train_step(dp, loss_cfg, torch.optim.SGD(dp.parameters(), 0.0), mesh)
            local = shard_batch(host, mesh, device=dev)
            state = step_state(dp)
            _kernels.reset_launch_counts()
            got = grads_after(dp_step, dp, local, 0.0, cw)
            torch.cuda.synchronize()
            by_path["dp_world1_train_step"] = counts_all_launched(
                "43a dp step", FORWARD_KERNELS + SSG_BACKWARD_KERNELS)
            check_same_bits("43a dp step", dp, state, got,
                            lambda: grads_after(dp_step, dp, local, 0.0, cw))
            holds = hold_to_single("43a dp step (world 1, NCCL)", got, want, pre_bn)
            dp_ms = time_ms(lambda: dp_step(local, 0.0, cw), reps=5, warmup=1)
            print(f"43a dp step: B={PAR_B} N={N} {dp_ms:.3f} ms against the single-device "
                  f"step's {single_ms:.3f} ms (ratio {dp_ms / single_ms:.4f}); sync-BN at a world "
                  f"of one gives {holds} [{card}]", flush=True)

            # (b) K = 4 dp steps as one graph replay, NCCL captured
            model = par_model(dev, "data")
            opt = make_optimizer(model.parameters(), capturable=True)
            ema = {k: p.detach().clone() for k, p in model.named_parameters()}
            multi = make_dp_multi_train_step(model, loss_cfg, opt, mesh, GRAPH_K, ema=ema,
                                             ema_decay=GRAPH_EMA)
            stacked = stacked_batches(ds, dev, SEED + 43, PAR_B)
            slots = [{key: stacked[key][i] for key in TRAIN_KEYS} for i in range(GRAPH_K)]
            set_lr(opt, GRAPH_LR)
            multi.run(slots[:1], cw)
            gens = model_generators(model)
            st = StepState(model, opt, ema, gens)
            _kernels.reset_launch_counts()
            eager = step_outcome(model, opt, ema, gens, multi.run(slots, cw))
            torch.cuda.synchronize()
            eager_launches = _kernels.launch_counts()
            st.restore()
            t0 = time.perf_counter()
            graph = step_outcome(model, opt, ema, gens, multi(stacked, GRAPH_LR, cw))
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            (steps,) = multi.graphs.values()
            differ = [k for k, v in eager.items() if not torch.equal(v, graph[k])]
            replay_ms = time_ms(steps.graph.replay, reps=5, warmup=1) / GRAPH_K
            print(f"43b dp multi-step: {GRAPH_K} eager world-1 dp steps against one captured "
                  f"dispatch: {len(differ)} of {len(eager)} tensors differ"
                  f"{': ' + ', '.join(differ[:6]) if differ else ' (torch.equal)'}; first "
                  f"dispatch {first_s:.3f} s; the replay {replay_ms:.3f} ms a step [{card}]",
                  flush=True)
            if differ:
                raise AssertionError(f"43b: the graph dispatch differs from {GRAPH_K} eager dp "
                                     f"steps: {differ[:12]}")
            if steps.launches != eager_launches:
                raise AssertionError(f"43b: a replay launches {steps.launches}, the eager "
                                     f"steps {eager_launches}")
            by_path["dp_multistep_graph"] = multi.launch_counts()
            del multi, steps, model, opt
            gc.collect()
            torch.cuda.empty_cache()

            # (c) FSDP2 at world 1
            fs = par_model(dev, "data")
            fs.load_state_dict(state0)
            fs_opt = torch.optim.SGD(fs.parameters(), 0.0)
            fs_step, place = make_fsdp_train_step(fs, loss_cfg, fs_opt, make_fsdp_mesh(1))
            local = place(host)
            _kernels.reset_launch_counts()
            m = fs_step(local, 0.0, cw)
            fs_grads = {k: p.grad.full_tensor() for k, p in fs.named_parameters()}
            torch.cuda.synchronize()
            by_path["fsdp_world1_train_step"] = counts_all_launched(
                "43c fsdp step", FORWARD_KERNELS + SSG_BACKWARD_KERNELS)
            hold_to_single("43c fsdp step (world 1, FSDP2)", (m["loss"], fs_grads), want, pre_bn)
            fs_ms = time_ms(lambda: fs_step(local, 0.0, cw), reps=5, warmup=1)
            del fs, fs_opt, fs_step
        finally:
            dist.destroy_process_group()

        # (c) tp on a 1 x 1 mesh (its own world of one)
        par_world(tmp, "tp", dev)
        try:
            tp = par_model(dev, "data")
            tp.load_state_dict(state0)
            tp_step, place = make_tp_train_step(tp, loss_cfg, torch.optim.SGD(tp.parameters(), 0.0),
                                                make_2d_mesh(1, 1))
            local = place(host)
            split = sum(m.column_group is not None for m in tp.modules()
                        if hasattr(m, "column_group"))
            _kernels.reset_launch_counts()
            got = grads_after(tp_step, tp, local, 0.0, cw)
            torch.cuda.synchronize()
            by_path["tp_1x1_train_step"] = counts_all_launched(
                "43c tp step", FORWARD_KERNELS + SSG_BACKWARD_KERNELS)
            hold_to_single(f"43c tp step (1 x 1 mesh, {split} column-parallel kernels)", got, want, pre_bn)
            tp_ms = time_ms(lambda: tp_step(local, 0.0, cw), reps=5, warmup=1)
            print(f"43c: fsdp step {fs_ms:.3f} ms, tp step {tp_ms:.3f} ms, single-device "
                  f"{single_ms:.3f} ms [{card}]", flush=True)
        finally:
            dist.destroy_process_group()

        # (d) two ranks on this card over gloo
        half = batch_to_device(par_batch(ds, slice(0, PAR_B // 2)), dev)
        kernels_at_rows(par_model(dev), half, cw, dev, "43d B=8")
        torch.save({"state": state0, "batch": host, "cw": cw.cpu()}, tmp / "inputs.pt")
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--gloo-rank",
                                   str(r), str(tmp)], cwd=ROOT) for r in range(2)]
        try:
            codes = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(codes):
            raise AssertionError(f"43d: the gloo ranks exited {codes}")
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
        for k, g in ranks[0]["grads"].items():
            if not torch.equal(g, ranks[1]["grads"][k]):
                raise AssertionError(f"43d: the ranks' gradients differ at {k}")
        hold_to_single("43d dp step (2 ranks x 8 blocks on cuda:0 over gloo)",
                       (ranks[0]["loss"], ranks[0]["grads"]),
                       (want[0].cpu(), {k: v.cpu() for k, v in want[1].items()}), pre_bn)
        missing = [k for k in FORWARD_KERNELS + SSG_BACKWARD_KERNELS if not ranks[0]["counts"][k]]
        if missing:
            raise AssertionError(f"43d: kernels never launched: {missing}")
        by_path["dp_gloo_2ranks_train_step"] = ranks[0]["counts"]
        print(f"43d: the gloo dp step {ranks[0]['ms']:.3f} ms (rank 0; both ranks share the "
              f"card) [{card}]; phase 43 in {time.perf_counter() - t_start:.1f} s (host)",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return by_path


# ----------------------------------------------------------- 44. the parallel layer, part 2

PAR2_RING = (B, N, 2, 192)  # flat ptv3's attention: B, N, heads, head width
PAR2_AUX = 1e-2  # the ep step's load-balance coefficient (parallel.ep_aux_coef)
PAR2_VOTE = dict(num_classes=NUM_CLASSES, block_points=N, block_size=8.0, stride=4.0,
                 num_votes=2, batch_size=3, seed=5)
# Each step's gradient limit, relative L2 a leaf (the cosine's is 1 - limit^2,
# which the L2 limit implies), set from the mode's readings on the H100
# (PERF.md section 6), far below the 0.1 of a gradient scaled by 0.9 (a wrong
# divisor, a rank's share lost). The PTv3 steps read 7e-7 (pp), 2.5e-6 (ep)
# and 1.4e-4 (sp: the head's BatchNorm synced over the ranks, the ring's
# combine). SSG's 17 BatchNorms are synced over the ranks: sync-BN's
# E[x^2] - E[x]^2 arithmetic puts it at 0.009 (phase 43a's world-1 dp step of
# the same model reads 0.013 for that arithmetic alone).
PAR2_GRAD_LIMITS = {"sp_ptv3": 1e-3, "sp_ssg": 0.02, "pp_ptv3": 1e-3, "ep_ptv3_moe": 1e-3}


def par2_model(name: str, dev: torch.device, **kw) -> torch.nn.Module:
    """``name`` at the registry's widths, weights and statistics from a
    seed, dropout 0, in train mode on ``dev``."""
    return no_dropout(seeded_model(name, SEED + 44, **kw)).to(dev).train()


def keep_aux_graph(model: torch.nn.Module) -> torch.nn.Module:
    """The MoE layers keep their load-balance loss's graph with no mesh
    axes: the single-rank objective of the ep step."""
    for m in model.modules():
        if hasattr(m, "ep_axes"):
            m.ep_axes = (None, None)
    return model


def par2_single_steps(ds: BlockDataset, dev: torch.device) -> tuple:
    """The single-rank references of phase 44 on the card: (saved inputs
    for the ranks, {check: (loss, grads)}, {check: ms}, pre-BatchNorm
    biases by check)."""
    from pointcloud_bridge_tpu_torch.parallel.ep import aux_mean
    from pointcloud_bridge_tpu_torch.train.loop import batch_to_device

    host = par_batch(ds, slice(0, B))
    batch = batch_to_device(host, dev)
    cw = losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES)).to(dev)
    saved = {"batch": host, "cw": cw.cpu(), "states": {}}
    want, ms, pre_bn = {}, {}, {}
    for check, name in (("sp_ptv3", "ptv3"), ("sp_ssg", "pointnet2_ssg"),
                        ("pp_ptv3", "ptv3"), ("ep_ptv3_moe", "ptv3_moe")):
        model = par2_model(name, dev)
        if name == "ptv3_moe":
            keep_aux_graph(model)
        saved["states"][check] = {k: v.cpu() for k, v in model.state_dict().items()}
        opt = torch.optim.SGD(model.parameters(), 0.0)

        def step(model=model, opt=opt, moe=name == "ptv3_moe"):
            opt.zero_grad(set_to_none=True)
            loss = losses.weighted_cross_entropy(model(batch["points"], batch["colors"]),
                                                 batch["labels"], cw)
            (loss + PAR2_AUX * aux_mean(model) if moe else loss).backward()
            return {"loss": loss}

        want[check] = grads_after(step, model)
        want[check] = (want[check][0].cpu(), {k: v.cpu() for k, v in want[check][1].items()})
        ms[check] = time_ms(step, reps=3, warmup=1)
        # the PTv3 family's final LayerNorm shift also feeds head_bn (through
        # head_fc1): exactly zero gradient (PRE_BN_BIASES)
        pre_bn[check] = pre_bn_biases(model, batch["points"], batch["colors"]) | (
            set(PRE_BN_BIASES) if name.startswith("ptv3") else set())
        del model, opt
    # the ring's inputs and the one-call kernels over the whole N
    rng = np.random.default_rng(SEED + 44)
    q, k, v, g = (torch.from_numpy(rng.normal(size=PAR2_RING).astype(np.float32) * sc).to(dev)
                  for sc in (2.0, 2.0, 1.0, 1.0))
    out, lse = attention.attention_cuda(q, k, v, need_lse=True)
    dq, dk, dv = attention.attention_backward_cuda(q, k, v, out, lse, g)
    saved["ring"] = {"inputs": [t.cpu() for t in (q, k, v, g)]}
    want["ring"] = {"out": out.cpu(), "lse": lse.cpu(), "grads": [t.cpu() for t in (dq, dk, dv)]}
    ms["ring"] = time_ms(lambda: attention.attention_backward_cuda(
        q, k, v, *attention.attention_cuda(q, k, v, need_lse=True), g), reps=5, warmup=1)
    # the single-rank vote
    xyz, rgb, labels = toy_bridge_scene(30000, seed=7)
    pts6 = np.concatenate([xyz, rgb], axis=1).astype(np.float32)
    lw = scene_labelweights([labels], NUM_CLASSES)
    vote_model = no_dropout(seeded_model("pointnet2_ssg", SEED + 45)).to(dev)
    saved["vote"] = {"pts6": pts6, "labels": labels, "lw": lw,
                     "state": {k: v.cpu() for k, v in vote_model.state_dict().items()}}
    t0 = time.perf_counter()
    want["vote"] = whole_scene_vote_predict(vote_model, pts6, labels, lw, **PAR2_VOTE)
    ms["vote"] = (time.perf_counter() - t0) * 1e3
    return saved, want, ms, pre_bn


def gloo2_rank_main(rank: int, tmp: str) -> None:
    """``--gloo2-rank R DIR``: one of phase 44's two ranks, both on cuda:0,
    joined over gloo: the ring, the sp, pp and ep steps and the vote over
    the saved inputs, each with its launch counts and ms."""
    import torch.distributed as dist
    from datetime import timedelta

    from pointcloud_bridge_tpu_torch.parallel import (
        make_ep_mesh, make_ep_train_step, make_mesh, make_pp_train_step, make_sp_train_step,
        ring_attention, shard_sp_batch)
    from pointcloud_bridge_tpu_torch.parallel import ep as ep_mod
    from pointcloud_bridge_tpu_torch.parallel.ring import ring_forward
    from pointcloud_bridge_tpu_torch.train.loop import batch_to_device
    from pointcloud_bridge_tpu_torch.utils.collectives import axis_group

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.library()
    saved = torch.load(Path(tmp) / "inputs2.pt", weights_only=False)
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(tmp) / "store_gloo44"), 2),
                            rank=rank, world_size=2, timeout=timedelta(seconds=300))
    out = {}
    cw = saved["cw"].to(dev)
    loss_cfg = Config().loss
    try:
        # (a) the ring over this rank's half of N
        make_mesh(2, "sp")
        rows = slice(rank * N // 2, (rank + 1) * N // 2)
        q, k, v, g = (t[:, rows].contiguous().to(dev) for t in saved["ring"]["inputs"])
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        _kernels.reset_launch_counts()
        o = ring_attention(*leaves, "sp")
        o.backward(g)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        _, lse = ring_forward(q, k, v, axis_group("sp"))

        def ring_step():
            ls = [t.detach().requires_grad_() for t in (q, k, v)]
            ring_attention(*ls, "sp").backward(g)
        out["ring"] = {"out": o.detach().cpu(), "lse": lse.cpu(),
                       "grads": [t.grad.cpu() for t in leaves], "counts": counts,
                       "ms": time_ms(ring_step, reps=5, warmup=1)}

        def run(check, model, step, local, full=lambda t: t, load=True):
            if load:
                model.load_state_dict(saved["states"][check])
            _kernels.reset_launch_counts()
            got = grads_after(step, model, local, 0.0, cw)
            torch.cuda.synchronize()
            counts = _kernels.launch_counts()
            grads = full({k2: v2 for k2, v2 in got[1].items()})
            out[check] = {"loss": got[0].cpu(), "grads": {k2: v2.cpu() for k2, v2 in grads.items()},
                          "counts": counts,
                          "ms": time_ms(lambda: step(local, 0.0, cw), reps=3, warmup=1)}

        # (b) sp: flat ptv3 over the ring, SSG with its queries sliced
        mesh = make_mesh(2, "sp")
        for check, name, shard in (("sp_ptv3", "ptv3", True), ("sp_ssg", "pointnet2_ssg", False)):
            model = par2_model(name, dev, sp_axis="sp", axis_name="sp")
            step = make_sp_train_step(model, loss_cfg, torch.optim.SGD(model.parameters(), 0.0),
                                      "sp")
            run(check, model, step, shard_sp_batch(saved["batch"], mesh, "sp", None, shard,
                                                   device=dev))
            del model, step
        # (c) pp: two stages of flat ptv3, M = 2
        mesh = make_mesh(2, "pp")
        model = par2_model("ptv3", dev)
        step, stages = make_pp_train_step(model, loss_cfg, torch.optim.SGD(model.parameters(), 0.0),
                                          mesh, "pp", 2)
        run("pp_ptv3", model, step, batch_to_device(saved["batch"], dev), stages.full_tensors)
        out["pp_ptv3"]["local_blocks"] = sorted({n.split(".")[0] for n, _ in
                                                 model.named_parameters() if n.startswith("block")})
        del model, step, stages
        # (d) ep: ptv3_moe on a 1 x 2 ("data", "expert") mesh
        mesh = make_ep_mesh(1, 2)
        model = par2_model("ptv3_moe", dev, axis_name="data")
        step, place = make_ep_train_step(model, loss_cfg, torch.optim.SGD(model.parameters(), 0.0),
                                         mesh, PAR2_AUX)
        model.load_state_dict(saved["states"]["ep_ptv3_moe"])
        run("ep_ptv3_moe", model, step, place(saved["batch"]),
            lambda t: ep_mod.full_tensors(model, mesh, t), load=False)
        del model, step
        # (e) the whole-scene vote over a "data" mesh of two
        vote = saved["vote"]
        vote_model = no_dropout(seeded_model("pointnet2_ssg", SEED + 45)).to(dev)
        vote_model.load_state_dict(vote["state"])
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = whole_scene_vote_predict(vote_model, vote["pts6"], vote["labels"], vote["lw"],
                                       mesh=make_mesh(2, "data"), **PAR2_VOTE)
        torch.cuda.synchronize()
        out["vote"] = {"pred": got["pred"], "counts": _kernels.launch_counts(),
                       "ms": (time.perf_counter() - t0) * 1e3}
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def run_parallel2_phases(ds: BlockDataset, dev: torch.device, card: str) -> tuple:
    """Phase 44, the parallel layer part 2, at the registry's widths on two
    gloo ranks on this card (module docstring) -> (launches by path, the
    sp ptv3 step's counts of rank 0: the ring's train-step pass)."""
    import tempfile

    t_start = time.perf_counter()
    saved, want, ms, pre_bn = par2_single_steps(ds, dev)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="pcb_parallel2_"))
    try:
        torch.save(saved, tmp / "inputs2.pt")
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--gloo2-rank",
                                   str(r), str(tmp)], cwd=ROOT) for r in range(2)]
        try:
            codes = [p.wait(timeout=400) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(codes):
            raise AssertionError(f"44: the gloo ranks exited {codes}")
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (a) the ring against one K6 call and one K6b pair over the whole N
    ring = want["ring"]
    h = N // 2
    for r, got in enumerate(ranks):
        rows = slice(r * h, (r + 1) * h)
        checks = (("output", got["ring"]["out"], ring["out"][:, rows],
                   ATTN_TOL * max(1.0, ring["out"].abs().max().item())),
                  ("lse", got["ring"]["lse"], ring["lse"][:, :, rows], 1e-5),
                  *((name, got["ring"]["grads"][i], ring["grads"][i][:, rows],
                     ATTN_TOL * max(1.0, ring["grads"][i].abs().max().item()))
                    for i, name in enumerate(("dq", "dk", "dv"))))
        for name, a, b2, tol in checks:
            err = max_abs_err(a, b2)
            if err > tol:
                raise AssertionError(f"44a rank {r}: ring {name} max|err| {err} > {tol}")
        if got["ring"]["counts"] != only(flash_attn=2, flash_attn_bwd_dq=2, flash_attn_bwd_dkv=2):
            raise AssertionError(f"44a rank {r}: ring launches {got['ring']['counts']}")
    print(f"44a ring attention [{B},{N},2,192] over 2 ranks: output, lse, dq, dk, dv held to one "
          f"K6 call and one K6b pair over the whole N; K6, dq and dk/dv launched 2 times each a "
          f"rank; {ranks[0]['ring']['ms']:.3f} ms forward + backward (rank 0, both ranks share "
          f"the card) against the one-call kernels' {ms['ring']:.3f} ms [{card}]", flush=True)

    by_path = {"sp_ring_attention": ranks[0]["ring"]["counts"]}
    paths = {"sp_ptv3": ("44b sp ptv3 (ring)", "sp_ptv3_train_step", ("flash_attn",) +
                         ATTN_BACKWARD_KERNELS),
             "sp_ssg": ("44b sp SSG (queries sliced)", "sp_ssg_train_step",
                        FORWARD_KERNELS + SSG_BACKWARD_KERNELS),
             "pp_ptv3": ("44c pp ptv3 (2 stages, M = 2)", "pp_ptv3_train_step",
                         ("flash_attn",) + ATTN_BACKWARD_KERNELS),
             "ep_ptv3_moe": ("44d ep ptv3_moe (1 x 2)", "ep_ptv3_moe_train_step",
                             ("flash_attn",) + ATTN_BACKWARD_KERNELS)}
    for check, (label, path, kernels) in paths.items():
        for k2, g2 in ranks[0][check]["grads"].items():
            if not torch.equal(g2, ranks[1][check]["grads"][k2]):
                raise AssertionError(f"{label}: the ranks' gradients differ at {k2}")
        limit = PAR2_GRAD_LIMITS[check]
        holds = hold_to_single(f"{label}, 2 ranks on cuda:0 over gloo",
                               (ranks[0][check]["loss"], ranks[0][check]["grads"]), want[check],
                               pre_bn[check], limit, 1.0 - limit ** 2)
        for r, got in enumerate(ranks):
            missing = [k2 for k2 in kernels if not got[check]["counts"][k2]]
            if missing:
                raise AssertionError(f"{label} rank {r}: kernels never launched: {missing}")
        by_path[path] = ranks[0][check]["counts"]
        print(f"{label}: B={B} N={N} {ranks[0][check]['ms']:.3f} ms a step (rank 0; both ranks "
              f"share the card) against the single-rank step's {ms[check]:.3f} ms, {holds}, "
              f"launches {ranks[0][check]['counts']} [{card}]", flush=True)
    sp_counts = ranks[0]["sp_ptv3"]["counts"]
    if sp_counts != attention_launches(16):
        raise AssertionError(f"44b sp ptv3: a rank's step launched {sp_counts}, not the ring's "
                             "16 of each attention kernel (8 blocks x P = 2)")
    if ranks[0]["pp_ptv3"]["local_blocks"] != [f"block{i}" for i in range(4)]:
        raise AssertionError(f"44c: stage 0 holds {ranks[0]['pp_ptv3']['local_blocks']}")

    # (e) the vote over the mesh against the single-rank vote
    for r, got in enumerate(ranks):
        if not np.array_equal(got["vote"]["pred"], want["vote"]["pred"]):
            raise AssertionError(f"44e rank {r}: the meshed vote's predictions differ")
    missing = [k2 for k2 in FORWARD_KERNELS if not ranks[0]["vote"]["counts"][k2]]
    if missing:
        raise AssertionError(f"44e: kernels never launched: {missing}")
    by_path["vote_mesh2"] = ranks[0]["vote"]["counts"]
    print(f"44e vote over a mesh of 2: {len(want['vote']['pred'])} points, predictions equal to "
          f"the single-rank vote's; {ranks[0]['vote']['ms']:.1f} ms (rank 0) against "
          f"{ms['vote']:.1f} ms single-rank [{card}]; phase 44 in "
          f"{time.perf_counter() - t_start:.1f} s (host)", flush=True)
    return by_path, sp_counts



# ------------------------------------------------------------------ phase 46
# SSG at the convergence run's size (bench/convergence_parity.py: B = 4,
# N = 512, SA levels 128, 64, 16): (n, s, K, radius, C) of its SA levels and
# (n, s, D) of its FP levels, as SSG_LEVELS and SSG_INTERP
CONV_LEVELS = ((512, 128, 32, 0.1, 3), (128, 64, 32, 0.2, 128), (64, 16, 32, 0.4, 256))
CONV_INTERP = ((64, 16, 512), (128, 64, 256), (512, 128, 128))
# phase 46a's check of the card's training: SSG at dropout 0 from seed 0's
# init, the loss of each of its first steps on the card against an
# in-process CPU run of the same steps, within the bands that bound two
# float32 runs apart (bench/convergence_parity.py's FLOAT32_LOSS_BANDS)
CONV_LOSS_BANDS = conv_bench.FLOAT32_LOSS_BANDS
CONV_STEPS = len(CONV_LOSS_BANDS)
# phase 46b: the sweep's rows at full width, B = 4 x 4096
EVA_ROWS = ("pointnet2_ssg", "dgcnn_k32", "ptv3_win_bf16")
EVA_ITERS, EVA_TRAIN_ITERS = 10, 5


def compare_convergence_kernels(dev: torch.device, res: Results, rng) -> None:
    """K1-K4 at the convergence run's SA and FP levels (B = 4, N = 512) and
    K3b and K4b at its train step's, each against its plain version as at
    SSG's shapes, timed, before phase 46a runs them."""

    def cloud(b, n):
        return torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    start = torch.zeros(B, dtype=torch.int32, device=dev)
    for n, s, k, r, c in CONV_LEVELS:
        xyz = cloud(B, n)
        centers = xyz[:, :s].contiguous()
        check_fps(res, f"B={B} {n}->{s}", xyz, s, start, (CONV,), timed=True)
        check_ball(res, f"B={B} N={n} S={s} K={k} r={r}", ((r, k),), xyz, centers, (CONV,),
                   timed=True)
        idx = grouping.ball_query_cuda(r, k, xyz, centers)
        check_group(res, f"B={B} N={n} S={s} K={k} C={c}", xyz, centers, idx,
                    normal(B, n, c), (CONV,), timed=True)
        if c > 3:  # the levels whose input features need a gradient
            check_group_bwd(res, f"g [{B},{s},{k},{3 + c}] -> [{B},{n},{c}]",
                            normal(B, s, k, 3 + c), idx, n, 3, 3 + c, (CONV_TRAIN,), timed=True)
    for n, s, d in CONV_INTERP:
        dst = cloud(B, n)
        src = dst[:, :s].contiguous()
        check_interp(res, f"B={B} N={n} S={s} D={d} k=3", dst, src, normal(B, s, d), 3, (CONV,),
                     timed=True)
        idx, w = kept_selection(dst, src, 3)
        check_interp_bwd(res, f"g [{B},{n},{d}] -> [{B},{s},{d}] k=3", normal(B, n, d), idx, w,
                         s, (CONV_TRAIN,), timed=True)
    for name in FORWARD_KERNELS:
        res.print_sums(name, (CONV,))
    for name in SSG_BACKWARD_KERNELS:
        res.print_sums(name, (CONV_TRAIN,))


def check_convergence(dev: torch.device) -> tuple:
    """Phase 46a: bench/convergence_parity.py on the card at the JAX
    module's configuration (25 steps x 6 epochs of SSG at B = 4 x 512,
    seeds 0-2). The launches of one train step and of one eval forward are
    counted alone; seed 0 runs twice and must give the same curve, losses
    and final parameters bit for bit, its launches exactly 150 steps' and 24
    eval forwards'. Then seed 0 at dropout 0 on the card and on the CPU:
    the losses of their first CONV_STEPS steps within CONV_LOSS_BANDS ->
    (one forward's launches, one step's, a run's)."""
    train, val = conv_bench.make_data(0)
    model, step = conv_bench.make_port(0, "cuda")
    _kernels.reset_launch_counts()
    step(*train[0])
    torch.cuda.synchronize()
    step_counts = _kernels.launch_counts()
    _kernels.reset_launch_counts()
    conv_bench.evaluate(model, val[:1])
    fwd_counts = _kernels.launch_counts()
    del model, step
    steps = conv_bench.EPOCHS * conv_bench.STEPS_PER_EPOCH
    forwards = conv_bench.EPOCHS * len(val)
    want = {k: steps * step_counts[k] + forwards * fwd_counts[k] for k in step_counts}
    runs, walls = [], []
    for _ in range(2):
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        runs.append(conv_bench.train_port(train, val, 0, device="cuda"))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = _kernels.launch_counts()
        if counts != want:
            raise AssertionError(f"convergence: launches {counts}, want {want} (a step "
                                 f"{step_counts}, a forward {fwd_counts})")
    first, second = runs
    a, b = first["model"].state_dict(), second["model"].state_dict()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if first["curve"] != second["curve"] or first["losses"] != second["losses"] or differ:
        raise AssertionError(f"convergence: seed 0 twice differs (curves {first['curve']}, "
                             f"{second['curve']}; {len(differ)} tensors differ)")
    curves = {0: first["curve"]}
    for seed in conv_bench.SEEDS[1:]:
        t0 = time.perf_counter()
        curves[seed] = conv_bench.run_port(*conv_bench.make_data(seed), seed, device="cuda")
        walls.append(time.perf_counter() - t0)
    for seed, curve in curves.items():
        if not all(0.0 <= x <= 1.0 for x in curve) or not np.isfinite(first["losses"]).all():
            raise AssertionError(f"convergence seed {seed}: curve {curve}")
        print(f"convergence seed {seed}: card mIoU curve {curve}", flush=True)
    final = [c[-1] for c in curves.values()]
    print(f"convergence: seed 0 twice the same bits (curve, {steps} losses, "
          f"{len(a)} tensors); card walls {', '.join(f'{w:.2f}' for w in walls)} s (seed 0 "
          f"twice, seeds 1, 2; {steps} steps and {forwards} eval forwards each); final mIoU "
          f"{np.mean(final):.4f} +- {np.std(final):.4f} over seeds {list(curves)}; launches "
          f"a step {step_counts}, a forward {fwd_counts}", flush=True)
    # the card's steps against the CPU's from the same init, dropout 0; the
    # CPU at its default threads and at 1, whose gap is the CPU's own
    def steps(device):
        t0 = time.perf_counter()
        losses = conv_bench.train_port(train, val[:1], 0, device=device, epochs=1,
                                       steps_per_epoch=CONV_STEPS, dropout_rate=0.0)["losses"]
        return losses, time.perf_counter() - t0

    card, card_s = steps("cuda")
    threads = torch.get_num_threads()
    cpu, cpu_s = steps("cpu")
    torch.set_num_threads(1)
    try:
        cpu1, _ = steps("cpu")
    finally:
        torch.set_num_threads(threads)

    def rel(xs, ys):
        return [abs(x - y) / abs(y) for x, y in zip(xs, ys)]

    gaps = rel(card, cpu)
    print(f"convergence: seed 0 at dropout 0, the losses of {CONV_STEPS} steps on the card "
          f"{card} and on the CPU ({threads} threads) {cpu}: relative gaps "
          f"{' '.join(f'{g:.2e}' for g in gaps)} (bands "
          f"{' '.join(f'{x:.0e}' for x in CONV_LOSS_BANDS)}); the CPU at 1 thread against "
          f"{threads}: {' '.join(f'{g:.2e}' for g in rel(cpu1, cpu))}; card {card_s:.2f} s, "
          f"CPU {cpu_s:.2f} s", flush=True)
    over = [(t + 1, g) for t, (g, band) in enumerate(zip(gaps, CONV_LOSS_BANDS)) if g > band]
    if over:
        raise AssertionError(f"convergence: card and CPU losses part at (step, gap) {over}")
    return fwd_counts, step_counts, counts


def run_sweep(dev: torch.device, rows, out_dir: Path, card: str) -> dict:
    """Phase 46b and ``--eva``: bench/eva_model.py's evaluate_model over
    ``rows`` of DEFAULT_ZOO on the card at full width, B = 4 x 4096, then
    its save_results_csv. Each row's launches are counted around one
    forward and one train step alone and around its evaluate_model, whose
    launches must be exactly its forwards' and train steps'. Prints the
    rows and the CSV under the card's name and power limit; then no row
    may carry an error, device_peak_mb must be > 0 and params must equal
    the same model built on the CPU -> {row: (a forward's launches, a
    step's, the row's)}."""
    counts, got = {}, []
    t0 = time.perf_counter()
    for name in rows:
        kwargs = eva_bench.DEFAULT_ZOO[name]
        try:
            model, batch, step, _ = eva_bench.build_row(name, model_kwargs=kwargs,
                                                        device="cuda")
            with torch.inference_mode():
                _kernels.reset_launch_counts()
                model(batch["points"], batch["colors"])
                torch.cuda.synchronize()
                fwd = _kernels.launch_counts()
            _kernels.reset_launch_counts()
            step()
            torch.cuda.synchronize()
            one_step = _kernels.launch_counts()
            del model, batch, step
            torch.cuda.empty_cache()
            _kernels.reset_launch_counts()
            row = eva_bench.evaluate_model(name, model_kwargs=kwargs, device="cuda",
                                           iters=EVA_ITERS, train_iters=EVA_TRAIN_ITERS)
            torch.cuda.synchronize()
            counts[name] = fwd, one_step, _kernels.launch_counts()
        except Exception as e:  # the sweep goes on, as run_benchmark's
            row = {"model": name, "error": str(e)[:200]}
        got.append(row)
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    eva_bench.save_results_csv(got, str(out_dir / "model_performance_comparison.csv"))
    print(card)
    for row in got:
        launches = counts.get(row["model"], ({},) * 3)[2]
        print(f"eva {json.dumps(row)} launches { {k: n for k, n in launches.items() if n} }",
              flush=True)
    print((out_dir / "model_performance_comparison.csv").read_text(), end="", flush=True)
    print(f"eva: {len(got)} rows in {wall:.1f} s", flush=True)
    bad = [row for row in got if "error" in row]
    if bad:
        raise AssertionError(f"eva: rows failed: {bad}")
    calls = eva_bench.WARMUP + EVA_ITERS + 1, eva_bench.WARMUP + EVA_TRAIN_ITERS
    for row in got:
        kwargs = dict(eva_bench.DEFAULT_ZOO[row["model"]])
        name = kwargs.pop("_model", row["model"])
        kwargs.pop("_note", None)
        if "_feature_dim" in kwargs:
            kwargs["in_features"] = kwargs.pop("_feature_dim")
        cpu_params = sum(p.numel() for p in get_model(name, NUM_CLASSES, **kwargs).parameters())
        if row["params"] != cpu_params or not row.get("device_peak_mb", 0) > 0:
            raise AssertionError(f"eva {row['model']}: params {row['params']} (CPU build "
                                 f"{cpu_params}), device_peak_mb {row.get('device_peak_mb')}")
        fwd, one_step, total = counts[row["model"]]
        want = {k: calls[0] * fwd[k] + calls[1] * one_step[k] for k in fwd}
        if total != want:
            raise AssertionError(f"eva {row['model']}: launches {total}, want {want} (a "
                                 f"forward {fwd}, a step {one_step})")
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    if sys.argv[1:2] == ["--gloo-rank"]:
        gloo_rank_main(int(sys.argv[2]), sys.argv[3])
        return
    if sys.argv[1:2] == ["--gloo2-rank"]:
        gloo2_rank_main(int(sys.argv[2]), sys.argv[3])
        return
    dev = torch.device("cuda", 0)
    # the DGCNN phases set the EdgeConv form themselves (edgeconv_form) and
    # hold the card's default
    os.environ.pop("PCB_EDGECONV_FAST", None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(card)
    t_start = time.perf_counter()

    def mark(what: str) -> None:
        print(f"[wall] {what}: {time.perf_counter() - t_start:.1f} s since the build began",
              flush=True)

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)

    # 2. build; where a flag times them, the first K7 and K7b and K3b's sort
    # alone (probes/k7_probe.py) build beside the package, one nvcc each
    global FIRST_DESIGN_TURNS
    FIRST_DESIGN_TURNS = sys.argv[1:2] in (["--dgcnn"], ["--edge"], ["--edge-split"])
    if FIRST_DESIGN_TURNS:
        k7_probe.start_build()
    t0 = time.perf_counter()
    so = _kernels.build()
    _kernels.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {so.relative_to(ROOT)}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas {line.strip()}")

    # 3. kernels against their plain versions; 3b. the backward kernels;
    # 3c. the flash-attention kernel; 3d. its backward kernels
    if sys.argv[1:] == ["--attention"]:
        # kernel work on K6 and K6b: phases 1, 2, 3c and 3d alone, no result line
        res = Results()
        compare_attention_kernel(dev, res)
        compare_attention_backward(dev, res)
        return
    if sys.argv[1:] == ["--attention-bf16"]:
        # kernel work on the bf16 K6 and K6b: phases 1, 2 and 3e alone, no
        # result line
        compare_attention_bf16(dev, Results())
        return
    if sys.argv[1:] == ["--grouping"]:
        # kernel work on K3 and K3b: phases 1, 2 and their cases of 3 and 3b
        # alone, then K3b's variants (probes/k3b_probe.py), no result line
        from pointcloud_bridge_tpu_torch.probes import k3b_probe

        res = Results()
        compare_group_kernel(dev, res, np.random.default_rng(SEED))
        compare_group_backward(dev, res, np.random.default_rng(SEED + 1))
        k3b_probe.compare(dev)
        return
    if sys.argv[1:] == ["--sampling"]:
        # kernel work on K1 and K4: phases 1, 2 and their cases of 3, then
        # their launch choices side by side, no result line
        res = Results()
        rng = np.random.default_rng(SEED)
        compare_fps_kernel(dev, res, rng)
        compare_interp_kernel(dev, res, rng)
        compare_sampling_designs(dev)
        return
    if sys.argv[1:] == ["--neighbours"]:
        # kernel work on K2, K5 and K5c: phases 1, 2 and their cases of 3,
        # then their launch choices side by side and K5c's first design in
        # turns with the kernel (probes/k2_k5_probe.py), no result line
        from pointcloud_bridge_tpu_torch.probes import k2_k5_probe

        compare_neighbour_kernels(dev, Results(), np.random.default_rng(SEED))
        compare_neighbour_designs(dev)
        k2_k5_probe.compare_k5c(dev)
        return
    if sys.argv[1:] == ["--k5c-exit"]:
        # K5c's early exit (probes/k2_k5_probe.py) on the features DGCNN's
        # graphs are built over and on normal ones, no result line
        from pointcloud_bridge_tpu_torch.probes import k2_k5_probe

        k2_k5_probe.probe_knn_c_exit(dev, dgcnn_features(dev))
        return
    if sys.argv[1:] == ["--interp-backward"]:
        # kernel work on K4b: phases 1, 2 and its cases of 3b, then its two
        # designs side by side (probes/k4b_probe.py), no result line
        from pointcloud_bridge_tpu_torch.probes import k4b_probe

        compare_interp_backward(dev, Results(), np.random.default_rng(SEED + 1))
        k4b_probe.compare(dev)
        return
    if sys.argv[1:] == ["--dgcnn"]:
        # model work on DGCNN: phases 1, 2, the K2, K5 and K5c cases of 3,
        # phase 3f and phases 18-20 and 45 alone, no result line
        res = Results()
        compare_neighbour_kernels(dev, res, np.random.default_rng(SEED))
        compare_edge_kernels(dev, res, np.random.default_rng(SEED + 3))
        data_dir = ROOT / "build" / "chip_smoke_data"
        try:
            ds = make_dataset(data_dir)
            check_dgcnn_forward("dgcnn", ds, dev, SEED + 18)
            check_dgcnn_forward("dgcnn_global", ds, dev, SEED + 28)
            check_dgcnn_train_step(ds, dev)
            train_dgcnn_through_cli(data_dir, len(ds), dev)
            compare_edgeconv_forms(ds, dev)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        return
    if sys.argv[1:] == ["--edge", "ties"]:
        # K7 counting the ties online against K7 and a row pass of K7b's own
        # (probes/k7b_rows.cu), beside K7b and the first design, at phase
        # 3f's train shapes, no result line
        rng = np.random.default_rng(SEED + 5)
        k7_probe.compare_tie_designs(
            dev, [(b, k, f, times, path) for b, k, f, times, path, moments in EDGE_CASES
                  if moments], lambda b, k, f: edge_inputs(dev, rng, b, k, f))
        return
    if sys.argv[1:2] == ["--edge"]:
        # kernel work on K7 and K7b: phases 1, 2 and 3f alone (not with
        # --edge probes), then K7b's parts and sort splits and both kernels
        # with a part taken out (probes/k7_probe.py), no result line
        if sys.argv[2:] != ["probes"]:
            compare_edge_kernels(dev, Results(), np.random.default_rng(SEED + 3))
        rng = np.random.default_rng(SEED + 4)
        inputs = lambda b, k, f: edge_inputs(dev, rng, b, k, f)  # noqa: E731
        k7_probe.split_backward(dev, EDGE_SPLIT_CASES, inputs)
        k7_probe.compare_variants(dev, EDGE_SPLIT_CASES, inputs)
        return
    if sys.argv[1:] == ["--edge-split"]:
        # The first K7b split into its per-edge pass, K3b's sort and K3b's fold
        # at phase 3f's train shapes, and the buckets of the graphs of real
        # DGCNN forwards (probes/k7_probe.py), no result line
        rng = np.random.default_rng(SEED + 3)
        k7_probe.split_first_backward(dev, EDGE_SPLIT_CASES,
                                      lambda b, k, f: edge_inputs(dev, rng, b, k, f))
        k7_probe.longest_buckets(dgcnn_features(dev))
        return
    if sys.argv[1:] == ["--msg"]:
        # model work on the PointNet++ MSG family: phases 1, 2, the family's
        # cases of 3 and 3b and phases 21-24 alone, no result line
        res = Results()
        compare_msg_family_kernels(dev, res, np.random.default_rng(SEED))
        compare_msg_family_backward(dev, res, np.random.default_rng(SEED + 1))
        data_dir = ROOT / "build" / "chip_smoke_data"
        try:
            run_msg_family_phases(make_dataset(data_dir), data_dir, dev)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        return
    if sys.argv[1:] == ["--pointnet"]:
        # model work on the PointNet family and enhanced_pointnet2_ssg: phases
        # 1, 2 and 28-33 alone, no result line
        data_dir = ROOT / "build" / "chip_smoke_data"
        try:
            ds = make_dataset(data_dir)
            check_pointnet_phases(ds, data_dir, dev)
            check_enhanced_phases(ds, data_dir, dev)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        return
    if sys.argv[1:] == ["--zoo"]:
        # model work on RandLA-Net and the superpoint models: phases 1, 2,
        # their kernel cases of 3 and 3b and phases 34-37 alone, no result
        # line
        res = Results()
        compare_zoo_kernels(dev, res, np.random.default_rng(SEED))
        compare_zoo_backward(dev, res, np.random.default_rng(SEED + 1))
        data_dir = ROOT / "build" / "chip_smoke_data"
        try:
            run_zoo_phases(make_dataset(data_dir), data_dir, dev)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        return
    if sys.argv[1:] == ["--train-steps"]:
        # every single-step train phase, each run twice from the same state:
        # phases 1, 2 and those alone, every phase's count of leaves that
        # differ printed before the script fails, no result line
        global REPEAT_REPORT_ONLY
        REPEAT_REPORT_ONLY = True
        data_dir = ROOT / "build" / "chip_smoke_data"
        try:
            run_train_steps(make_dataset(data_dir), dev)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        print(f"train steps run twice: {len(REPEAT_DIFFERS)} differ "
              f"{[(label, same, len(d)) for label, same, d in REPEAT_DIFFERS]}")
        if REPEAT_DIFFERS:
            raise SystemExit(1)
        return
    if sys.argv[1:] == ["--graphs"]:
        # multi-step dispatch for every other model with a step phase or a
        # recipe: phases 1, 2 and 38 over GRAPH_MORE, then the ops that warn
        # under set_random_seed(deterministic=True), no result line
        data_dir = ROOT / "build" / "chip_smoke_data"
        try:
            ds = make_dataset(data_dir)
            run_graph_phases(ds, dev, GRAPH_MORE)
            determinism_warnings(ds, dev)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        return
    if sys.argv[1:] == ["--measure"]:
        # work on the measurement layer: phases 1, 2, K5's deck cases of 3
        # and phases 40-41 alone, no result line
        res = Results()
        compare_measure_knn(dev, res, np.random.default_rng(SEED))
        check_measurement_chain(dev, res)
        run_full_pipeline(dev)
        return
    if sys.argv[1:] == ["--large-scene"]:
        # phases 1, 2 and examples/large_scene_stream.py at 5M points, no
        # result line
        run_large_scene(dev)
        return
    if sys.argv[1:] == ["--tools"]:
        # phases 1, 2 and 42 alone, no result line
        data_dir = ROOT / "build" / "chip_smoke_data"
        try:
            run_tool_phases(make_dataset(data_dir), data_dir, dev)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        return
    if sys.argv[1:] == ["--export-all"]:
        # phases 1, 2 and every registry name exported, no result line
        export_all(dev)
        return
    if sys.argv[1:] == ["--parallel"]:
        # phases 1, 2 and 43 alone, no result line
        data_dir = ROOT / "build" / "chip_smoke_data"
        try:
            run_parallel_phases(make_dataset(data_dir), dev, card)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        return
    if sys.argv[1:] == ["--parallel2"]:
        # phases 1, 2, 3c, 3d and 44 alone, no result line
        data_dir = ROOT / "build" / "chip_smoke_data"
        try:
            res = Results()
            compare_attention_kernel(dev, res)
            compare_attention_backward(dev, res)
            run_parallel2_phases(make_dataset(data_dir), dev, card)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        return
    if sys.argv[1:] == ["--host-us"]:
        # phases 1, 2 and the entry points' host time, no result line
        entry_point_host_us(dev)
        return
    if sys.argv[1:] == ["--eva"]:
        # phases 1, 2 and bench/eva_model.py's whole DEFAULT_ZOO on the card,
        # the CSV in results_torch/, no result line
        run_sweep(dev, tuple(eva_bench.DEFAULT_ZOO), ROOT / "results_torch", card)
        return
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
    res = compare_kernels(dev)
    compare_backward_kernels(dev, res)
    compare_attention_kernel(dev, res)
    compare_attention_backward(dev, res)
    # 3e. the bf16 flash-attention kernels
    compare_attention_bf16(dev, res)
    # 3f. K7 and K7b, DGCNN's restructured EdgeConv
    compare_edge_kernels(dev, res, np.random.default_rng(SEED + 3))
    # 3g. K1-K4, K3b and K4b at the convergence run's shapes (phase 46a)
    compare_convergence_kernels(dev, res, np.random.default_rng(SEED + 46))
    mark("phases 3-3g")

    # 4. the SSG forward on the card against the CPU
    data_dir = ROOT / "build" / "chip_smoke_data"
    try:
        t0 = time.perf_counter()
        ds = make_dataset(data_dir)
        print(f"dataset: {len(ds)} blocks x {ds.num_points} points from 2 LAS scenes "
              f"in {time.perf_counter() - t0:.2f} s (host)")
        gen = torch.Generator().manual_seed(SEED)
        model = get_model("pointnet2_ssg", NUM_CLASSES, generator=gen)
        randomize_bn(model, gen)
        model.eval()
        cpu_model = copy.deepcopy(model)
        model.to(dev)
        xyz_cpu = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32))
        rgb_cpu = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32))
        xyz, rgb = xyz_cpu.to(dev), rgb_cpu.to(dev)
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref = cpu_model(xyz_cpu, rgb_cpu)
            cpu_s = time.perf_counter() - t0
            _kernels.reset_launch_counts()
            out = model(xyz, rgb)
            torch.cuda.synchronize()
            fwd_counts = counts_all_launched("forward", FORWARD_KERNELS)
            out = out.cpu()
            err = max_abs_err(out, ref)
            agree = (out.argmax(-1) == ref.argmax(-1)).double().mean().item()
            print(f"forward: logits {tuple(out.shape)} CUDA vs CPU max|err| {err:.3g}, "
                  f"argmax agreement {agree:.6f}, launches {fwd_counts}, "
                  f"CPU reference forward {cpu_s:.2f} s (host)")
            if not torch.isfinite(out).all():
                raise AssertionError("forward: non-finite logits")
            if not torch.allclose(out, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL):
                raise AssertionError(f"forward: CUDA logits differ from CPU by {err}")
            fwd_ms = time_ms(lambda: model(xyz, rgb))
        print(f"forward: B={B} N={N} {fwd_ms:.3f} ms, {B * N / fwd_ms * 1e3:.0f} points/s")

        # 5. serve the 48 blocks twice: the first call meets the batch-16
        # shapes for the first time (library kernels load lazily); the
        # counters cover exactly the second
        t0 = time.perf_counter()
        run_block_inference(model, ds, NUM_CLASSES, batch_size=16)
        first_wall = time.perf_counter() - t0
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        served = run_block_inference(model, ds, NUM_CLASSES, batch_size=16)
        wall = time.perf_counter() - t0
        serve_counts = counts_all_launched("serve", FORWARD_KERNELS)
        if any(serve_counts[k] for k in BACKWARD_KERNELS):
            raise AssertionError(f"serve: a backward kernel ran ({serve_counts})")
        preds = served["predictions"]
        if preds.shape != (len(ds), N) or len(ds) != 48:
            raise AssertionError(f"serve: predictions {preds.shape}, {len(ds)} blocks")
        g = served["global"]
        for key in ("mIoU", "OA", "mAcc", "Precision", "Recall", "F1_score"):
            if not np.isfinite(g[key]):
                raise AssertionError(f"serve: {key} = {g[key]}")
        same = (preds[:B] == ref.argmax(-1).numpy()).mean()
        if same < 0.999:
            raise AssertionError(f"serve: blocks 0-3 agree with the CPU forward on {same}")
        print(f"serve: {len(ds)} blocks in {wall:.4f} s wall, "
              f"{len(ds) * N / wall:.0f} points/s (first call {first_wall:.4f} s), "
              f"launches {serve_counts}, "
              f"OA {g['OA']:.4f} mIoU {g['mIoU']:.4f} (random weights), "
              f"blocks 0-3 vs CPU argmax {same:.6f}")

        # 6. one train step on the card against the CPU
        step_counts = check_ssg_train_step(ds, dev)
        mark("phases 4-6")

        # 7. train through the CLI
        train_counts, exp_dir = train_through_cli(
            "train pointnet2_ssg", "pointnet2_ssg", FORWARD_KERNELS + SSG_BACKWARD_KERNELS,
            data_dir, dev, profile=True)
        try:
            # 8. the BriStruNet forward; 9. serve through the inference CLI
            bristrunet, _ = forward_against_cpu(
                "BriStruNet forward", seeded_model("bristrunet", SEED + 8), ds, dev,
                BRISTRUNET_LAUNCHES)
            by_path = serve_through_cli(data_dir, exp_dir, bristrunet, len(ds), dev)
        finally:
            shutil.rmtree(exp_dir, ignore_errors=True)
        del bristrunet
        mark("phases 7-9")

        # 10. ptv3_pooled at the benched configuration; 11. flat ptv3 at its
        # default width; 12. ptv3_pooled served through the inference CLI
        pooled_counts = only(flash_attn=12)
        forward_against_cpu("ptv3_pooled forward",
                            seeded_model("ptv3_pooled", SEED + 10, **POOLED_BENCHED), ds, dev,
                            pooled_counts)
        flat_counts = only(flash_attn=FLAT_DEPTH)
        forward_against_cpu(f"ptv3 forward ({FLAT_DEPTH} of 8 blocks)",
                            seeded_model("ptv3", SEED + 11, depth=FLAT_DEPTH), ds, dev,
                            flat_counts, profile=False)
        time_flat_forward(ds, dev)
        by_path |= serve_ptv3_pooled_through_cli(data_dir, len(ds), dev)
        mark("phases 10-12")

        # 13. one ptv3_pooled train step at the benched configuration against
        # the CPU; 14. ptv3_pooled trained through the training CLI and served
        # from the checkpoint it wrote; 15. one flat ptv3 train step
        no_dropout = dict(drop_rate=0.0, head_drop_rate=0.0)
        pooled_step_counts = attention_launches(12)
        check_attention_train_step(
            "ptv3_pooled train step",
            seeded_model("ptv3_pooled", SEED + 13, **no_dropout, **POOLED_BENCHED), ds, dev,
            pooled_step_counts)
        by_path |= train_ptv3_through_cli(data_dir, len(ds), dev)
        flat_step_counts = attention_launches(FLAT_DEPTH)
        check_attention_train_step(
            "ptv3 train step", seeded_model("ptv3", SEED + 15, depth=FLAT_DEPTH, **no_dropout),
            ds, dev, flat_step_counts)
        mark("phases 13-15")

        # 16. one BriStruNet train step against the CPU; 17. BriStruNet
        # trained through the training CLI with its recipe and served from
        # the checkpoint it wrote
        bristrunet_step_counts = check_bristrunet_train_step(ds, dev)
        by_path |= train_bristrunet_through_cli(data_dir, len(ds), dev, bristrunet_step_counts)
        mark("phases 16-17")

        # 18. the DGCNN and DGCNNGlobal forwards against the CPU; 19. one DGCNN
        # train step against the CPU; 20. configs/train_dgcnn.yaml through the
        # training CLI, served from the checkpoint it wrote
        dgcnn_counts = check_dgcnn_forward("dgcnn", ds, dev, SEED + 18)
        dgcnn_global_counts = check_dgcnn_forward("dgcnn_global", ds, dev, SEED + 28)
        dgcnn_step_counts = check_dgcnn_train_step(ds, dev)
        by_path[DGCNN_TRAIN] = dgcnn_step_counts
        by_path |= train_dgcnn_through_cli(data_dir, len(ds), dev)
        mark("phases 18-20")
        # 45. both EdgeConv forms of dgcnn and dgcnn_global side by side
        compare_edgeconv_forms(ds, dev)
        mark("phase 45")

        # 21. the pointnet2_msg forward with 9 channels; 22. the sem_seg and
        # classifier forwards; 23. one pointnet2_msg train step against the
        # CPU; 24. configs/train_partsize_msg.yaml through the training CLI,
        # served from the checkpoint it wrote
        msg_passes, msg_by_path = run_msg_family_phases(ds, data_dir, dev)
        by_path |= msg_by_path
        mark("phases 21-24")

        # 25. ptv3_moe: the forward and a train step against the CPU, then
        # trained at its defaults through the training CLI and served
        by_path["ptv3_moe_forward"] = check_moe_forward(ds, dev)
        by_path["ptv3_moe_train_step"] = check_moe_train_step(ds, dev)
        by_path["ptv3_moe_train_cli"], moe_exp = train_through_cli(
            "train ptv3_moe", "ptv3_moe", ("flash_attn",) + ATTN_BACKWARD_KERNELS, data_dir,
            dev, profile=True)
        try:
            by_path["ptv3_moe_serve_trained"] = serve_blocks(
                "serve trained ptv3_moe blocks", "ptv3_moe", moe_exp, ("flash_attn",),
                data_dir, len(ds), dev)
        finally:
            shutil.rmtree(moe_exp, ignore_errors=True)
        mark("phase 25")

        # 26. the options of ptv3 and ptv3_pooled: bf16 forwards, remat, a
        # bf16-stream train step
        ptv3_bf16_counts = bf16_against("ptv3 bf16 stream", "ptv3", {"stream_dtype": "bfloat16"},
                                        ds, dev, 8, SEED + 31)
        by_path["ptv3_bf16_compute_forward"] = bf16_against(
            "ptv3 bf16 compute", "ptv3", {"compute_dtype": "bfloat16"}, ds, dev, 8, SEED + 31)
        pooled_bf16_counts = bf16_against(
            "ptv3_pooled bf16 stream", "ptv3_pooled",
            dict(POOLED_BENCHED, stream_dtype="bfloat16"), ds, dev, 12, SEED + 32)
        by_path["ptv3_pooled_bf16_compute_forward"] = bf16_against(
            "ptv3_pooled bf16 compute", "ptv3_pooled",
            dict(POOLED_BENCHED, compute_dtype="bfloat16"), ds, dev, 12, SEED + 32)
        by_path["ptv3_pooled_remat_train_step"] = check_remat_exact(ds, dev)
        by_path["ptv3_bf16_train_step"] = check_bf16_train_step(ds, dev)
        mark("phase 26")

        # 27. configs/train_ptv3_big_prod.yaml through the training CLI
        prod_by_path = train_prod_through_cli(data_dir, dev)
        prod_counts = prod_by_path.pop(PROD_TRAIN)
        by_path |= prod_by_path
        mark("phase 27")

        # 28. the PointNet family's forwards; 29. a pointnet train step;
        # 30. configs/train_pointnet.yaml through the training CLI, served
        by_path |= check_pointnet_phases(ds, data_dir, dev)
        mark("phases 28-30")

        # 31. the enhanced_pointnet2_ssg forwards; 32. its train steps; 33.
        # served through the inference CLI
        enhanced_passes, enhanced_by_path = check_enhanced_phases(ds, data_dir, dev)
        by_path |= enhanced_passes | enhanced_by_path
        mark("phases 31-33")

        # 34. the forwards of randlanet, randlanet_ss, spg and spt; 35. a
        # train step of each; 36. configs/train_randlanet.yaml through the
        # training CLI, served; 37. spg and spt timed at batch 16 and served
        zoo_passes, zoo_by_path = run_zoo_phases(ds, data_dir, dev)
        by_path |= zoo_by_path
        mark("phases 34-37")

        # 38. K = 4 train steps at batch 16 as one CUDA graph replay against
        # 4 eager steps: SSG, the pointnet2_msg and BriStruNet recipes and the
        # benched ptv3_pooled; 39. configs/train_partsize_msg.yaml at
        # steps_per_dispatch 4 through the training CLI
        run_graph_phases(ds, dev)
        by_path["msg_multistep_train_cli"] = train_multistep_through_cli(data_dir, len(ds), dev)
        mark("phases 38-39")

        # 42. reference checkpoints imported and served, six programs
        # exported and run, debug_module, the superpoint host modules
        by_path |= run_tool_phases(ds, data_dir, dev)
        mark("phase 42")

        # 43. the parallel layer: dp at a world of one over NCCL (and as a
        # CUDA-graph replay), FSDP2 and tp at one rank, two gloo ranks on
        # this card
        by_path |= run_parallel_phases(ds, dev, card)
        mark("phase 43")

        # 44. the parallel layer, part 2: ring attention, sp, pp, ep and the
        # vote over a mesh, two gloo ranks on this card
        par2_by_path, sp_ring_counts = run_parallel2_phases(ds, dev, card)
        by_path |= par2_by_path
        mark("phase 44")
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    # 40. the deck-measurement chain at both deck sizes against the CPU
    # path; 41. examples/full_pipeline.py: train, vote, export, measure
    measure_counts = check_measurement_chain(dev, res)
    by_path["full_pipeline"] = run_full_pipeline(dev)
    mark("phases 40-41")

    # 46a. bench/convergence_parity.py on the card, seeds 0-2, seed 0 twice,
    # its first steps at dropout 0 against the CPU's; 46b.
    # bench/eva_model.py's sweep over three rows at full width
    conv_fwd, conv_step, by_path["convergence_seed0"] = check_convergence(dev)
    mark("phase 46a")
    eva_dir = ROOT / "build" / "chip_smoke_eva"
    try:
        eva_counts = run_sweep(dev, EVA_ROWS, eva_dir, card)
    finally:
        shutil.rmtree(eva_dir, ignore_errors=True)
    by_path |= {f"eva_{name}": counts[2] for name, counts in eva_counts.items()}
    mark("phase 46b")
    # Per kernel and path: the launches of one pass at B=4 (phases 4, 6, 8,
    # 10, 11, 13, 15, 16 and 18) beside the times and bound summed over
    # exactly those launches' shapes (phases 3, 3b, 3c and 3d). The row's own
    # numbers are those of the BriStruNet forward, of the SSG train step for
    # its backward kernels, of the DGCNN forward for K5c, of the ptv3_pooled
    # forward for the flash-attention kernel and of the ptv3_pooled train
    # step for its backward kernels (ROW_PATH). The SSG and BriStruNet train steps give their forward
    # kernels the shapes of their forwards, which stand under those paths.
    pass_counts = {SSG: fwd_counts, BRISTRUNET: BRISTRUNET_LAUNCHES, TRAIN: step_counts,
                   BRISTRUNET_TRAIN: bristrunet_step_counts,
                   PTV3_POOLED: pooled_counts, PTV3: flat_counts,
                   PTV3_POOLED_TRAIN: pooled_step_counts, PTV3_TRAIN: flat_step_counts,
                   DGCNN: dgcnn_counts, DGCNN_GLOBAL: dgcnn_global_counts,
                   DGCNN_TRAIN: dgcnn_step_counts, **msg_passes,
                   PROD_TRAIN: prod_counts, PTV3_BF16: ptv3_bf16_counts,
                   POOLED_BF16: pooled_bf16_counts, **zoo_passes, **measure_counts,
                   SP_RING_TRAIN: sp_ring_counts, CONV: conv_fwd, CONV_TRAIN: conv_step,
                   DGCNN_K32: eva_counts["dgcnn_k32"][0],
                   DGCNN_K32_TRAIN: eva_counts["dgcnn_k32"][1],
                   PTV3_WIN_BF16: eva_counts["ptv3_win_bf16"][0],
                   PTV3_WIN_BF16_TRAIN: eva_counts["ptv3_win_bf16"][1]}
    serves = {"ssg_serve_blocks": serve_counts, "ssg_train_cli": train_counts, **by_path}
    kernels = []
    for k in _kernels.KERNELS:
        paths = {path: res.row(k.name, path, counts[k.name])
                 for path, counts in pass_counts.items()
                 if counts[k.name] and k.name in TRAIN_PATH_KERNELS.get(path, (k.name,))}
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "max_abs_err": res.err[k.name],
            **paths[ROW_PATH.get(k.name, BRISTRUNET)],
            "paths": paths,
            "launches_by_path": {path: c[k.name] for path, c in serves.items()},
        })
    summary = {"kernels": kernels}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
