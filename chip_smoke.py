#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``nwhead_tpu_torch``).

Run from the repository root on a machine with an NVIDIA Hopper GPU::

    python3 chip_smoke.py

It fails (non-zero exit, no result line) without a CUDA device or without the
package beside it. With one, in order:

1. prints the card (nvidia-smi name and power limit, compute capability) and
   ``nwhead_tpu_torch.capabilities()``;
2. builds the CUDA kernel libraries from ``nwhead_tpu_torch/csrc`` (one nvcc
   per source, all at once) and prints the build time and ptxas's
   register/shared-memory report;
3. K2 kernel phase: the prepared NW head kernel against its plain PyTorch
   version, all five similarity kernels, f32 and bf16 banks with masked rows,
   at the CUB-200 shape (B=64, S=5994, D=512, C=200), at B=256, at a ragged
   B=37, at C=10, at the training eval's B=8, at the ViT-S/14 bank's D=384
   and at C=1,000 (S=65,536, class-sorted); each called twice for the same
   bits; times kernel and plain version with CUDA events at the CUB shape
   and at C=1,000, and prints each timed call's split count, partials bytes
   and device functions (pass 1, the merge; ``head_split``);
4. K1/K3 kernel phase: the raw fused forward (K1) and its backward (K3, dq
   and ds) against their plain versions, all five similarity kernels, f32
   and bf16, masked rows holding NaN, at the training episode's shape (B=8,
   S=1200, D=512, C=200), at B=64, S=5994, at a ragged B=37, S=1001, at
   C=10 and with six queries copied into the support at the episode's
   shape and at B=64 (K1 and dq on 8- and 32-query tiles), clip's scale
   gradient included, and at a data shard's share of the episode over a
   data axis of 2 (B=4, S=1200); K1 and dq each called twice for the same
   bits; times each at the episode's shape, the shard's and B=64, and
   prints K1's and dq's device functions (pass 1, the merge;
   ``raw_split``);
5. ViT kernel phase: K7 (attention off the packed qkv) f32 and bf16 at
   ViT-S/14's B=64, N=257, H=6, hd=64, at a ragged N=197, at N=1370, at
   ViT-B/14's 12 heads and at the edges of its tiles (N of 1, 8, 16, 17,
   64 and 65, hd 32, 64 and 128, B=2); the K9 forward (fused MLP) f32 and
   bf16 at M=16,448 tokens, D=384, D_h=1,536, at a ragged M and at
   ViT-B/14's width (D=768, D_h=3,072, timed); K10 and K11 (the bf16
   attention and MLP half-blocks) at B=64 with every combination of the
   LayerNorm, LayerScale and residual folds, K11 with no fold against K9
   bit for bit, K11 at a ragged M=1,001 with D_h=100 and at ViT-B/14's
   width (timed), and K10 at the edges of its tiles (B=1, N of 1, 63, 64,
   65 and 129; B=3, N=37, heads of 32) and at ViT-B/14's width (timed),
   every fold; each against its plain version, timed at the serving shape,
   K10 also split into its device functions by ``torch.profiler``, K7 beside
   ``F.scaled_dot_product_attention`` on the same data, by ``time_ms`` and
   again in turns with it by the labs' harness (L2 flushed by a read);
6. K4/K5 kernel phase: the int8 and int4 prepared heads against the plain
   version (integer products exact), all five similarity kernels, masked
   rows holding NaN, at the CUB-200 shape, the ViT-S/14 bank's D=384, the
   training eval's B=8 and a ragged B=37, S=1001, D=509 (off the word for
   int8, off the 8-wide int4 pair), C=150 (class-sorted); timed at the CUB
   shape;
7. K10/K11 int8 kernel phase: the int8 attention and MLP half-blocks at
   B=64, N=257, D=384 (M=16,448 tokens) with every combination of the
   folds, against their plain versions, timed with the serving folds, K11
   int8 bit-equal to its plain version (exact int32 sums) or the phase
   fails, also at M=1,001, D=388, D_h=100 and at ViT-B/14's width (timed);
   K10 int8's qkv stage alone (``qkv_proj_int8_cuda``) bit-equal to
   ``int8_dense_f32(quantize_act(...))`` at every fold and shape or the
   phase fails; K10 int8 at K10's extra shapes (ViT-B/14's timed) and split
   into its device functions; and
   the plain int8 attention chain with its scores rounded exactly (an f64
   sum) against itself, which shows why K10 int8's attention stage keeps
   the plain version's summation order;
8. ViT training kernel phase: K8 (the attention backward) f32 and bf16 at
   ViT-S/14's B=64, N=257, H=6, hd=64, at a ragged N=197, at N=1370 with
   B=8, at ViT-B/14's 12 heads, at 12 heads of 32 and at K7's tile edges,
   every part of dqkv;
   the K9 backward (all five gradients) f32 and bf16 at M=16,448, at a
   ragged M=1,001 and at ViT-B/14's width (timed); each against its plain
   version within ``GRAD_REL`` of
   max|plain|, timed at B=64, K8 beside the backward of
   ``F.scaled_dot_product_attention`` on the same q, k, v and dO (by
   ``time_ms`` and in turns, as K7);
9. K6 kernel phase: a 1,048,576-row, D=512, C=1,000 bank of Gaussian class
   centres plus noise (drawn with numpy from a fixed seed) built by
   ``prepare_support_ivf`` at 1,024-row tiles (cluster order, k-means on the
   card) at f32, bf16, int8 and int4; a skewed batch (64 queries of 4
   classes, n_probe 8, one union) and a diverse one (64 classes, n_probe 4,
   group_b 16). K6 against ``_nw_prepared_sel_plain``; the union's rows,
   its bound, top-1 agreement and the largest probability difference
   against the exact head; K6, its plain version and the full pass (K2, K4
   or K5) over the same bank timed, K6 split as the K2 phase splits K2 and
   called twice for the same bits; at full probe K6 equals the full pass
   within 2e-4;
9a. partials and K12 kernel phase: K1 ``partials=True`` against its plain
    version, all five kernels, f32 and bf16, masked rows holding NaN and an
    all-masked support, at the training episode's shape, at B=64, S=5,994
    and at a streamed chunk's (B=64, 65,536 rows, C=1,000, labels in row
    order), each called twice for the same bits; K2/K4/K5
    ``partials=True`` at the CUB shape, every kernel and bank precision, and
    K6 ``partials=True`` there over a list of 1,024-row tiles with empty
    slots; K12 (``fused_attention``, K7's kernel on q, k, v by their
    strides) f32 and bf16 at ViT-S/14's B=64, H=6, N=257, hd=64 and at
    N=197, timed beside ``F.scaled_dot_product_attention``;
9b. sharded serving phase, on the K6 phase's bank with its last 48,576
    rows masked, per bank precision: the unsharded full pass and its
    partials route (held to its plain version, both split as the K2 phase
    splits K2); ``ShardedSupportBank`` on
    ``make_mesh(1, 4, devices=[cuda:0] * 4)`` with ``ivf=True``, its full
    predict (four partials launches) against the full pass within 2e-4
    (bf16 2e-3), both timed; its routed predict at ``ivf_n_probe=8`` on the
    skewed batch (four K6 ``partials=True`` launches; top-1 agreement and
    the largest probability difference against the exact head; one shard's
    list held to its plain version); at f32, ``nw_streaming_log_probs`` over
    the same rows from the host in 16 chunks of 65,536 (K1 ``partials=True``
    16 times) against the full pass;
9c. million-row bank edits, on the same bank at int8: the last 65,536 rows
    prepared by ``prepare_for_concat`` and joined by ``concat_prepared``
    onto the rest, and 10,000 rows tombstoned by ``mask_prepared_rows``,
    each served through K4 against a whole ``prepare_support`` (with the
    rows masked) through K4, and timed beside that whole prepare;
10. ResNet serving phase: ``python -m nwhead_tpu_torch.serve --dataset
   synthetic_cub --arch resnet18 --batch_size 64 --latency_bench``, through the serve
   module's functions, with an f32, a bf16, an int8 and an int4 head (the
   first featurizes the bank and saves it with ``--bank_cache``; the other
   heads, the IVF and the ``--mesh 1,1`` serving phases restore it and
   prepare it at their own precision). It
   checks that the bank's kernel (K2, K4 or K5) was launched, and that the
   served log-probs equal the plain head's on the same features;
11. IVF serving phase: the same command with ``--serve_mode ivf``, with
    ``--ivf_probe auto`` (calibrated on 256 validation images),
    ``--ivf_probe 2 --ivf_group 16``, ``--ivf_probe 1 --head_precision
    int8``, and at bf16 and int4. It counts K6's launches in each run and
    checks the served log-probs against the plain selected head on the
    features the request used; then ``--mesh 1,1`` with an f32 and an int8
    head: one K2 or K4 ``partials=True`` launch per request and no
    finalizing head, the served log-probs against the plain partials on the
    one shard, merged;
11a. bank-edit phase: the same ResNet-18 serving bank (S=5,800, C=200),
    a serving callable made before the edits, then ``add_support`` of 256
    validation images, ``remove_support`` of 64 rows (tombstones), of
    enough more to pass a quarter of the prepared rows (a compaction) and
    ``add_support`` of 64 images to a new environment, with f32, bf16
    (K2), int8 (K4) and int4 (K5) heads: after each edit the callable's
    log-probs against the plain head over the rows left and against a
    fresh ``restore_bank`` of them through the kernel, and the path taken
    (the old rows kept, the features untouched, the dead count). Then the
    IVF bank grown by the same adds (two ``concat_ivf`` calls and no
    rebuild; routed against the plain selected head, every tile against
    full mode) and a tombstone removal on four shards of the card (four K2
    ``partials=True`` launches a request, against a rebuilt sharded bank).
    It prints each edit's seconds beside ``precompute`` and
    ``restore_bank``, and the launches of the edited banks' serving calls;
12. ViT serving phase: ``python -m nwhead_tpu_torch.serve --dataset
    synthetic_cub --arch vit_s14 --batch_size 64 --latency_bench`` with
    ``--featurizer_precision bf16_fused``, with ``--fused_inference`` and
    with ``--fused_inference --bf16``, through the serve module's functions,
    LayerScale gammas set to values of order 1 before the bank is built. It
    checks the launches per request (K10 and K11 12 times, or K7 and K9 12
    times, and K2 once), the served features against the plain featurizer
    and the served log-probs against the plain head on the same images, and
    prints p50, p95, queries/s, the bank's seconds and peak device memory;
13. ViT int8 serving phase: ``python -m nwhead_tpu_torch.serve --dataset
    synthetic_cub --arch vit_s14 --featurizer_precision int8 --head_precision
    int8 --batch_size 64 --latency_bench`` and the same with ``--head_precision
    int4``, calibrated on 256 training images, gammas as in 10. It checks the
    launches per request (K10 int8 and K11 int8 12 times, K4 or K5 once), the
    served features against the plain quantized featurizer and the served
    log-probs against the plain head, and prints p50, p95, queries/s, the
    calibration's and the bank's seconds and peak device memory;
14. training phase: ``python -m nwhead_tpu_torch.train --dataset
    synthetic_cub --arch resnet18 --batch_size 8 --n_shot 6 --lr 1e-2
    --num_epochs 1 --num_steps_per_epoch 5 --num_val_steps_per_epoch 10``
    through the module's functions (eval in the random, full and cluster
    modes, one centroid a class, then 5 steps on 1,208-image batches). It
    checks that K1, dq and ds launched once per step and K2 in the
    full-mode eval, that every loss is finite
    and the weights moved, that the first step's head through the kernels
    equals the plain versions on the same features, and that K2 at the
    eval's batch of 8 equals its plain version. It prints the time of the
    steps split into featurizer and head by CUDA events recorded from hooks
    inside them, and the peak device memory. Then 3 steps with a bf16 head,
    and 3 steps of the
    canonical ``--n_way 10 --n_shot 1`` recipe, which is too small for the
    fused head and must launch no K1;
14m. mesh training phase (``NWTrainer(mesh=)``): ``train --mesh 1,1`` of
    the same configuration (3 steps, 2 eval batches) through the module's
    functions, K1, dq and ds once a step and the full-mode eval on the
    sharded bank's K2 ``partials``; then the trainer over a (2, 2) mesh of
    the one card (``make_mesh(2, 2, devices=[cuda:0] * 4)``, set up by the
    same functions) beside the meshless trainer, from the same weights:
    3 steps each from the same state (the mesh trainer takes the meshless
    weights, statistics, momentum and generators before each step, so
    both draw the same episode): the losses within rtol 1e-4, the update
    within 1% of the meshless one's in norm, the first step's gradients
    against the f64 step's (the mesh's worst tensor within 1.5 times the
    meshless step's own worst); then 3 free-running steps each, K1, dq and
    ds twice a step in the mesh run (one data replica of 4 queries each,
    against all 1,200 support rows, BatchNorm synced over the two
    replicas), the first step's loss within rtol 1e-4 (the later steps
    part by f32 rounding that grows at lr 1e-2: their drift is printed
    beside a second meshless run's); the first step's per-shard head (B=4,
    S=1,200) through K1, dq and ds against the plain versions; distributed
    precompute (each 128-image batch in 4 pieces) against the meshless
    features (1e-5 of max); the full-mode eval on the sharded bank's K2
    ``partials`` (4 a batch), a batch against the meshless prepared head
    (2e-4); it prints each run's ms a step and peak device memory beside
    the nvidia-smi line;
14a. eval CLI phase: two training steps of the same configuration write a
    checkpoint, then ``python -m nwhead_tpu_torch.eval --dataset
    synthetic_cub --arch resnet18 --batch_size 8 --modes random full cluster
    ivf ensemble knn hnsw --n_shot_cluster 6 --fit_temperature
    --influence_queries 8 --num_val_steps 10 --ckpt ...`` runs in process
    (its ``main``, the phase's datasets). It checks each mode's launches
    (cluster: K1 once a batch on the 1,200-row cluster bank; full: K2; ivf:
    K6; ensemble: K1 once a batch over the one environment's 5,800 rows;
    random, knn and hnsw: none, their 200- and 80-row supports take the
    naive head),
    one cluster batch against the plain head and one full batch against
    the plain prepared head (2e-4), the device k-means built again to the
    same bits and against its CPU run from the same kmeans++ init (1e-4 of
    max|centroid|), and support influence on the card against the CPU
    (1e-5); it prints each mode's seconds, acc/nll/ece, T and holdout NLL,
    and the k-means seconds (C=200, k=6, D=512);
14b. retrieval phase: ResNet-18 (random weights from seed 0) over
    ``synthetic_cub`` with the training images in three environments
    (``default_rng(0).integers(0, 3, 5994)``), ``train_type="irm"``,
    ``n_neighbors=20`` and ``fused_min_support=512`` (the environments'
    balanced banks hold 600, 600 and 800 rows), precomputed; then for 3
    batches of 64 validation images: ``predict`` in ensemble (K1 three
    times a batch over the stacked banks, padding masked), knn and hnsw (K1
    once a batch over the 1,280-row union), launches counted around each
    call alone; on the same features the ensemble held to the plain
    per-environment loop, each union's head to the plain head (2e-4), the
    knn ids to a CPU stable sort of the card's own distances and, as a set,
    to an f64 CPU search up to the f32 distances' rounding bound, hnsw's
    recall@20 against exact (at least 0.8; with ``ef_search`` the bank's
    rows every row returned within the rounding bound of the exact k-th).
    On ``make_mesh(1, 4, devices=[cuda:0] * 4)`` a second net with the same
    featurizer serves ensemble through the sharded environments (K1
    ``partials=True`` 4 x 3 times a batch), held to the unsharded
    ensemble, and ``sharded_knn_predict_fn`` over the raw bank is held to
    the single-device knn (2e-4; to the plain head over its own union
    where the shards' distances round a near tie the other way). It prints
    each mode's host seconds a batch, the HNSW build seconds and the knn
    search ms;
15. ViT training phase: ``--arch vit_s14`` with the same episode (``--lr
    1e-3``, 5 steps, 3 eval batches) through ``train.setup(...,
    featurizer_kwargs={"attn_impl": "fused", "mlp_impl": "fused"})`` and
    ``train.run_epochs``, LayerScale gammas of order 1. It checks that K8,
    the K9 backward, K1, dq and ds launched 12, 12, 1, 1 and 1 times per
    step and K2 in the full-mode eval, that every loss is finite and every
    block's qkv, proj, fc1 and fc2 weights moved, and holds K8 and the K9
    backward to their plain versions on one block's tensors of the first
    step. It prints the step time split by CUDA events, each featurizer
    kernel's time at the step's own shapes against the step (K8's beside
    its bound at that shape), and the peak
    device memory; compares every parameter gradient of the fused featurizer with
    the plain (``xla``) one on a small episode (``--n_way 4 --n_shot 1``);
    then trains 3 steps with ``--bf16``, steps 2-3 timed by CUDA events, the
    K9 backward held to its plain version on one block's tensors of the
    first bf16 step, K9 and the K9 backward timed at its shapes;
16. lab kernel phase: K13/L4 ``stream`` and L1 ``stream_reduce``
    (``csrc/lab_stream.cu``) at bench.py's 12,288 and 196,608 rows of
    D=512 against their plain versions (the reduce at block_s 1,024, 2,048
    and 4,096, both modes), timed with the L2 flushed (GB/s and the share of
    3.35 TB/s; the 12,288-row bank also unflushed, L2-resident),
    failing if the flushed 403 MB read runs above 1.05 x 3.35 TB/s or the
    touch_only reduce takes under 0.9 of the full one (either means bytes
    were skipped); L1 ``fused_variant`` (``csrc/lab_nw.cu``, on the
    forward's tensor-core pass 1) at the CUB shape, the f32, f32s2, x3,
    split and bf16 variants, against its plain version and the naive op,
    timed at the lab's block_s and at K1's split count beside K1 f32 and
    bf16; L3 ``manual_fused`` (K2's route of the same pass, one block_s
    tile a split) at B=64 and B=8, f32 and bf16 banks, block_s 1,024 at
    every ring depth of ``MANUAL_STAGES``, 2,048 and K2's own split count
    at 3 stages, against its plain version and timed in turns with K2 on
    the same bank, each case with its read rate per block; L2
    ``fused_blocks`` (``csrc/lab_blocks.cu``, implicit GEMMs on bf16
    ``mma.sync``) at (64, 56, 56, 64) bf16, two blocks, at its
    planned tile and at tiles 8, 12 and 16, against its plain version and
    the port's ``BasicBlock``s, timed beside cuDNN's bf16 layer1;
17. lab phase: ``python -m nwhead_tpu_torch.labs.<lab>`` for ``kernel_lab
    --quick``, ``manual_pipe_lab``, ``prepared_lab``, ``roofline_lab`` and
    ``block_lab`` (their ``main``, in this process), each exiting 0, every
    lab kernel and variant launched;
17a. zoo kernel phase: K2 (f32, bf16) and K4 (int8) at the zoo's serving
    banks (B=64, S=5,800, C=200 at ResNet-50's D=2,048, DenseNet-121's
    1,024 and DenseNet-161's 2,208, 34.5 bf16 slices of 128 bytes), K1, dq
    and ds (f32, bf16) at the training episodes (B=8 over 400, 800 and
    1,200 rows at D=2,048, 1,024 and 2,208) and at B=64 over 1,200 rows at
    D=2,048 (dq's 16-query tile), all five kernels, masked rows holding
    NaN, against their plain versions, each shape's plan printed; K2 and
    K4 timed at ResNet-50's and DenseNet-121's banks, K1, dq and ds at
    training runs 1 and 2's episodes;
17b. zoo serving phase: ``python -m nwhead_tpu_torch.serve --dataset
    synthetic_cub --batch_size 64 --latency_bench`` through the serve
    module's functions with ``--arch resnet50 --pretrained_path`` (a
    torchvision-named state dict the phase writes from the port's own
    ResNet-50, with an ``fc`` the loader ignores) and an f32 and a bf16
    head, ``--arch resnet50 --bf16`` and ``--arch densenet121
    --head_precision int8``, every backbone's BatchNorm statistics
    calibrated on 64 training images first: the served weights equal the
    file's, one K2 or K4 launch a request, the served log-probs against the
    plain head; p50, p95, queries/s, the bank's seconds, peak memory;
17c. zoo training phase: ``train.setup`` and ``NWTrainer``, 3 steps each
    on ``synthetic_cub`` at 224 px, B=8: ResNet-50 f32 at ``--n_shot 2``
    (400 rows, the head's ``fused_min_support`` 256), ResNet-50 ``--bf16
    --head_precision bf16`` at ``--n_shot 4`` (800 rows, 512) and
    DenseNet-121 with ``memory_efficient=True`` at ``--n_shot 6`` (1,200
    rows): K1, dq and ds once a step, the first step's head against the
    plain versions, finite losses, moved weights, the step time (CUDA
    events from hooks, steps 2-3) and peak memory;
17d. grouped int8 conv routes (after the zoo kernel phase): ResNeXt-50
    32x4d's grouped 3x3 convs at layer1 and layer4, B=64, on the
    block-diagonal GEMM (``ops/int8_conv.py``'s route) and on one padded
    GEMM a group, both bit-equal to the plain version, timed beside
    cuDNN's bf16 grouped conv;
17e. int8 CNN serving phase: ``--featurizer_precision int8`` through the
    serve module at B=64, ResNet-50 from a written file (its statistics
    by three train-mode passes) with f32 and int8 heads, ResNeXt-50,
    DenseNet-121 with an int8 head, ResNet-18 with an int4 head: one head
    launch and one ``int8_conv2d_cuda`` launch a quantized conv per
    request, the served log-probs against the plain head, the features
    bit-equal to the route's plain version on the card and against the
    f32 model at JAX's gates; p50, p95, queries/s, calibration and bank
    seconds, peak memory, a featurizer call split by CUDA events, beside
    the zoo phase's ResNet-50 f32 and ``--bf16`` p50s; the zoo phase's file
    quantized for an ungated agreement line;
17f. data and FC phase: CIFAR-100-shaped ``.npy`` files (10,000 /
    2,000 images of 32 x 32 x 3 uint8, 100 classes, cut from 50,000 /
    10,000) written to the work directory; ``python -m
    nwhead_tpu_torch.train --train_method fchead --dataset cifar100 --arch
    resnet18`` (CIFAR_ResNet18, D=512, C=100, B=128, the CIFAR transforms on
    the host) through ``train.setup`` / ``run_epochs``: an eval and 10 steps,
    the first step's log-probs held to the same weights on the CPU (1e-3),
    then ``--resume`` for a second epoch, step ms and peak memory printed;
    ``--train_method nwhead --n_shot 11`` on the same files (1,100-row
    episodes: K1, dq and ds once a step, K2 in the full-mode eval, the first
    step's head held to the plain versions); the eval CLI ``--modes full
    --bank_cache DIR`` on that run's checkpoint twice (the first saves, the
    second restores: equal acc, NLL and ECE, K2 launched, restore seconds
    beside ``precompute``'s, the restored bank's K2 against the plain head);
    the serve CLI ``--latency_bench --bank_cache`` twice (its own tagged
    cache, as the eval CLI's carries no tag: one K2 launch a request on the
    restored bank, p50, served against the plain head; the restored server
    is kept for 17g); and
    ``device_normalize_fn`` on a 64 x 224 x 224 x 3 uint8 batch against
    numpy's ``normalize`` (1e-6). The card's machine has Pillow but not
    libjpeg's headers, so the JPEG decoders are held on the CPU only
    (``tests/test_torch_data.py``);
17g. serving-surface phase (last): the serve module's actions at
    ResNet-18 / ``synthetic_cub`` (D=512, S=5,800, C=200), B=64, f32 head,
    on the eval CLI phase's checkpoint (``--ckpt``: the tag carries the
    path; served log-probs against the plain head): ``--queries`` on 70
    written JPEGs (480 x 640 mosaics, ``--decoder pil``, a ragged second
    chunk) with ``--topk 5 --temperature 1.5``, each top-5 equal to the
    argsort of the serving callable on the same decoded chunk and K2 once
    a chunk, then ``--explain 3`` on 8 of them (3 neighbours a query,
    weights descending; the explainer's log-probs against the plain head);
    ``--latency_bench`` (20 requests, one client) and ``--microbatch_bench
    --concurrency 16 --bench_batches 1`` (every request's row against a
    direct B=64 call holding that image, K2 once a dispatched batch; qps
    beside the single client's, request p50/p95, mean occupancy); the HTTP
    daemon (``build_http_server``, port 0, on a thread): ``/healthz``, one
    ``/predict`` and a burst of 32 one-image predicts from 16 threads, 2
    rounds of ``/add_support`` of 8 images and ``/remove_support`` of those
    rows while 4 threads keep predicting (every response a 200 with finite
    probabilities), ``/stats``, K2 once a dispatched batch; one
    ``images_b64`` ``/predict`` of 8 PIL-encoded JPEGs on the data phase's
    restored CIFAR-100 server; ``--jpeg_bench --decoder pil --workers 8
    --bench_batches 4`` (stage rates, ``bound_by``, the JPEG source: no
    sklearn there, so mosaics) and the ``pil`` leg of
    ``labs/pipeline_bench`` at 8 workers on 64 JPEGs;
18. the AOT artifact phase (``utils/aot.py``, the serving kernels as
    ``torch.library`` custom ops): ResNet-18 at B=64, 224 px, uint8 pixels
    with the normalization folded in, over the ``synthetic_cub`` bank,
    exported six ways (the f32 head, K2; the int8 head, K4; ``--serve_mode
    ivf`` at probe 2, K6; ViT-S/14 ``bf16_fused``, K10/K11; the int8 ViT
    stack, K10/K11 int8 and K4; a (1, 4) mesh on the one card, K2
    ``partials`` x 4), each live callable's launches a request counted;
    all six loaded in one fresh process that imports only
    ``nwhead_tpu_torch.utils.aot`` (no JAX, no model-building module), each
    answering the saved batch 3 times within 1e-6 of its live callable,
    the same argmax, its launches 3 x one request's; the serve CLI's
    ``--export_artifact`` then ``--serve_artifact --latency_bench
    --queries`` (70 JPEGs, PIL) in a fresh process, its p50 beside the live
    ``--latency_bench`` p50 and the
    live callable's on the same uint8 batch, each artifact's size on disk
    and load seconds (measurements, not gates);
18p. profiling phase, in the artifact loader's fresh process (late in
    this one ``torch.profiler`` has recorded no device time): the f32
    artifact (ResNet-18, K2) answers 10 B=64 requests inside
    ``utils.profiling.trace``, each in an ``annotate`` span and a
    ``StepTimer(block=True)`` phase; the trace file must hold every span
    and K2's ``nw_prepared_tc_kernel`` events; the timer's p50 is printed
    beside CUDA events around the same request;
18q. the big-bank lab phase (after the lab phase): ``labs/bigbank_lab.py``'s
    ``run`` in this process four times at its full width (D=512, C=1,000):
    the defaults (the four prepared heads against the streaming oracle at
    131,072 rows, the million-row bank at every precision timed at B=64,
    int8 and int4 at B=256, beside K13 at 403 MB) with ``--hnsw --hnsw_s
    8192``, ``--giant 8000000`` (int8, chunk by chunk), ``--giant 8000000
    --giant_ivf`` (the routed gate, K6) and ``--stream_host 1048576`` (16
    host chunks through K1 ``partials``); every head the lab times held to
    its plain version at both batches (K2, K4, K5 over the million-row and
    8M-row banks, the plain version over 1M-row chunks; K6 over its routed
    tiles); every gate the lab returns ok, each leg's kernels launched
    (K2's f32 and bf16 banks booked on the f32 entry); ms/batch, q/s,
    ``frac_vs_stream`` and
    ``frac_vs_peak``, the HNSW build seconds, q/s and recall@10, the
    resident GB and the host link's MB/s printed;
18r. the endurance phase (last): gate 2, ``labs/endurance_run.py``'s
    ``run`` on CIFAR-100-shaped files (``write_endurance_cifar100``: 1,100
    / 400 images whose accuracy moves), CIFAR_ResNet18, 1,100-row
    episodes, 6 epochs of 24 steps, a checkpoint every 2, killed when epoch
    4 starts and resumed; each phase of the training CLI a process that
    prints its K1, dq, ds and K2 launches when it ends; all five checks OK,
    and the state phase B restored bit-equal to its checkpoint (digests);
19. prints the nvidia-smi line, a JSON line of per-kernel results (the
    zoo phases' launches added to K1-K4, their times as ``d2048_*`` and
    ``d1024_*``; the int8 CNN phase's launches and errors added to K2, K4
    and K5; the bank-edit phases' to K2, K4, K5, K6 and K2 ``partials``;
    the data phase's to K1, dq, ds and K2 f32, the serving-surface
    phase's to K2 f32, the artifact phase's fresh process's to K2, K4, K6,
    K10/K11, K10/K11 int8 and K2 ``partials``; the mesh training
    phase's to K1, dq, ds and K2 ``partials`` f32, the shard's times as
    ``shard_ms``, ``shard_plain_ms`` and ``shard_bound_ms``; the big-bank
    phase's to K1 ``partials``, K2 f32, K4, K5, K6 int8 and K13, its figures
    as ``bigbank``; the endurance phase's to K1, dq, ds and K2 f32), and as
    the last line
    ``{"ok": true, "device": {...}}``.

Kernel times are device times: CUDA events around each call, queued behind
a spin kernel so that the host's overhead does not count, L2 flushed before
each call by zeroing a 256 MB buffer, median of 30. The lab kernel phase
times by the labs' harness (``nwhead_tpu_torch.labs.timing``): cases in
turns, median of 15, the L2 flushed by a read, so that no dirty line is
written back during the call; it also reads K1 and K2 at the CUB shape by
both methods, which shows how far the zero flush moves the K1-K12 times.

Bounds in the JSON line: the larger of the bytes the call must move (each
input read once, each output written once) over 3.35 TB/s and its products
(2 operations per multiply-add: scores, attention, the MLP's and
projections' matrix products) over 165 TFLOP/s for f32 inputs (three TF32
passes at the published 495 TFLOP/s: the least time in which this card
gives a product within f32's limits, as the 3xTF32 kernels K7-K9 do), 989
TFLOP/s for bf16 or 1,979 TOP/s for int8, the H100 SXM's published peaks;
a kernel with int8 and bf16 products (K10 int8) adds the two times. The
exponentials, GELUs and LayerNorms are not counted. The backward kernels
count the products their function needs (five for K8 and for the K9
backward), not the recomputations a kernel adds.
"""

from __future__ import annotations

import contextlib
import copy
import io
import itertools
import json
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# Tolerances of kernel vs plain PyTorch on the card: f32 as the JAX kernel is
# held to its naive op (tests/test_pallas_nw.py); bf16 inputs differ from the
# plain version only in the f32 summation order of bf16 products. Gradients
# are held relative to their largest value: near-coincident pairs make
# t = dscore / dist large where the plain and kernel distances differ by
# rounding, and the t s - q sum(t) terms cancel only up to rounding. Where a
# query is also a support row, the reference is the plain version in f64
# (see check_raw_kernels).
TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.0, atol=2e-3)}
GRAD_REL = {"f32": 1e-3, "bf16": 2e-2}
KERNEL_CASES = (  # name, B, S, D, C
    ("cub_b64", 64, 5994, 512, 200),
    ("cub_b256", 256, 5994, 512, 200),
    ("ragged_b37", 37, 5994, 512, 200),
    ("c10_b64", 64, 5994, 512, 10),
    ("eval_b8", 8, 5800, 512, 200),  # the training run's full-mode eval batch
    ("vit_b64", 64, 5800, 384, 200),  # the ViT-S/14 serving bank
    ("c1000_b64", 64, 65_536, 512, 1000),  # the million-row bank's class count, timed
)
RAW_CASES = (  # name, B, S, D, C, queries copied into the support; the first
    ("episode_b8", 8, 1200, 512, 200, 0),  # is the training episode's shape
    ("shard_b4", 4, 1200, 512, 200, 0),  # a data shard's of it over a data axis of 2, timed
    ("head_raw_b64", 64, 5994, 512, 200, 0),
    ("ragged_b37", 37, 1001, 512, 200, 0),
    ("c10_b8", 8, 1200, 512, 10, 0),
    ("dup_b8", 8, 1200, 512, 200, 6),
    ("episode_d384", 8, 1200, 384, 200, 0),  # the ViT-S/14 training episode
    ("dup_b64", 64, 5994, 512, 200, 6),  # 32-query tiles: no split-K halves
)
PREPARED_SOURCE = "nwhead_tpu_torch/csrc/nw_prepared.cu"
FUSED_SOURCE = "nwhead_tpu_torch/csrc/nw_fused.cu"
REPLACES = {
    "nw_prepared": "nwhead_tpu/ops/pallas_nw.py:820",
    "nw_fwd": "nwhead_tpu/ops/pallas_nw.py:579",
    "nw_bwd_dq": "nwhead_tpu/ops/pallas_nw.py:1749",
    "nw_bwd_ds": "nwhead_tpu/ops/pallas_nw.py:1788",
}
# The raw path's kernels: their source and device functions (pass 1, merge).
RAW_KERNELS = {
    "nw_fwd": (PREPARED_SOURCE, "nw_prepared_tc_kernel (raw rows), nw_merge_kernel"),
    "nw_bwd_dq": (FUSED_SOURCE, "nw_raw_dq_tc_kernel, nw_bwd_dq_merge_kernel"),
    "nw_bwd_ds": (FUSED_SOURCE, "nw_raw_ds_tc_kernel"),
}
TRAIN_ARGV = [
    "--dataset", "synthetic_cub", "--arch", "resnet18", "--batch_size", "8", "--n_shot", "6",
    "--lr", "1e-2", "--num_epochs", "1", "--num_steps_per_epoch", "5",
    "--num_val_steps_per_epoch", "10",
]
TRAIN_STEPS = 5
# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W); f32 as three
# TF32 passes (495 TFLOP/s / 3), the 3xTF32 route to f32-exact products.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 495e12 / 3, "bf16": 989e12, "int8": 1979e12}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def within(got, want, rtol, atol) -> bool:
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in f32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def bound(n_bytes: float, flops: float, prec: str, **more_ops: float) -> dict:
    """The least time of a call on this card's published peaks, and which
    of bytes or operations sets it; ``more_ops`` adds operations at other
    precisions' peaks (``bf16=...``)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[prec] + sum(n / PEAK_FLOPS[p] for p, n in more_ops.items())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# Cycles of the spin kernel queued before each timed call, about 2 ms: the
# host queues the call (its Python wrapper, the plain version's many small
# kernels) while the card spins, so the events time the card's work alone.
SPIN_CYCLES = 4_000_000


def time_ms(fn, flush, n=30) -> float:
    """Median device time of one call, with L2 flushed before each (the
    training and serving loops run the featurizer between head calls), by
    CUDA events around the call, queued behind a spin kernel so that host
    overhead does not count."""
    import torch

    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for i in range(n):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def head_split(label: str, fn, flush) -> dict:
    """One prepared-bank call's split count and partials bytes (the lab's
    ``SplitSpy``) and its device functions' mean ms (``device_split``:
    torch.profiler, the L2 zeroed before each call), printed on one line."""
    from nwhead_tpu_torch.labs.attn_block_lab import device_split, split_line
    from nwhead_tpu_torch.labs.prepared_head_lab import SplitSpy
    from nwhead_tpu_torch.ops import fused_nw as F

    spy = SplitSpy(F)
    try:
        fn()
    finally:
        spy.close()
    n_splits, n_bytes = spy.last()
    split = {}
    for _ in range(3):  # the profiler sometimes records no device time; ask again
        split = split or device_split(fn, flush)
    print(f"{split_line(label, split)}; {n_splits} splits, partials {n_bytes / 1e6:.2f} MB")
    return {"splits": n_splits, "partials_bytes": n_bytes, "split": split}


def same_bits(label: str, fn) -> None:
    """Two calls on the same inputs give the same bits (no float atomics)."""
    import torch

    a, b = fn(), fn()
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    if not all(torch.equal(x, y) for x, y in pairs):
        raise AssertionError(f"{label}: two calls on the same inputs differ")


def kernel_phase(flush) -> dict:
    """K2 vs plain at each case, each called twice for the same bits;
    returns per-precision max |err|, the CUB B=64 euclidean times and that
    call's bound, and the C=1,000 case's (``c1000``), each with its split."""
    import torch

    from nwhead_tpu_torch.ops.fused_nw import (
        _nw_prepared_plain, _resolve_mode, nw_prepared_cuda, prepare_support,
    )
    from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES

    dev = torch.device("cuda")
    res = {p: {"max_abs_err": 0.0, "ms": None, "plain_ms": None, "c1000": {}} for p in TOL}
    for ci, (case, B, S, D, C) in enumerate(KERNEL_CASES):
        rng = np.random.default_rng(ci)
        q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
        s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
        sy = rng.integers(0, C, size=S)
        mask = torch.from_numpy((rng.random(S) > 0.03).astype(np.float32))
        for kernel in KERNEL_NAMES:
            params = {"logit_scale": torch.tensor(1.3, device=dev)} if kernel == "clip" else {}
            for prec in TOL:
                prep = prepare_support(s, sy, C, kernel=kernel, support_mask=mask,
                                       precision=prec)
                mode, scale, qn, _ = _resolve_mode(kernel, params, q)
                qc = qn.to(prep.s.dtype)
                got = nw_prepared_cuda(qc, prep, scale, mode, C)
                want = _nw_prepared_plain(qc, prep, scale, mode, C)
                same_bits(f"K2 {case} {kernel} {prec}",
                          lambda: nw_prepared_cuda(qc, prep, scale, mode, C))
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                ok = bool(torch.isfinite(got).all()) and within(got, want, **TOL[prec])
                print(f"kernel {case} {kernel} {prec}: max|err| {err:.3e} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel disagrees with plain: {case} {kernel} {prec}")
                res[prec]["max_abs_err"] = max(res[prec]["max_abs_err"], err)
                if case in ("cub_b64", "c1000_b64") and kernel == "euclidean":
                    r = res[prec] if case == "cub_b64" else res[prec]["c1000"]
                    r["ms"] = time_ms(lambda: nw_prepared_cuda(qc, prep, scale, mode, C), flush)
                    r["plain_ms"] = time_ms(
                        lambda: _nw_prepared_plain(qc, prep, scale, mode, C), flush)
                    item = prep.s.element_size()
                    r.update(bound(
                        (B * D + S * D) * item + 4 * (2 * S + 1 + B * C), 2 * B * S * D, prec))
                    print(f"time {case} {kernel} {prec}: kernel {r['ms']:.4f} ms, "
                          f"plain {r['plain_ms']:.4f} ms, "
                          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
                    r.update(head_split(f"K2 {case} {prec}",
                                        lambda: nw_prepared_cuda(qc, prep, scale, mode, C),
                                        flush))
    return res


# The prepared head's kernel wrapper for each bank precision.
HEAD_WRAPPERS = {"f32": "nw_prepared_cuda", "bf16": "nw_prepared_cuda",
                 "int8": "nw_prepared_int8_cuda", "int4": "nw_prepared_int4_cuda"}
# K4/K5 vs plain: the integer products are exact on both sides, so the f32
# bound holds.
HEAD_TOL = {**TOL, "int8": TOL["f32"], "int4": TOL["f32"]}


def plain_head(net, feats):
    """The plain prepared head on ``feats`` against the net's bank: the query
    normalized and cast or quantized as the serving path does it."""
    from nwhead_tpu_torch.ops import fused_nw as F

    prep = net._prepared_full
    q, scale, mode, qscale = F._prepared_query(feats, prep, net.kernel_type,
                                               net.model.head.kernel_params())
    return F._nw_prepared_plain(q, prep, scale, mode, net.n_classes, qscale)


def slice_phase(datasets, bank_cache: str) -> dict:
    """The serving CLI's path at the CUB recipe's scale with an f32, bf16,
    int8 and int4 head, the featurized bank saved to ``bank_cache`` by the
    first and restored by the others (``--bank_cache``). Returns the bank
    kernel's launch count and the latency report per head."""
    import torch

    from nwhead_tpu_torch import serve

    args = serve.parse_args([
        "--dataset", "synthetic_cub", "--arch", "resnet18", "--batch_size", "64",
        "--latency_bench", "--bank_cache", bank_cache,
    ])
    train_ds, val_ds = datasets
    out = {}
    for prec in HEAD_TOL:
        args.head_precision = prec
        _counts(reset=True)
        net = serve.build_server(args, train_ds)
        report = serve.latency_bench(net, val_ds, args)
        torch.cuda.synchronize()
        launches = _counts()[HEAD_WRAPPERS[prec]]
        if launches == 0:
            raise AssertionError(f"{prec}: the serving path never launched the kernel")

        x = val_ds.gather(np.arange(args.batch_size))
        served = net.make_serving_fn()(x)
        with torch.inference_mode():
            prep = net._prepared_full
            plain = plain_head(net, net.model.featurize(torch.from_numpy(x).to(net.device)))
        torch.cuda.synchronize()
        err = float((served - plain).abs().max())
        mass = float((served.exp().sum(1) - 1).abs().max())
        S = prep.s.shape[0]
        print(f"slice {prec}: bank S={S} D={prep.s.shape[1]} C={net.n_classes}; "
              f"launches {launches}; served vs plain max|err| {err:.3e}; "
              f"|sum p - 1| {mass:.2e}; p50 {report['p50_ms']:.3f} ms, "
              f"p95 {report['p95_ms']:.3f} ms, {report['queries_per_sec']:.1f} q/s")
        if tuple(served.shape) != (args.batch_size, net.n_classes):
            raise AssertionError(f"served shape {tuple(served.shape)}")
        if not bool(torch.isfinite(served).all()):
            raise AssertionError("served log-probs are not finite")
        if not within(served, plain, **HEAD_TOL[prec]) or mass > 1e-3:
            raise AssertionError(f"{prec}: served log-probs disagree with the plain head")
        out[prec] = {"launches": launches, "report": report, "served_err": err}
        del net
        torch.cuda.empty_cache()
    return out


def check_raw_kernels(qn, sn, labels, scale, mode, C, g, prec, where: str,
                      check_dscale: bool = False, dup_queries=None) -> dict:
    """K1, dq and ds on one input against the plain versions (and, with
    ``check_dscale``, clip's scale gradient ``sum(q dq) / scale``); raises
    on a disagreement. ``dup_queries`` (a tensor of indices, maybe empty)
    says that queries may coincide with support rows, those indices exactly:
    then the plain versions run in f64, because in f32 the distance of such
    a pair is the rounding residue of |q|^2 - 2 q.s + |s|^2, up to
    sqrt(eps |q|^2), while the kernels sum all three in one order and get
    exactly 0; in l2 mode those queries' maximum score ``m`` must be
    exactly 0. Returns each kernel's max |err|."""
    import torch

    from nwhead_tpu_torch.ops import fused_nw as F

    exact = dup_queries is not None
    rq, rs = (qn.double(), sn.double()) if exact else (qn, sn)
    out, m, l = F.nw_fwd_cuda(qn, sn, labels, scale, mode, C)
    want = [x.float() for x in F._nw_fwd_plain(rq, rs, labels, scale, mode, C)]
    u = (g * torch.exp(-want[0])).contiguous()
    r = torch.sum(u * (torch.exp(want[0]) - 1e-12), dim=-1, keepdim=True)
    dq = F.nw_bwd_dq_cuda(qn, sn, labels, u, r, want[1], want[2], scale, mode, C)
    same_bits(f"K1 {where} {prec}", lambda: F.nw_fwd_cuda(qn, sn, labels, scale, mode, C))
    same_bits(f"K3 dq {where} {prec}", lambda: F.nw_bwd_dq_cuda(
        qn, sn, labels, u, r, want[1], want[2], scale, mode, C))
    ds = F.nw_bwd_ds_cuda(qn, sn, labels, u, r, want[1], want[2], scale, mode, C)
    same_bits(f"K3 ds {where} {prec}", lambda: F.nw_bwd_ds_cuda(
        qn, sn, labels, u, r, want[1], want[2], scale, mode, C))
    dq_p, ds_p = F._nw_bwd_plain(rq, rs, labels, u, r, want[1], want[2], scale, mode, C)
    torch.cuda.synchronize()
    l_tol = dict(rtol=2e-3 if prec == "bf16" else 2e-4, atol=1e-6)
    fwd_ok = (bool(torch.isfinite(out).all()) and within(out, want[0], **TOL[prec])
              and within(m, want[1], **TOL[prec]) and within(l, want[2], **l_tol))
    dup = ""
    if exact:
        dup = f", {dup_queries.numel()} of {qn.shape[0]} queries coincide with support rows"
        if mode == "l2" and dup_queries.numel():
            m_dup = m[dup_queries]
            fwd_ok = fwd_ok and bool((m_dup == 0).all())
            dup += f" (their kernel m max|.| {float(m_dup.abs().max()):.1e})"
    rel = {"dq": rel_err(dq, dq_p), "ds": rel_err(ds, ds_p)}
    grads_ok = (bool(torch.isfinite(dq).all() and torch.isfinite(ds).all())
                and bool((ds[labels < 0] == 0).all())
                and max(rel.values()) <= GRAD_REL[prec])
    dscale = ""
    if check_dscale:
        ds_k = torch.sum(qn.float() * dq.float()) / scale
        ds_pl = torch.sum(qn.float() * dq_p.float()) / scale
        rel["dscale"] = rel_err(ds_k, ds_pl)
        grads_ok = grads_ok and rel["dscale"] <= GRAD_REL[prec]
        dscale = f", dscale rel {rel['dscale']:.2e}"
    errs = {"nw_fwd": float((out - want[0]).abs().max()),
            "nw_bwd_dq": float((dq.float() - dq_p.float()).abs().max()),
            "nw_bwd_ds": float((ds.float() - ds_p.float()).abs().max())}
    ok = fwd_ok and grads_ok
    print(f"raw {where} {prec}{' (f64 reference)' if exact else ''}: out max|err| "
          f"{errs['nw_fwd']:.3e}, m {float((m - want[1]).abs().max()):.3e}, dq rel "
          f"{rel['dq']:.2e}, ds rel {rel['ds']:.2e}{dscale}{dup} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K1/K3 disagree with the plain versions: {where} {prec}")
    return errs


def raw_kernel_phase(flush) -> dict:
    """K1 and K3 vs plain at each raw case, all five kernels, f32 and bf16,
    masked rows holding NaN; times them at the training episode's shape
    (and prints the B=64 times). Returns, per kernel and precision, max
    |err|, kernel and plain ms and the bound."""
    import torch

    from nwhead_tpu_torch.ops import fused_nw as F
    from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES

    dev = torch.device("cuda")
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    res = {k: {p: {"max_abs_err": 0.0} for p in TOL} for k in ("nw_fwd", "nw_bwd_dq", "nw_bwd_ds")}
    for ci, (case, B, S, D, C, n_dup) in enumerate(RAW_CASES):
        rng = np.random.default_rng(100 + ci)
        q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
        s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
        valid = rng.random(S) > 0.03
        valid[0] = True
        # Rows that will hold copies of the first n_dup queries (unmasked).
        dup_rows = torch.from_numpy(rng.choice(np.flatnonzero(valid), n_dup, replace=False)).to(dev)
        s[torch.from_numpy(~valid).to(dev)] = float("nan")
        labels = torch.from_numpy(
            np.where(valid, rng.integers(0, C, size=S), -1).astype(np.int32)).to(dev)
        g = torch.from_numpy(rng.standard_normal((B, C), np.float32)).to(dev)
        for kernel in KERNEL_NAMES:
            params = {"logit_scale": torch.tensor(1.3, device=dev)} if kernel == "clip" else {}
            for prec in TOL:
                mode, scale, qn, sn = F._resolve_mode(kernel, params, q.to(dtypes[prec]),
                                                      s.to(dtypes[prec]))
                qn, sn = qn.to(sn.dtype).contiguous(), sn.contiguous()
                dups = None
                if n_dup:  # copied after normalizing, so the kernel's inputs coincide
                    sn = sn.clone()
                    sn[dup_rows] = qn[:n_dup]
                    dups = torch.arange(n_dup, device=dev)
                errs = check_raw_kernels(qn, sn, labels, scale, mode, C, g, prec,
                                         f"{case} {kernel}", check_dscale=kernel == "clip",
                                         dup_queries=dups)
                for k, e in errs.items():
                    res[k][prec]["max_abs_err"] = max(res[k][prec]["max_abs_err"], e)
                if kernel == "euclidean" and ci < 3:
                    timed = _time_raw(flush, qn, sn, labels, scale, mode, C, g, prec)
                    print(f"time raw {case} {prec}: " + ", ".join(
                        f"{k} kernel {v['ms']:.4f} ms / plain {v['plain_ms']:.4f} ms / "
                        f"bound {v['bound_ms']:.4f} ms ({v['bound_by']})"
                        for k, v in timed.items()))
                    for k, v in timed.items():
                        if ci == 0:
                            res[k][prec].update(v)
                        elif case == "shard_b4":
                            res[k][prec]["shard"] = v
                    if case != "shard_b4":
                        raw_split(f"{case} {prec}", qn, sn, labels, scale, mode, C, g, flush)
    return res


def raw_split(label: str, qn, sn, labels, scale, mode, C, g, flush) -> None:
    """K1's and K3's device functions (K1 and dq: pass 1, merge; ds: its
    one kernel) and their mean ms by ``torch.profiler``
    (``attn_block_lab.device_split``), one line each."""
    import torch

    from nwhead_tpu_torch.labs.attn_block_lab import device_split, split_line
    from nwhead_tpu_torch.ops import fused_nw as F

    out, m, l = F._nw_fwd_plain(qn, sn, labels, scale, mode, C)
    u = (g * torch.exp(-out)).contiguous()
    r = torch.sum(u * (torch.exp(out) - 1e-12), dim=-1, keepdim=True)
    for name, fn in (("K1", lambda: F.nw_fwd_cuda(qn, sn, labels, scale, mode, C)),
                     ("K3 dq", lambda: F.nw_bwd_dq_cuda(qn, sn, labels, u, r, m, l, scale,
                                                        mode, C)),
                     ("K3 ds", lambda: F.nw_bwd_ds_cuda(qn, sn, labels, u, r, m, l, scale,
                                                        mode, C))):
        split = {}
        for _ in range(3):  # the profiler sometimes records no device time; ask again
            split = split or device_split(fn, flush)
        print(split_line(f"{name} raw {label}", split))


def _time_raw(flush, qn, sn, labels, scale, mode, C, g, prec) -> dict:
    """K1, dq and ds kernel times and their plain versions', with each
    call's bound."""
    import torch

    from nwhead_tpu_torch.ops import fused_nw as F

    out, m, l = F._nw_fwd_plain(qn, sn, labels, scale, mode, C)
    u = (g * torch.exp(-out)).contiguous()
    r = torch.sum(u * (torch.exp(out) - 1e-12), dim=-1, keepdim=True)
    args = (qn, sn, labels, u, r, m, l, scale, mode, C)
    (B, D), S, item = qn.shape, sn.shape[0], sn.element_size()
    inputs = (B + S) * D * item + 4 * (S + 1)  # q, s, labels, scale
    per_query = 4 * B * (C + 3)  # u, r, m, l
    return {
        "nw_fwd": {"ms": time_ms(lambda: F.nw_fwd_cuda(qn, sn, labels, scale, mode, C), flush),
                   "plain_ms": time_ms(lambda: F._nw_fwd_plain(qn, sn, labels, scale, mode, C),
                                       flush),
                   **bound(inputs + 4 * B * (C + 2), 2 * B * S * D + 2 * S * D, prec)},
        "nw_bwd_dq": {"ms": time_ms(lambda: F.nw_bwd_dq_cuda(*args), flush),
                      "plain_ms": time_ms(lambda: F._nw_bwd_dq_plain(*args), flush),
                      **bound(inputs + per_query + B * D * item, 4 * B * S * D + 2 * S * D, prec)},
        "nw_bwd_ds": {"ms": time_ms(lambda: F.nw_bwd_ds_cuda(*args), flush),
                      "plain_ms": time_ms(lambda: F._nw_bwd_ds_plain(*args), flush),
                      **bound(inputs + per_query + S * D * item, 4 * B * S * D + 2 * S * D, prec)},
    }


RAW_WRAPPERS = ("nw_fwd_cuda", "nw_bwd_dq_cuda", "nw_bwd_ds_cuda")
VIT_WRAPPERS = ("attention_qkv_cuda", "attention_block_bf16_cuda", "mlp_cuda",
                "mlp_block_bf16_cuda", "attention_qkv_bwd_cuda", "mlp_bwd_cuda",
                "attention_block_int8_cuda", "mlp_block_int8_cuda", "qkv_proj_int8_cuda")
SEL_WRAPPERS = ("nw_prepared_sel_cuda", "nw_prepared_sel_quant_cuda")
PARTIALS_WRAPPERS = ("nw_fwd_partials_cuda", "nw_prepared_partials_cuda",
                     "nw_prepared_partials_int8_cuda", "nw_prepared_partials_int4_cuda",
                     "nw_prepared_sel_partials_cuda", "nw_prepared_sel_partials_quant_cuda",
                     "fused_attention_cuda")
WRAPPERS = ("nw_prepared_cuda", "nw_prepared_int8_cuda", "nw_prepared_int4_cuda") + \
    RAW_WRAPPERS + VIT_WRAPPERS + SEL_WRAPPERS + PARTIALS_WRAPPERS


def _wrapper(name: str):
    from nwhead_tpu_torch.ops import fused_attn, fused_mlp, fused_nw

    for module in (fused_nw, fused_attn, fused_mlp):
        if hasattr(module, name):
            return getattr(module, name)
    raise KeyError(name)


def _counts(names=WRAPPERS, reset: bool = False) -> dict:
    """Every kernel wrapper's launch count (then set to 0 with ``reset``)."""
    out = {n: _wrapper(n).launches for n in names}
    if reset:
        for n in names:
            _wrapper(n).launches = 0
    return out


class StepTimer:
    """CUDA events recorded by hooks inside the training steps themselves:
    featurizer forward (its pre-hook to its hook), head forward, head
    backward (from the gradient of the log-probs to that of the features)
    and featurizer backward (to the gradient of the stem's first weight,
    the last one autograd computes). Passes without autograd (the evals)
    are not recorded; the optimizer update is outside every span."""

    def __init__(self, model):
        import torch

        self.torch, self.steps = torch, []
        # A ViT's first parameter is cls_token, whose gradient comes before
        # the patch embedding's; the stem is the first op either way.
        patch_embed = getattr(model.featurizer, "patch_embed", None)
        stem = next((patch_embed or model.featurizer).parameters())
        self.handles = [
            model.featurizer.register_forward_pre_hook(self._start),
            model.featurizer.register_forward_hook(self._tap("feat_fwd", "feat_bwd_start")),
            model.head.register_forward_pre_hook(self._mark("head_fwd_start")),
            model.head.register_forward_hook(self._tap("head_fwd", "head_bwd_start")),
            stem.register_hook(lambda grad: self._record("feat_bwd")),
        ]

    def _record(self, key):
        if self.steps and key not in self.steps[-1]:
            self.steps[-1][key] = self.torch.cuda.Event(enable_timing=True)
            self.steps[-1][key].record()

    def _start(self, module, inputs):
        if self.torch.is_grad_enabled():
            self.steps.append({})
            self._record("feat_fwd_start")

    def _mark(self, key):
        def hook(module, inputs):
            if self.torch.is_grad_enabled():
                self._record(key)
        return hook

    def _tap(self, key, grad_key):
        """Forward hook: marks the end of the forward and, on the output's
        gradient, the start of the next backward span."""
        def hook(module, inputs, output):
            if self.torch.is_grad_enabled():
                self._record(key)
                output.register_hook(lambda grad: self._record(grad_key))
        return hook

    def split(self) -> dict:
        """Medians over the steps after the first (cuDNN set-up), in ms."""
        self.torch.cuda.synchronize()
        for h in self.handles:
            h.remove()

        def ms(e, a, b):
            return e[a].elapsed_time(e[b])

        rows = [(ms(e, "feat_fwd_start", "feat_fwd") + ms(e, "feat_bwd_start", "feat_bwd"),
                 ms(e, "head_fwd_start", "head_fwd") + ms(e, "head_bwd_start", "feat_bwd_start"),
                 ms(e, "feat_fwd_start", "feat_bwd")) for e in self.steps[1:]]
        feat_ms, head_ms, step_ms = np.median(np.asarray(rows), axis=0)
        return {"featurizer_ms": float(feat_ms), "head_ms": float(head_ms),
                "step_ms": float(step_ms), "steps": len(rows)}


def first_step_head(net, captured: dict, where: str) -> dict:
    """The first training step's head (its query and support features and
    labels, ``captured`` by a forward hook on the head) through K1, dq and
    ds against their plain versions; raises unless the episode took the
    fused head. A query drawn into its own episode has the same features as
    its support row, so the reference is the plain version in f64."""
    import torch

    from nwhead_tpu_torch.ops import fused_nw as F

    S = captured["s"].shape[0]
    if S != net.support_train.support_size() or not net.model.head.takes_fused(
            captured["q"], captured["s"]):
        raise AssertionError(f"the episode ({S} rows) did not take the fused head")
    mode, scale, qn, sn = F._resolve_mode(net.kernel_type, net.model.head.kernel_params(),
                                          captured["q"], captured["s"])
    qn, sn = qn.contiguous(), sn.contiguous()
    dups = torch.nonzero((qn[:, None, :] == sn[None, :, :]).all(-1).any(1)).flatten()
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (qn.shape[0], net.n_classes), np.float32)).to(net.device)
    return check_raw_kernels(qn, sn, captured["sy"].to(torch.int32), scale.detach(), mode,
                             net.n_classes, g, "f32", where, dup_queries=dups)


def capture_head_inputs(net) -> tuple:
    """A forward hook on the head that keeps the first training step's
    query and support features and labels: ``(captured, handle)``."""
    import torch

    captured = {}

    def capture(module, inputs, output):
        if "q" not in captured and torch.is_grad_enabled() and inputs[1].dim() == 2:
            captured.update(q=inputs[0].detach().clone(), s=inputs[1].detach().clone(),
                            sy=inputs[2].detach().clone())

    return captured, net.model.head.register_forward_hook(capture)


def training_phase(datasets, workdir: str) -> dict:
    """The training CLI's path at the slice configuration; then a bf16 head
    and the canonical n_way 10 recipe. Returns launch counts, parity errors
    and times."""
    import torch

    from nwhead_tpu_torch import train
    from nwhead_tpu_torch.ops import fused_nw as F

    argv = TRAIN_ARGV + ["--models_dir", workdir, "--log_interval", "1000"]
    args, trainer, start = train.setup(argv, datasets=datasets)
    net = trainer.net
    captured, handle = capture_head_inputs(net)
    timer = StepTimer(net.model)
    before = {n: p.detach().clone() for n, p in net.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counts(reset=True)
    t0 = time.perf_counter()
    train.run_epochs(args, trainer, start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    handle.remove()
    split = timer.split()
    print(f"train f32: launches {launches}; {len(trainer.step_losses)} steps in "
          f"{trainer.train_seconds:.2f}s ({trainer.train_seconds / TRAIN_STEPS * 1e3:.1f} ms/step, "
          f"first step included); eval + train {wall:.2f}s; peak device memory "
          f"{peak / 2**30:.2f} GiB; losses {['%.4f' % v for v in trainer.step_losses]}")
    print(f"train step split (CUDA events from hooks in the run's steps, median of steps "
          f"2-{split['steps'] + 1}): featurizer fwd+bwd {split['featurizer_ms']:.2f} ms, head "
          f"fwd+bwd {split['head_ms']:.3f} ms, step {split['step_ms']:.2f} ms (optimizer "
          f"update not included)")
    for name in RAW_WRAPPERS:
        if launches[name] != TRAIN_STEPS:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{TRAIN_STEPS} training steps")
    if launches["nw_prepared_cuda"] == 0:
        raise AssertionError("the full-mode eval never launched K2")
    if len(trainer.step_losses) != TRAIN_STEPS or not np.isfinite(trainer.step_losses).all():
        raise AssertionError(f"losses {trainer.step_losses}")
    if split["steps"] != TRAIN_STEPS - 1:
        raise AssertionError(f"the step timer saw {split['steps'] + 1} steps")
    moved = sum(not torch.equal(p.detach(), before[n]) for n, p in net.model.named_parameters())
    if moved == 0:
        raise AssertionError("no parameter changed in training")
    print(f"first step: query {tuple(captured['q'].shape)}, support {tuple(captured['s'].shape)}; "
          f"{moved} of {len(before)} parameter tensors moved")
    errs = first_step_head(net, captured, "first-step")

    # K2 at the full-mode eval's batch against its plain version.
    x = trainer.val_dataset.gather(np.arange(trainer.batch_size))
    got = net.predict(x, "full")
    with torch.inference_mode():
        prep = net._prepared_full
        plain = plain_head(net, net.model.featurize(torch.as_tensor(x).to(net.device)))
    torch.cuda.synchronize()
    eval_err = float((got - plain).abs().max())
    print(f"full-mode eval batch: B={got.shape[0]}, bank S={prep.s.shape[0]}; K2 vs plain "
          f"max|err| {eval_err:.3e}")
    if (tuple(got.shape) != (trainer.batch_size, net.n_classes)
            or not bool(torch.isfinite(got).all()) or not within(got, plain, **TOL["f32"])):
        raise AssertionError("the full-mode eval's K2 disagrees with the plain version")
    out = {"launches": {"f32": launches}, "errs": errs, "eval_err": eval_err, "split": split,
           "peak_bytes": peak, "ms_per_step": trainer.train_seconds / TRAIN_STEPS,
           "losses": trainer.step_losses}
    del trainer, net, captured, timer
    torch.cuda.empty_cache()

    # bf16 head: the same path with the head's features in bf16.
    args, trainer, _ = train.setup(argv + ["--head_precision", "bf16"], datasets=datasets)
    _counts(reset=True)
    trainer.train_epoch(num_steps=3)
    torch.cuda.synchronize()
    out["launches"]["bf16"] = _counts()
    print(f"train bf16 head: launches {out['launches']['bf16']}; losses "
          f"{['%.4f' % v for v in trainer.step_losses]}")
    if any(out["launches"]["bf16"][n] != 3 for n in RAW_WRAPPERS):
        raise AssertionError("the bf16 head did not launch K1/K3 once per step")
    if not np.isfinite(trainer.step_losses).all():
        raise AssertionError(f"bf16 losses {trainer.step_losses}")
    del trainer
    torch.cuda.empty_cache()

    # The canonical recipe: 10-row episodes take the naive head.
    args, trainer, _ = train.setup(
        argv[:argv.index("--n_shot")] + ["--n_way", "10", "--n_shot", "1"]
        + argv[argv.index("--n_shot") + 2:], datasets=datasets)
    _counts(reset=True)
    trainer.train_epoch(num_steps=3)
    torch.cuda.synchronize()
    naive = _counts()
    print(f"train n_way 10: launches {naive}; losses {['%.4f' % v for v in trainer.step_losses]}")
    if naive["nw_fwd_cuda"] != 0 or not np.isfinite(trainer.step_losses).all():
        raise AssertionError("the n_way 10 recipe launched K1 or lost finiteness")
    del trainer
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The evaluation CLI: cluster mode on K1, full mode on K2, ivf on K6.
# ---------------------------------------------------------------------------

EVAL_ARGV = ["--dataset", "synthetic_cub", "--arch", "resnet18", "--batch_size", "8",
             "--modes", "random", "full", "cluster", "ivf", "ensemble", "knn", "hnsw",
             "--n_shot_cluster", "6",
             "--fit_temperature", "--influence_queries", "8", "--num_val_steps", "10"]
EVAL_BATCHES = 10
EVAL_CLUSTER_ROWS = 200 * 6  # at least fused_min_support (1,024): the K1 route
# Which wrapper each mode must launch once a batch (random's 200-row
# episodes and knn's and hnsw's 80-row unions take the naive head; the one
# environment's ensemble bank, 5,800 rows, takes K1).
EVAL_KERNELS = {"random": None, "full": "nw_prepared_cuda", "cluster": "nw_fwd_cuda",
                "ivf": "nw_prepared_sel_cuda", "ensemble": "nw_fwd_cuda", "knn": None,
                "hnsw": None}
KMEANS_REL = 1e-4  # device vs CPU Lloyd from one init, of max|centroid|
INFLUENCE_TOL = 1e-5  # card vs CPU on the same probabilities and weights


def eval_phase(datasets, workdir: str) -> dict:
    """``python -m nwhead_tpu_torch.eval`` at ResNet-18's full width on the
    CUB-scale bank, in process (``main`` with the phase's datasets), on a
    checkpoint that two training steps write: ``--modes random full cluster
    ivf --n_shot_cluster 6`` (200 x 6 = 1,200 cluster rows: K1),
    ``--fit_temperature --influence_queries 8``, 10 batches of 8 a mode.
    Each mode's seconds and launches come from ``evaluate_mode`` wrapped for
    the call; afterwards one cluster batch is held to the plain head, the
    device k-means to its CPU run from the same init, and the influences on
    the card to their CPU run. The ensemble, knn and hnsw modes are checked
    as the others."""
    from unittest import mock

    import torch

    from nwhead_tpu_torch import eval as eval_cli
    from nwhead_tpu_torch import train
    from nwhead_tpu_torch.ops import kmeans as K
    from nwhead_tpu_torch.ops import nw as nw_ops
    from nwhead_tpu_torch.ops.influence import support_influence
    from nwhead_tpu_torch.train.checkpoint import save_checkpoint

    args, trainer, _ = train.setup(TRAIN_ARGV + ["--models_dir", workdir, "--log_interval",
                                                 "1000"], datasets=datasets)
    trainer.train_epoch(num_steps=2)
    ckpt = save_checkpoint(1, trainer.state_dict(), args.ckpt_dir)
    del trainer
    torch.cuda.empty_cache()

    modes, seen = {}, {}
    evaluate = eval_cli.evaluate_mode

    def timed(net, val_ds, mode, batch_size, num_steps):
        torch.cuda.synchronize()
        before, t0 = _counts(), time.perf_counter()
        out = evaluate(net, val_ds, mode, batch_size, num_steps)
        torch.cuda.synchronize()
        after = _counts()
        modes[mode] = {"seconds": time.perf_counter() - t0,
                       "launches": {n: after[n] - before[n] for n in after
                                    if after[n] != before[n]}}
        seen["net"] = net
        return out

    _counts(reset=True)
    t0 = time.perf_counter()
    with mock.patch.object(eval_cli, "evaluate_mode", timed):
        results = eval_cli.main(EVAL_ARGV + ["--ckpt", ckpt], datasets=datasets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    net, val_ds = seen["net"], datasets[1]
    for mode, r in results.items():
        m = modes[mode]
        print(f"eval {mode}: {m['seconds']:.2f}s for {EVAL_BATCHES} batches of 8; acc "
              f"{r['acc']:.3f} nll {r['nll']:.4f} ece {r['ece']:.3f}; T {r['temperature']:.4f}, "
              f"holdout nll {r['nll_holdout_raw']:.4f} -> {r['nll_holdout_cal']:.4f}; launches "
              f"{m['launches']}")
        kernel = EVAL_KERNELS[mode]
        want = {kernel: EVAL_BATCHES} if kernel else {}
        if m["launches"] != want:
            raise AssertionError(f"eval {mode} launched {m['launches']}, not {want}")
        if r["n"] != 8 * EVAL_BATCHES or not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"eval {mode}: {r}")
    print(f"eval CLI: {wall:.2f}s in all (checkpoint load, bank, clusters, {len(results)} "
          f"modes, temperature fits, influence); launches "
          f"{ {n: c for n, c in launches.items() if c} }")

    # One cluster batch and one full batch against the plain heads.
    sfeat, sy = net.support_eval.get_support("cluster")
    x = torch.from_numpy(val_ds.gather(np.arange(8))).to(net.device)
    with torch.inference_mode():
        feats = net._featurize_eval(x)
        got = net.model.head(feats, sfeat, sy)
        plain = nw_ops.nw_log_probs(feats, sfeat, sy, net.n_classes)
        full, full_plain = net.predict(x, "full"), plain_head(net, feats)
    torch.cuda.synchronize()
    cluster_err = float((got - plain).abs().max())
    full_err = float((full - full_plain).abs().max())
    print(f"eval cluster batch: bank {tuple(sfeat.shape)}, K1 vs the plain head max|err| "
          f"{cluster_err:.3e}; full batch K2 vs plain {full_err:.3e}")
    if (sfeat.shape[0] != EVAL_CLUSTER_ROWS or not net.model.head.takes_fused(feats, sfeat)
            or not within(got, plain, **TOL["f32"]) or not within(full, full_plain, **TOL["f32"])):
        raise AssertionError("the eval CLI's cluster or full batch disagrees with the plain head")

    # The k-means at the cluster bank's size: built again (seconds), then
    # the device Lloyd against its CPU run from the same init.
    bank, bank_y = net.support_eval.full_feat, net.support_eval._full_y_np
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, _ = K.compute_clusters(bank, bank_y, 6)
    torch.cuda.synchronize()
    km_s = time.perf_counter() - t0
    x3, mask, classes = K.pad_by_class(bank, bank_y)
    init = K.kmeanspp_init(x3, mask, 6, torch.Generator().manual_seed(0))
    on_card = K.batched_kmeans(x3, mask, 6, init=init)
    on_cpu = K.batched_kmeans(x3.cpu(), mask.cpu(), 6, init=init.cpu())
    km_err = float((on_card.cpu() - on_cpu).abs().max() / on_cpu.abs().max())
    print(f"k-means C={len(classes)} k=6 D={bank.shape[1]} over {bank.shape[0]} rows (25 Lloyd "
          f"steps, kmeans++): {km_s:.3f}s on the card; same bits as the bank's build "
          f"{torch.equal(again, sfeat)}; card vs CPU from one init max|err| / max|c| "
          f"{km_err:.3e}")
    if not torch.equal(again, sfeat) or km_err > KMEANS_REL:
        raise AssertionError("the device k-means is not repeatable or disagrees with the CPU")

    # Support influence on the card against the CPU, same inputs.
    y = torch.as_tensor(val_ds.targets[:8]).to(net.device)
    with torch.inference_mode():
        probs, weights = net.model.head.probs_and_weights(feats, bank, net.support_eval.full_y)
        infl = support_influence(probs, y, weights, net.support_eval.full_y)
    ref = support_influence(probs.cpu(), y.cpu(), weights.cpu(), net.support_eval.full_y.cpu())
    fin = torch.isfinite(ref)
    infl_err = float((infl.cpu()[fin] - ref[fin]).abs().max())
    print(f"influence (8, {bank.shape[0]}): card vs CPU max|err| {infl_err:.3e} over "
          f"{int(fin.sum())} finite entries ({int((~fin).sum())} not finite on both)")
    if (not torch.equal(torch.isfinite(infl.cpu()), fin)
            or infl_err > INFLUENCE_TOL * max(1.0, float(ref[fin].abs().max()))):
        raise AssertionError("support influence on the card disagrees with the CPU")
    out = {"modes": modes, "results": results, "launches": launches, "kmeans_s": km_s,
           "cluster_err": cluster_err, "full_err": full_err, "ckpt": ckpt}
    del net, seen
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The retrieval modes: ensemble on K1 (sharded: K1 partials), knn and hnsw.
# ---------------------------------------------------------------------------

RETRIEVAL_ENVS = 3
RETRIEVAL_B = 64
RETRIEVAL_K = 20
RETRIEVAL_BATCHES = 3
# The environments' balanced banks hold 600, 600 and 800 rows (the smallest
# class of an environment has 3 or 4 images): below the default 1,024, so
# the phase lowers the fused head's threshold to put them on K1.
RETRIEVAL_MIN_SUPPORT = 512
# HNSW recall@20 against exact at the reference's parameters (M=16,
# ef_construction=100, ef_search=64): on these features of 200 tight
# classes it reads 0.853, and the JAX package's index returns the same ids
# on them (PERF.md), so the gate is set to catch a broken graph, not at the
# 0.9 of JAX's Gaussian test bank. With ef_search the bank's rows the search
# must reach every true neighbour (the graph is whole): each row it returns
# within the f32 rounding bound of the exact k-th distance.
HNSW_RECALL_MIN = 0.8
F32_EPS = float(np.finfo(np.float32).eps)


def _batch_ms(fn, n: int = 10) -> float:
    """Median of ``n`` calls' CUDA-event times (host queueing included)."""
    import torch

    fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def retrieval_phase(datasets) -> dict:
    """The ensemble, knn and hnsw modes of ``NWNet.predict`` at ResNet-18's
    width on ``synthetic_cub`` in three environments, each mode's launches
    counted around its call alone, then held to its plain version on the
    same features; the sharded ensemble and knn on four shards of the card.
    Returns launches, errors and times."""
    import torch

    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.nw.net import NWNet
    from nwhead_tpu_torch.ops import nw as nw_ops
    from nwhead_tpu_torch.ops.kernels import pairwise_sqdist
    from nwhead_tpu_torch.parallel import make_mesh, sharded_knn_predict_fn

    train_ds, val_ds = datasets
    dev = torch.device("cuda")
    env = np.random.default_rng(0).integers(0, RETRIEVAL_ENVS, len(train_ds))
    featurizer = load_model("resnet18", device=dev, generator=torch.Generator().manual_seed(0))

    def build(mesh=None):
        net = NWNet(featurizer, train_ds.num_classes, support_dataset=train_ds, device=dev,
                    feat_dim=featurizer.feat_dim, train_type="irm", env_array=env,
                    n_neighbors=RETRIEVAL_K, fused_min_support=RETRIEVAL_MIN_SUPPORT, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.precompute()
        torch.cuda.synchronize()
        return net, time.perf_counter() - t0

    net, bank_s = build()
    se, C, k = net.support_eval, net.n_classes, RETRIEVAL_K
    sizes = [len(f) for f in se.full_feat_sep]
    print(f"retrieval: bank {tuple(se.full_feat.shape)} in {RETRIEVAL_ENVS} environments of "
          f"{sizes} rows, precomputed in {bank_s:.2f}s")
    if len(sizes) != RETRIEVAL_ENVS or min(sizes) < RETRIEVAL_MIN_SUPPORT:
        raise AssertionError(f"environment banks {sizes} do not all take K1")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = se.hnsw  # the graph is built at its first use
    hnsw_build_s = time.perf_counter() - t0
    print(f"HNSW graph over {len(index)} rows (D={index.dim}, M=16, ef_construction=100) built "
          f"in {hnsw_build_s:.2f}s on the host")
    mesh = make_mesh(1, 4, devices=[dev] * 4)
    mesh_net, mesh_bank_s = build(mesh)
    bank, labels = se.full_feat, se.full_y
    knn_sharded = sharded_knn_predict_fn(mesh, bank, labels, torch.ones(len(labels), device=dev),
                                         C, k)

    want_launches = {"ensemble": {"nw_fwd_cuda": RETRIEVAL_ENVS}, "knn": {"nw_fwd_cuda": 1},
                     "hnsw": {"nw_fwd_cuda": 1},
                     "sharded ensemble": {"nw_fwd_partials_cuda": 4 * RETRIEVAL_ENVS}}
    launches = {m: {} for m in want_launches}
    seconds = {m: [] for m in want_launches}
    errs = {m: 0.0 for m in ("ensemble", "knn", "hnsw", "sharded ensemble", "sharded knn")}
    recalls, exact_ids, worst_tie, swapped, whole = [], 0, 0.0, 0, -np.inf
    for b in range(RETRIEVAL_BATCHES):
        x = torch.from_numpy(val_ds.gather(np.arange(b * RETRIEVAL_B,
                                                     (b + 1) * RETRIEVAL_B))).to(dev)
        outs = {}
        for mode, runner in (("ensemble", net), ("knn", net), ("hnsw", net),
                             ("sharded ensemble", mesh_net)):
            torch.cuda.synchronize()
            _counts(reset=True)
            t0 = time.perf_counter()
            outs[mode] = runner.predict(x, mode.split()[-1])
            torch.cuda.synchronize()
            seconds[mode].append(time.perf_counter() - t0)
            got = {n: c for n, c in _counts().items() if c}
            if got != want_launches[mode]:
                raise AssertionError(f"retrieval {mode} launched {got}, not {want_launches[mode]}")
            for n, c in got.items():
                launches[mode][n] = launches[mode].get(n, 0) + c
            if (tuple(outs[mode].shape) != (RETRIEVAL_B, C)
                    or not bool(torch.isfinite(outs[mode]).all())):
                raise AssertionError(f"retrieval {mode}: not finite (B, C) log-probs")
        with torch.inference_mode():
            qfeat = net._featurize_eval(x)
            ens = se.get_support("ensemble")
            got = net._ensemble_from_feats(qfeat, *ens)
            plain = torch.log(sum(torch.exp(nw_ops.nw_log_probs(qfeat, f, y, C, support_mask=m))
                                  for f, y, m in zip(*ens)) / RETRIEVAL_ENVS)
            errs["ensemble"] = max(errs["ensemble"], float((got - plain).abs().max()))
            if not within(got, plain, **TOL["f32"]):
                raise AssertionError("the ensemble through K1 disagrees with the plain loop")
            sharded = mesh_net._ensemble_sharded(qfeat)
            errs["sharded ensemble"] = max(errs["sharded ensemble"],
                                           float((sharded - got).abs().max()))
            if not within(sharded, got, **TOL["f32"]):
                raise AssertionError("the sharded ensemble disagrees with the unsharded one")
            ids = se.knn.indices(qfeat)
            d2 = pairwise_sqdist(qfeat, bank)
            if not torch.equal(ids.cpu(), torch.sort(d2.cpu(), dim=1, stable=True)[1][:, :k]):
                raise AssertionError("the knn ids differ from a CPU stable sort of their distances")
            # Against the exact (f64) search the f32 expansion |q|^2 - 2 q.s +
            # |s|^2 may swap rows whose exact distances lie within twice its
            # rounding bound, gamma_D (|q| + |s|)^2 (D products a dot): a
            # selected row must be no farther than the exact k-th plus that.
            q64, b64 = qfeat.cpu().double(), bank.cpu().double()
            d64 = pairwise_sqdist(q64, b64)
            ref = torch.sort(d64, dim=1, stable=True)[1][:, :k]
            exact_ids += int((torch.sort(ids.cpu(), 1)[0] == torch.sort(ref, 1)[0]).all(1).sum())
            kth = torch.sort(d64, 1)[0][:, k - 1:k]
            gamma = bank.shape[1] * F32_EPS / (1 - bank.shape[1] * F32_EPS)
            slack = 2 * gamma * (q64.norm(dim=1, keepdim=True) + b64.norm(dim=1).max()) ** 2

            def beyond(sel):
                """How far the selected rows' largest exact distance lies past
                the exact k-th, in units of the rounding bound."""
                return float(((torch.gather(d64, 1, torch.as_tensor(sel)) - kth) / slack).max())

            excess = beyond(ids.cpu())
            worst_tie = max(worst_tie, excess)
            if excess > 1.0:
                raise AssertionError("the knn search missed a neighbour by more than the f32 "
                                     f"distances' rounding bound ({excess:.3f} of it)")
            for mode in ("knn", "hnsw"):
                sf, sy = se.get_support(mode, x=qfeat)
                if sf.shape[0] != RETRIEVAL_B * k or not net.model.head.takes_fused(qfeat, sf):
                    raise AssertionError(f"the {mode} union does not take K1")
                got_u = net.model.head(qfeat, sf, sy)
                plain_u = nw_ops.nw_log_probs(qfeat, sf, sy, C)
                errs[mode] = max(errs[mode], float((got_u - plain_u).abs().max()))
                if not within(got_u, plain_u, **TOL["f32"]):
                    raise AssertionError(f"the {mode} union's K1 disagrees with the plain head")
                if mode == "knn":
                    # The shards' own distances (the same products at a
                    # shard's shape) select the sharded union; where cuBLAS
                    # rounds them otherwise than the whole bank's, a near
                    # tie may swap, and the sharded knn is held to the
                    # plain head over its own union instead.
                    loc = len(labels) // 4
                    d2_sh = torch.cat([pairwise_sqdist(qfeat, bank[j * loc:(j + 1) * loc])
                                       for j in range(4)], 1)
                    ids_sh = torch.sort(d2_sh, dim=1, stable=True)[1][:, :k]
                    swapped += int((ids_sh != ids).sum())
                    want_sh = got_u if torch.equal(ids_sh, ids) else nw_ops.nw_log_probs(
                        qfeat, bank[ids_sh.reshape(-1)], labels[ids_sh.reshape(-1)], C)
                    sharded_knn = knn_sharded(qfeat)
                    errs["sharded knn"] = max(errs["sharded knn"],
                                              float((sharded_knn - want_sh).abs().max()))
                    if not within(sharded_knn, want_sh, **TOL["f32"]):
                        raise AssertionError("the sharded knn disagrees with the single-device "
                                             f"knn ({swapped} ids swapped by the shards)")
            hnsw_ids = index.knn_query(qfeat)
            recalls.append(np.mean([len(set(h) & set(e)) / k for h, e in
                                    zip(hnsw_ids.tolist(), ids.cpu().tolist())]))
            index.ef_search = len(labels)  # the search visits every row it can reach
            whole = max(whole, beyond(index.knn_query(qfeat)))
            index.ef_search = max(64, k)
    recall = float(np.mean(recalls))
    with torch.inference_mode():
        search_ms = _batch_ms(lambda: se.knn.indices(qfeat))
        hnsw_ms = _batch_ms(lambda: index.knn_query(qfeat))
    per_batch = {m: float(np.median(v)) for m, v in seconds.items()}
    print(f"retrieval on {nvidia_smi_line()}: host seconds a batch of 64 (median of 3, "
          "featurizer included): " + ", ".join(f"{m} {v:.4f}" for m, v in per_batch.items())
          + f"; launches {launches}")
    print(f"retrieval checks: max|err| vs plain {errs}; knn ids equal to the f64 CPU search in "
          f"{exact_ids} of {RETRIEVAL_B * RETRIEVAL_BATCHES} queries (the rest within "
          f"{worst_tie:.4f} of the f32 rounding bound of the k-th distance); sharded knn "
          f"union: {swapped} ids differ from the single-device one; "
          f"hnsw recall@{k} {recall:.4f} (with ef_search {len(labels)} its farthest row "
          f"{whole:.4f} bounds past the exact k-th); knn search "
          f"{search_ms:.4f} ms (B=64 over "
          f"{len(labels)} rows), hnsw search {hnsw_ms:.4f} ms on the host; the mesh net's bank "
          f"{mesh_bank_s:.2f}s")
    if recall < HNSW_RECALL_MIN or whole > 1.0:
        raise AssertionError(f"hnsw recall@{k} {recall:.4f} (< {HNSW_RECALL_MIN}?) or a row "
                             f"{whole:.4f} bounds past the k-th with ef_search over the bank")
    out = {"launches": launches, "errs": errs, "seconds": per_batch, "recall": recall,
           "recall_whole": whole,
           "hnsw_build_s": hnsw_build_s, "knn_search_ms": search_ms, "hnsw_search_ms": hnsw_ms,
           "bank_s": bank_s, "sizes": sizes, "exact_ids": exact_ids, "swapped": swapped}
    del net, mesh_net, index, knn_sharded
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# ViT serving: K7, K9, K10 and K11.
# ---------------------------------------------------------------------------

ATTN_SOURCE = "nwhead_tpu_torch/csrc/vit_attn.cu"
MLP_SOURCE = "nwhead_tpu_torch/csrc/vit_mlp.cu"
VIT_REPLACES = {
    "attention_qkv": "nwhead_tpu/ops/pallas_attn.py:68",
    "mlp": "nwhead_tpu/ops/pallas_mlp.py:43",
    "attention_block_bf16": "nwhead_tpu/ops/pallas_attn.py:376",
    "mlp_block_bf16": "nwhead_tpu/ops/pallas_mlp.py:206",
}
# ViT-S/14 serving at B=64, 224 px: N = 16 * 16 + 1 tokens, D = 384, 6
# heads of 64, MLP 1,536.
VIT_B, VIT_N, VIT_D, VIT_H, VIT_DH = 64, 257, 384, 6, 1536
# The edges of K7's and K8's tiles (64-row blocks of four 16-row warps,
# 8-key score tiles, 16-key bf16 PV steps) at every head width, small B.
ATTN_EDGE_CASES = (  # name, B, N, H, hd
    ("edge_n1_hd32", 2, 1, 2, 32),
    ("edge_n8_hd128", 2, 8, 2, 128),
    ("edge_n16_hd64", 2, 16, 2, 64),
    ("edge_n17_hd32", 2, 17, 2, 32),
    ("edge_n64_hd128", 2, 64, 2, 128),
    ("edge_n65_hd64", 2, 65, 2, 64),
)
ATTN_CASES = (  # name, B, N, H, hd; the first is the serving shape, timed
    ("vit_s14_b64", VIT_B, VIT_N, VIT_H, 64),
    ("ragged_n197", VIT_B, 197, VIT_H, 64),
    ("n1370_b16", 16, 1370, VIT_H, 64),  # DINOv2's native 518 px grid
    ("vit_b14_b64", VIT_B, VIT_N, 12, 64),
) + ATTN_EDGE_CASES
MLP_CASES = (("vit_s14_b64", VIT_B * VIT_N), ("ragged_m1001", 1001))  # name, M
VIT_B14_MLP = (768, 3072)  # ViT-B/14's D, D_h: K9 takes two column blocks there
# K11 and K11 int8 beyond the serving shape, every fold: a ragged M and
# D_h (K11 int8 also a D_in off the 16-byte row) and ViT-B/14's width,
# timed with the serving folds. name, M, D, D_h.
K11_CASES = (("ragged_m1001_dh100", 1001, VIT_D, 100), ("vit_b14_b64", VIT_B * VIT_N) + VIT_B14_MLP)
K11_INT8_CASES = (("ragged_m1001_din388_dh100", 1001, 388, 100),
                  ("vit_b14_b64", VIT_B * VIT_N) + VIT_B14_MLP)
# K10 and K10 int8 beyond the serving shape, every fold: the edges of the
# 64-query tiles and of the projections' 128-row tiles (B = 1, hd = 64),
# heads of 32 (B = 3, N = 37, D = 64), and ViT-B/14's width, timed with the
# serving folds. name, B, N, D, H.
K10_CASES = tuple((f"edge_n{n}", 1, n, VIT_D, VIT_H) for n in (1, 63, 64, 65, 129)) + (
    ("hd32_b3_n37", 3, 37, 64, 2), ("vit_b14_b64", VIT_B, VIT_N, 768, 12))
VIT_SERVE_ARGV = ["--dataset", "synthetic_cub", "--arch", "vit_s14", "--batch_size", "64",
                  "--latency_bench"]
VIT_CONFIGS = (  # name, extra flags, kernels launched 12 times per request, the head's
    ("bf16_fused", ["--featurizer_precision", "bf16_fused"],
     ("attention_block_bf16_cuda", "mlp_block_bf16_cuda"), "nw_prepared_cuda"),
    ("fused_inference", ["--fused_inference"], ("attention_qkv_cuda", "mlp_cuda"),
     "nw_prepared_cuda"),
    ("fused_inference_bf16", ["--fused_inference", "--bf16"], ("attention_qkv_cuda", "mlp_cuda"),
     "nw_prepared_cuda"),
)
# The int8 serving stack: calibrated on the serve CLI's default 256 images.
VIT_INT8_CONFIGS = tuple(
    (f"int8_{head}", ["--featurizer_precision", "int8", "--head_precision", head],
     ("attention_block_int8_cuda", "mlp_block_int8_cuda"), HEAD_WRAPPERS[head])
    for head in ("int8", "int4"))
GAMMA_SEED = 11
TURNS_KEYS = ("turns_ms", "turns_library_ms")  # K7 and K8 beside SDPA in turns, read flush


# Served bf16 features against the plain featurizer: 24 bf16 half-blocks
# whose products are summed in another order than cuBLAS sums them flip
# single bf16 roundings that carry through the residual stream. The same
# plain graph on the card and on the CPU differ by 1.3e-2 of max|plain|
# (cosine 0.99996; H100, chip_smoke.py's ViT serving phase prints it on
# every run), so 1e-2 cannot hold for any implementation; 3e-2 with the
# cosine at 0.9999.
FEATURE_BF16_REL = 3e-2


def vit_agree(got, want, prec: str, bf16_rel: float = 1e-2):
    """Kernel (or served) values against the plain version's: f32 within
    1e-4 of max|plain|; bf16 within ``bf16_rel`` of max|plain| (a kernel's
    sums run in another order than cuBLAS's, so a bf16 rounding may flip by
    one ulp) and cosine >= 0.9999. Returns (ok, max |err|, relative error,
    cosine)."""
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    cos = float(torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0))
    ok = bool(torch.isfinite(got).all()) and (
        rel <= 1e-4 if prec == "f32" else rel <= bf16_rel and cos >= 0.9999)
    return ok, err, rel, cos


@contextlib.contextmanager
def plain_vit_kernels():
    """The ViT ops' kernel wrappers swapped for their plain versions (same
    signatures), so that a module run on the card computes the plain
    function; restored on exit."""
    from nwhead_tpu_torch.ops import fused_attn as FA
    from nwhead_tpu_torch.ops import fused_mlp as FM

    swaps = [(FA, "attention_qkv_cuda", FA._attention_qkv_plain),
             (FA, "attention_block_bf16_cuda", FA._attention_block_bf16_plain),
             (FA, "attention_block_int8_cuda", FA._attention_block_int8_plain),
             (FM, "mlp_cuda", FM._mlp_plain), (FM, "mlp_block_bf16_cuda", FM._mlp_block_bf16_plain),
             (FM, "mlp_block_int8_cuda", FM._mlp_block_int8_plain)]
    saved = [getattr(m, n) for m, n, _ in swaps]
    try:
        for m, n, plain in swaps:
            setattr(m, n, plain)
        yield
    finally:
        for (m, n, _), fn in zip(swaps, saved):
            setattr(m, n, fn)


def _vit_record(res: dict, key: str, err: float) -> None:
    res.setdefault(key, {"max_abs_err": 0.0})
    res[key]["max_abs_err"] = max(res[key]["max_abs_err"], err)


def _vit_timed(res, key, flush, kernel, plain, n_bytes, flops, prec, library=None,
               **more_ops) -> None:
    res[key].update(ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush),
                    library_ms=None if library is None else time_ms(library, flush),
                    **bound(n_bytes, flops, prec, **more_ops))
    r = res[key]
    lib = "" if library is None else f", library {r['library_ms']:.4f} ms"
    print(f"time {key}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{lib}, "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def _check_block(res: dict, key: str, kernel, plain, args, label: str, exact=False) -> None:
    """One half-block call against its plain version within the bf16
    limits (``exact``, K11 int8's exact int32 sums: also bit-equal 1.0000),
    printed; its max |err| recorded under ``key``. Raises if it
    disagrees."""
    import torch

    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    ok, err, rel, cos = vit_agree(got, want, "bf16")
    equal = float((got == want).double().mean())
    ok = ok and (torch.equal(got, want) or not exact)
    print(f"{label}: max|err| {err:.3e}, rel {rel:.2e}, cos {cos:.7f}, bit-equal {equal:.4f} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: disagrees with its plain version")
    _vit_record(res, key, err)


def _mlp_vit_b(res: dict, flush, backward: bool) -> None:
    """K9 (or its backward) at ViT-B/14's width and the serving M against
    its plain version, f32 and bf16, timed (``mlp_vit_b_*`` entries, not
    part of the kernels line)."""
    import torch

    from nwhead_tpu_torch.ops import fused_mlp as FM

    dev = torch.device("cuda")
    D, Dh = VIT_B14_MLP
    M = VIT_B * VIT_N
    rng = np.random.default_rng(310)
    x, w1, b1, w2, b2, go = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.standard_normal((M, D)), rng.standard_normal((D, Dh)) / np.sqrt(D),
        0.1 * rng.standard_normal(Dh), rng.standard_normal((Dh, D)) / np.sqrt(Dh),
        0.1 * rng.standard_normal(D), rng.standard_normal((M, D))))
    for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = (x.to(dt), w1.to(dt), b1, w2.to(dt), b2) + ((go.to(dt),) if backward else ())
        kernel, plain = (FM.mlp_bwd_cuda, FM._mlp_bwd_plain) if backward else \
            (FM.mlp_cuda, FM._mlp_plain)
        key = f"mlp{'_bwd' if backward else ''}_vit_b_{prec}"
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        name = (f"K9{' backward' if backward else ''} at ViT-B/14's width "
                f"(M={M}, D={D}, D_h={Dh})")
        if backward:
            err = check_grads(got, want, prec, ("dx", "dw1", "db1", "dw2", "db2"), name)
        else:
            ok, err, rel, cos = vit_agree(got, want, prec)
            print(f"{name} {prec}: max|err| {err:.3e}, rel {rel:.2e}, cos {cos:.7f} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version: {prec}")
        del got, want
        _vit_record(res, key, err)
        item = x.to(dt).element_size()
        n_bytes = (3 if backward else 2) * M * D * item + (4 if backward else 2) * D * Dh * item
        _vit_timed(res, key, flush, lambda: kernel(*args), lambda: plain(*args), n_bytes,
                   (10 if backward else 4) * M * D * Dh, prec)


def _turns_with_library(r: dict, name: str, kernel, library_name: str, library) -> None:
    """Time a kernel in turns with its PyTorch yardstick by the labs'
    harness (``lab_times``: the L2 flushed by a read) beside ``time_ms``'s
    reading; adds ``turns_ms`` and ``turns_library_ms`` to ``r``."""
    t = lab_times([(name, kernel), (library_name, library)])
    r.update(turns_ms=t[name], turns_library_ms=t[library_name])
    print(f"time {name} in turns with {library_name} (read flush): kernel {t[name]:.4f} ms, "
          f"{library_name} {t[library_name]:.4f} ms ({t[name] / t[library_name]:.2f}x); "
          f"time_ms: kernel {r['ms']:.4f} ms, {library_name} {r['library_ms']:.4f} ms")


def vit_kernel_phase(flush) -> dict:
    """K7 and K9 (f32 and bf16) and K10, K11 (bf16, every fold) against
    their plain versions on the card; times each at the ViT-S/14 serving
    shape, K7 beside ``F.scaled_dot_product_attention`` on the same data.
    Returns, per entry, max |err|, kernel, plain and library ms and the
    bound."""
    import torch
    import torch.nn.functional as TF

    from nwhead_tpu_torch.ops import fused_attn as FA
    from nwhead_tpu_torch.ops import fused_mlp as FM

    dev = torch.device("cuda")
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    res: dict = {}
    for ci, (case, B, N, H, hd) in enumerate(ATTN_CASES):
        qkv32 = torch.from_numpy(np.random.default_rng(200 + ci).standard_normal(
            (B, N, 3 * H * hd), np.float32)).to(dev)
        for prec, dt in dtypes.items():
            qkv, key = qkv32.to(dt), f"attention_qkv_{prec}"
            got = FA.attention_qkv_cuda(qkv, H, hd ** -0.5)
            want = FA._attention_qkv_plain(qkv, H, hd ** -0.5)
            torch.cuda.synchronize()
            ok, err, rel, cos = vit_agree(got, want, prec)
            print(f"K7 {case} {prec}: max|err| {err:.3e}, rel {rel:.2e}, cos {cos:.7f} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K7 disagrees with its plain version: {case} {prec}")
            _vit_record(res, key, err)
            if ci == 0:
                q, k, v = (t.permute(0, 2, 1, 3).contiguous()
                           for t in qkv.reshape(B, N, 3, H, hd).unbind(2))
                item = qkv.element_size()
                _vit_timed(res, key, flush, lambda: FA.attention_qkv_cuda(qkv, H, hd ** -0.5),
                           lambda: FA._attention_qkv_plain(qkv, H, hd ** -0.5),
                           4 * B * N * H * hd * item, 4 * B * H * N * N * hd, prec,
                           library=lambda: TF.scaled_dot_product_attention(q, k, v))
                _turns_with_library(res[key], "K7",
                                    lambda: FA.attention_qkv_cuda(qkv, H, hd ** -0.5),
                                    "SDPA", lambda: TF.scaled_dot_product_attention(q, k, v))
    D, Dh = VIT_D, VIT_DH
    rng = np.random.default_rng(300)
    w1, b1, w2, b2, ln_s, ln_b, gamma = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.standard_normal((D, Dh)) / np.sqrt(D), 0.1 * rng.standard_normal(Dh),
        rng.standard_normal((Dh, D)) / np.sqrt(Dh), 0.1 * rng.standard_normal(D),
        1.0 + 0.2 * rng.standard_normal(D), 0.1 * rng.standard_normal(D),
        rng.uniform(0.5, 1.5, D)))
    for ci, (case, M) in enumerate(MLP_CASES):
        x32 = torch.from_numpy(np.random.default_rng(400 + ci).standard_normal(
            (M, D), np.float32)).to(dev)
        for prec, dt in dtypes.items():
            args, key = (x32.to(dt), w1.to(dt), b1, w2.to(dt), b2), f"mlp_{prec}"
            got, want = FM.mlp_cuda(*args), FM._mlp_plain(*args)
            torch.cuda.synchronize()
            ok, err, rel, cos = vit_agree(got, want, prec)
            print(f"K9 {case} {prec}: max|err| {err:.3e}, rel {rel:.2e}, cos {cos:.7f} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K9 disagrees with its plain version: {case} {prec}")
            _vit_record(res, key, err)
            if ci == 0:
                item = x32.to(dt).element_size()
                _vit_timed(res, key, flush, lambda: FM.mlp_cuda(*args),
                           lambda: FM._mlp_plain(*args),
                           2 * M * D * item + 2 * D * Dh * item + 4 * (Dh + D), 4 * M * D * Dh,
                           prec)
    _mlp_vit_b(res, flush, backward=False)
    # K10 and K11 at the serving shape, every fold on and off (bf16 only).
    bf = torch.bfloat16
    M = VIT_B * VIT_N
    x = torch.from_numpy(np.random.default_rng(500).standard_normal(
        (VIT_B, VIT_N, D), np.float32)).to(dev, bf)
    w_qkv, b_qkv, w_proj, b_proj = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.standard_normal((D, 3 * D)) / np.sqrt(D), 0.1 * rng.standard_normal(3 * D),
        rng.standard_normal((D, D)) / np.sqrt(D), 0.1 * rng.standard_normal(D)))
    scale = (D // VIT_H) ** -0.5
    for ln, ls, resid in itertools.product([False, True], repeat=3):
        folds = (ln_s if ln else None, ln_b if ln else None, 1e-6,
                 gamma.to(bf) if ls else None, resid)
        a_args = (x, w_qkv.to(bf), b_qkv, w_proj.to(bf), b_proj, VIT_H, scale) + folds
        m_args = (x.reshape(M, D), w1.to(bf), b1, w2.to(bf), b2) + folds
        where = f"ln={int(ln)} ls={int(ls)} residual={int(resid)}"
        for key, kernel, plain, args in (
                ("attention_block_bf16", FA.attention_block_bf16_cuda,
                 FA._attention_block_bf16_plain, a_args),
                ("mlp_block_bf16", FM.mlp_block_bf16_cuda, FM._mlp_block_bf16_plain, m_args)):
            _check_block(res, key, kernel, plain, args, f"{key} B={VIT_B} N={VIT_N} {where}")
            if ln and ls and resid:  # the serving path's folds
                if key == "attention_block_bf16":
                    n_bytes, flops, _ = _k10_work(VIT_B, VIT_N, D, VIT_H, int8=False)
                else:
                    n_bytes = 4 * M * D + 2 * 2 * D * Dh + 4 * (Dh + D) + 8 * D + 2 * D
                    flops = 4 * M * D * Dh
                _vit_timed(res, key, flush, lambda k=kernel, a=args: k(*a),
                           lambda p=plain, a=args: p(*a), n_bytes, flops, "bf16")
                if key == "attention_block_bf16":
                    _print_split(f"{key} B={VIT_B} N={VIT_N} {where}", lambda a=args: kernel(*a),
                                 flush)
    # K11 with every fold off is K9's function on the same products: K9's bits.
    m_args = (x.reshape(M, D), w1.to(bf), b1, w2.to(bf), b2)
    same = torch.equal(FM.mlp_block_bf16_cuda(*m_args), FM.mlp_cuda(*m_args))
    print(f"mlp_block_bf16 B={VIT_B} N={VIT_N} no folds vs K9 (mlp_cuda): bit-equal {same} "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("K11 with no fold disagrees with K9's bits")
    for case, Mc, Dc, Dhc in K11_CASES:
        _k11_case(res, flush, case, Mc, Dc, Dhc)
    for case, Bc, Nc, Dc, Hc in K10_CASES:
        _k10_case(res, flush, case, Bc, Nc, Dc, Hc, int8=False)
    return res


def _k10_work(B: int, N: int, D: int, H: int, int8: bool):
    """(bytes, operations, operations at other precisions) of one K10 or
    K10 int8 call with every fold: x in and out, the weights, biases (int8:
    and scales), the LayerNorm and LayerScale vectors; the two projections'
    products (int8 operations for K10 int8) and the attention's (bf16)."""
    M, att = B * N, 4 * B * H * N * N * (D // H)
    if int8:
        return (4 * M * D + 4 * D * D + 4 * 2 * (3 * D + D) + 4 * 2 * D + 2 * D,
                8 * M * D * D, {"bf16": att})
    return 4 * M * D + 2 * 4 * D * D + 4 * 4 * D + 8 * D + 2 * D, 8 * M * D * D + att, {}


def _print_split(label: str, fn, flush) -> None:
    """One call's device functions, each's mean ms (``attn_block_lab``'s
    ``device_split``: torch.profiler, the L2 zeroed before each call), one
    line."""
    from nwhead_tpu_torch.labs.attn_block_lab import device_split, split_line

    print(split_line(label, device_split(fn, flush)))


def _qkv_gate(res: dict, label: str, x, wq, sq, bq, a_in: float, ln) -> None:
    """K10 int8's qkv stage alone (``qkv_proj_int8_cuda``: the codes'
    prologue, the s8 GEMM, the dequantized sum) against its plain version
    ``int8_dense_f32(quantize_act(...))``, ``ln`` = (scale, bias, eps) or
    Nones: bit-equal 1.0000, or the phase fails."""
    import torch

    from nwhead_tpu_torch.ops import fused_attn as FA

    got = FA.qkv_proj_int8_cuda(x, wq, sq, bq, a_in, *ln)
    want = FA._qkv_proj_int8_plain(x, wq, sq, bq, a_in, *ln)
    torch.cuda.synchronize()
    equal = float((got == want).double().mean())
    ok = bool(torch.isfinite(got).all()) and torch.equal(got, want)
    print(f"K10 int8 qkv stage {label} vs int8_dense_f32(quantize_act(...)): bit-equal "
          f"{equal:.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K10 int8's qkv stage is not bit-equal to its plain version: {label}")
    _vit_record(res, "qkv_proj_int8", float((got - want).abs().max()))


def _k10_case(res: dict, flush, case: str, B: int, N: int, D: int, H: int, int8: bool) -> None:
    """K10 (or K10 int8) at one more shape, every fold, against its plain
    version (K10 int8 also its qkv stage alone, bit for bit); timed and
    split with the serving folds at ViT-B/14's width under
    ``attention_block_{bf16,int8}_<case>`` (not part of the kernels line)."""
    import torch

    from nwhead_tpu_torch.ops import fused_attn as FA

    dev, bf = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(520)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    ln_s, ln_b, gamma = (to(a.astype(np.float32)) for a in (
        1.0 + 0.2 * rng.standard_normal(D), 0.1 * rng.standard_normal(D),
        rng.uniform(0.5, 1.5, D)))
    if int8:
        (wq, sq, bq), (wp, sp, bp) = ([to(a) for a in _qdense(rng, D, o)] for o in (3 * D, D))
        kernel, plain = FA.attention_block_int8_cuda, FA._attention_block_int8_plain
    else:
        w_qkv, b_qkv, w_proj, b_proj = (to(a.astype(np.float32)) for a in (
            rng.standard_normal((D, 3 * D)) / np.sqrt(D), 0.1 * rng.standard_normal(3 * D),
            rng.standard_normal((D, D)) / np.sqrt(D), 0.1 * rng.standard_normal(D)))
        w_qkv, w_proj = w_qkv.to(bf), w_proj.to(bf)
        kernel, plain = FA.attention_block_bf16_cuda, FA._attention_block_bf16_plain
    x = to(np.random.default_rng(521).standard_normal((B, N, D)).astype(np.float32)).to(bf)
    scale = (D // H) ** -0.5
    key = f"attention_block_{'int8' if int8 else 'bf16'}_{case}"
    for ln, ls, resid in itertools.product([False, True], repeat=3):
        folds = (ln_s if ln else None, ln_b if ln else None, 1e-6,
                 gamma.to(bf) if ls else None, resid)
        where = f"{case} (B={B}, N={N}, D={D}, H={H}) ln={int(ln)} ls={int(ls)} residual={int(resid)}"
        if int8:
            h = FA._layer_norm_f32(x, ln_s, ln_b, 1e-6).to(bf) if ln else x
            a_in = float(h.float().abs().max()) / 127.0
            _qkv_gate(res, where, x, wq, sq, bq, a_in, folds[:3])
            args = (x, wq, sq, bq, a_in, wp, sp, bp, 3.0 / 127.0, H, scale) + folds
        else:
            args = (x, w_qkv, b_qkv, w_proj, b_proj, H, scale) + folds
        _check_block(res, key, kernel, plain, args, f"{key[:len(key) - len(case) - 1]} {where}")
        if ln and ls and resid and case.startswith("vit_b14"):
            n_bytes, flops, more = _k10_work(B, N, D, H, int8)
            _vit_timed(res, key, flush, lambda a=args: kernel(*a), lambda a=args: plain(*a),
                       n_bytes, flops, "int8" if int8 else "bf16", **more)
            _print_split(f"{key} every fold", lambda a=args: kernel(*a), flush)


def _k11_case(res: dict, flush, case: str, M: int, D: int, Dh: int) -> None:
    """K11 at one more shape, every fold, against its plain version; timed
    with the serving folds under ``mlp_block_bf16_<case>`` (not part of
    the kernels line)."""
    import torch

    from nwhead_tpu_torch.ops import fused_mlp as FM

    dev, bf = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(320)
    w1, b1, w2, b2, ln_s, ln_b, gamma = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.standard_normal((D, Dh)) / np.sqrt(D), 0.1 * rng.standard_normal(Dh),
        rng.standard_normal((Dh, D)) / np.sqrt(Dh), 0.1 * rng.standard_normal(D),
        1.0 + 0.2 * rng.standard_normal(D), 0.1 * rng.standard_normal(D),
        rng.uniform(0.5, 1.5, D)))
    x = torch.from_numpy(np.random.default_rng(321).standard_normal((M, D), np.float32)).to(dev, bf)
    key = f"mlp_block_bf16_{case}"
    for ln, ls, resid in itertools.product([False, True], repeat=3):
        args = (x, w1.to(bf), b1, w2.to(bf), b2, ln_s if ln else None, ln_b if ln else None,
                1e-6, gamma.to(bf) if ls else None, resid)
        _check_block(res, key, FM.mlp_block_bf16_cuda, FM._mlp_block_bf16_plain, args,
                     f"mlp_block_bf16 {case} (M={M}, D={D}, D_h={Dh}) ln={int(ln)} "
                     f"ls={int(ls)} residual={int(resid)}")
        if ln and ls and resid and case.startswith("vit_b14"):
            _vit_timed(res, key, flush, lambda a=args: FM.mlp_block_bf16_cuda(*a),
                       lambda a=args: FM._mlp_block_bf16_plain(*a),
                       4 * M * D + 2 * 2 * D * Dh + 4 * (Dh + D) + 8 * D + 2 * D,
                       4 * M * D * Dh, "bf16")


# ---------------------------------------------------------------------------
# The int8 serving stack: K4, K5, K10 int8 and K11 int8.
# ---------------------------------------------------------------------------

QUANT_CASES = (  # name, B, S, D, C; the first and the last are timed
    ("cub_b64", 64, 5994, 512, 200),
    ("vit_b64", 64, 5800, 384, 200),  # the ViT-S/14 serving bank
    ("eval_b8", 8, 5800, 512, 200),  # the training run's full-mode eval batch
    ("ragged_d509", 37, 1001, 509, 150),  # D off the int8 word and the int4 pair
    ("ragged_d37", 17, 700, 37, 9),  # rows the TMA cannot address: plain staging
    ("c1000_b64", 64, 65_536, 512, 1000),  # the million-row bank's class count, timed
)
QUANT_REPLACES = "nwhead_tpu/ops/pallas_nw.py:820"
VIT_INT8_REPLACES = {"attention_block_int8": "nwhead_tpu/ops/pallas_attn.py:376",
                     "mlp_block_int8": "nwhead_tpu/ops/pallas_mlp.py:206"}


def quant_kernel_phase(flush) -> dict:
    """K4 and K5 against the plain version at each case, all five kernels,
    masked rows holding NaN, each called twice for the same bits; times
    each at the CUB B=64 euclidean case and at C = 1,000 (``c1000``, 65,536
    class-sorted rows, with its split). Returns, per precision, max |err|,
    kernel and plain ms and the bound."""
    import warnings

    import torch

    from nwhead_tpu_torch.ops import fused_nw as F
    from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES

    dev = torch.device("cuda")
    res = {p: {"max_abs_err": 0.0, "c1000": {}} for p in ("int8", "int4")}
    for ci, (case, B, S, D, C) in enumerate(QUANT_CASES):
        rng = np.random.default_rng(900 + ci)
        q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
        s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
        sy = rng.integers(0, C, size=S)
        valid = rng.random(S) > 0.03
        valid[0] = True
        s[torch.from_numpy(~valid).to(dev)] = float("nan")
        mask = torch.from_numpy(valid.astype(np.float32))
        for kernel in KERNEL_NAMES:
            params = {"logit_scale": torch.tensor(1.3, device=dev)} if kernel == "clip" else {}
            for prec in res:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")  # int4 + dotproduct warns
                    prep = F.prepare_support(s, sy, C, kernel=kernel, support_mask=mask,
                                             precision=prec)
                args = F._prepared_query(q, prep, kernel, params)
                args = (args[0], prep, args[1], args[2], C, args[3])
                wrapper = getattr(F, HEAD_WRAPPERS[prec])
                got, want = wrapper(*args), F._nw_prepared_plain(*args)
                same_bits(f"K4/K5 {case} {kernel} {prec}", lambda: wrapper(*args))
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                ok = bool(torch.isfinite(got).all()) and within(got, want, **HEAD_TOL[prec])
                print(f"kernel {case} {kernel} {prec}: max|err| {err:.3e} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel disagrees with plain: {case} {kernel} {prec}")
                res[prec]["max_abs_err"] = max(res[prec]["max_abs_err"], err)
                if case in ("cub_b64", "c1000_b64") and kernel == "euclidean":
                    r = res[prec] if case == "cub_b64" else res[prec]["c1000"]
                    Dp = args[0].shape[1]
                    r.update(
                        ms=time_ms(lambda: wrapper(*args), flush),
                        plain_ms=time_ms(lambda: F._nw_prepared_plain(*args), flush),
                        # q8, the bank, s2, sscale and labels, qscale, out
                        **bound(B * Dp + prep.s.numel() + 12 * S + 4 * B + 4 * B * C,
                                2 * B * S * Dp, "int8"))
                    print(f"time {case} {kernel} {prec}: kernel {r['ms']:.4f} ms, plain "
                          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
                    r.update(head_split(f"{'K4' if prec == 'int8' else 'K5'} {case} {prec}",
                                        lambda: wrapper(*args), flush))
    return res


def _qdense(rng, din, dout):
    """Random int8 weights quantized per output channel, as quantize_vit
    does, their scales and a bias (numpy)."""
    from nwhead_tpu_torch.labs.mlp_block_lab import qdense

    return qdense(rng, din, dout)


def vit_int8_kernel_phase(flush) -> dict:
    """K10 int8 and K11 int8 at the ViT-S/14 serving shape (B=64, N=257,
    D=384), every combination of the folds, against their plain versions;
    timed with the serving path's folds. Activation scales are each input's
    amax / 127, as calibration sets them."""
    import torch

    from nwhead_tpu_torch.ops import fused_attn as FA
    from nwhead_tpu_torch.ops import fused_mlp as FM

    dev = torch.device("cuda")
    bf = torch.bfloat16
    D, Dh, H = VIT_D, VIT_DH, VIT_H
    M = VIT_B * VIT_N
    rng = np.random.default_rng(1000)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    (wq, sq, bq), (wp, sp, bp), (w1, s1, b1), (w2, s2, b2) = (
        [to(a) for a in _qdense(rng, i, o)] for i, o in ((D, 3 * D), (D, D), (D, Dh), (Dh, D)))
    ln_s, ln_b, gamma = (to(a.astype(np.float32)) for a in (
        1.0 + 0.2 * rng.standard_normal(D), 0.1 * rng.standard_normal(D),
        rng.uniform(0.5, 1.5, D)))
    x = to(np.random.default_rng(1001).standard_normal((VIT_B, VIT_N, D), np.float32)).to(bf)
    scale = (D // H) ** -0.5
    res: dict = {}
    for ln, ls, resid in itertools.product([False, True], repeat=3):
        h = FA._layer_norm_f32(x, ln_s, ln_b, 1e-6).to(bf) if ln else x
        a_in = float(h.float().abs().max()) / 127.0
        # Attention outputs and GELU outputs stay within a few units here.
        a_att, a_fc2 = 3.0 / 127.0, 4.0 / 127.0
        folds = (ln_s if ln else None, ln_b if ln else None, 1e-6,
                 gamma.to(bf) if ls else None, resid)
        a_args = (x, wq, sq, bq, a_in, wp, sp, bp, a_att, H, scale) + folds
        m_args = (x.reshape(M, D), w1, s1, b1, a_in, w2, s2, b2, a_fc2) + folds
        where = f"ln={int(ln)} ls={int(ls)} residual={int(resid)}"
        _qkv_gate(res, f"B={VIT_B} N={VIT_N} {where}", x, wq, sq, bq, a_in, folds[:3])
        for key, kernel, plain, args in (
                ("attention_block_int8", FA.attention_block_int8_cuda,
                 FA._attention_block_int8_plain, a_args),
                ("mlp_block_int8", FM.mlp_block_int8_cuda, FM._mlp_block_int8_plain, m_args)):
            _check_block(res, key, kernel, plain, args, f"{key} B={VIT_B} N={VIT_N} {where}",
                         exact=key == "mlp_block_int8")
            if ln and ls and resid:  # the serving path's folds
                if key == "attention_block_int8":  # the scores and PV in bf16 beside
                    n_bytes, flops, more = _k10_work(VIT_B, VIT_N, D, H, int8=True)
                else:
                    vecs = 4 * 2 * D + 2 * D  # LN affine f32, LayerScale bf16
                    n_bytes = 4 * M * D + 2 * D * Dh + 4 * 2 * (Dh + D) + vecs
                    flops, more = 4 * M * D * Dh, {}
                _vit_timed(res, key, flush, lambda k=kernel, a=args: k(*a),
                           lambda p=plain, a=args: p(*a), n_bytes, flops, "int8", **more)
                if key == "attention_block_int8":
                    _print_split(f"{key} B={VIT_B} N={VIT_N} {where}",
                                 lambda a=args: kernel(*a), flush)
    for case, Mc, Dc, Dhc in K11_INT8_CASES:
        _k11_int8_case(res, flush, case, Mc, Dc, Dhc)
    for case, Bc, Nc, Dc, Hc in K10_CASES:
        _k10_case(res, flush, case, Bc, Nc, Dc, Hc, int8=True)
    # Why K10 int8's attention stage sums the scores in cuBLAS's order: the
    # plain chain with its scores rounded exactly (an f64 sum) against the
    # plain chain itself, at the folds without LayerNorm.
    a_in = float(x.float().abs().max()) / 127.0
    qkv = FA.int8_dense_f32(FA.quantize_act(x, a_in), wq, a_in, sq, bq).to(bf)
    want = FA._attention_block_int8_plain(x, wq, sq, bq, a_in, wp, sp, bp, 3.0 / 127.0, H, scale,
                                          None, None, 1e-6, None, False)
    att = _attention_exact_scores(qkv, H, scale).to(bf)
    got = FA.int8_dense_f32(FA.quantize_act(att, 3.0 / 127.0), wp, 3.0 / 127.0, sp, bp).to(bf)
    _, err, rel, cos = vit_agree(got, want, "bf16")
    print(f"the K10 int8 chain with exactly rounded attention scores vs the plain chain (ln=0 "
          f"ls=0 residual=0): max|err| {err:.3e}, rel {rel:.2e}, cos {cos:.7f}, bit-equal "
          f"{float((got == want).float().mean()):.4f} (a kernel is held to 1e-2)")
    return res


def _k11_int8_case(res: dict, flush, case: str, M: int, D: int, Dh: int) -> None:
    """K11 int8 at one more shape, every fold, against its plain version:
    bit-equal 1.0000 or the phase fails; timed with the serving folds under
    ``mlp_block_int8_<case>`` (not part of the kernels line)."""
    import torch

    from nwhead_tpu_torch.ops import fused_attn as FA
    from nwhead_tpu_torch.ops import fused_mlp as FM

    dev, bf = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(1010)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    (w1, s1, b1), (w2, s2, b2) = ([to(a) for a in _qdense(rng, i, o)] for i, o in ((D, Dh), (Dh, D)))
    ln_s, ln_b, gamma = (to(a.astype(np.float32)) for a in (
        1.0 + 0.2 * rng.standard_normal(D), 0.1 * rng.standard_normal(D),
        rng.uniform(0.5, 1.5, D)))
    x = to(np.random.default_rng(1011).standard_normal((M, D), np.float32)).to(bf)
    key = f"mlp_block_int8_{case}"
    for ln, ls, resid in itertools.product([False, True], repeat=3):
        h = FA._layer_norm_f32(x, ln_s, ln_b, 1e-6).to(bf) if ln else x
        args = (x, w1, s1, b1, float(h.float().abs().max()) / 127.0, w2, s2, b2, 4.0 / 127.0,
                ln_s if ln else None, ln_b if ln else None, 1e-6, gamma.to(bf) if ls else None,
                resid)
        _check_block(res, key, FM.mlp_block_int8_cuda, FM._mlp_block_int8_plain, args,
                     f"mlp_block_int8 {case} (M={M}, D={D}, D_h={Dh}) ln={int(ln)} "
                     f"ls={int(ls)} residual={int(resid)}", exact=True)
        if ln and ls and resid and case.startswith("vit_b14"):
            _vit_timed(res, key, flush, lambda a=args: FM.mlp_block_int8_cuda(*a),
                       lambda a=args: FM._mlp_block_int8_plain(*a),
                       4 * M * D + 2 * D * Dh + 4 * 2 * (Dh + D) + 4 * 2 * D + 2 * D,
                       4 * M * D * Dh, "int8")


def _attention_exact_scores(qkv, num_heads: int, scale: float):
    """K7's plain function on bf16 qkv with every score q . k rounded once
    from an f64 sum (no f32 summation order at all); the f32 output."""
    import torch

    B, N, three_d = qkv.shape
    hd = three_d // 3 // num_heads
    x = qkv.to(torch.float32).reshape(B, N, 3, num_heads, hd)
    q, k, v = (x[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    s = torch.matmul(q.double(), k.transpose(-1, -2).double()).to(torch.float32) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)).to(qkv.dtype).to(torch.float32)
    return torch.matmul(p, v).permute(0, 2, 1, 3).reshape(B, N, num_heads * hd)


def quant_entries(quant: dict, vit_int8: dict, served: dict, resnet: dict) -> list:
    """The ``kernels`` JSON entries of K4, K5, K10 int8 and K11 int8:
    launches from the ViT int8 serving runs (K4 and the half-blocks from
    ``--head_precision int8``, K5 from ``int4``); max |err| over the kernel
    phases and the served heads."""
    entries = []
    for prec in ("int8", "int4"):
        r, run = quant[prec], served[f"int8_{prec}"]
        entries.append({
            "name": f"nw_prepared_{prec}", "route": "cuda", "source": PREPARED_SOURCE,
            "replaces": QUANT_REPLACES, "launches": run["launches"][HEAD_WRAPPERS[prec]],
            "max_abs_err": max(r["max_abs_err"], run["logprob_err"], resnet[prec]["served_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "splits": r["splits"],
            "c1000_ms": r["c1000"]["ms"], "c1000_plain_ms": r["c1000"]["plain_ms"],
            "c1000_bound_ms": r["c1000"]["bound_ms"]})
    for key, wrapper, source in (("attention_block_int8", "attention_block_int8_cuda",
                                  ATTN_SOURCE),
                                 ("mlp_block_int8", "mlp_block_int8_cuda", MLP_SOURCE)):
        r = vit_int8[key]
        entries.append({
            "name": key, "route": "cuda", "source": source, "replaces": VIT_INT8_REPLACES[key],
            "launches": served["int8_int8"]["launches"][wrapper], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    return entries


# ---------------------------------------------------------------------------
# IVF-pruned serving: K6 (the prepared head over the tiles a list names).
# ---------------------------------------------------------------------------

IVF_REPLACES = "nwhead_tpu/ops/pallas_nw.py:820"
IVF_BANK = (1 << 20, 512, 1000, 1024)  # rows, D, classes, rows per tile: 1,024 tiles
IVF_SEED = 6
IVF_NOISE = 0.5  # noise per feature around unit-Gaussian class centres
IVF_BATCHES = (  # name, classes drawn from, n_probe, group_b; B = 64, the first is timed
    ("skewed", 4, 8, None),
    ("diverse", 64, 4, 16),
)
# The tile-selected head's wrapper for each bank precision.
SEL_WRAPPER = {"f32": "nw_prepared_sel_cuda", "bf16": "nw_prepared_sel_cuda",
               "int8": "nw_prepared_sel_quant_cuda", "int4": "nw_prepared_sel_quant_cuda"}
IVF_SERVE_ARGV = ["--dataset", "synthetic_cub", "--arch", "resnet18", "--batch_size", "64",
                  "--serve_mode", "ivf", "--latency_bench"]
IVF_CONFIGS = (  # name, flags; each bank precision once
    ("auto", ["--ivf_probe", "auto"]),
    ("p2_g16", ["--ivf_probe", "2", "--ivf_group", "16"]),
    ("p1_int8", ["--ivf_probe", "1", "--head_precision", "int8"]),
    ("p2_g16_bf16", ["--ivf_probe", "2", "--ivf_group", "16", "--head_precision", "bf16"]),
    ("p1_int4", ["--ivf_probe", "1", "--head_precision", "int4"]),
)


def _ivf_bank_features(dev):
    """The kernel phase's bank, drawn from ``IVF_SEED`` with numpy: class
    centres N(0, 1) per feature, rows their class centre plus N(0, 0.5^2)
    noise, uniform labels. Filled on the card in chunks of 131,072 rows.
    Returns ``(features (S, D) f32 on dev, labels (S,), centres)``."""
    import torch

    S, D, C, _ = IVF_BANK
    rng = np.random.default_rng(IVF_SEED)
    cents = rng.standard_normal((C, D), dtype=np.float32)
    sy = rng.integers(0, C, S)
    s = torch.empty((S, D), dtype=torch.float32, device=dev)
    for lo in range(0, S, 1 << 17):
        hi = min(S, lo + (1 << 17))
        noise = rng.standard_normal((hi - lo, D), dtype=np.float32)
        s[lo:hi] = torch.from_numpy(cents[sy[lo:hi]] + np.float32(IVF_NOISE) * noise).to(dev)
    return s, sy, cents


def _sel_bound(tsel, block_s: int, group_b: int, D: int, prec: str, B: int, C: int) -> dict:
    """K6's least time for this list: each selected tile's rows read once
    (features, label, self-norm, a quantized bank's row scale), the queries
    and the output once; a group's products against its own union only."""
    rows = (tsel.reshape(-1, tsel.shape[-1]) >= 0).sum(1).double().cpu().numpy() * block_s
    row_bytes = {"f32": 4 * D, "bf16": 2 * D, "int8": D + 4, "int4": D // 2 + 4}[prec] + 8
    q_bytes = B * D * {"f32": 4, "bf16": 2, "int8": 1, "int4": 1}[prec]
    flops = float(2 * group_b * rows.sum() * D)
    b = bound(float(rows.sum()) * row_bytes + q_bytes + 4 * B * C, flops,
              "int8" if prec == "int4" else prec)
    b["union_rows"] = int(rows.sum())
    b["bytes_ms"] = (float(rows.sum()) * row_bytes + q_bytes + 4 * B * C) / HBM_BYTES_PER_S * 1e3
    return b


def _ivf_queries(cents, dev) -> dict:
    """The batches of ``IVF_BATCHES``, drawn from ``IVF_SEED + 1``: 64
    queries each, their class centre plus N(0, 0.5^2) noise."""
    import torch

    C, D = cents.shape
    rng = np.random.default_rng(IVF_SEED + 1)
    queries = {}
    for name, n_cls, _, _ in IVF_BATCHES:
        qy = rng.choice(C, n_cls, replace=False)[rng.integers(0, n_cls, 64)] if n_cls < 64 \
            else rng.choice(C, 64, replace=False)
        noise = np.float32(IVF_NOISE) * rng.standard_normal((64, D), dtype=np.float32)
        queries[name] = torch.from_numpy(cents[qy] + noise).to(dev)
    return queries


def ivf_kernel_phase(flush, bank) -> dict:
    """K6 on a 1,048,576-row, D=512, C=1,000 clustered bank built by
    ``prepare_support_ivf`` at 1,024-row tiles (1,024 tiles, cluster order:
    k-means on the card) at f32, bf16, int8 and int4, for a skewed batch
    (64 queries of 4 classes, n_probe 8, one union) and a diverse one (64
    classes, n_probe 4, group_b 16). Each against ``_nw_prepared_sel_plain``
    (the head tolerances), top-1 agreement and the largest probability
    difference against the exact head (K2, K4 or K5 over the whole bank),
    K6, its plain version and that full pass timed; at full probe K6 equals
    the full pass within 2e-4. ``bank`` is ``_ivf_bank_features``'s.
    Returns per precision the skewed batch's numbers (timed) and max
    |err|."""
    import torch

    from nwhead_tpu_torch.ops import fused_nw as F
    from nwhead_tpu_torch.ops import ivf as I

    dev = torch.device("cuda")
    S, D, C, block_s = IVF_BANK
    s, sy, cents = bank
    queries = _ivf_queries(cents, dev)
    res = {}
    for prec in SEL_WRAPPER:
        t0 = time.perf_counter()
        ivf = I.prepare_support_ivf(s, sy, C, precision=prec, block_s=block_s)
        torch.cuda.synchronize()
        n_tiles = ivf.cents.shape[0]
        print(f"ivf {prec}: bank {tuple(ivf.prep.s.shape)} {ivf.prep.s.dtype}, {n_tiles} tiles "
              f"of {ivf.prep.block_s}, built in {time.perf_counter() - t0:.1f}s")
        wrapper = getattr(F, SEL_WRAPPER[prec])
        full = getattr(F, HEAD_WRAPPERS[prec])
        r = res[prec] = {"max_abs_err": 0.0}
        for name, _, n_probe, group_b in IVF_BATCHES:
            q = queries[name]
            qk, tsel, inv = I._ivf_route(q, ivf, kernel="euclidean", kernel_params=None,
                                         n_probe=n_probe, group_b=group_b)
            qq, scale, mode, qscale = F._prepared_query(qk, ivf.prep)
            args = (qq, ivf.prep, scale, mode, C, qscale)
            got = wrapper(*args, tsel)
            want = F._nw_prepared_sel_plain(*args, tsel)
            same_bits(f"K6 {prec} {name}", lambda: wrapper(*args, tsel))
            exact = F.nw_fused_from_prepared(q, ivf.prep, C)
            torch.cuda.synchronize()
            routed = got if inv is None else got[inv][:q.shape[0]]
            err = float((got - want).abs().max())
            ok = bool(torch.isfinite(got).all()) and within(got, want, **HEAD_TOL[prec])
            agree = float((routed.argmax(1) == exact.argmax(1)).float().mean())
            pdiff = float((routed.exp() - exact.exp()).abs().max())
            b = _sel_bound(tsel, block_s, group_b or q.shape[0], D, prec, q.shape[0], C)
            timed = dict(
                ms=time_ms(lambda: wrapper(*args, tsel), flush),
                plain_ms=time_ms(lambda: F._nw_prepared_sel_plain(*args, tsel), flush),
                full_ms=time_ms(lambda: full(*args), flush))
            print(f"ivf {prec} {name} (n_probe {n_probe}, group_b {group_b}): list "
                  f"{tuple(tsel.shape)}, union {b['union_rows']} rows of {S}; vs plain "
                  f"max|err| {err:.3e} {'ok' if ok else 'FAIL'}; top-1 agreement with the "
                  f"exact head {agree:.4f}, max prob diff {pdiff:.2e}; K6 {timed['ms']:.4f} ms, "
                  f"plain {timed['plain_ms']:.4f} ms, full pass {timed['full_ms']:.4f} ms; "
                  f"bytes bound {b['bytes_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']})")
            if not ok:
                raise AssertionError(f"K6 disagrees with plain: {prec} {name}")
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r[name] = {"agreement": agree, "prob_diff": pdiff, **timed, **b}
            r[name].update(head_split(f"K6 {prec} {name}", lambda: wrapper(*args, tsel), flush))
        # Full probe: every tile, ascending, is the full pass.
        qk, tsel, _ = I._ivf_route(queries["skewed"], ivf, kernel="euclidean",
                                   kernel_params=None, n_probe=n_tiles, group_b=None)
        qq, scale, mode, qscale = F._prepared_query(qk, ivf.prep)
        got = wrapper(qq, ivf.prep, scale, mode, C, qscale, tsel)
        want = full(qq, ivf.prep, scale, mode, C, qscale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"ivf {prec} full probe ({tuple(tsel.shape)}): K6 vs the full pass max|err| "
              f"{err:.3e} {'ok' if within(got, want, 2e-4, 2e-4) else 'FAIL'}")
        if not within(got, want, 2e-4, 2e-4):
            raise AssertionError(f"K6 at full probe differs from the full pass: {prec}")
        del ivf
        torch.cuda.empty_cache()
    return res


class _FeatureTap:
    """The featurizer's last output, recorded by a forward hook (the
    features a serving call used)."""

    def __init__(self, module):
        self.out = None
        self.handle = module.register_forward_hook(self._hook)

    def _hook(self, module, inputs, output):
        self.out = output


def ivf_serving_phase(datasets, bank_cache: str) -> dict:
    """``python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch
    resnet18 --serve_mode ivf --latency_bench --bank_cache DIR`` through the
    serve module's functions, once per ``IVF_CONFIGS`` entry, the bank
    restored from the slice phase's cache. Counts K6's launches over the
    run (bank, calibration and requests), checks the served log-probs
    against the plain selected head on the features the request used, and
    prints p50 / p95 / queries/s and the resolved knobs."""
    import torch

    from nwhead_tpu_torch import serve
    from nwhead_tpu_torch.ops import fused_nw as F
    from nwhead_tpu_torch.ops import ivf as I

    train_ds, val_ds = datasets
    out = {}
    for name, flags in IVF_CONFIGS:
        args = serve.parse_args(IVF_SERVE_ARGV + flags + ["--bank_cache", bank_cache])
        t0 = time.perf_counter()
        _counts(reset=True)
        net = serve.build_server(args, train_ds, val_ds=val_ds)
        report = serve.latency_bench(net, val_ds, args)
        torch.cuda.synchronize()
        launches = _counts()
        wrapper = SEL_WRAPPER[args.head_precision]
        if launches[wrapper] == 0:
            raise AssertionError(f"ivf {name}: the serving path never launched K6")
        tap = _FeatureTap(net.model.featurizer)
        x = val_ds.gather(np.arange(args.batch_size))
        served = net.make_serving_fn(mode="ivf")(x)
        tap.handle.remove()
        with torch.inference_mode():
            ivf = net._ivf_bank()
            params = net.model.head.kernel_params()
            qk, tsel, inv = I._ivf_route(tap.out, ivf, kernel=net.kernel_type,
                                         kernel_params=params,
                                         n_probe=min(net.ivf_n_probe, ivf.cents.shape[0]),
                                         group_b=net.ivf_group_b)
            q, scale, mode, qscale = F._prepared_query(qk, ivf.prep, net.kernel_type, params)
            plain = F._nw_prepared_sel_plain(q, ivf.prep, scale, mode, net.n_classes, qscale,
                                             tsel)
            plain = plain if inv is None else plain[inv][:args.batch_size]
        torch.cuda.synchronize()
        err = float((served - plain).abs().max())
        ok = (tuple(served.shape) == (args.batch_size, net.n_classes)
              and bool(torch.isfinite(served).all())
              and within(served, plain, **HEAD_TOL[args.head_precision]))
        seconds = time.perf_counter() - t0
        print(f"ivf serving {name}: bank {ivf.cents.shape[0]} tiles of {ivf.prep.block_s} "
              f"({args.head_precision}); n_probe {net.ivf_n_probe}, group_b {net.ivf_group_b}; "
              f"K6 launches {launches[wrapper]} (full-pass kernels "
              f"{launches[HEAD_WRAPPERS[args.head_precision]]}); served vs plain max|err| "
              f"{err:.3e} {'ok' if ok else 'FAIL'}; p50 {report['p50_ms']:.3f} ms, p95 "
              f"{report['p95_ms']:.3f} ms, {report['queries_per_sec']:.1f} q/s; {seconds:.1f}s")
        if not ok:
            raise AssertionError(f"ivf {name}: served log-probs disagree with the plain head")
        out[name] = {"launches": launches[wrapper], "precision": args.head_precision,
                     "report": report, "served_err": err}
        del net
        torch.cuda.empty_cache()
    return out


def ivf_entries(kern: dict, served: dict) -> list:
    """The ``kernels`` JSON entries of K6, one per bank precision: launches
    from the IVF serving runs at that precision, times and bound from the
    kernel phase's skewed batch (its full pass over the same bank as
    ``full_ms``), max |err| over both phases."""
    entries = []
    for prec, r in kern.items():
        runs = [v for v in served.values() if v["precision"] == prec]
        sk = r["skewed"]
        entries.append({
            "name": f"nw_prepared_sel_{prec}", "route": "cuda", "source": PREPARED_SOURCE,
            "replaces": IVF_REPLACES, "launches": sum(v["launches"] for v in runs),
            "max_abs_err": max([r["max_abs_err"]] + [v["served_err"] for v in runs]),
            "ms": sk["ms"], "plain_ms": sk["plain_ms"], "bound_ms": sk["bound_ms"],
            "bound_by": sk["bound_by"], "library_ms": None, "full_ms": sk["full_ms"],
            "union_rows": sk["union_rows"], "diverse_ms": r["diverse"]["ms"]})
    return entries


# ---------------------------------------------------------------------------
# Support-sharded serving: K1 and K2/K4/K5/K6 partials=True, and K12 over K7.
# ---------------------------------------------------------------------------

PARTIAL_CASES = (  # name, B, S, D, C; the last is a streamed chunk's shape, timed
    ("episode_b8", 8, 1200, 512, 200),
    ("head_raw_b64", 64, 5994, 512, 200),
    ("stream_chunk", 64, 65_536, 512, 1000),
)
# Partials held to their plain versions: rtol = atol, bf16 as its log-probs.
PARTIALS_TOL = {"f32": 2e-4, "bf16": 2e-3, "int8": 2e-4, "int4": 2e-4}
PARTIALS_WRAPPER = {"f32": "nw_prepared_partials_cuda", "bf16": "nw_prepared_partials_cuda",
                    "int8": "nw_prepared_partials_int8_cuda",
                    "int4": "nw_prepared_partials_int4_cuda"}
SEL_PARTIALS_WRAPPER = {"f32": "nw_prepared_sel_partials_cuda",
                        "bf16": "nw_prepared_sel_partials_cuda",
                        "int8": "nw_prepared_sel_partials_quant_cuda",
                        "int4": "nw_prepared_sel_partials_quant_cuda"}
K12_CASES = (("vit_s14_b64", VIT_B, VIT_H, VIT_N, 64), ("ragged_n197", VIT_B, VIT_H, 197, 64))
K12_REPLACES = "nwhead_tpu/ops/pallas_attn.py:44"
SHARDS = 4  # support shards on the one card
SHARD_LIVE = 1_000_000  # rows of the million-row bank served; the last 48,576 are masked
SHARD_PROBE = 8
STREAM_CHUNK = 65_536  # rows a host chunk: 16 chunks, the last padded with masked rows
MESH_SERVE_ARGV = ["--dataset", "synthetic_cub", "--arch", "resnet18", "--batch_size", "64",
                   "--mesh", "1,1", "--latency_bench"]
MESH_CONFIGS = (("f32", []), ("int8", ["--head_precision", "int8"]))


def partials_agree(got, want, prec: str):
    """Kernel partials ``(m, l, acc)`` against the plain version's, each
    within ``PARTIALS_TOL``; a query with no valid row must read the same
    (the finite -inf, 0, 0) on both. Returns (ok, max |err|)."""
    import torch

    tol = PARTIALS_TOL[prec]
    ok = all(bool(torch.isfinite(g).all()) and within(g, w, tol, tol) for g, w in zip(got, want))
    return ok, max(float((g - w).abs().max()) for g, w in zip(got, want))


def _timed(res: dict, flush, kernel, plain, n_bytes, flops, prec, fin=None, **more) -> None:
    """Kernel and plain ms, more keys' ms (name -> fn) and the bound into
    ``res``. With ``fin``, the finalizing route on the same inputs, kernel
    and ``fin`` are timed in turns (kernel, fin, fin, kernel) and each reads
    the mean of its two medians (``fin_ms``)."""
    if fin is None:
        res["ms"] = time_ms(kernel, flush)
    else:
        k1, f1, f2, k2 = (time_ms(fn, flush) for fn in (kernel, fin, fin, kernel))
        res.update(ms=(k1 + k2) / 2, fin_ms=(f1 + f2) / 2)
    res.update(plain_ms=time_ms(plain, flush), **{k: time_ms(fn, flush) for k, fn in more.items()},
               **bound(n_bytes, flops, prec))


def sharded_kernel_phase(flush) -> dict:
    """K1 ``partials=True`` against its plain version, all five kernels,
    f32 and bf16, masked rows holding NaN, at the training episode's shape
    (B=8, S=1,200), at B=64, S=5,994 and at a streamed chunk's (B=64,
    65,536 rows, C=1,000), and an all-masked support; K2/K4/K5
    ``partials=True`` at the CUB shape, all five kernels and every bank
    precision, and K6 ``partials=True`` there over the list [3, -1, 0, 5,
    -1] of 1,024-row tiles; K12 (K7's kernel on q, k, v by their strides)
    f32 and bf16 at ViT-S/14's B=64, H=6, N=257, hd=64 and at N=197. Each
    timed beside its plain version (the finalizing K1/K2/K4/K5 as
    ``fin_ms``, SDPA beside K12).
    Returns per wrapper and precision max |err|, times and bound."""
    import warnings

    import torch
    import torch.nn.functional as TF

    from nwhead_tpu_torch.ops import fused_attn as FA
    from nwhead_tpu_torch.ops import fused_nw as F
    from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES

    dev = torch.device("cuda")
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    res = {"nw_fwd_partials": {p: {"max_abs_err": 0.0} for p in dtypes},
           "nw_prepared_partials": {p: {"max_abs_err": 0.0} for p in PARTIALS_WRAPPER},
           "nw_prepared_sel_partials": {p: {"max_abs_err": 0.0} for p in PARTIALS_WRAPPER},
           "fused_attention": {p: {"max_abs_err": 0.0} for p in dtypes}}
    for ci, (case, B, S, D, C) in enumerate(PARTIAL_CASES):
        rng = np.random.default_rng(1300 + ci)
        q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
        s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
        valid = rng.random(S) > 0.03
        s[torch.from_numpy(~valid).to(dev)] = float("nan")
        labels = torch.from_numpy(
            np.where(valid, rng.integers(0, C, size=S), -1).astype(np.int32)).to(dev)
        for kernel in KERNEL_NAMES:
            params = {"logit_scale": torch.tensor(1.3, device=dev)} if kernel == "clip" else {}
            for prec, dt in dtypes.items():
                mode, scale, qn, sn = F._resolve_mode(kernel, params, q.to(dt), s.to(dt))
                qn, sn = qn.to(sn.dtype).contiguous(), sn.contiguous()
                for lab in (labels, torch.full_like(labels, -1)) if ci == 0 else (labels,):
                    args = (qn, sn, lab, scale, mode, C)
                    got, want = F.nw_fwd_partials_cuda(*args), F._nw_fwd_partials_plain(*args)
                    same_bits(f"K1 partials {case} {kernel} {prec}",
                              lambda: F.nw_fwd_partials_cuda(*args))
                    torch.cuda.synchronize()
                    ok, err = partials_agree(got, want, prec)
                    where = f"{case} {kernel} {prec}{' all masked' if lab is not labels else ''}"
                    print(f"K1 partials {where}: max|err| {err:.3e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"K1 partials disagree with plain: {where}")
                    r = res["nw_fwd_partials"][prec]
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                if kernel == "euclidean" and ci > 0:
                    args = (qn, sn, labels, scale, mode, C)
                    t = {}
                    _timed(t, flush, lambda: F.nw_fwd_partials_cuda(*args),
                           lambda: F._nw_fwd_partials_plain(*args),
                           (B + S) * D * sn.element_size() + 4 * (S + 1) + 4 * B * (C + 2),
                           2 * B * S * D + 2 * S * D, prec,
                           fin=lambda: F.nw_fwd_cuda(*args))
                    print(f"time K1 partials {case} {prec}: kernel {t['ms']:.4f} ms (finalizing "
                          f"K1 {t['fin_ms']:.4f}), plain {t['plain_ms']:.4f} ms, bound "
                          f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
                    res["nw_fwd_partials"][prec][case] = t
                    if case == "stream_chunk":
                        res["nw_fwd_partials"][prec].update(t)
    # K2/K4/K5 partials at the CUB shape; K6 partials over a list of its
    # 1,024-row tiles with empty slots.
    B, S, D, C = 64, 5994, 512, 200
    rng = np.random.default_rng(1400)
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
    s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
    sy = rng.integers(0, C, size=S)
    valid = rng.random(S) > 0.03
    s[torch.from_numpy(~valid).to(dev)] = float("nan")
    mask = torch.from_numpy(valid.astype(np.float32))
    for kernel in KERNEL_NAMES:
        params = {"logit_scale": torch.tensor(1.3, device=dev)} if kernel == "clip" else {}
        for prec, name in PARTIALS_WRAPPER.items():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # int4 + dotproduct warns
                prep = F.prepare_support(s, sy, C, kernel=kernel, support_mask=mask,
                                         precision=prec)
                tiled = F.prepare_support(s, sy, C, kernel=kernel, support_mask=mask,
                                          precision=prec, block_s=1024)
            qq, scale, mode, qscale = F._prepared_query(q, prep, kernel, params)
            args = (qq, prep, scale, mode, C, qscale)
            wrapper = getattr(F, name)
            got, want = wrapper(*args), F._nw_prepared_plain(*args, partials=True)
            tsel = torch.tensor([3, -1, 0, 5, -1], dtype=torch.int32, device=dev)
            sargs = (*F._prepared_query(q, tiled, kernel, params), tsel)
            sargs = (sargs[0], tiled, sargs[1], sargs[2], C, sargs[3], tsel)
            sel = getattr(F, SEL_PARTIALS_WRAPPER[prec])
            got_sel = sel(*sargs)
            want_sel = F._nw_prepared_sel_plain(*sargs, partials=True)
            torch.cuda.synchronize()
            ok, err = partials_agree(got, want, prec)
            ok_sel, err_sel = partials_agree(got_sel, want_sel, prec)
            print(f"K2/K4/K5 partials cub_b64 {kernel} {prec}: max|err| {err:.3e} "
                  f"{'ok' if ok else 'FAIL'}; K6 partials over tiles [3, -1, 0, 5, -1] "
                  f"max|err| {err_sel:.3e} {'ok' if ok_sel else 'FAIL'}")
            if not (ok and ok_sel):
                raise AssertionError(f"prepared partials disagree with plain: {kernel} {prec}")
            r = res["nw_prepared_partials"][prec]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            rs = res["nw_prepared_sel_partials"][prec]
            rs["max_abs_err"] = max(rs["max_abs_err"], err_sel)
            if kernel == "euclidean":
                Dp, item = qq.shape[1], prep.s.element_size()
                n_bytes = B * Dp * qq.element_size() + prep.s.numel() * item + 4 * (
                    (3 if qscale is not None else 2) * S + 1 + B * (C + 2))
                fin = getattr(F, HEAD_WRAPPERS[prec])
                _timed(r, flush, lambda: wrapper(*args),
                       lambda: F._nw_prepared_plain(*args, partials=True), n_bytes,
                       2 * B * S * Dp, "int8" if qscale is not None else prec,
                       fin=lambda: fin(*args))
                print(f"time K2/K4/K5 partials cub_b64 {prec}: kernel {r['ms']:.4f} ms "
                      f"(finalizing {r['fin_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    # K12 over K7.
    for ci, (case, B, H, N, hd) in enumerate(K12_CASES):
        rng = np.random.default_rng(1500 + ci)
        qkv32 = [torch.from_numpy(rng.standard_normal((B, H, N, hd), np.float32)).to(dev)
                 for _ in range(3)]
        for prec, dt in dtypes.items():
            q, k, v = (t.to(dt) for t in qkv32)
            got, want = FA.fused_attention_cuda(q, k, v, hd ** -0.5), \
                FA._attention_plain(q, k, v, hd ** -0.5)
            torch.cuda.synchronize()
            ok, err, rel, cos = vit_agree(got, want, prec)
            print(f"K12 {case} {prec}: max|err| {err:.3e}, rel {rel:.2e}, cos {cos:.7f} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K12 disagrees with its plain version: {case} {prec}")
            r = res["fused_attention"][prec]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if ci == 0:
                _timed(r, flush, lambda: FA.fused_attention_cuda(q, k, v, hd ** -0.5),
                       lambda: FA._attention_plain(q, k, v, hd ** -0.5),
                       4 * B * H * N * hd * q.element_size(), 4 * B * H * N * N * hd, prec,
                       library_ms=lambda: TF.scaled_dot_product_attention(q, k, v))
                print(f"time K12 {case} {prec}: kernel {r['ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return res


def sharded_serving_phase(flush, bank) -> dict:
    """The million-row bank (``bank``, the K6 phase's; its last 48,576 rows
    masked) served four ways, per bank precision: (1) the unsharded full
    pass (K2/K4/K5), whose partials route is held to its plain version and
    timed; (2) ``ShardedSupportBank`` on ``make_mesh(1, 4, devices=[cuda:0]
    * 4)`` (four shards of 250,000 rows, ``ivf=True``), its full predict
    (four K2/K4/K5 ``partials=True`` launches and the merge) held to the
    full pass within 2e-4 (bf16 2e-3) and timed beside it; (3) its routed
    predict on the skewed batch at ``ivf_n_probe=8`` (four K6 ``partials=True``
    launches): top-1 agreement and the largest probability difference
    against the exact head, one shard's routed list held to its plain
    version and timed; (4) at f32, ``nw_streaming_log_probs`` over the same
    rows from the host in 16 chunks of 65,536 (K1 ``partials=True`` 16
    times) against the full pass. Returns per precision the launches,
    errors and times."""
    import torch

    from nwhead_tpu_torch.nw.streaming import nw_streaming_log_probs
    from nwhead_tpu_torch.ops import fused_nw as F
    from nwhead_tpu_torch.ops import ivf as I
    from nwhead_tpu_torch.parallel import ShardedSupportBank, make_mesh

    dev = torch.device("cuda")
    s, sy, cents = bank
    S, D, C, _ = IVF_BANK
    queries = _ivf_queries(cents, dev)
    q, skewed = queries["skewed"], queries["skewed"]
    mask = torch.zeros(S)
    mask[:SHARD_LIVE] = 1.0
    mesh = make_mesh(1, SHARDS, devices=[dev] * SHARDS)
    res = {}
    for prec, name in PARTIALS_WRAPPER.items():
        r = res[prec] = {}
        t0 = time.perf_counter()
        prep = F.prepare_support(s, sy, C, precision=prec, support_mask=mask)
        qq, scale, mode, qscale = F._prepared_query(q, prep)
        args = (qq, prep, scale, mode, C, qscale)
        wrapper, full = getattr(F, name), getattr(F, HEAD_WRAPPERS[prec])
        got, want = wrapper(*args), F._nw_prepared_plain(*args, partials=True)
        exact = full(*args)
        torch.cuda.synchronize()
        ok, err = partials_agree(got, want, prec)
        print(f"sharded {prec}: unsharded bank prepared in {time.perf_counter() - t0:.1f}s; "
              f"K2/K4/K5 partials over {S} rows vs plain max|err| {err:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"prepared partials disagree with plain on the bank: {prec}")
        item, Dp = prep.s.element_size(), qq.shape[1]
        _timed(r, flush, lambda: wrapper(*args),
               lambda: F._nw_prepared_plain(*args, partials=True),
               64 * Dp * qq.element_size() + prep.s.numel() * item + 4 * (
                   (3 if qscale is not None else 2) * S + 1 + 64 * (C + 2)),
               2 * 64 * SHARD_LIVE * Dp, "int8" if qscale is not None else prec,
               fin=lambda: full(*args))
        r["max_abs_err"] = err
        kname = {"int8": "K4", "int4": "K5"}.get(prec, "K2")
        r["full_split"] = head_split(f"{kname} {prec} million-row bank", lambda: full(*args),
                                     flush)
        r["split"] = head_split(f"{kname} partials {prec} million-row bank",
                                lambda: wrapper(*args), flush)
        t0 = time.perf_counter()
        sharded = ShardedSupportBank.build(s[:SHARD_LIVE], sy[:SHARD_LIVE], mesh, C,
                                           precision=prec, use_prepared=True, ivf=True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        predict, routed = sharded.predict_fn(), sharded.predict_fn(ivf_n_probe=SHARD_PROBE)
        _counts(reset=True)
        out = predict(q)
        torch.cuda.synchronize()
        r["launches"] = _counts()[name]
        out_err = float((out - exact).abs().max())
        tol = HEAD_TOL[prec]
        ok = (r["launches"] == SHARDS and tuple(out.shape) == (64, C)
              and bool(torch.isfinite(out).all()) and within(out, exact, **tol))
        r.update(sharded_err=out_err, sharded_ms=time_ms(lambda: predict(q), flush),
                 build_s=build_s)
        r["full_ms"] = r["fin_ms"]
        print(f"sharded {prec}: {SHARDS} shards of {sharded.local} rows built in {build_s:.1f}s; "
              f"full predict {r['launches']} launches, vs the unsharded full pass max|err| "
              f"{out_err:.3e} {'ok' if ok else 'FAIL'}; sharded {r['sharded_ms']:.4f} ms, "
              f"unsharded {r['full_ms']:.4f} ms, partials kernel {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, {r['bound_by']})")
        if not ok:
            raise AssertionError(f"the sharded bank disagrees with the full pass: {prec}")
        one = sharded.shards[0][dev].ivf.prep
        oq, oscale, omode, oqscale = F._prepared_query(q, one)
        r["shard_split"] = head_split(f"K2/K4/K5 partials {prec} one shard",
                                      lambda: wrapper(oq, one, oscale, omode, C, oqscale), flush)
        # Routed: each shard's own tiles, K6 partials.
        sel_name = SEL_PARTIALS_WRAPPER[prec]
        _counts(reset=True)
        out = routed(skewed)
        torch.cuda.synchronize()
        r["sel_launches"] = _counts()[sel_name]
        agree = float((out.argmax(1) == exact.argmax(1)).float().mean())
        pdiff = float((out.exp() - exact.exp()).abs().max())
        shard = sharded.shards[0][dev].ivf
        qk, tsel, _ = I._ivf_route(skewed, shard, kernel="euclidean", kernel_params=None,
                                   n_probe=SHARD_PROBE, group_b=None)
        sq, scale, mode, qscale = F._prepared_query(qk, shard.prep)
        sargs = (sq, shard.prep, scale, mode, C, qscale, tsel)
        sel = getattr(F, sel_name)
        got, want = sel(*sargs), F._nw_prepared_sel_plain(*sargs, partials=True)
        torch.cuda.synchronize()
        ok, sel_err = partials_agree(got, want, prec)
        b = _sel_bound(tsel, shard.prep.block_s, 64, D, prec, 64, C)
        r["sel"] = dict(max_abs_err=sel_err, ms=time_ms(lambda: sel(*sargs), flush),
                        plain_ms=time_ms(lambda: F._nw_prepared_sel_plain(*sargs, partials=True),
                                         flush), routed_ms=time_ms(lambda: routed(skewed), flush),
                        agreement=agree, prob_diff=pdiff, **b)
        print(f"sharded {prec} routed (n_probe {SHARD_PROBE}): {r['sel_launches']} K6 partials "
              f"launches; top-1 agreement with the exact head {agree:.4f}, max prob diff "
              f"{pdiff:.2e}; shard 0's list {tuple(tsel.shape)}, union {b['union_rows']} rows, "
              f"vs plain max|err| {sel_err:.3e} {'ok' if ok else 'FAIL'}; K6 partials "
              f"{r['sel']['ms']:.4f} ms, plain {r['sel']['plain_ms']:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); routed predict "
              f"{r['sel']['routed_ms']:.4f} ms")
        if not ok or r["sel_launches"] != SHARDS:
            raise AssertionError(f"K6 partials on a shard's routed list: {prec}")
        if prec == "f32":
            host = s[:SHARD_LIVE].cpu().numpy()
            chunks = [(host[i:i + STREAM_CHUNK], sy[i:min(i + STREAM_CHUNK, SHARD_LIVE)])
                      for i in range(0, SHARD_LIVE, STREAM_CHUNK)]
            seconds = []
            for rep in range(2):
                _counts(reset=True)
                t0 = time.perf_counter()
                out = nw_streaming_log_probs(q, chunks, C, chunk_size=STREAM_CHUNK)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                if rep == 0:
                    stream_launches = _counts()["nw_fwd_partials_cuda"]
            err = float((out - exact).abs().max())
            ok = stream_launches == len(chunks) and within(out, exact, 2e-4, 2e-4)
            r["stream"] = {"launches": stream_launches, "chunks": len(chunks), "err": err,
                           "seconds": seconds}
            print(f"streaming: {len(chunks)} host chunks of {STREAM_CHUNK} rows, K1 partials "
                  f"{stream_launches} launches, vs the full pass max|err| {err:.3e} "
                  f"{'ok' if ok else 'FAIL'}; {seconds[0]:.3f} s, then {seconds[1]:.3f} s")
            if not ok:
                raise AssertionError("streaming disagrees with the full pass")
            del host, chunks
        del prep, sharded, predict, routed
        torch.cuda.empty_cache()
    return res


def mesh_serving_phase(datasets, bank_cache: str) -> dict:
    """``python -m nwhead_tpu_torch.serve --dataset synthetic_cub --arch
    resnet18 --batch_size 64 --mesh 1,1 --latency_bench --bank_cache DIR``
    through the serve module's functions with an f32 and an int8 head (the
    bank restored from the slice phase's cache): one prepared partials
    launch (K2 or K4 ``partials=True``) per request and no finalizing head,
    the served log-probs against the plain head's partials on the shard,
    merged, on the features the request used."""
    import torch

    from nwhead_tpu_torch import serve
    from nwhead_tpu_torch.ops import fused_nw as F
    from nwhead_tpu_torch.parallel import merge_partials

    train_ds, val_ds = datasets
    out = {}
    for prec, flags in MESH_CONFIGS:
        args = serve.parse_args(MESH_SERVE_ARGV + flags + ["--bank_cache", bank_cache])
        _counts(reset=True)
        net = serve.build_server(args, train_ds)
        report = serve.latency_bench(net, val_ds, args)
        torch.cuda.synchronize()
        counts = _counts()
        launches, requests = counts[PARTIALS_WRAPPER[prec]], report["batches"] + 3
        tap = _FeatureTap(net.model.featurizer)
        x = val_ds.gather(np.arange(args.batch_size))
        served = net.make_serving_fn()(x)
        tap.handle.remove()
        with torch.inference_mode():
            (shard,) = net.sharded_bank.shards[0].values()
            params = net.model.head.kernel_params()
            qq, scale, mode, qscale = F._prepared_query(tap.out, shard.ivf.prep, net.kernel_type,
                                                        params)
            plain = merge_partials([F._nw_prepared_plain(qq, shard.ivf.prep, scale, mode,
                                                         net.n_classes, qscale, partials=True)])
        torch.cuda.synchronize()
        err = float((served - plain).abs().max())
        ok = (launches == requests and counts[HEAD_WRAPPERS[prec]] == 0
              and tuple(served.shape) == (args.batch_size, net.n_classes)
              and bool(torch.isfinite(served).all()) and within(served, plain, **HEAD_TOL[prec])
              and report["mesh"] == {"data": 1, "support": 1, "model": 1})
        print(f"mesh serving {prec} (--mesh 1,1): bank {net.sharded_bank.capacity} rows in one "
              f"shard; {launches} partials launches for {requests} requests, finalizing head "
              f"{counts[HEAD_WRAPPERS[prec]]}; served vs plain max|err| {err:.3e} "
              f"{'ok' if ok else 'FAIL'}; p50 {report['p50_ms']:.3f} ms, p95 "
              f"{report['p95_ms']:.3f} ms, {report['queries_per_sec']:.1f} q/s")
        if not ok:
            raise AssertionError(f"mesh serving {prec}: launches or served log-probs wrong")
        out[prec] = {"launches": launches, "report": report, "served_err": err}
        del net
        torch.cuda.empty_cache()
    return out


def sharded_entries(kern: dict, served: dict, mesh: dict, retrieval: dict) -> list:
    """The ``kernels`` JSON entries of K1 ``partials=True`` (launches: the
    streaming run and the retrieval phase's sharded ensemble; times at a
    streamed chunk's shape), K2/K4/K5
    ``partials=True`` (launches: the sharded bank's full predict and the
    ``--mesh 1,1`` serving runs; times at the CUB shape), K6
    ``partials=True`` (launches: the routed sharded predict; times on one
    shard's routed list) and K12 (no main path runs it; SDPA as the
    library call)."""
    common = dict(route="cuda", library_ms=None)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    entries = []
    for prec, r in kern["nw_fwd_partials"].items():
        stream = served["f32"]["stream"]
        entries.append({"name": f"nw_fwd_partials_{prec}", "source": RAW_KERNELS["nw_fwd"][0],
                        "device_functions": RAW_KERNELS["nw_fwd"][1],
                        "replaces": REPLACES["nw_fwd"],
                        "launches": stream["launches"] + retrieval["launches"][
                            "sharded ensemble"]["nw_fwd_partials_cuda"] if prec == "f32" else 0,
                        "max_abs_err": max(r["max_abs_err"], retrieval["errs"]["sharded ensemble"]
                                           if prec == "f32" else 0.0),
                        **{k: r[k] for k in keys}, **common,
                        "fin_ms": r["fin_ms"], "head_raw_b64_ms": r["head_raw_b64"]["ms"],
                        "head_raw_b64_fin_ms": r["head_raw_b64"]["fin_ms"]})
    for prec, r in kern["nw_prepared_partials"].items():
        sv = served[prec]
        runs = mesh[prec]["launches"] if prec in mesh else 0
        entries.append({"name": f"nw_prepared_partials_{prec}", "source": PREPARED_SOURCE,
                        "replaces": REPLACES["nw_prepared"], "launches": sv["launches"] + runs,
                        "max_abs_err": max(r["max_abs_err"], sv["max_abs_err"],
                                           mesh[prec]["served_err"] if prec in mesh else 0.0),
                        **{k: r[k] for k in keys}, **common, "fin_ms": r["fin_ms"],
                        "bank_1m_ms": sv["ms"], "bank_1m_full_ms": sv["full_ms"],
                        "bank_1m_plain_ms": sv["plain_ms"], "bank_1m_bound_ms": sv["bound_ms"],
                        "sharded_1m_ms": sv["sharded_ms"]})
        sel = sv["sel"]
        entries.append({"name": f"nw_prepared_sel_partials_{prec}", "source": PREPARED_SOURCE,
                        "replaces": IVF_REPLACES, "launches": sv["sel_launches"],
                        "max_abs_err": max(sel["max_abs_err"],
                                           kern["nw_prepared_sel_partials"][prec]["max_abs_err"]),
                        **{k: sel[k] for k in keys}, **common,
                        "union_rows": sel["union_rows"], "routed_ms": sel["routed_ms"]})
    for prec, r in kern["fused_attention"].items():
        entries.append({"name": f"fused_attention_{prec}", "route": "cuda",
                        "source": ATTN_SOURCE, "replaces": K12_REPLACES, "launches": 0,
                        "max_abs_err": r["max_abs_err"], **{k: r[k] for k in keys},
                        "library_ms": r["library_ms"]})
    return entries


def _set_gammas(net) -> None:
    """LayerScale gammas of order 1 (uniform in [0.5, 1.5], seeded), in
    place of the init's 1e-5, under which every block adds almost nothing
    and a wrong K10 or K11 would pass every comparison."""
    import torch

    rng = np.random.default_rng(GAMMA_SEED)
    with torch.no_grad():
        for blk in net.model.featurizer.blocks:
            for g in (blk.ls1_gamma, blk.ls2_gamma):
                g.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, g.shape[0]).astype(np.float32)))


def vit_serving_phase(datasets, configs=VIT_CONFIGS) -> dict:
    """ViT serving commands through the serve module's functions
    (``VIT_CONFIGS``: the bf16 fused graph, ``--fused_inference`` and
    ``--fused_inference --bf16``; ``VIT_INT8_CONFIGS``: the int8 stack with
    an int8 and an int4 head), with LayerScale gammas of order 1 set before
    the featurizer is fused or quantized and the bank built. For each:
    launch counts per request and over the latency run, served features
    against the plain featurizer on the same images, served log-probs
    against the plain head, p50 / p95 / queries/s, the calibration's and
    the bank's seconds and peak device memory."""
    import torch

    from nwhead_tpu_torch import serve

    train_ds, val_ds = datasets
    out = {}
    for name, flags, kernels, head in configs:
        args = serve.parse_args(VIT_SERVE_ARGV + flags)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        net = serve.build_server(args, train_ds, edit=_set_gammas)
        print(f"vit {name}: LayerScale gammas set to U[0.5, 1.5] (seed {GAMMA_SEED}) before "
              "precompute, in place of the init's 1e-5")
        serve_fn = net.make_serving_fn()
        x = val_ds.gather(np.arange(args.batch_size))
        expect = {n: 0 for n in WRAPPERS}
        expect.update({n: 12 for n in kernels}, **{head: 1})
        _counts(reset=True)
        served = serve_fn(x)
        torch.cuda.synchronize()
        per_request = _counts()
        _counts(reset=True)
        report = serve.latency_bench(net, val_ds, args)
        torch.cuda.synchronize()
        launches = _counts()
        peak = torch.cuda.max_memory_allocated()
        requests = report["batches"] + 3  # the latency run's warm-up requests count too
        print(f"vit {name}: launches per request {per_request}; over the latency run's "
              f"{requests} requests {launches}")
        if per_request != expect or launches != {n: c * requests for n, c in expect.items()}:
            raise AssertionError(f"{name}: launches {per_request} per request, want {expect}")
        with torch.inference_mode():
            xt = torch.from_numpy(x).to(net.device)
            feats = net._featurize_eval(xt)
            with plain_vit_kernels():
                plain_feats = net._featurize_eval(xt)
            prep = net._prepared_full
            plain = plain_head(net, feats)
        torch.cuda.synchronize()
        prec = "bf16" if name != "fused_inference" else "f32"
        # The noise floor: the same plain featurizer on the CPU, 8 images.
        with torch.inference_mode():
            module = (net.model.featurizer if net.serving_featurizer is None
                      else net.serving_featurizer)
            cpu_feats = copy.deepcopy(module).cpu()(torch.from_numpy(x[:8]))
        _, _, floor_rel, floor_cos = vit_agree(plain_feats[:8].cpu(), cpu_feats, prec)
        f_ok, f_err, f_rel, f_cos = vit_agree(feats, plain_feats, prec, FEATURE_BF16_REL)
        lp_err = float((served - plain).abs().max())
        lp_ok = (tuple(served.shape) == (args.batch_size, net.n_classes)
                 and bool(torch.isfinite(served).all()) and within(served, plain, **TOL["f32"]))
        print(f"vit {name}: features (B={feats.shape[0]}, D={feats.shape[1]}) vs the plain "
              f"featurizer max|err| {f_err:.3e}, rel {f_rel:.2e}, cos {f_cos:.7f} "
              f"{'ok' if f_ok else 'FAIL'} (the plain featurizer on the card vs on the CPU, 8 "
              f"images: rel {floor_rel:.2e}, cos {floor_cos:.7f}); log-probs vs the plain head "
              f"max|err| {lp_err:.3e} {'ok' if lp_ok else 'FAIL'}; calibration "
              f"{net.calibration_seconds:.2f}s; bank S={prep.s.shape[0]} {prep.s.dtype} "
              f"{tuple(prep.s.shape)} prepared in {net.precompute_seconds:.2f}s; p50 "
              f"{report['p50_ms']:.3f} ms, "
              f"p95 {report['p95_ms']:.3f} ms, {report['queries_per_sec']:.1f} q/s; peak device "
              f"memory {peak / 2**30:.2f} GiB")
        if not (f_ok and lp_ok):
            raise AssertionError(f"{name}: served features or log-probs disagree")
        out[name] = {"launches": launches, "per_request": per_request, "report": report,
                     "feature_err": f_err, "logprob_err": lp_err,
                     "precompute_s": net.precompute_seconds,
                     "calibration_s": net.calibration_seconds, "peak_bytes": peak}
        del net, serve_fn
        torch.cuda.empty_cache()
    return out


def request_split(run: dict, kern: dict, name: str, attn: str, mlp: str) -> None:
    """A served ViT request's p50 beside its 12 K10 and 12 K11 launches at
    their kernel-phase times (the serving shape and folds, L2 flushed)."""
    p50, k10, k11 = run["report"]["p50_ms"], 12 * kern[attn]["ms"], 12 * kern[mlp]["ms"]
    print(f"vit {name}: p50 {p50:.3f} ms; 12 x K10 {k10:.3f} ms, 12 x K11 {k11:.3f} ms "
          f"(kernel phase times), the rest {p50 - k10 - k11:.3f} ms")


def vit_entries(kern: dict, served: dict) -> list:
    """The ``kernels`` JSON entries of K7, K9, K10 and K11: launches from
    the serving configuration that runs each."""
    runs = {  # entry: (serving configuration, wrapper, kernel)
        "attention_qkv_f32": ("fused_inference", "attention_qkv_cuda", "attention_qkv"),
        "attention_qkv_bf16": ("fused_inference_bf16", "attention_qkv_cuda", "attention_qkv"),
        "mlp_f32": ("fused_inference", "mlp_cuda", "mlp"),
        "mlp_bf16": ("fused_inference_bf16", "mlp_cuda", "mlp"),
        "attention_block_bf16": ("bf16_fused", "attention_block_bf16_cuda",
                                 "attention_block_bf16"),
        "mlp_block_bf16": ("bf16_fused", "mlp_block_bf16_cuda", "mlp_block_bf16"),
    }
    entries = []
    for key, (config, wrapper, kernel) in runs.items():
        r = kern[key]
        entries.append({
            "name": key, "route": "cuda",
            "source": ATTN_SOURCE if "attention" in key else MLP_SOURCE,
            "replaces": VIT_REPLACES[kernel], "launches": served[config]["launches"][wrapper],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{t: r[t] for t in TURNS_KEYS if t in r}})
    return entries


# ---------------------------------------------------------------------------
# ViT training: K8 and the K9 backward.
# ---------------------------------------------------------------------------

ATTN_BWD_SOURCE = "nwhead_tpu_torch/csrc/vit_attn_bwd.cu"
MLP_BWD_SOURCE = "nwhead_tpu_torch/csrc/vit_mlp_bwd.cu"
VIT_BWD_REPLACES = {
    "attention_qkv_bwd": "nwhead_tpu/ops/pallas_attn.py:120",
    "mlp_bwd": "nwhead_tpu/ops/pallas_mlp.py:61",
}
ATTN_BWD_CASES = ATTN_CASES[:2] + (  # name, B, N, H, hd; the first is timed
    ("n1370_b8", 8, 1370, VIT_H, 64),
    ATTN_CASES[3],
    ("hd32_b64", VIT_B, VIT_N, 12, 32),
) + ATTN_EDGE_CASES
FUSED = {"attn_impl": "fused", "mlp_impl": "fused"}
VIT_TRAIN_ARGV = [
    "--dataset", "synthetic_cub", "--arch", "vit_s14", "--batch_size", "8", "--n_shot", "6",
    "--lr", "1e-3", "--num_epochs", "1", "--num_steps_per_epoch", "5",
    "--num_val_steps_per_epoch", "3",
]
VIT_BLOCKS = 12
# Per training step: each block's backward kernels once, the fused head once.
VIT_STEP_LAUNCHES = {"attention_qkv_bwd_cuda": VIT_BLOCKS, "mlp_bwd_cuda": VIT_BLOCKS,
                     "nw_fwd_cuda": 1, "nw_bwd_dq_cuda": 1, "nw_bwd_ds_cuda": 1}


def check_grads(got, want, prec: str, names, where: str) -> float:
    """Each gradient within ``GRAD_REL[prec]`` of its plain version's max,
    finite, with the plain version's shape and dtype; raises otherwise.
    Returns the largest max |err|."""
    import torch

    rels, worst = [], 0.0
    for name, a, b in zip(names, got, want):
        ok = (a.shape == b.shape and a.dtype == b.dtype and bool(torch.isfinite(a).all()))
        rel = rel_err(a, b)
        rels.append(f"{name} {rel:.2e}")
        worst = max(worst, float((a.float() - b.float()).abs().max()))
        if not ok or rel > GRAD_REL[prec]:
            raise AssertionError(f"{where} {prec}: {name} disagrees with the plain version "
                                 f"(rel {rel:.2e})")
    print(f"{where} {prec}: rel " + ", ".join(rels) + " ok")
    return worst


def _qkv_parts(t, D):
    return [t[..., i * D:(i + 1) * D] for i in range(3)]


def vit_train_kernel_phase(flush) -> dict:
    """K8 and the K9 backward (f32 and bf16) against their plain versions on
    the card; times each at B=64, K8 beside the SDPA backward. Returns, per
    entry, max |err|, kernel, plain and library ms and the bound."""
    import torch
    import torch.nn.functional as TF

    from nwhead_tpu_torch.ops import fused_attn as FA
    from nwhead_tpu_torch.ops import fused_mlp as FM

    dev = torch.device("cuda")
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    res: dict = {}
    for ci, (case, B, N, H, hd) in enumerate(ATTN_BWD_CASES):
        rng = np.random.default_rng(600 + ci)
        qkv32 = torch.from_numpy(rng.standard_normal((B, N, 3 * H * hd), np.float32)).to(dev)
        g32 = torch.from_numpy(rng.standard_normal((B, N, H * hd), np.float32)).to(dev)
        for prec, dt in dtypes.items():
            qkv, g, key = qkv32.to(dt), g32.to(dt), f"attention_qkv_bwd_{prec}"
            got = FA.attention_qkv_bwd_cuda(qkv, g, H, hd ** -0.5)
            want = FA._attention_qkv_bwd_plain(qkv, g, H, hd ** -0.5)
            torch.cuda.synchronize()
            err = check_grads(_qkv_parts(got, H * hd), _qkv_parts(want, H * hd), prec,
                              ("dq", "dk", "dv"), f"K8 {case}")
            _vit_record(res, key, err)
            if ci == 0:
                q, k, v = (t.permute(0, 2, 1, 3).contiguous().requires_grad_(True)
                           for t in qkv.reshape(B, N, 3, H, hd).unbind(2))
                out = TF.scaled_dot_product_attention(q, k, v)
                g_heads = g.reshape(B, N, H, hd).permute(0, 2, 1, 3).contiguous()
                item = qkv.element_size()
                sdpa_bwd = lambda: torch.autograd.grad(out, (q, k, v), g_heads,  # noqa: E731
                                                       retain_graph=True)
                _vit_timed(res, key, flush, lambda: FA.attention_qkv_bwd_cuda(qkv, g, H, hd ** -0.5),
                           lambda: FA._attention_qkv_bwd_plain(qkv, g, H, hd ** -0.5),
                           7 * B * N * H * hd * item, 10 * B * H * N * N * hd, prec,
                           library=sdpa_bwd)
                _turns_with_library(res[key], "K8",
                                    lambda: FA.attention_qkv_bwd_cuda(qkv, g, H, hd ** -0.5),
                                    "SDPA backward", sdpa_bwd)
                del q, k, v, out
    D, Dh = VIT_D, VIT_DH
    rng = np.random.default_rng(700)
    w1, b1, w2, b2 = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.standard_normal((D, Dh)) / np.sqrt(D), 0.1 * rng.standard_normal(Dh),
        rng.standard_normal((Dh, D)) / np.sqrt(Dh), 0.1 * rng.standard_normal(D)))
    for ci, (case, M) in enumerate(MLP_CASES):
        rng = np.random.default_rng(800 + ci)
        x32 = torch.from_numpy(rng.standard_normal((M, D), np.float32)).to(dev)
        g32 = torch.from_numpy(rng.standard_normal((M, D), np.float32)).to(dev)
        for prec, dt in dtypes.items():
            args = (x32.to(dt), w1.to(dt), b1, w2.to(dt), b2, g32.to(dt))
            key = f"mlp_bwd_{prec}"
            got, want = FM.mlp_bwd_cuda(*args), FM._mlp_bwd_plain(*args)
            torch.cuda.synchronize()
            err = check_grads(got, want, prec, ("dx", "dw1", "db1", "dw2", "db2"),
                              f"K9 backward {case}")
            _vit_record(res, key, err)
            if ci == 0:
                item = x32.to(dt).element_size()
                _vit_timed(res, key, flush, lambda: FM.mlp_bwd_cuda(*args),
                           lambda: FM._mlp_bwd_plain(*args),
                           3 * M * D * item + 4 * D * Dh * item + 4 * (2 * Dh + D),
                           10 * M * D * Dh, prec)
    _mlp_vit_b(res, flush, backward=True)
    return res


def _capture_first(module, name: str, store: dict):
    """Stand in for ``module.name`` (a kernel wrapper), calling it, and copy
    the first call's arguments into ``store``, tensors to host memory (so
    that the run's peak device memory is its own); returns the function
    that puts the wrapper back. The wrapper counts its launches into
    whatever its module holds under its name, so the stand-in carries the
    count while it is in place and hands it back."""
    import torch

    wrapper = getattr(module, name)

    def capturing(*args):
        if not store:
            store["args"] = tuple(a.detach().cpu() if torch.is_tensor(a) else a for a in args)
        return wrapper(*args)

    def restore():
        wrapper.launches = capturing.launches
        setattr(module, name, wrapper)

    capturing.launches = wrapper.launches
    setattr(module, name, capturing)
    return restore


def step_attention_times(label: str, qkv, g, H: int, scale: float, flush) -> dict:
    """K7 and K8 at a training step's own shapes (the tensors the step gave
    K8), median of 5 by ``time_ms``, each beside its bound (as at B=64: K7
    reads q, k, v and writes the output, 4 B N D elements, and does two
    products of 2 N^2 hd a (batch, head); K8 reads q, k, v, dO and writes
    dq, dk, dv, 7 B N D, and does five) and beside SDPA on the same data:
    ``F.scaled_dot_product_attention`` forward, and its backward by
    ``torch.autograd.grad``, timed only. Prints one line each."""
    import torch
    import torch.nn.functional as TF

    from nwhead_tpu_torch.ops import fused_attn as FA

    B, N = qkv.shape[:2]
    D = qkv.shape[-1] // 3
    hd, item = D // H, qkv.element_size()
    prec = "bf16" if qkv.dtype == torch.bfloat16 else "f32"
    q, k, v = (t.permute(0, 2, 1, 3).contiguous().requires_grad_(True)
               for t in qkv.reshape(B, N, 3, H, hd).unbind(2))
    out = TF.scaled_dot_product_attention(q, k, v)
    g_heads = g.reshape(B, N, H, hd).permute(0, 2, 1, 3).contiguous()
    res = {
        "K7": {"ms": time_ms(lambda: FA.attention_qkv_cuda(qkv, H, scale), flush, n=5),
               "library_ms": time_ms(lambda: TF.scaled_dot_product_attention(q, k, v), flush,
                                     n=5),
               **bound(4 * B * N * D * item, 2 * 2 * B * N * N * D, prec)},
        "K8": {"ms": time_ms(lambda: FA.attention_qkv_bwd_cuda(qkv, g, H, scale), flush, n=5),
               "library_ms": time_ms(lambda: torch.autograd.grad(out, (q, k, v), g_heads,
                                                                 retain_graph=True), flush, n=5),
               **bound(7 * B * N * D * item, 5 * 2 * B * N * N * D, prec)},
    }
    for name, r in res.items():
        print(f"{label} {name} at the step's shape (B={B}, N={N}, D={D}, H={H}) {prec}: kernel "
              f"{r['ms']:.4f} ms, SDPA {'backward ' if name == 'K8' else ''}"
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    del q, k, v, out, g_heads
    return res


def vit_training_phase(datasets, workdir: str) -> dict:
    """The ViT training path on the kernels: 5 steps of the ``n_shot 6``
    episode with the fused impls, launch counts, moved weights, K8 and the
    K9 backward on the first step's tensors, the step split and peak
    memory; then the fused featurizer's gradients against the plain one's
    on a small episode, and 3 steps with ``--bf16`` (steps 2-3 split, the
    K9 backward on the first bf16 step's tensors, K9 and the K9 backward
    timed at its shapes)."""
    import torch

    from nwhead_tpu_torch import train
    from nwhead_tpu_torch.ops import fused_attn as FA
    from nwhead_tpu_torch.ops import fused_mlp as FM
    from nwhead_tpu_torch.ops import metrics as M

    argv = VIT_TRAIN_ARGV + ["--models_dir", workdir, "--log_interval", "1000"]
    args, trainer, start = train.setup(argv, datasets=datasets, featurizer_kwargs=FUSED)
    net = trainer.net
    _set_gammas(net)
    print(f"vit train: LayerScale gammas set to U[0.5, 1.5] (seed {GAMMA_SEED})")
    timer = StepTimer(net.model)
    blocks = net.model.featurizer.blocks
    watched = {f"blocks.{i}.{m}": b.get_submodule(m).weight for i, b in enumerate(blocks)
               for m in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")}
    before = {n: w.detach().clone() for n, w in watched.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counts(reset=True)
    attn_in, mlp_in = {}, {}
    restore = [_capture_first(FA, "attention_qkv_bwd_cuda", attn_in),
               _capture_first(FM, "mlp_bwd_cuda", mlp_in)]
    try:
        t0 = time.perf_counter()
        train.run_epochs(args, trainer, start)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for r in restore:
            r()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    split = timer.split()
    losses = trainer.step_losses
    print(f"vit train f32: launches {launches}; {len(losses)} steps in "
          f"{trainer.train_seconds:.2f}s ({trainer.train_seconds / TRAIN_STEPS * 1e3:.1f} ms/step, "
          f"first step included); eval + train {wall:.2f}s; peak device memory "
          f"{peak / 2**30:.2f} GiB; losses {['%.4f' % v for v in losses]}")
    print(f"vit train step split (CUDA events from hooks in the run's steps, median of steps "
          f"2-{split['steps'] + 1}): featurizer fwd+bwd {split['featurizer_ms']:.2f} ms, head "
          f"fwd+bwd {split['head_ms']:.3f} ms, step {split['step_ms']:.2f} ms (optimizer "
          f"update not included)")
    for name, per_step in VIT_STEP_LAUNCHES.items():
        if launches[name] != per_step * TRAIN_STEPS:
            raise AssertionError(f"{name} launched {launches[name]} times in {TRAIN_STEPS} "
                                 f"ViT training steps, want {per_step} per step")
    if launches["nw_prepared_cuda"] == 0:
        raise AssertionError("the ViT full-mode eval never launched K2")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"ViT losses {losses}")
    if split["steps"] != TRAIN_STEPS - 1:
        raise AssertionError(f"the step timer saw {split['steps'] + 1} ViT steps")
    still = [n for n, w in watched.items() if torch.equal(w.detach(), before[n])]
    if still:
        raise AssertionError(f"block weights that did not move: {still}")
    print(f"vit train: all {len(watched)} qkv/proj/fc1/fc2 weights of the {len(blocks)} "
          "blocks moved")

    # K8 and the K9 backward on the first step's tensors (the last block's,
    # the first backward of the run) against their plain versions.
    dev = net.device
    qkv, g, H, scale = (a.to(dev) if torch.is_tensor(a) else a for a in attn_in.pop("args"))
    D = qkv.shape[-1] // 3
    got = FA.attention_qkv_bwd_cuda(qkv, g, H, scale)
    want = FA._attention_qkv_bwd_plain(qkv, g, H, scale)
    torch.cuda.synchronize()
    errs = {"attention_qkv_bwd": check_grads(_qkv_parts(got, D), _qkv_parts(want, D), "f32",
                                             ("dq", "dk", "dv"),
                                             f"K8 on the first step's qkv {tuple(qkv.shape)}")}
    del got, want
    torch.cuda.empty_cache()
    # Each featurizer kernel's device time at the step's own shapes, times
    # its launches per step, against the step.
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    attn = step_attention_times("vit train", qkv, g, H, scale, flush)
    step_ms = {"K7": attn["K7"]["ms"], "K8": attn["K8"]["ms"]}
    del qkv, g
    m_args = tuple(a.to(dev) for a in mlp_in.pop("args"))
    got, want = FM.mlp_bwd_cuda(*m_args), FM._mlp_bwd_plain(*m_args)
    torch.cuda.synchronize()
    errs["mlp_bwd"] = check_grads(got, want, "f32", ("dx", "dw1", "db1", "dw2", "db2"),
                                  f"K9 backward on the first step's x {tuple(m_args[0].shape)}")
    del got, want
    torch.cuda.empty_cache()
    step_ms["K9"] = time_ms(lambda: FM.mlp_cuda(*m_args[:5]), flush, n=5)
    step_ms["K9 backward"] = time_ms(lambda: FM.mlp_bwd_cuda(*m_args), flush, n=5)
    kernels_ms = VIT_BLOCKS * sum(step_ms.values())
    print(f"vit train kernels at the step's shapes (median of 5): " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in step_ms.items()) + f"; {VIT_BLOCKS} x their sum = "
        f"{kernels_ms:.1f} ms of the {split['step_ms']:.1f} ms step "
        f"({kernels_ms / split['step_ms']:.2f})")
    out = {"launches": {"f32": launches}, "errs": errs, "split": split, "peak_bytes": peak,
           "ms_per_step": trainer.train_seconds / TRAIN_STEPS, "losses": losses,
           "kernel_step_ms": step_ms, "attention_step": attn}
    del trainer, net, timer, m_args, watched, before, flush
    torch.cuda.empty_cache()

    # Every parameter gradient of the fused featurizer against the plain one
    # (xla impls) on one small episode, where the plain path fits.
    small = argv[:argv.index("--n_shot")] + ["--n_way", "4", "--n_shot", "1"] + \
        argv[argv.index("--n_shot") + 2:]
    grads = []
    for kwargs in (FUSED, None):
        _, tr, _ = train.setup(small, datasets=datasets, featurizer_kwargs=kwargs)
        _set_gammas(tr.net)
        x, y = tr.train_dataset.gather(np.arange(4)), tr.train_dataset.targets[:4]
        log_probs, _ = tr.net.forward(x, y)
        loss = M.nll_loss(log_probs, torch.as_tensor(y, device=tr.net.device))
        params = dict(tr.net.model.featurizer.named_parameters())
        grads.append(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
        del tr, log_probs, loss, params
    # The final LayerNorm's bias shifts query and support features alike, so
    # the euclidean head gives it a gradient of 0 up to rounding: it is held
    # against the largest gradient of all, every other tensor against its own.
    top = max(float(t.abs().max()) for t in grads[1].values())

    def rel_of(n):
        diff = float((grads[0][n] - grads[1][n]).abs().max())
        return diff / (top if n == "norm.bias" else max(float(grads[1][n].abs().max()), 1e-30))

    worst = max(grads[1], key=rel_of)
    rel = rel_of(worst)
    print(f"vit fused vs xla featurizer gradients (n_way 4, n_shot 1, 4 queries): "
          f"{len(grads[0])} tensors, worst {worst} rel {rel:.2e}, norm.bias "
          f"{rel_of('norm.bias'):.2e} of the largest gradient "
          f"{'ok' if rel <= GRAD_REL['f32'] else 'FAIL'}")
    if rel > GRAD_REL["f32"] or not all(bool(torch.isfinite(t).all()) for t in grads[0].values()):
        raise AssertionError("the fused featurizer's gradients disagree with the plain one's")
    out["fused_vs_xla_rel"] = rel
    del grads
    torch.cuda.empty_cache()

    # bf16 featurizer: 3 steps, each kernel of the path once per block per
    # step, steps 2-3 timed by CUDA events; the K9 backward held to its plain
    # version on one block's tensors of the first step, and K9 and the K9
    # backward timed at the step's shapes.
    torch.cuda.reset_peak_memory_stats()
    _, trainer, _ = train.setup(argv + ["--bf16"], datasets=datasets, featurizer_kwargs=FUSED)
    _set_gammas(trainer.net)
    timer = StepTimer(trainer.net.model)
    _counts(reset=True)
    mlp_in, attn_in = {}, {}
    restore = [_capture_first(FM, "mlp_bwd_cuda", mlp_in),
               _capture_first(FA, "attention_qkv_bwd_cuda", attn_in)]
    try:
        trainer.train_epoch(num_steps=3)
        torch.cuda.synchronize()
    finally:
        for r in restore:
            r()
    bf = _counts()
    split_bf = timer.split()
    out["launches"]["bf16"] = bf
    out["split_bf16"] = split_bf
    print(f"vit train bf16: launches {bf}; losses {['%.4f' % v for v in trainer.step_losses]}; "
          f"{trainer.train_seconds / 3 * 1e3:.1f} ms/step (first step included); steps 2-3 by "
          f"CUDA events: featurizer fwd+bwd {split_bf['featurizer_ms']:.2f} ms, head fwd+bwd "
          f"{split_bf['head_ms']:.3f} ms, step {split_bf['step_ms']:.2f} ms (optimizer update "
          f"not included); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want_bf = {n: 3 * c for n, c in VIT_STEP_LAUNCHES.items()}
    want_bf.update(attention_qkv_cuda=3 * VIT_BLOCKS, mlp_cuda=3 * VIT_BLOCKS)
    if any(bf[n] != c for n, c in want_bf.items()) or not np.isfinite(trainer.step_losses).all():
        raise AssertionError(f"bf16 ViT training: launches {bf}, want {want_bf}; losses "
                             f"{trainer.step_losses}")
    if split_bf["steps"] != 2:
        raise AssertionError(f"the step timer saw {split_bf['steps'] + 1} bf16 ViT steps")
    del trainer, timer
    torch.cuda.empty_cache()
    m_args = tuple(a.to(dev) for a in mlp_in.pop("args"))
    got, want = FM.mlp_bwd_cuda(*m_args), FM._mlp_bwd_plain(*m_args)
    torch.cuda.synchronize()
    out["errs_bf16"] = {"mlp_bwd": check_grads(
        got, want, "bf16", ("dx", "dw1", "db1", "dw2", "db2"),
        f"K9 backward on the first bf16 step's x {tuple(m_args[0].shape)}")}
    del got, want
    torch.cuda.empty_cache()
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    qkv, g, H, scale = (a.to(dev) if torch.is_tensor(a) else a for a in attn_in.pop("args"))
    attn_bf = step_attention_times("vit train bf16", qkv, g, H, scale, flush)
    out["attention_step_bf16"] = attn_bf
    del qkv, g
    torch.cuda.empty_cache()
    bf_ms = {"K7": attn_bf["K7"]["ms"], "K8": attn_bf["K8"]["ms"],
             "K9": time_ms(lambda: FM.mlp_cuda(*m_args[:5]), flush, n=5),
             "K9 backward": time_ms(lambda: FM.mlp_bwd_cuda(*m_args), flush, n=5)}
    kernels_ms = VIT_BLOCKS * sum(bf_ms.values())
    print(f"vit train bf16 kernels at the step's shapes (median of 5): " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in bf_ms.items()) + f"; {VIT_BLOCKS} x their sum = "
        f"{kernels_ms:.1f} ms of the {split_bf['step_ms']:.1f} ms step "
        f"({kernels_ms / split_bf['step_ms']:.2f})")
    out["kernel_step_ms_bf16"] = bf_ms
    del m_args, flush
    torch.cuda.empty_cache()
    return out


def vit_train_entries(kern: dict, tr: dict) -> list:
    """The ``kernels`` JSON entries of K8 and the K9 backward: launches from
    the ViT training runs (f32: 5 steps, bf16: 3)."""
    entries = []
    for kernel, wrapper, source in (("attention_qkv_bwd", "attention_qkv_bwd_cuda", ATTN_BWD_SOURCE),
                                    ("mlp_bwd", "mlp_bwd_cuda", MLP_BWD_SOURCE)):
        for prec in ("f32", "bf16"):
            r = kern[f"{kernel}_{prec}"]
            step_errs = tr["errs"] if prec == "f32" else tr["errs_bf16"]
            err = max(r["max_abs_err"], step_errs.get(kernel, 0.0))
            entries.append({
                "name": f"{kernel}_{prec}", "route": "cuda", "source": source,
                "replaces": VIT_BWD_REPLACES[kernel], "launches": tr["launches"][prec][wrapper],
                "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], **{t: r[t] for t in TURNS_KEYS if t in r}})
    return entries


LAB_STREAM_SOURCE = "nwhead_tpu_torch/csrc/lab_stream.cu"
LAB_NW_SOURCE = "nwhead_tpu_torch/csrc/lab_nw.cu"
LAB_BLOCKS_SOURCE = "nwhead_tpu_torch/csrc/lab_blocks.cu"
# The TPU kernels; "stream" is K13 and also L4 (scripts/prepared_lab.py:70,
# scripts/roofline_lab.py:51, scripts/bigbank_lab.py:69).
LAB_REPLACES = {
    "stream": "bench.py:122",
    "stream_reduce": "scripts/kernel_lab.py:103",
    "fused_variant": "scripts/kernel_lab.py:304",
    "manual_fused": "scripts/manual_pipe_lab.py:127",
    "fused_blocks": "scripts/block_lab.py:191",
}
STREAM_ROWS = (12288, 196608)  # bench.py's two banks: 25.2 MB (fits the L2), 403 MB
STREAM_SEED = 8
# A flushed read above the card's rate means the kernel skipped bytes; so does a
# touch_only reduce much faster than the full one (both read every byte).
STREAM_RATE_LIMIT = 1.05 * HBM_BYTES_PER_S
TOUCH_FULL_MIN = 0.9
LAB_B, LAB_S, LAB_D, LAB_C = 64, 5994, 512, 200  # the labs' CUB shape
LAB_CYCLES = 15
MANUAL_STAGES = (3, 2, 4, 6, 7)  # L3's ring depths (manual_pipe_lab.MANUAL_STAGES), K2's first
# prec, B, block_s, stages, at K2's split count: the depths at block_s 1,024
# only; the first of each precision is the entry's.
MANUAL_CASES = tuple((prec, b, bs, st, k2) for prec in ("f32", "bf16") for b in (64, 8)
                     for bs, st, k2 in [(1024, st, False) for st in MANUAL_STAGES]
                     + [(2048, 3, False), (1024, 3, True)])
BLOCKS_SHAPE = (64, 56, 56, 64)  # ResNet-18's layer1 at B=64
BLOCKS_TILES = (8, 12, 14, 16)  # the tiles timed beside the plan's
LAB_RUNS = (("kernel_lab", ["--quick"]), ("manual_pipe_lab", []), ("prepared_lab", []),
            ("roofline_lab", []), ("block_lab", []))


def lab_variants() -> dict:
    """fused_variant's entries, name -> (dist, agg, cast, block_s), from
    ``kernel_lab.DECOMPOSITION``, each named by the option it changes."""
    from nwhead_tpu_torch.labs.kernel_lab import DECOMPOSITION

    out = {}
    for v in DECOMPOSITION:
        dist, agg, cast = v["dist"], v["agg"], v.get("cast", "f32")
        out["bf16" if cast == "bf16" else "split" if agg == "split" else dist] = (
            dist, agg, cast, v["block_s"])
    return out


def lab_times(cases) -> dict:
    """ms per call of each ``(name, fn)`` case by the labs' harness
    (``labs.timing.interleaved_time``): in turns, median of ``LAB_CYCLES``,
    the L2 flushed by a read."""
    from nwhead_tpu_torch.labs.timing import interleaved_time

    t = interleaved_time([(name, fn, ()) for name, fn in cases], cycles=LAB_CYCLES)
    return {name: s * 1e3 for name, s in t.items()}


def stream_phase() -> dict:
    """K13/L4 ``stream`` and L1 ``stream_reduce`` at bench.py's 12,288 and
    196,608 rows of D=512: against their plain versions (rtol 1e-5 of the
    sum of |x| added; at 12,288 rows the reduce at every block_s of
    ``kernel_lab.STREAM_SETTINGS``, both modes), then timed by ``lab_times``:
    GB/s and the share of 3.35 TB/s; at 12,288 rows also unflushed
    (L2-resident); at 196,608 rows the full and touch_only reduces in the
    same loop. Fails if the flushed 403 MB rate is above 1.05 x 3.35 TB/s,
    or touch_only takes under 0.9 of the full reduce: either means bytes
    were skipped."""
    import torch

    from nwhead_tpu_torch.labs import stream as L
    from nwhead_tpu_torch.labs.kernel_lab import STREAM_SETTINGS
    from nwhead_tpu_torch.labs.timing import interleaved_time

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(STREAM_SEED)
    res = {"stream": {"max_abs_err": 0.0}, "stream_reduce": {"max_abs_err": 0.0}}
    bs = L.STREAM_BLOCK_S
    for rows in STREAM_ROWS:
        s = torch.randn((rows, LAB_D), generator=gen, device=dev)
        sizes = sorted({b for b, _ in STREAM_SETTINGS}) if rows == STREAM_ROWS[0] else [bs]
        checks = [("stream", bs, True, L.stream_cuda(s))] + [
            ("stream_reduce", b, touch, L.stream_reduce_cuda(s, b, touch))
            for b in sizes for touch in (False, True)]
        torch.cuda.synchronize()
        for name, b, touch, got in checks:
            ok, err = L.plain_agreement(got, s, b, touch)
            print(f"lab {name} rows={rows} block_s={b} touch_only={touch}: max|err| {err:.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version at {rows} rows, "
                                     f"block_s {b}, touch_only {touch}")
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        n_bytes = L.stream_bytes(s)
        # One PyTorch call with stream's output: it reads rows 0-7 of each
        # tile, 1/256 of the bank, so it is no yardstick of the read rate.
        tiles = s[:n_bytes // (4 * LAB_D)].view(-1, bs, LAB_D)
        cases = [("stream", lambda: L.stream_cuda(s)), ("plain", lambda: L._stream_plain(s)),
                 ("library", lambda: tiles[:, :L.TOUCH_ROWS].sum(0))]
        if rows == STREAM_ROWS[-1]:
            cases += [("full", lambda: L.stream_reduce_cuda(s, bs, False)),
                      ("touch", lambda: L.stream_reduce_cuda(s, bs, True)),
                      ("full_plain", lambda: L._stream_reduce_plain(s, bs)),
                      ("full_library", lambda: torch.sum(s, dim=0, keepdim=True))]
        t = lab_times(cases)
        r = res["stream"][rows] = {"bytes": n_bytes, "ms": t["stream"], "plain_ms": t["plain"],
                                   "library_ms": t["library"]}
        r.update(bound(n_bytes + 8 * LAB_D * 4, (n_bytes // (4 * bs)) * 8, "f32"))
        r["gbps"] = n_bytes / r["ms"] / 1e6
        line = (f"lab stream rows={rows} ({n_bytes / 1e6:.1f} MB): {r['ms']:.4f} ms L2 flushed, "
                f"{r['gbps']:.1f} GB/s, {r['gbps'] * 1e9 / HBM_BYTES_PER_S:.3f} of 3.35 TB/s "
                f"(bound {r['bound_ms']:.4f} ms); plain {r['plain_ms']:.4f} ms, rows 0-7 "
                f"by torch.sum {r['library_ms']:.4f} ms")
        if rows == STREAM_ROWS[0]:
            r["l2_ms"] = interleaved_time([("stream", L.stream_cuda, (s,))], cycles=LAB_CYCLES,
                                          flush=False)["stream"] * 1e3
            line += (f"; L2-resident (unflushed) {r['l2_ms']:.4f} ms, "
                     f"{n_bytes / r['l2_ms'] / 1e6:.1f} GB/s")
        print(line)
        if rows == STREAM_ROWS[-1]:
            if n_bytes / (r["ms"] * 1e-3) > STREAM_RATE_LIMIT:
                raise AssertionError(f"stream read {r['gbps']:.1f} GB/s from HBM, above 1.05 x "
                                     "3.35 TB/s: the kernel skipped bytes")
            f = res["stream_reduce"]
            f.update(ms=t["full"], touch_ms=t["touch"], rows=rows, plain_ms=t["full_plain"],
                     library_ms=t["full_library"],
                     **bound(n_bytes + LAB_D * 4, n_bytes // 4, "f32"))
            ratio = f["touch_ms"] / f["ms"]
            print(f"lab stream_reduce rows={rows}: full {f['ms']:.4f} ms, touch_only "
                  f"{f['touch_ms']:.4f} ms (ratio {ratio:.3f}), plain {f['plain_ms']:.4f} ms, "
                  f"torch.sum {f['library_ms']:.4f} ms, bound {f['bound_ms']:.4f} ms")
            if ratio < TOUCH_FULL_MIN:
                raise AssertionError(f"touch_only takes {ratio:.3f} of the full reduce (under "
                                     f"{TOUCH_FULL_MIN}): the kernel skipped bytes")
        del s, tiles
    return res


def _flush_methods(flush, name: str, fn, before_ms: float, read_ms: float) -> float:
    """``fn``'s ms by ``time_ms`` (the ``zero_`` flush of the K1-K12 rows):
    the mean of ``before_ms``, taken before ``lab_times`` read ``read_ms``
    (the read flush), and one more median taken now; prints both."""
    zero_ms = (before_ms + time_ms(fn, flush)) / 2
    print(f"flush methods, {name}: {zero_ms:.4f} ms with the zero_ flush (time_ms), "
          f"{read_ms:.4f} ms with the read flush (lab_times), ratio {zero_ms / read_ms:.3f}")
    return zero_ms


def variant_phase(flush, stream_gbps: float) -> dict:
    """L1 ``fused_variant`` at the CUB shape (B=64, S=5,994, D=512, C=200),
    each variant of ``kernel_lab.DECOMPOSITION`` at its block_s, at the
    block_s of K1's own split count (``kernel_lab.k1_block_s``) and the
    f32s2 variant also at 512, against its plain version (f32 rtol=atol
    2e-4, bf16 atol 2e-3) and the naive op; the variants at both block_s,
    their plain versions and K1 (f32 and bf16) on the same features timed
    in one ``lab_times`` loop, with ``frac_vs_stream``; K1 also by
    ``time_ms``, before and after."""
    import torch

    from nwhead_tpu_torch.labs import kernel_lab as KL
    from nwhead_tpu_torch.ops import _cuda
    from nwhead_tpu_torch.ops import fused_nw as F
    from nwhead_tpu_torch.ops.nw import nw_log_probs

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    B, S, D, C = LAB_B, LAB_S, LAB_D, LAB_C
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
    bank = torch.from_numpy(rng.standard_normal((S, D)).astype(np.float32)).to(dev)
    sy = torch.from_numpy(rng.integers(0, C, size=S).astype(np.int32)).to(dev)
    naive = nw_log_probs(q, bank, sy, C)
    scale = torch.ones(1, device=dev)

    def k1():
        return F.nw_fwd_cuda(q, bank, sy, scale, "l2", C)

    qb16, bank16 = q.bfloat16(), bank.bfloat16()
    k1_bs = KL.k1_block_s(B, S, C, torch.cuda.get_device_properties(dev).multi_processor_count,
                          _cuda.load_library("lab_nw").lab_optin_smem(0))
    print(f"lab fused_variant: K1's split count at this shape is block_s {k1_bs} "
          f"({-(-S // k1_bs)} splits); the lab's block_s 2,048 gives {-(-S // 2048)}")
    k1_before = time_ms(k1, flush)
    res, cases, sizes = {"k1_block_s": k1_bs}, [
        ("K1", k1), ("K1 bf16", lambda: F.nw_fwd_cuda(qb16, bank16, sy, scale, "l2", C))], {}
    for name, (dist, agg, cast, block_s) in lab_variants().items():
        r = res[name] = {"max_abs_err": 0.0}
        qc, sc = (q, bank) if cast == "f32" else (qb16, bank16)
        x = KL.variant_inputs(qc, sc, dist)
        want = KL._fused_variant_plain(qc, sc, sy, C, dist, agg)
        for bs in ((block_s, 512, k1_bs) if name == "f32s2" else (block_s, k1_bs)):
            got = KL.fused_variant_cuda(x, sy, C, dist, agg, bs)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = float(torch.max(torch.abs(got - naive) / (torch.abs(naive) + 1e-6)))
            ok = bool(torch.isfinite(got).all()) and within(got, want, **TOL[cast])
            print(f"lab fused_variant {name} block_s={bs}: max|err| vs plain {err:.3e} "
                  f"{'ok' if ok else 'FAIL'}; relerr vs the naive op {rel:.2e}")
            if not ok:
                raise AssertionError(f"fused_variant {name} disagrees with its plain version")
            r["max_abs_err"] = max(r["max_abs_err"], err)
        cases += [(name, lambda x=x, v=(dist, agg, block_s): KL.fused_variant_cuda(
                      x, sy, C, v[0], v[1], v[2])),
                  (f"{name} k1", lambda x=x, v=(dist, agg, k1_bs): KL.fused_variant_cuda(
                      x, sy, C, v[0], v[1], v[2])),
                  (f"{name} plain", lambda a=(qc, sc, sy, C, dist, agg): KL._fused_variant_plain(
                      *a))]
        item = 2 if cast == "bf16" else 4
        sizes[name] = ((B + S) * D * item + 4 * (S + B * C) + (4 * S if dist != "f32" else 0),
                       2 * B * S * D * (3 if dist == "x3" else 1),
                       "bf16" if cast == "bf16" or dist == "x3" else "f32")
    t = lab_times(cases)
    res["k1_ms"], res["k1_bf16_ms"] = t["K1"], t["K1 bf16"]
    res["k1_zero_flush_ms"] = _flush_methods(flush, "K1 f32 at the CUB shape", k1, k1_before,
                                             t["K1"])
    for name, (n_bytes, n_ops, prec) in sizes.items():
        r = res[name]
        r.update(ms=t[name], k1_splits_ms=t[f"{name} k1"], plain_ms=t[f"{name} plain"],
                 **bound(n_bytes, n_ops, prec))
        r["frac_vs_stream"] = S * D * 4 / (stream_gbps * 1e9) / (r["ms"] * 1e-3)
        k1_ms = res["k1_bf16_ms"] if name == "bf16" else res["k1_ms"]
        print(f"lab fused_variant {name}: kernel {r['ms']:.4f} ms at block_s 2,048, "
              f"{r['k1_splits_ms']:.4f} ms at K1's split count ({r['k1_splits_ms'] / k1_ms:.2f} x "
              f"K1 {'bf16 ' if name == 'bf16' else ''}{k1_ms:.4f} ms), plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), frac_vs_stream "
              f"{r['frac_vs_stream']:.3f}")
    return res


def manual_phase(flush, stream_gbps: float) -> dict:
    """L3 ``manual_fused`` at the CUB shape, every case of ``MANUAL_CASES``
    (B=64 and B=8, f32 and bf16 banks prepared with block_s 1,024 at every
    ring depth, 2,048 and K2's own split count at 3 stages): its shared
    memory by the library against ``manual_plan``'s, its output finite and
    against its plain version (``TOL``); every case beside K2 on the same
    bank, and the plain version at each precision's first case, timed in
    one ``lab_times`` loop, with ``frac_vs_stream``, the blocks, the read
    rate per block (the bank's bytes over the splits, over the time) and
    the bytes a block's rings keep in flight; K2 of the first case also by
    ``time_ms``."""
    import torch

    from nwhead_tpu_torch.labs import manual_pipe_lab as MP
    from nwhead_tpu_torch.ops import _cuda
    from nwhead_tpu_torch.ops import fused_nw as F

    if sorted(MANUAL_STAGES) != sorted(MP.MANUAL_STAGES):
        raise AssertionError(f"MANUAL_STAGES {MANUAL_STAGES} are not the library's "
                             f"{MP.MANUAL_STAGES}")
    dev = torch.device("cuda")
    lab = _cuda.load_library("lab_nw")
    optin = lab.lab_optin_smem(0)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    B, S, D, C = LAB_B, LAB_S, LAB_D, LAB_C
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
    bank = torch.from_numpy(rng.standard_normal((S, D)).astype(np.float32)).to(dev)
    sy = rng.integers(0, C, size=S).astype(np.int32)
    scale = torch.ones(1, device=dev)
    res = {prec: {"max_abs_err": 0.0, "cases": {}} for prec in TOL}
    cases, first, preps, plains, k2_banks = [], {}, {}, {}, set()
    for prec, b, block_s, stages, k2 in MANUAL_CASES:
        r = res[prec]
        if (prec, block_s) not in preps:
            preps[(prec, block_s)] = F.prepare_support(bank, sy, C, precision=prec,
                                                       block_s=block_s)
        prep = preps[(prec, block_s)]
        S_pad = prep.s.shape[0]
        qc = q[:b].to(prep.s.dtype).contiguous()
        rows = None
        if k2:
            qt = MP.manual_plan(b, S_pad, block_s, C, stages, optin)[0]
            rows = F._tc_splits(S_pad, -(-b // qt), n_sms)[0]
        qt, split_rows, n_splits, smem = MP.manual_plan(b, S_pad, rows or prep.block_s, C, stages,
                                                         optin)
        if lab.lab_manual_smem_bytes(qt, C, stages) != smem:
            raise AssertionError(f"manual_plan's {smem} bytes at {stages} stages are not the "
                                 f"library's {lab.lab_manual_smem_bytes(qt, C, stages)}")
        if (prec, b, block_s) not in plains:
            plains[(prec, b, block_s)] = MP._manual_fused_plain(qc, prep, C)
        want = plains[(prec, b, block_s)]
        got = MP.manual_fused_cuda(qc, prep, C, stages, block_s=rows)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and within(got, want, **TOL[prec])
        r["max_abs_err"] = max(r["max_abs_err"], err)
        key = f"b{b}_{'k2_rows' if k2 else 'bs'}{split_rows}_st{stages}"
        print(f"lab manual_fused {prec} {key} ({n_splits} splits, {smem} bytes of shared memory): "
              f"max|err| {err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"manual_fused disagrees with its plain version: {prec} {key}")
        bank_key = (prec, f"b{b}_bs{block_s}", "K2")
        cases.append(((prec, key), lambda a=(qc, prep, C, stages, rows): MP.manual_fused_cuda(*a)))
        if bank_key not in k2_banks:
            k2_banks.add(bank_key)
            cases.append((bank_key, lambda a=(qc, prep): F.nw_prepared_cuda(*a, scale, "l2", C)))
        if prec not in first:
            first[prec] = key
            cases.append(((prec, "plain"), lambda a=(qc, prep): MP._manual_fused_plain(*a, C)))
            r.update(bound(b * D * prep.s.element_size() + prep.s.numel() * prep.s.element_size()
                           + 4 * (2 * S_pad + b * C), 2 * b * S * D, prec),
                     stages=stages, block_s=block_s)
        r["cases"][key] = {"bank_bytes": prep.s.numel() * prep.s.element_size(), "K2": bank_key,
                           "blocks": -(-b // qt) * n_splits, "splits": n_splits,
                           "stages": stages, "in_flight_bytes": MP.ring_bytes(stages)}
    k2_first = dict(cases)[("f32", f"b{B}_bs{MANUAL_CASES[0][2]}", "K2")]
    k2_before = time_ms(k2_first, flush)
    t = lab_times(cases)
    for prec, r in res.items():
        for key, c in r["cases"].items():
            bank_bytes = c.pop("bank_bytes")
            c.update(ms=t[(prec, key)], k2_ms=t[c.pop("K2")])
            c["frac_vs_stream"] = bank_bytes / (stream_gbps * 1e9) / (c["ms"] * 1e-3)
            c["block_gbps"] = bank_bytes / c["splits"] / (c["ms"] * 1e-3) / 1e9
            print(f"lab manual_fused {prec} {key}: {c['ms']:.4f} ms, K2 on the same bank "
                  f"{c['k2_ms']:.4f} ms ({c['ms'] / c['k2_ms']:.3f} x), frac_vs_stream "
                  f"{c['frac_vs_stream']:.3f}, {c['blocks']} blocks, per block "
                  f"{c['block_gbps']:.2f} GB/s, {c['in_flight_bytes']} bytes in flight")
        c = r["cases"][first[prec]]
        r.update(ms=c["ms"], k2_ms=c["k2_ms"], frac_vs_stream=c["frac_vs_stream"],
                 plain_ms=t[(prec, "plain")])
    res["f32"]["k2_zero_flush_ms"] = _flush_methods(
        flush, f"K2 f32 at the CUB shape ({first['f32']})", k2_first, k2_before,
        res["f32"]["k2_ms"])
    return res


def blocks_phase() -> dict:
    """L2 ``fused_blocks`` at (64, 56, 56, 64) bf16, two blocks: against its
    plain version (1e-2 of max|plain|, cosine 0.9999) on random folded
    weights, and on the port's ``BasicBlock``s folded by
    ``fold_basic_block`` against the blocks themselves in bf16 (2e-2, as the
    lab), at ``tile_plan``'s tile and at ``BLOCKS_TILES``; timed by
    ``lab_times`` beside its plain version and cuDNN running those two
    blocks (bf16, channels_last), every tile in the same loop."""
    import copy

    import torch

    from nwhead_tpu_torch.labs import block_lab as BL
    from nwhead_tpu_torch.ops import _cuda

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    B, H, W, C = BLOCKS_SHAPE
    x = torch.from_numpy(rng.standard_normal(BLOCKS_SHAPE).astype(np.float32)).to(
        dev, torch.bfloat16)
    blocks = BL.random_blocks(C, 2, rng, dev)
    w, b = BL.pack_weights([f for blk in blocks for f in BL.fold_basic_block(blk)])
    w, b = w.to(dev), b.to(dev)
    plan = BL.tile_plan(B, H, W, C, 2, smem_optin=_cuda.load_library(
        "lab_blocks").lab_blocks_smem_optin(0), n_sms=torch.cuda.get_device_properties(
            dev).multi_processor_count)
    print(f"lab fused_blocks plan: {plan}")
    want = BL._fused_blocks_plain(x, w, b)
    bf_blocks = [copy.deepcopy(blk).to(torch.bfloat16) for blk in blocks]
    with torch.no_grad():
        ref = BL.layer_reference(bf_blocks, x)
    wf = want.float().flatten()
    r = {"max_abs_err": 0.0, "tile": plan.tile, "smem_bytes": plan.smem_bytes}
    for tile in (None,) + tuple(tt for tt in BLOCKS_TILES if tt != plan.tile):
        got = BL.fused_blocks_cuda(x, w, b, tile=tile)
        torch.cuda.synchronize()
        gf = got.float().flatten()
        rel, ref_rel = BL.rel_to_max(got, want), BL.rel_to_max(got, ref)
        cos = float(torch.nn.functional.cosine_similarity(gf, wf, dim=0))
        ok = bool(torch.isfinite(gf).all()) and rel <= 1e-2 and cos >= 0.9999 and ref_rel <= 2e-2
        print(f"lab fused_blocks {BLOCKS_SHAPE} tile {tile or plan.tile}: vs plain {rel:.3e} of "
              f"max, cosine {cos:.7f}; vs the port's BasicBlocks in bf16 {ref_rel:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("fused_blocks disagrees with its plain version or the BasicBlocks")
        if tile is None:
            r.update(max_abs_err=float((gf - wf).abs().max()), rel_to_max=rel, cosine=cos,
                     ref_rel=ref_rel)

    def cudnn():
        with torch.no_grad():
            return BL.layer_reference(bf_blocks, x)

    cases = [("kernel", lambda: BL.fused_blocks_cuda(x, w, b)),
             ("plain", lambda: BL._fused_blocks_plain(x, w, b)), ("cudnn", cudnn)]
    cases += [(f"tile {tt}", lambda tt=tt: BL.fused_blocks_cuda(x, w, b, tile=tt))
              for tt in BLOCKS_TILES if tt != plan.tile]
    t = lab_times(cases)
    convs = 4 * 2 * B * H * W * 9 * C * C
    r.update(ms=t["kernel"], plain_ms=t["plain"], cudnn_layer1_ms=t["cudnn"],
             tiles_ms={plan.tile: t["kernel"], **{tt: t[f"tile {tt}"] for tt in BLOCKS_TILES
                                                  if tt != plan.tile}},
             **bound(2 * 2 * B * H * W * C + w.numel() * 2 + b.numel() * 4, convs, "bf16"))
    print(f"lab fused_blocks: kernel {r['ms']:.4f} ms (tile {plan.tile}), cuDNN layer1 "
          f"{r['cudnn_layer1_ms']:.4f} ms ({r['cudnn_layer1_ms'] / r['ms']:.2f} x the kernel), "
          f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
          f"{convs / (r['ms'] * 1e-3) / 1e12:.1f} TFLOP/s; by tile: "
          + ", ".join(f"{tt} {ms:.4f} ms" for tt, ms in sorted(r["tiles_ms"].items())))
    return r


def lab_kernel_phase(flush) -> dict:
    """The lab kernels against their plain versions and timed by the labs'
    harness: K13/L4 and L1's stream, L1 fused_variant, L3 manual_fused, L2
    fused_blocks. ``flush`` serves ``time_ms``'s readings of K1 and K2
    beside the harness's, which measure what the flush method moves."""
    res = {"stream": stream_phase()}
    gbps = res["stream"]["stream"][STREAM_ROWS[0]]["gbps"]  # the labs' flushed yardstick
    res["fused_variant"] = variant_phase(flush, gbps)
    res["manual_fused"] = manual_phase(flush, gbps)
    res["fused_blocks"] = blocks_phase()
    return res


def lab_phase() -> dict:
    """The labs as a user runs them, ``python -m nwhead_tpu_torch.labs.<lab>``
    (their ``main``, in this process so that the launches count):
    ``kernel_lab --quick``, ``manual_pipe_lab``, ``prepared_lab``,
    ``roofline_lab`` and ``block_lab``, each exiting 0. Every lab kernel
    (and every fused_variant and manual_fused variant) must launch."""
    import importlib

    from nwhead_tpu_torch.labs import LAB_KERNELS, lab_wrapper
    from nwhead_tpu_torch.labs.kernel_lab import variant_key

    for kernel in LAB_KERNELS:
        w = lab_wrapper(kernel)
        w.launches = 0
        if hasattr(w, "by_variant"):
            w.by_variant.clear()
    seconds = {}
    for lab, argv in LAB_RUNS:
        t0 = time.perf_counter()
        print(f"--- python -m nwhead_tpu_torch.labs.{lab} {' '.join(argv)}", flush=True)
        rc = importlib.import_module(f"nwhead_tpu_torch.labs.{lab}").main(argv)
        seconds[lab] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"nwhead_tpu_torch.labs.{lab} exited {rc}")
    launches = {k: lab_wrapper(k).launches for k in LAB_KERNELS}
    by_variant = {k: dict(lab_wrapper(k).by_variant) for k in ("fused_variant", "manual_fused")}
    want_variants = {"fused_variant": [variant_key(*v[:3]) for v in lab_variants().values()],
                     "manual_fused": list(TOL)}
    missing = [k for k, n in launches.items() if n == 0] + [
        f"{k} {v}" for k, vs in want_variants.items() for v in vs if not by_variant[k].get(v)]
    print(f"lab launches: {launches}; by variant: {by_variant}; seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    if missing:
        raise AssertionError(f"the labs launched no {missing}")
    return {"launches": launches, "by_variant": by_variant, "seconds": seconds}


def lab_entries(kern: dict, labs: dict) -> list:
    """The ``kernels`` JSON entries of the lab kernels: launches from the
    lab phase; times from the lab kernel phase (stream at 196,608 rows,
    the others at the CUB shape or layer1 at B=64)."""
    from nwhead_tpu_torch.labs.kernel_lab import variant_key

    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    st = kern["stream"]
    big, small = st["stream"][STREAM_ROWS[-1]], st["stream"][STREAM_ROWS[0]]
    entries = [
        {"name": "stream_f32", "route": "cuda", "source": LAB_STREAM_SOURCE,
         "replaces": LAB_REPLACES["stream"], "launches": labs["launches"]["stream"],
         "max_abs_err": st["stream"]["max_abs_err"], **{k: big[k] for k in keys},
         "library_ms": big["library_ms"], "gbps": big["gbps"],
         "rows_12288_ms": small["ms"], "rows_12288_l2_resident_ms": small["l2_ms"]},
        {"name": "stream_reduce_f32", "route": "cuda", "source": LAB_STREAM_SOURCE,
         "replaces": LAB_REPLACES["stream_reduce"], "launches": labs["launches"]["stream_reduce"],
         "max_abs_err": st["stream_reduce"]["max_abs_err"],
         **{k: st["stream_reduce"][k] for k in keys + ("library_ms", "touch_ms")}},
    ]
    fv = kern["fused_variant"]
    for name, v in lab_variants().items():
        r = fv[name]
        entries.append({"name": f"fused_variant_{name}", "route": "cuda", "source": LAB_NW_SOURCE,
                        "replaces": LAB_REPLACES["fused_variant"],
                        "launches": labs["by_variant"]["fused_variant"].get(variant_key(*v[:3]), 0),
                        "max_abs_err": r["max_abs_err"], **{k: r[k] for k in keys},
                        "library_ms": None, "k1_ms": fv["k1_ms"], "k1_bf16_ms": fv["k1_bf16_ms"],
                        "k1_zero_flush_ms": fv["k1_zero_flush_ms"],
                        "k1_block_s": fv["k1_block_s"], "k1_splits_ms": r["k1_splits_ms"],
                        "frac_vs_stream": r["frac_vs_stream"]})
    for prec, r in kern["manual_fused"].items():
        entries.append({"name": f"manual_fused_{prec}", "route": "cuda", "source": LAB_NW_SOURCE,
                        "replaces": LAB_REPLACES["manual_fused"],
                        "launches": labs["by_variant"]["manual_fused"].get(prec, 0),
                        "max_abs_err": r["max_abs_err"], **{k: r[k] for k in keys},
                        "library_ms": None, "pass": "nw_prepared_tc_kernel, K2's route",
                        "stages": r["stages"], "block_s": r["block_s"], "k2_ms": r["k2_ms"],
                        "frac_vs_stream": r["frac_vs_stream"], "cases": r["cases"],
                        **({"k2_zero_flush_ms": r["k2_zero_flush_ms"]}
                           if "k2_zero_flush_ms" in r else {})})
    r = kern["fused_blocks"]
    entries.append({"name": "fused_blocks_bf16", "route": "cuda", "source": LAB_BLOCKS_SOURCE,
                    "replaces": LAB_REPLACES["fused_blocks"],
                    "launches": labs["launches"]["fused_blocks"], "max_abs_err": r["max_abs_err"],
                    **{k: r[k] for k in keys}, "library_ms": None,
                    "cudnn_layer1_ms": r["cudnn_layer1_ms"], "tile": r["tile"],
                    "tiles_ms": r["tiles_ms"]})
    return entries


# ---------------------------------------------------------------------------
# The featurizer zoo: ResNet-50 and DenseNet-121 served (K2, K4) and trained
# (K1, K3) at feature widths 2,048 and 1,024.
# ---------------------------------------------------------------------------

ZOO_KERNEL_CASES = (  # name, B, S, D, C; the first is timed (f32, bf16 and int8)
    ("r50_b64", 64, 5800, 2048, 200),  # ResNet-50's serving bank
    ("d121_b64", 64, 5800, 1024, 200),  # DenseNet-121's
    ("d161_b64", 64, 5800, 2208, 200),  # DenseNet-161's: 34.5 bf16 slices of 128 bytes
)
ZOO_RAW_CASES = (  # name, B, S, D, C; the first two are timed (training runs 1 and 2)
    ("r50_episode", 8, 400, 2048, 200),
    ("r50_bf16_episode", 8, 800, 2048, 200),
    ("d121_episode", 8, 1200, 1024, 200),
    ("d161_episode", 8, 1200, 2208, 200),
    ("r50_b64", 64, 1200, 2048, 200),  # dq's 16-query tile at D = 2,048
)
ZOO_SERVE_ARGV = ["--dataset", "synthetic_cub", "--batch_size", "64", "--latency_bench",
                  "--bench_batches", "20"]
ZOO_SERVE_CONFIGS = (  # name, flags, serves the written checkpoint, head precision
    ("r50_pretrained_f32", ["--arch", "resnet50"], True, "f32"),
    ("r50_pretrained_bf16_head", ["--arch", "resnet50", "--head_precision", "bf16"], True, "bf16"),
    ("r50_bf16_backbone", ["--arch", "resnet50", "--bf16"], False, "f32"),
    ("d121_int8_head", ["--arch", "densenet121", "--head_precision", "int8"], False, "int8"),
)
ZOO_CKPT_SEED = 21
ZOO_CKPT_FILE = "resnet50_torchvision.pth"  # written by zoo_serving_phase
ZOO_TRAIN_ARGV = ["--dataset", "synthetic_cub", "--batch_size", "8", "--lr", "1e-2",
                  "--num_epochs", "1", "--num_steps_per_epoch", "3",
                  "--num_val_steps_per_epoch", "1", "--log_interval", "1000"]
# name, flags, the head's fused_min_support (None: the default 1,024),
# load_model options, the head's precision. The episode sizes come from
# activation memory: 400, 800 and 1,200 support rows (ResNet-50 cannot hold
# the recipe's 1,208-image episode on an 80 GB card; DenseNet-121 holds it
# only with its dense layers checkpointed).
ZOO_TRAIN_RUNS = (
    ("r50_f32", ["--arch", "resnet50", "--n_shot", "2"], 256, {}, "f32"),
    ("r50_bf16", ["--arch", "resnet50", "--n_shot", "4", "--bf16", "--head_precision", "bf16"],
     512, {}, "bf16"),
    ("d121_checkpointed", ["--arch", "densenet121", "--n_shot", "6"], None,
     {"memory_efficient": True}, "f32"),
)
ZOO_TRAIN_STEPS = 3


def zoo_kernel_phase(flush) -> dict:
    """K2 (f32, bf16) and K4 (int8) at the zoo's serving banks, K1 and K3 at
    its training episodes and at B=64 with D = 2,048, all five kernels,
    masked rows holding NaN, each against its plain version; K2 called
    twice for the same bits. Times K2 and K4 at ResNet-50's and
    DenseNet-121's banks and K1, dq and ds at training runs 1 and 2's
    episodes, each with its bound. Prints each shape's plan (query tiles,
    ds clusters)."""
    import torch

    from nwhead_tpu_torch.ops import fused_nw as F
    from nwhead_tpu_torch.ops._cuda import load_library
    from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES

    dev = torch.device("cuda")
    optin = F._smem_optin(load_library(), dev)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"prepared": {p: {"max_abs_err": 0.0, "timed": {}} for p in ("f32", "bf16", "int8")},
           "raw": {k: {p: {"max_abs_err": 0.0} for p in TOL} for k in RAW_KERNELS}}
    for ci, (case, B, S, D, C) in enumerate(ZOO_KERNEL_CASES):
        rng = np.random.default_rng(2100 + ci)
        q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
        s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
        sy = rng.integers(0, C, size=S)
        valid = rng.random(S) > 0.03
        valid[0] = True
        s[torch.from_numpy(~valid).to(dev)] = float("nan")
        mask = torch.from_numpy(valid.astype(np.float32))
        print(f"zoo plan {case}: K2 query tile {F._tc_query_tile(B, C, False, optin)}")
        for kernel in KERNEL_NAMES:
            params = {"logit_scale": torch.tensor(1.3, device=dev)} if kernel == "clip" else {}
            for prec, r in res["prepared"].items():
                prep = F.prepare_support(s, sy, C, kernel=kernel, support_mask=mask,
                                         precision=prec)
                args = F._prepared_query(q, prep, kernel, params)
                args = (args[0], prep, args[1], args[2], C, args[3])
                wrapper = getattr(F, HEAD_WRAPPERS[prec])
                got, want = wrapper(*args), F._nw_prepared_plain(*args)
                same_bits(f"zoo {case} {kernel} {prec}", lambda: wrapper(*args))
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                ok = bool(torch.isfinite(got).all()) and within(got, want, **HEAD_TOL[prec])
                print(f"zoo kernel {case} D={D} {kernel} {prec}: max|err| {err:.3e} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel disagrees with plain: zoo {case} {kernel} {prec}")
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if kernel == "euclidean" and ci < 2:
                    Dp, item = args[0].shape[1], prep.s.element_size()
                    t = {"ms": time_ms(lambda: wrapper(*args), flush),
                         "plain_ms": time_ms(lambda: F._nw_prepared_plain(*args), flush),
                         # the query, the bank, s2 (and int8's sscale), labels, out
                         **bound(B * Dp * item + prep.s.numel() * item
                                 + (12 if prec == "int8" else 8) * S + 4 * B * C,
                                 2 * B * S * Dp, prec)}
                    r["timed"][case] = t
                    print(f"time zoo {case} D={D} {prec}: kernel {t['ms']:.4f} ms, plain "
                          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for ci, (case, B, S, D, C) in enumerate(ZOO_RAW_CASES):
        rng = np.random.default_rng(2200 + ci)
        q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
        s = torch.from_numpy(rng.standard_normal((S, D), np.float32)).to(dev)
        valid = rng.random(S) > 0.03
        valid[0] = True
        s[torch.from_numpy(~valid).to(dev)] = float("nan")
        labels = torch.from_numpy(
            np.where(valid, rng.integers(0, C, size=S), -1).astype(np.int32)).to(dev)
        g = torch.from_numpy(rng.standard_normal((B, C), np.float32)).to(dev)
        for prec in TOL:
            qb, cl, group = F._ds_plan(B, S, D, 4 if prec == "f32" else 2, optin, n_sms)
            print(f"zoo plan {case} {prec}: K1 query tile {F._tc_query_tile(B, C, False, optin)}, "
                  f"dq query tile {F._dq_query_tile(B, D, optin)}, ds query tile {qb}, clusters "
                  f"of {cl}, group {group}")
        for kernel in KERNEL_NAMES:
            params = {"logit_scale": torch.tensor(1.3, device=dev)} if kernel == "clip" else {}
            for prec in TOL:
                mode, scale, qn, sn = F._resolve_mode(kernel, params, q.to(dtypes[prec]),
                                                      s.to(dtypes[prec]))
                qn, sn = qn.to(sn.dtype).contiguous(), sn.contiguous()
                errs = check_raw_kernels(qn, sn, labels, scale, mode, C, g, prec,
                                         f"zoo {case} D={D} {kernel}",
                                         check_dscale=kernel == "clip")
                for k, e in errs.items():
                    res["raw"][k][prec]["max_abs_err"] = max(res["raw"][k][prec]["max_abs_err"], e)
                if kernel == "euclidean" and (ci, prec) in ((0, "f32"), (1, "bf16")):
                    timed = _time_raw(flush, qn, sn, labels, scale, mode, C, g, prec)
                    print(f"time zoo raw {case} D={D} {prec}: " + ", ".join(
                        f"{k} kernel {v['ms']:.4f} ms / plain {v['plain_ms']:.4f} ms / "
                        f"bound {v['bound_ms']:.4f} ms ({v['bound_by']})"
                        for k, v in timed.items()))
                    for k, v in timed.items():
                        res["raw"][k][prec]["timed"] = {"case": case, **v}
    return res


ZOO_CALIB_IMAGES = 64


def calibrate_batchnorm(model, images) -> None:
    """Every BatchNorm's running statistics set to those of one train-mode
    pass over ``images`` (momentum 1, no gradient), as a trained model's
    are. At random init they are (0, 1), and eval-mode features blow up
    with depth (ResNet-50's pooled features reach a norm of about 640,
    DenseNet-121's about 1.6e8; ResNet-18's stay near 16), where f32
    distances round by more than the head's tolerance."""
    import torch

    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    device = next(model.parameters()).device
    model.train()
    with torch.no_grad():
        model(torch.as_tensor(images).to(device))
    model.eval()
    for m, momentum in zip(norms, momenta):
        m.momentum = momentum


def write_zoo_checkpoint(path: str, images, statistics=calibrate_batchnorm) -> dict:
    """A torchvision-named ResNet-50 state dict from the port's own model
    under a fixed generator, its BatchNorm statistics set on ``images`` on
    the card by ``statistics`` (``calibrate_batchnorm``, or
    ``trained_like_batchnorm``), plus an ``fc`` classifier the loader must
    ignore, saved at ``path``. Returns the state dict (CPU tensors)."""
    import torch

    from nwhead_tpu_torch.models import load_model

    g = torch.Generator().manual_seed(ZOO_CKPT_SEED)
    model = load_model("resnet50", device="cuda", generator=g)
    statistics(model, images)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return sd


def zoo_serving_phase(datasets, workdir: str) -> dict:
    """The serve module's path for ``ZOO_SERVE_CONFIGS`` on the CUB-scale
    bank at B=64: ResNet-50 from a written torchvision-format checkpoint
    (``--pretrained_path``) with an f32 and a bf16 head (K2 at D = 2,048),
    ResNet-50 with the bf16 backbone (``--bf16``), DenseNet-121 with an int8
    head (K4 at D = 1,024); every backbone's BatchNorm statistics calibrated
    on the first 64 training images (``calibrate_batchnorm``). Checks the
    served featurizer holds the file's weights, one launch of the head's
    kernel per request (and none of any other), and the served log-probs
    against the plain head on the same features; prints p50, p95,
    queries/s, the bank's seconds and peak device memory."""
    import os

    import torch

    from nwhead_tpu_torch import serve

    train_ds, val_ds = datasets
    calib = train_ds.gather(np.arange(ZOO_CALIB_IMAGES))
    path = os.path.join(workdir, ZOO_CKPT_FILE)
    t0 = time.perf_counter()
    sd = write_zoo_checkpoint(path, calib)
    print(f"zoo: wrote {path} ({len(sd)} tensors, fc.* included) in "
          f"{time.perf_counter() - t0:.1f}s")
    out = {}
    for name, flags, pretrained, prec in ZOO_SERVE_CONFIGS:
        args = serve.parse_args(ZOO_SERVE_ARGV + flags
                                + (["--pretrained_path", path] if pretrained else []))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # The checkpoint's statistics were calibrated when it was written;
        # a random-init backbone's are calibrated here, before the bank.
        net = serve.build_server(args, train_ds, edit=None if pretrained else (
            lambda n: calibrate_batchnorm(n.model.featurizer, calib)))
        featurizer = net.model.featurizer
        if pretrained:
            state = featurizer.state_dict()
            same = all(torch.equal(v.cpu(), sd[k]) for k, v in state.items()
                       if not k.endswith("num_batches_tracked"))
            print(f"zoo {name}: served featurizer holds the file's {len(state)} tensors: {same}")
            if not same:
                raise AssertionError(f"{name}: the served weights are not the file's")
        head = HEAD_WRAPPERS[prec]
        serve_fn = net.make_serving_fn()
        x = val_ds.gather(np.arange(args.batch_size))
        _counts(reset=True)
        served = serve_fn(x)
        torch.cuda.synchronize()
        per_request = _counts()
        _counts(reset=True)
        report = serve.latency_bench(net, val_ds, args)
        torch.cuda.synchronize()
        launches = _counts()
        peak = torch.cuda.max_memory_allocated()
        requests = report["batches"] + 3  # the latency run's warm-up requests count too
        expect = {n: 0 for n in WRAPPERS}
        expect[head] = 1
        if per_request != expect or launches != {n: c * requests for n, c in expect.items()}:
            raise AssertionError(f"{name}: launches {per_request} per request, {launches} over "
                                 f"{requests} requests; want one {head} a request")
        with torch.inference_mode():
            feats = net._featurize_eval(torch.from_numpy(x).to(net.device))
            plain = plain_head(net, feats)
        torch.cuda.synchronize()
        prep = net._prepared_full
        err = float((served - plain).abs().max())
        ok = (tuple(served.shape) == (args.batch_size, net.n_classes)
              and bool(torch.isfinite(served).all()) and within(served, plain, **HEAD_TOL[prec]))
        print(f"zoo {name}: {type(featurizer).__name__} dtype {featurizer.dtype}, features "
              f"(B={feats.shape[0]}, D={feats.shape[1]}, mean norm "
              f"{float(feats.norm(dim=1).mean()):.2f}); {head} {per_request[head]} a request, "
              f"{launches[head]} over {requests} requests; served vs the plain head max|err| "
              f"{err:.3e} {'ok' if ok else 'FAIL'}; bank S={prep.s.shape[0]} {prep.s.dtype} "
              f"prepared in {net.precompute_seconds:.2f}s; p50 {report['p50_ms']:.3f} ms, p95 "
              f"{report['p95_ms']:.3f} ms, {report['queries_per_sec']:.1f} q/s; peak device "
              f"memory {peak / 2**30:.2f} GiB")
        if not ok:
            raise AssertionError(f"{name}: served log-probs disagree with the plain head")
        out[name] = {"launches": launches, "head": head, "prec": prec, "report": report,
                     "served_err": err, "precompute_s": net.precompute_seconds,
                     "peak_bytes": peak}
        del net, serve_fn, featurizer
        torch.cuda.empty_cache()
    return out


def zoo_training_phase(datasets, workdir: str) -> dict:
    """``ZOO_TRAIN_RUNS`` through ``train.setup`` and ``NWTrainer``, 3 steps
    each on the CUB-scale data at 224 px: ResNet-50 f32 (K1, dq, ds at
    D = 2,048 on 400 support rows), ResNet-50 with the bf16 backbone and a
    bf16 head (their bf16 route, 800 rows) and DenseNet-121 with its dense
    layers checkpointed (D = 1,024, the recipe's 1,200 rows). Checks one K1,
    dq and ds launch a step, the first step's head against the plain
    versions (``check_raw_kernels``), finite losses and moved weights;
    prints the step time (CUDA events from hooks in the steps, steps 2-3)
    and the peak device memory."""
    import torch

    from nwhead_tpu_torch import train
    from nwhead_tpu_torch.ops import fused_nw as F

    out = {}
    for name, flags, min_support, options, prec in ZOO_TRAIN_RUNS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        args, trainer, _ = train.setup(ZOO_TRAIN_ARGV + flags + ["--models_dir", workdir],
                                       datasets=datasets, featurizer_kwargs=options)
        net = trainer.net
        if min_support is not None:
            net.model.head.fused_min_support = min_support
        captured = {}

        def capture(module, inputs, output):
            if "q" not in captured and torch.is_grad_enabled() and inputs[1].dim() == 2:
                captured.update(q=inputs[0].detach().clone(), s=inputs[1].detach().clone(),
                                sy=inputs[2].detach().clone())

        handle = net.model.head.register_forward_hook(capture)
        timer = StepTimer(net.model)
        before = {n: p.detach().clone() for n, p in net.model.named_parameters()}
        _counts(reset=True)
        trainer.train_epoch(num_steps=ZOO_TRAIN_STEPS)
        torch.cuda.synchronize()
        launches = _counts()
        peak = torch.cuda.max_memory_allocated()
        handle.remove()
        split = timer.split()
        losses = trainer.step_losses
        moved = sum(not torch.equal(p.detach(), before[n]) for n, p in net.model.named_parameters())
        S = captured["s"].shape[0]
        print(f"zoo train {name}: {type(net.model.featurizer).__name__} dtype "
              f"{net.model.featurizer.dtype}, head {prec}, episode: query "
              f"{tuple(captured['q'].shape)}, support {tuple(captured['s'].shape)} "
              f"(fused_min_support {net.model.head.fused_min_support}); launches "
              f"{ {n: launches[n] for n in RAW_WRAPPERS} }; losses {['%.4f' % v for v in losses]}; "
              f"{moved} of {len(before)} parameter tensors moved; step {split['step_ms']:.1f} ms "
              f"(featurizer fwd+bwd {split['featurizer_ms']:.1f} ms, head fwd+bwd "
              f"{split['head_ms']:.3f} ms; CUDA events, median of steps 2-{ZOO_TRAIN_STEPS}); "
              f"peak device memory {peak / 2**30:.2f} GiB")
        if any(launches[n] != ZOO_TRAIN_STEPS for n in RAW_WRAPPERS):
            raise AssertionError(f"{name}: K1/K3 launched {launches} in {ZOO_TRAIN_STEPS} steps")
        if len(losses) != ZOO_TRAIN_STEPS or not np.isfinite(losses).all() or moved == 0:
            raise AssertionError(f"{name}: losses {losses}, {moved} tensors moved")
        if S != net.support_train.support_size() or not net.model.head.takes_fused(
                captured["q"], captured["s"]):
            raise AssertionError(f"{name}: the episode ({S} rows) did not take the fused head")
        # The first step's head through the kernels against the plain
        # versions; queries drawn into their own episode make the plain
        # reference f64 (as in the training phase).
        dtype = torch.bfloat16 if prec == "bf16" else torch.float32
        mode, scale, qn, sn = F._resolve_mode(net.kernel_type, net.model.head.kernel_params(),
                                              captured["q"].to(dtype), captured["s"].to(dtype))
        qn, sn = qn.to(sn.dtype).contiguous(), sn.contiguous()
        dups = torch.nonzero((qn[:, None, :] == sn[None, :, :]).all(-1).any(1)).flatten()
        g = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (qn.shape[0], net.n_classes), np.float32)).to(net.device)
        errs = check_raw_kernels(qn, sn, captured["sy"].to(torch.int32), scale.detach(), mode,
                                 net.n_classes, g, prec, f"zoo first-step {name}",
                                 dup_queries=dups)
        out[name] = {"launches": launches, "prec": prec, "errs": errs, "split": split,
                     "peak_bytes": peak, "losses": losses, "support": S,
                     "dim": int(captured["q"].shape[1])}
        del trainer, net, captured, timer, before
        torch.cuda.empty_cache()
    return out


def zoo_update_entries(entries: list, kern: dict, served: dict, trained: dict) -> None:
    """The zoo phases' launches and errors added to the K1, K2, K3 and K4
    entries of the ``kernels`` line, with the D = 2,048 times beside the
    earlier ones (``d2048_*``; K4's at DenseNet-121's D = 1,024,
    ``d1024_*``)."""
    by_name = {e["name"]: e for e in entries}
    for prec, r in kern["prepared"].items():
        e = by_name[f"nw_prepared_{prec}"]
        runs = [s for s in served.values() if s["prec"] == prec]
        e["launches"] += sum(s["launches"][s["head"]] for s in runs)
        e["max_abs_err"] = max([e["max_abs_err"], r["max_abs_err"]]
                               + [s["served_err"] for s in runs])
        key, case = ("d1024", "d121_b64") if prec == "int8" else ("d2048", "r50_b64")
        t = r["timed"][case]
        e.update({f"{key}_ms": t["ms"], f"{key}_plain_ms": t["plain_ms"],
                  f"{key}_bound_ms": t["bound_ms"], f"{key}_bound_by": t["bound_by"]})
    for k, by_prec in kern["raw"].items():
        for prec, r in by_prec.items():
            e = by_name[f"{k}_{prec}"]
            runs = [t for t in trained.values() if t["prec"] == prec]
            e["launches"] += sum(t["launches"][f"{k}_cuda"] for t in runs)
            e["max_abs_err"] = max([e["max_abs_err"], r["max_abs_err"]]
                                   + [t["errs"][k] for t in runs])
            t = r["timed"]
            e.update({"d2048_case": t["case"], "d2048_ms": t["ms"], "d2048_plain_ms": t["plain_ms"],
                      "d2048_bound_ms": t["bound_ms"], "d2048_bound_by": t["bound_by"]})


# ---------------------------------------------------------------------------
# The int8 CNN featurizers: ResNet-50 (from the zoo's written checkpoint),
# ResNeXt-50, DenseNet-121 and ResNet-18 served through the int8 conv route
# (ops/int8_conv.py) into K2, K4 and K5.
# ---------------------------------------------------------------------------

# name, flags, serves a written checkpoint (--pretrained_path), head
# precision, the backbone's int8 convs a request, the feature gates against
# the f32 model (max|d| / max|f|, min cosine; None: no gate): JAX's
# (tests/test_quantize.py: resnet10's for the ResNets, resnext50_32x4d's,
# densenet121's).
INT8_CNN_CONFIGS = (
    ("r50_int8_f32", ["--arch", "resnet50"], True, "f32", 16 * 3 + 4, (0.05, 0.995)),
    ("r50_int8_int8", ["--arch", "resnet50", "--head_precision", "int8"], True, "int8",
     16 * 3 + 4, (0.05, 0.995)),
    ("rx50_int8_f32", ["--arch", "resnext50_32x4d"], False, "f32", 16 * 3 + 4, (0.06, None)),
    ("d121_int8_int8", ["--arch", "densenet121", "--head_precision", "int8"], False, "int8",
     (6 + 12 + 24 + 16) * 2 + 3, (0.08, 0.99)),
    ("r18_int8_int4", ["--arch", "resnet18", "--head_precision", "int4"], False, "int4",
     8 * 2 + 3, (0.05, 0.995)),
)
INT8_CKPT_FILE = "resnet50_trained_like.pth"
INT8_CALIB_SHOWN = 64  # the first calibration images, their agreement printed
# ResNeXt-50 32x4d's grouped 3x3 convs (B, H, channels, stride) timed on the
# block-diagonal route and on one K- and N-padded GEMM per group.
GROUPED_CASES = (("rx50_layer1", 64, 56, 128, 1), ("rx50_layer4", 64, 7, 1024, 1))


def trained_like_batchnorm(model, images, passes: int = 3) -> None:
    """Every BatchNorm's running statistics moved from the init's (0, 1)
    by ``passes`` train-mode passes over ``images`` at the model's momentum
    (0.1), no gradient: the JAX package's ``_init_trained_like``
    (``tests/test_quantize.py``), where its int8 feature gates were set.
    ``calibrate_batchnorm``'s exact batch statistics leave channels of
    near-zero variance, which ``1 / sqrt(var + eps)`` turns into outlier
    channels of a random network; one such channel sets a per-tensor
    activation scale for all (PTQ of a trained network does not meet them:
    its BatchNorm scales are small there)."""
    import torch

    device = next(model.parameters()).device
    x = torch.as_tensor(images).to(device)
    model.train()
    with torch.no_grad():
        for _ in range(passes):
            model(x)
    model.eval()


def _event_split(fn, parts: dict, reps: int = 5) -> dict:
    """``fn()`` timed by CUDA events, and inside it the calls of each
    ``parts`` entry (label -> (module, attribute)), each wrapped to record
    events around itself: the median over ``reps`` calls of the total and of
    each part's summed ms, and the GEMM's operations and bytes (the
    unpadded problem's) a call."""
    import torch

    spans = {k: [] for k in parts}
    work = {"gemm_ops": 0, "gemm_bytes": 0}
    saved = {k: getattr(m, a) for k, (m, a) in parts.items()}

    def wrap(label, orig):
        def wrapped(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*args, **kwargs)
            end.record()
            spans[label].append((start, end))
            if label == "int_mm":
                (M, K), N = args[0].shape, args[1].shape[0]
                work["gemm_ops"] += 2 * M * K * N
                work["gemm_bytes"] += M * K + N * K + 4 * M * N
            return out
        return wrapped

    rows = []
    try:
        for k, (m, a) in parts.items():
            setattr(m, a, wrap(k, saved[k]))
        for _ in range(reps):
            for v in spans.values():
                v.clear()
            work.update(gemm_ops=0, gemm_bytes=0)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            rows.append({"total_ms": start.elapsed_time(end),
                         **{k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()},
                         "calls": {k: len(v) for k, v in spans.items()}})
    finally:
        for k, (m, a) in parts.items():
            setattr(m, a, saved[k])
    out = {k: float(np.median([r[k] for r in rows])) for k in ["total_ms", *parts]}
    out["rest_ms"] = out["total_ms"] - sum(out[k] for k in parts)
    out.update(calls=rows[-1]["calls"], **work)
    return out


def _grouped_per_group(codes, wq, stride: int, padding: int, groups: int):
    """A grouped conv as one ``_gemm`` per group, each group's K and N
    zero-padded to 8 inside ``_gemm``: the other exact route, timed beside
    the block-diagonal one."""
    import torch

    from nwhead_tpu_torch.ops import int8_conv as IC

    kh, kw, cpg, cout = wq.shape
    opg = cout // groups
    a, (B, Ho, Wo) = IC._im2col(codes, kh, kw, stride, padding)
    a = a.view(-1, kh * kw, groups, cpg)
    outs = []
    for g in range(groups):
        w_g = wq[..., g * opg:(g + 1) * opg].reshape(kh * kw * cpg, opg).t().contiguous()
        outs.append(IC._gemm(a[:, :, g, :].reshape(-1, kh * kw * cpg), w_g))
    return torch.cat(outs, dim=1).reshape(B, Ho, Wo, cout)


def grouped_route_phase(flush) -> dict:
    """ResNeXt-50's grouped 3x3 convs (``GROUPED_CASES``) on the two exact
    routes: the block-diagonal dense weight in one GEMM (the route) and one
    K- and N-padded GEMM per group; both bit-equal to the plain version,
    timed (``time_ms``), the dense route's GEMM weight made once as
    ``QConv`` keeps it."""
    import torch

    from nwhead_tpu_torch.ops import int8_conv as IC

    out = {}
    for name, B, H, C, stride in GROUPED_CASES:
        rng = np.random.default_rng(2300)
        codes = torch.from_numpy(rng.integers(-127, 128, (B, H, H, C)).astype(np.int8)).cuda()
        wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, C // 32, C)).astype(np.int8)).cuda()
        w_gemm = IC.gemm_weight(wq, 32)
        dense = IC.int8_conv2d_cuda(codes, wq, stride, 1, 32, w_gemm)
        per_group = _grouped_per_group(codes, wq, stride, 1, 32)
        want = IC._int8_conv2d_plain(codes, wq, stride, 1, 32)
        torch.cuda.synchronize()
        if not (torch.equal(dense, want) and torch.equal(per_group, want)):
            raise AssertionError(f"grouped conv {name}: a route differs from the plain version")
        r = {"block_diagonal_ms": time_ms(lambda: IC.int8_conv2d_cuda(codes, wq, stride, 1, 32,
                                                                         w_gemm), flush),
             "per_group_ms": time_ms(lambda: _grouped_per_group(codes, wq, stride, 1, 32), flush),
             "cudnn_bf16_grouped_ms": time_ms(lambda: torch.nn.functional.conv2d(
                 codes.permute(0, 3, 1, 2).to(torch.bfloat16),
                 wq.permute(3, 2, 0, 1).to(torch.bfloat16), stride=stride, padding=1, groups=32),
                 flush)}
        print(f"grouped int8 conv {name} (B={B}, {H}x{H}, {C} channels, 32 groups of {C // 32}): "
              f"block-diagonal {r['block_diagonal_ms']:.4f} ms, one padded GEMM a group "
              f"{r['per_group_ms']:.4f} ms, cuDNN bf16 grouped conv (a yardstick, not the same "
              f"function) {r['cudnn_bf16_grouped_ms']:.4f} ms; both routes bit-equal to plain")
        out[name] = r
    return out


def _feature_agreement(q, model, x) -> tuple:
    """``(max|d| / max|f|, min cosine)`` of the quantized features against
    the f32 model's on the images ``x``."""
    import torch

    with torch.inference_mode():
        got, want = q(x), model(x)
    rel = float((got - want).abs().max() / want.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=1).min())
    return rel, cos, bool(torch.isfinite(got).all())


def int8_cnn_serving_phase(datasets, workdir: str, zoo_served: dict) -> dict:
    """``INT8_CNN_CONFIGS`` through the serve module at B=64 on
    ``synthetic_cub`` with ``--featurizer_precision int8`` (256 calibration
    images): ResNet-50 from a written torchvision-format checkpoint
    (``--pretrained_path``) with an f32 and an int8 head (K2 at D = 2,048,
    K4), ResNeXt-50 32x4d (the grouped route), DenseNet-121 with an int8
    head (K4 at D = 1,024) and ResNet-18 with an int4 head (K5); every
    backbone's BatchNorm statistics set by ``trained_like_batchnorm`` on 64
    training images first (the checkpoint's when it is written). Checks,
    per request, one launch of the head's kernel (no other) and as many
    ``int8_conv2d_cuda`` launches as the backbone has int8 convs; the
    served log-probs against the plain head on the same features; the
    features bit-equal to the same featurizer on the int8 route's plain
    version on the card; the served batch's features against the f32
    model's at JAX's gates (the agreement on the first 64 calibration
    images, where JAX's test reads its gates, is printed beside it). Every
    config runs before the phase fails on any check. Prints p50, p95, queries/s, the calibration's and the bank's
    seconds, peak memory, one featurizer call split by CUDA events (im2col,
    ``_int_mm``, the bf16 stem, the rest: the quantize and dequantize
    chains, ReLUs, residual adds, concatenations, pools), and the zoo
    phase's ResNet-50 f32 and ``--bf16`` p50s beside them. Also prints,
    with no gate, the int8 features' agreement on the zoo phase's
    checkpoint, whose statistics ``calibrate_batchnorm`` set."""
    import os

    import torch

    from nwhead_tpu_torch import serve
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.models import quantize as TQ
    from nwhead_tpu_torch.ops import int8_conv as IC

    train_ds, val_ds = datasets
    calib = train_ds.gather(np.arange(ZOO_CALIB_IMAGES))
    path = os.path.join(workdir, INT8_CKPT_FILE)
    write_zoo_checkpoint(path, calib, trained_like_batchnorm)
    cli = serve.parse_args(ZOO_SERVE_ARGV)
    dev, n_cal = torch.device(cli.device), cli.calib_images
    calib_x = torch.from_numpy(train_ds.gather(np.arange(INT8_CALIB_SHOWN))).to(dev)
    zoo_model = load_model("resnet50", device=dev, pretrained=os.path.join(workdir, ZOO_CKPT_FILE))
    zoo_q = TQ.quantize_featurizer(zoo_model, train_ds.gather(np.arange(n_cal)))
    zoo_rel, zoo_cos, _ = _feature_agreement(zoo_q, zoo_model, calib_x)
    print(f"int8 cnn finding (no gate): ResNet-50 of the zoo phase's checkpoint "
          f"(calibrate_batchnorm's statistics) quantized on {n_cal} images: features vs the "
          f"f32 model on the first {INT8_CALIB_SHOWN} of them max|d|/max|f| {zoo_rel:.4f}, "
          f"min cosine {zoo_cos:.5f}")
    del zoo_model, zoo_q
    out = {"zoo_checkpoint": {"feature_rel": zoo_rel, "feature_cos": zoo_cos}}
    failed = []
    for name, flags, pretrained, prec, n_convs, (rel_gate, cos_gate) in INT8_CNN_CONFIGS:
        args = serve.parse_args(ZOO_SERVE_ARGV + flags + ["--featurizer_precision", "int8"]
                                + (["--pretrained_path", path] if pretrained else []))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        net = serve.build_server(args, train_ds, edit=None if pretrained else (
            lambda n: trained_like_batchnorm(n.model.featurizer, calib)))
        q = net.serving_featurizer
        have = sum(isinstance(m, TQ.QConv) for m in q.modules())
        if have != n_convs:
            raise AssertionError(f"{name}: {type(q).__name__} holds {have} int8 convs, want "
                                 f"{n_convs}")
        head = HEAD_WRAPPERS[prec]
        serve_fn = net.make_serving_fn()
        x = val_ds.gather(np.arange(args.batch_size))
        _counts(reset=True)
        IC.int8_conv2d_cuda.launches = 0
        served = serve_fn(x)
        torch.cuda.synchronize()
        per_request = {**_counts(), "int8_conv2d_cuda": IC.int8_conv2d_cuda.launches}
        _counts(reset=True)
        IC.int8_conv2d_cuda.launches = 0
        report = serve.latency_bench(net, val_ds, args)
        torch.cuda.synchronize()
        launches = {**_counts(), "int8_conv2d_cuda": IC.int8_conv2d_cuda.launches}
        peak = torch.cuda.max_memory_allocated()
        requests = report["batches"] + 3  # the latency run's warm-up requests count too
        expect = {n: 0 for n in WRAPPERS}
        expect.update({head: 1, "int8_conv2d_cuda": n_convs})
        if per_request != expect or launches != {n: c * requests for n, c in expect.items()}:
            raise AssertionError(f"{name}: launches {per_request} per request, {launches} over "
                                 f"{requests} requests; want {expect} a request")
        xt = torch.from_numpy(x).to(net.device)
        with torch.inference_mode():
            feats = net._featurize_eval(xt)
            plain = plain_head(net, feats)
            saved = IC.int8_conv2d_cuda
            IC.int8_conv2d_cuda = lambda c, w, s, p, g=1, w_gemm=None: IC._int8_conv2d_plain(
                c, w, s, p, g)
            try:
                plain_route = q(xt)
            finally:
                IC.int8_conv2d_cuda = saved
        torch.cuda.synchronize()
        err = float((served - plain).abs().max())
        head_ok = (tuple(served.shape) == (args.batch_size, net.n_classes)
                   and bool(torch.isfinite(served).all()) and within(served, plain, **HEAD_TOL[prec]))
        same = bool(torch.equal(feats, plain_route))
        rel, cos, finite = _feature_agreement(q, net.model.featurizer, xt)
        cal_rel, cal_cos, _ = _feature_agreement(q, net.model.featurizer, calib_x)
        feats_ok = finite and rel < rel_gate and (cos_gate is None or cos > cos_gate)
        split = _event_split(lambda: q(xt), {"im2col": (IC, "_im2col"), "int_mm": (IC, "_gemm"),
                                             "stem": (TQ, "stem_conv_bf16")})
        gemm_bound = bound(split["gemm_bytes"], split["gemm_ops"], "int8")
        print(f"int8 cnn {name}: {type(q).__name__} (D={feats.shape[1]}), {n_convs} int8 convs; "
              f"a request: {head} {per_request[head]}, int8_conv2d_cuda "
              f"{per_request['int8_conv2d_cuda']} ({launches['int8_conv2d_cuda']} over {requests} "
              f"requests); served vs the plain head max|err| {err:.3e} "
              f"{'ok' if head_ok else 'FAIL'}; features vs the plain route on the card bit-equal: "
              f"{same}; vs the f32 model max|d|/max|f| {rel:.4f} (gate {rel_gate}), min cosine "
              f"{cos:.5f} (gate {cos_gate}) {'ok' if feats_ok else 'FAIL'}, on the first "
              f"{INT8_CALIB_SHOWN} calibration images {cal_rel:.4f} / {cal_cos:.5f}; "
              f"calibration {net.calibration_seconds:.2f}s, bank S={net._prepared_full.s.shape[0]} "
              f"{net._prepared_full.s.dtype} in {net.precompute_seconds:.2f}s; p50 "
              f"{report['p50_ms']:.3f} ms, p95 {report['p95_ms']:.3f} ms, "
              f"{report['queries_per_sec']:.1f} q/s; peak device memory {peak / 2**30:.2f} GiB")
        print(f"split int8 cnn {name} featurizer (B=64, CUDA events, median of 5): total "
              f"{split['total_ms']:.3f} ms = im2col {split['im2col']:.3f} ms ({split['calls']['im2col']}"
              f" calls) + _int_mm {split['int_mm']:.3f} ms ({split['calls']['int_mm']} calls; "
              f"{split['gemm_ops'] / 1e9:.1f} G int8 ops, {split['gemm_bytes'] / 1e6:.1f} MB, bound "
              f"{gemm_bound['bound_ms']:.3f} ms by {gemm_bound['bound_by']}) + bf16 stem "
              f"{split['stem']:.3f} ms + the rest {split['rest_ms']:.3f} ms")
        failed += [f"{name}: {what}" for what, ok in (
            ("served log-probs disagree with the plain head", head_ok),
            ("the int8 route's features differ from its plain version", same),
            (f"int8 features off the f32 model's ({rel}, {cos})", feats_ok)) if not ok]
        out[name] = {"launches": launches, "head": head, "prec": prec, "report": report,
                     "served_err": err, "calibration_s": net.calibration_seconds,
                     "precompute_s": net.precompute_seconds, "peak_bytes": peak,
                     "feature_rel": rel, "feature_cos": cos, "calib_rel": cal_rel,
                     "calib_cos": cal_cos, "split": split}
        del net, serve_fn, q
        torch.cuda.empty_cache()
    beside = {k: zoo_served[k]["report"]["p50_ms"] for k in ("r50_pretrained_f32",
                                                             "r50_bf16_backbone")}
    print(f"ResNet-50 p50 at B=64 in this run: int8 featurizer {out['r50_int8_f32']['report']['p50_ms']:.3f}"
          f" ms (f32 head), f32 backbone {beside['r50_pretrained_f32']:.3f} ms, --bf16 backbone "
          f"{beside['r50_bf16_backbone']:.3f} ms")
    if failed:
        raise AssertionError("int8 CNN serving: " + "; ".join(failed))
    return out


def int8_cnn_update_entries(entries: list, served: dict) -> None:
    """The int8 CNN phase's launches and errors added to the K2, K4 and K5
    entries of the ``kernels`` line."""
    by_name = {e["name"]: e for e in entries}
    for run in served.values():
        if "prec" not in run:
            continue
        e = by_name[f"nw_prepared_{run['prec']}"]
        e["launches"] += run["launches"][run["head"]]
        e["max_abs_err"] = max(e["max_abs_err"], run["served_err"])


# ---------------------------------------------------------------------------
# Bank edits: NWNet.add_support / remove_support / restore_bank on the CUB
# serving bank (K2, K4, K5, K6 and K2 partials), and concat / mask on the
# million-row bank (K4).
# ---------------------------------------------------------------------------

EDIT_ARGV = ["--dataset", "synthetic_cub", "--arch", "resnet18", "--batch_size", "64"]
EDIT_ADD, EDIT_REMOVE, EDIT_ENV_ADD = 256, 64, 64  # rows added, tombstoned, added to env 1
EDIT_PROBE = 2  # the IVF leg's n_probe; the grown bank is also probed whole
BIG_ADD, BIG_MASK = 65_536, 10_000  # million-row bank: rows concatenated, rows tombstoned


def _synced(fn):
    """``(result, seconds)`` of ``fn()`` by the host's clock, the card
    synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _edit_net(base, prec: str, **kw):
    """A net on ``base``'s featurizer (the same module) and dataset at head
    precision ``prec``, its bank installed from ``base``'s features by
    ``restore_bank`` (no featurizer pass); returns it and the seconds."""
    from nwhead_tpu_torch.nw.net import NWNet

    net = NWNet(base.model.featurizer, base.n_classes, support_dataset=base.support_dataset,
                device=base.device, kernel_type=base.kernel_type,
                n_shot_full=base.support_eval.n_shot_full, head_precision=prec,
                fused_min_support=1, **kw)
    _, seconds = _synced(lambda: net.restore_bank(base.full_feat, base.full_y,
                                                  meta=base.support_eval.full_meta))
    return net, seconds


def _served_with_features(net, fn, x):
    """``fn(x)`` (a serving callable of ``net``) and the features it used."""
    tap = _FeatureTap(net.model.featurizer)
    try:
        out = fn(x)
    finally:
        tap.handle.remove()
    return out, tap.out


def bank_edit_phase(datasets) -> dict:
    """``NWNet.add_support`` / ``remove_support`` on the CUB serving bank
    (ResNet-18, D=512, S=5,800, C=200): a serving callable made first, then
    ``add_support`` of 256 validation images (the O(new) concat),
    ``remove_support`` of 64 rows (tombstones), of enough more to pass 25%
    of the prepared rows (a compaction), and ``add_support`` of 64 images
    to a new environment, at each head precision (f32 and bf16 K2, int8
    K4, int4 K5). After each edit the callable's log-probs are held to the
    plain head over the rows left and to a fresh ``restore_bank`` of them
    served through the kernel. Then the IVF bank grown by the same adds
    (K6; ``concat_ivf`` counted, no rebuild; every tile probed equals full
    mode) and a tombstone removal on four shards of the card (K2
    ``partials=True``) held to a rebuilt sharded bank. Prints the seconds
    of each edit beside the rebuild it replaces, and the launches of the
    edited banks' serving calls."""
    import torch

    import nwhead_tpu_torch.nw.net as N
    from nwhead_tpu_torch import serve
    from nwhead_tpu_torch.ops import fused_nw as F
    from nwhead_tpu_torch.ops import ivf as I
    from nwhead_tpu_torch.parallel import ShardedSupportBank, make_mesh

    train_ds, val_ds = datasets
    t_phase = time.perf_counter()
    base = serve.build_server(serve.parse_args(EDIT_ARGV), train_ds)
    precompute_s = base.precompute_seconds
    x = val_ds.gather(np.arange(64))
    pool = np.arange(64, 64 + EDIT_ADD + EDIT_ENV_ADD)
    images, labels = val_ds.gather(pool), np.asarray(val_ds.targets)[pool]
    S0 = len(base.full_y)
    print(f"bank edits: precompute of the {S0}-row bank {precompute_s:.4f}s (featurizer pass "
          f"over every image, then the prepare); each edit below beside a restore_bank of its "
          f"rows (no featurizer pass)")
    out = {"launches": {}, "errs": {}, "seconds": {"precompute": precompute_s}}

    def serve_counted(net, fn, key):
        _counts(reset=True)
        served, feats = _served_with_features(net, fn, x)
        torch.cuda.synchronize()
        for name, n in _counts().items():
            if n:
                out["launches"][(key, name)] = out["launches"].get((key, name), 0) + n
        return served, feats

    for prec in ("f32", "bf16", "int8", "int4"):
        net, restore_s = _edit_net(base, prec)
        serve_fn = net.make_serving_fn()
        n_compact = int(N.NWNet._COMPACT_DEAD_FRAC * (S0 + EDIT_ADD)) - EDIT_REMOVE + 1
        rng = np.random.default_rng(IVF_SEED)
        steps = (
            ("add", lambda: net.add_support(images[:EDIT_ADD], labels[:EDIT_ADD])),
            ("tombstone", lambda: net.remove_support(rng.choice(S0 + EDIT_ADD, EDIT_REMOVE,
                                                                replace=False))),
            ("compact", lambda: net.remove_support(rng.choice(len(net.full_y), n_compact,
                                                              replace=False))),
            ("env add", lambda: net.add_support(images[EDIT_ADD:], labels[EDIT_ADD:],
                                                env_id=1)),
        )
        errs, line = [], []
        for step, edit in steps:
            prep, rows = net._prepared_full, net._prepared_full.labels.shape[0]
            _, seconds = _synced(edit)
            ref, ref_s = _edit_net(net, prec)
            served, feats = serve_counted(net, serve_fn, prec)
            with torch.inference_mode():
                oracle = ref.model.predict_from_prepared(feats, ref._prepared_full)
                plain = plain_head(ref, feats)
            torch.cuda.synchronize()
            err = max(float((served - plain).abs().max()), float((served - oracle).abs().max()))
            ok = (tuple(served.shape) == (64, net.n_classes) and bool(torch.isfinite(served).all())
                  and within(served, plain, **HEAD_TOL[prec])
                  and within(served, oracle, **HEAD_TOL[prec]))
            new = net._prepared_full
            path_ok = {
                "add": new.labels.shape[0] > rows and torch.equal(new.s[:rows], prep.s),
                "tombstone": new.s is prep.s and net._prepared_dead == EDIT_REMOVE,
                "compact": net._prepared_dead == 0 and new.labels.shape[0] == len(net.full_y),
                "env add": new.labels.shape[0] > rows and torch.equal(new.s[:rows], prep.s),
            }[step]
            out["seconds"][(prec, step)] = seconds
            out["seconds"][(prec, step, "restore")] = ref_s
            errs.append(err)
            line.append(f"{step} {seconds:.4f}s (restore_bank {ref_s:.4f}s) S={len(net.full_y)} "
                        f"max|err| {err:.2e}{'' if ok and path_ok else ' FAIL'}")
            del ref
            if not (ok and path_ok):
                raise AssertionError(f"bank edit {prec} {step}: "
                                     + ("wrong path" if ok else "served log-probs disagree"))
        out["errs"][prec] = max(errs)
        print(f"bank edits {prec}: first restore_bank {restore_s:.4f}s; " + "; ".join(line))
        del net, serve_fn
        torch.cuda.empty_cache()

    # IVF growth (K6): the adds join a chunk of the new rows by concat_ivf.
    net, _ = _edit_net(base, "f32", ivf_n_probe=EDIT_PROBE)
    net._ivf_bank()
    serve_ivf = net.make_serving_fn(mode="ivf")
    calls = {"concat_ivf": 0, "prepare_support_ivf": 0}
    real = {name: getattr(N, name) for name in calls}

    def counted(name):
        def call(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return call

    try:
        for name in calls:
            setattr(N, name, counted(name))
        _, add_s = _synced(lambda: net.add_support(images[:EDIT_ADD], labels[:EDIT_ADD]))
        _, env_s = _synced(lambda: net.add_support(images[EDIT_ADD:], labels[EDIT_ADD:],
                                                   env_id=1))
        ivf = net._ivf_bank()
    finally:
        for name, fn in real.items():
            setattr(N, name, fn)
    served, feats = serve_counted(net, serve_ivf, "ivf")
    n_tiles = ivf.cents.shape[0]
    with torch.inference_mode():
        params = net.model.head.kernel_params()
        qk, tsel, _ = I._ivf_route(feats, ivf, kernel=net.kernel_type, kernel_params=params,
                                   n_probe=EDIT_PROBE, group_b=None)
        q, scale, mode, qscale = F._prepared_query(qk, ivf.prep, net.kernel_type, params)
        plain = F._nw_prepared_sel_plain(q, ivf.prep, scale, mode, net.n_classes, qscale, tsel)
        every = net._ivf_head(feats, ivf, n_tiles, None)
        full = net.model.predict_from_prepared(feats, net._prepared_full)
    torch.cuda.synchronize()
    err = float((served - plain).abs().max())
    full_err = float((every.exp() - full.exp()).abs().max())
    ok = (calls == {"concat_ivf": 2, "prepare_support_ivf": 2}
          and net._ivf_cache[0] is net.full_feat
          and within(served, plain, **HEAD_TOL["f32"]) and full_err < 1e-5)
    print(f"bank edits ivf: {n_tiles} tiles of {ivf.prep.block_s} after the adds "
          f"(add {add_s:.4f}s, env add {env_s:.4f}s; calls {calls}); routed (n_probe "
          f"{EDIT_PROBE}) vs plain max|err| {err:.2e}; every tile vs full mode max|dp| "
          f"{full_err:.2e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("bank edits ivf: the IVF bank was not grown by concat_ivf, or "
                             "its head disagrees")
    out["errs"]["ivf"] = err
    out["seconds"]["ivf add"] = add_s
    del net, serve_ivf, ivf
    torch.cuda.empty_cache()

    # Sharded removal: four shards of the card, tombstoned (K2 partials).
    mesh = make_mesh(1, SHARDS, devices=[base.device] * SHARDS)
    net, _ = _edit_net(base, "f32", mesh=mesh)
    serve_sh = net.make_serving_fn()
    bank = net.sharded_bank
    drop = np.random.default_rng(IVF_SEED + 2).choice(S0, EDIT_REMOVE, replace=False)
    _, rm_s = _synced(lambda: net.remove_support(drop))
    served, feats = serve_counted(net, serve_sh, "sharded")
    with torch.inference_mode():
        rebuilt, build_s = _synced(lambda: ShardedSupportBank.build(
            net.full_feat, net.full_y, mesh, net.n_classes, precision="f32", ivf=True))
        want = rebuilt.predict_fn()(feats)
        fresh = F.prepare_support(net.full_feat, net.full_y, net.n_classes)
        q, scale, mode, _ = F._prepared_query(feats, fresh, net.kernel_type)
        plain = F._nw_prepared_plain(q, fresh, scale, mode, net.n_classes)
    torch.cuda.synchronize()
    new = net.sharded_bank
    err = max(float((served - want).abs().max()), float((served - plain).abs().max()))
    ok = (new.dead == EDIT_REMOVE and new.capacity == bank.capacity
          and out["launches"].get(("sharded", "nw_prepared_partials_cuda")) == SHARDS
          and within(served, want, **HEAD_TOL["f32"]) and within(served, plain, **HEAD_TOL["f32"]))
    print(f"bank edits sharded ({SHARDS} shards of the card): remove_support of {EDIT_REMOVE} "
          f"rows {rm_s:.4f}s (tombstones; a rebuilt sharded bank {build_s:.4f}s), dead "
          f"{new.dead} of {new.capacity} rows; vs rebuilt and plain max|err| {err:.2e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("bank edits sharded: the tombstoned bank disagrees or rebuilt")
    out["errs"]["sharded"] = err
    del net, serve_sh, bank, new, rebuilt, base
    torch.cuda.empty_cache()
    totals = {}
    for (_, name), n in out["launches"].items():
        totals[name] = totals.get(name, 0) + n
    out["totals"] = totals
    print(f"bank edit launches (the edited banks' serving calls): {json.dumps(totals)}; phase "
          f"{time.perf_counter() - t_phase:.1f}s")
    return out


def bigbank_edit_phase(bank) -> dict:
    """``concat_prepared`` and ``mask_prepared_rows`` on the K6 phase's
    million-row bank (2^20 x 512, C=1,000) at int8, each against a whole
    ``prepare_support`` through K4: the last 65,536 rows prepared by
    ``prepare_for_concat`` and concatenated onto the first 983,040 (against
    the whole bank prepared at once), and 10,000 rows tombstoned (against
    the bank prepared with them masked). Seconds by the host's clock, the
    card synchronized, median of 3; each bank freed before the next."""
    import torch

    from nwhead_tpu_torch.ops import fused_nw as F

    s, sy, cents = bank
    S, C = s.shape[0], IVF_BANK[2]
    N = S - BIG_ADD
    q = _ivf_queries(cents, s.device)["skewed"]

    def median_s(fn):
        times = []
        for _ in range(3):
            res, t = _synced(fn)
            times.append(t)
            del res
        return float(np.median(times))

    def k4(prep):
        _counts(reset=True)
        got = F.nw_fused_from_prepared(q, prep, C)
        torch.cuda.synchronize()
        return got, _counts()["nw_prepared_int8_cuda"]

    whole_s = median_s(lambda: F.prepare_support(s, sy, C, precision="int8"))
    whole, order = F.prepare_support(s, sy, C, precision="int8", return_order=True)
    with torch.inference_mode():
        want = F.nw_fused_from_prepared(q, whole, C)
    old = F.prepare_support(s[:N], sy[:N], C, precision="int8")
    concat_s = median_s(lambda: F.concat_prepared(
        [old, F.prepare_for_concat(s[N:], sy[N:], C, old, precision="int8")]))
    cat = F.concat_prepared([old, F.prepare_for_concat(s[N:], sy[N:], C, old, precision="int8")])
    del old
    got, n_cat = k4(cat)
    cat_err = float((got - want).abs().max())
    cat_ok = within(got, want, **HEAD_TOL["int8"])
    del cat, got
    torch.cuda.empty_cache()
    drop = np.random.default_rng(IVF_SEED + 3).choice(S, BIG_MASK, replace=False)
    rows = F.inverse_order(order)[drop]
    mask_s = median_s(lambda: F.mask_prepared_rows(whole, rows))
    masked = F.mask_prepared_rows(whole, rows)
    got, n_mask = k4(masked)
    del masked, whole
    torch.cuda.empty_cache()
    keep = torch.ones(S, dtype=torch.float32, device=s.device)
    keep[torch.as_tensor(drop, device=s.device)] = 0.0
    oracle = F.prepare_support(s, sy, C, precision="int8", support_mask=keep)
    with torch.inference_mode():
        want_m = F.nw_fused_from_prepared(q, oracle, C)
    del oracle
    torch.cuda.empty_cache()
    mask_err = float((got - want_m).abs().max())
    ok = cat_ok and within(got, want_m, **HEAD_TOL["int8"]) and n_cat == n_mask == 1
    print(f"bank edits million-row int8 ({S} x {s.shape[1]}, C={C}): whole prepare_support "
          f"{whole_s:.4f}s; prepare_for_concat + concat_prepared of {BIG_ADD} rows "
          f"{concat_s:.4f}s, K4 vs whole max|err| {cat_err:.2e}; mask_prepared_rows of "
          f"{BIG_MASK} rows {mask_s:.4f}s, K4 vs masked prepare max|err| {mask_err:.2e}; K4 "
          f"launches {n_cat + n_mask} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("bank edits million-row: an edited bank disagrees with the whole "
                             "prepare")
    return {"launches": n_cat + n_mask, "err": max(cat_err, mask_err), "whole_s": whole_s,
            "concat_s": concat_s, "mask_s": mask_s}


def bank_edit_update_entries(entries: list, edits: dict, big: dict) -> None:
    """The bank-edit phases' launches and errors added to the K2, K4, K5, K6
    and K2 ``partials`` entries of the ``kernels`` line."""
    by_name = {e["name"]: e for e in entries}
    for (key, wrapper), n in edits["launches"].items():
        name = {"nw_prepared_cuda": f"nw_prepared_{key}",
                "nw_prepared_int8_cuda": "nw_prepared_int8",
                "nw_prepared_int4_cuda": "nw_prepared_int4",
                "nw_prepared_sel_cuda": "nw_prepared_sel_f32",
                "nw_prepared_partials_cuda": "nw_prepared_partials_f32"}.get(wrapper)
        if name is None:
            raise AssertionError(f"bank edits: unexpected launches of {wrapper}")
        e = by_name[name]
        e["launches"] += n
        e["max_abs_err"] = max(e["max_abs_err"], edits["errs"][key])
    e = by_name["nw_prepared_int8"]
    e["launches"] += big["launches"]
    e["max_abs_err"] = max(e["max_abs_err"], big["err"])


# ---------------------------------------------------------------------------
# The data layer and the FC baseline: CIFAR-100-shaped .npy files through the
# training CLI (fchead, then nwhead on K1/K3), the eval CLI's --bank_cache
# (K2), the serve CLI on its own cache (K2), and device_normalize_fn.
# ---------------------------------------------------------------------------

DATA_TRAIN, DATA_TEST = 10_000, 2_000  # CIFAR-100 has 50,000 / 10,000
DATA_SEED = 24
FC_ARGV = ["--dataset", "cifar100", "--arch", "resnet18", "--train_method", "fchead",
           "--batch_size", "128", "--lr", "0.01", "--num_steps_per_epoch", "10",
           "--num_val_steps_per_epoch", "5", "--log_interval", "1"]
FC_STEPS = 10
FC_CPU_TOL = 1e-3  # the first step's log-probs, card vs CPU, same weights (both f32)
NW_CIFAR_ARGV = ["--dataset", "cifar100", "--arch", "resnet18", "--batch_size", "8",
                 "--n_shot", "11", "--lr", "1e-2", "--num_epochs", "1",
                 "--num_steps_per_epoch", "5", "--num_val_steps_per_epoch", "3",
                 "--log_interval", "1"]
NW_CIFAR_STEPS = 5
CACHE_EVAL_ARGV = ["--dataset", "cifar100", "--arch", "resnet18", "--batch_size", "64",
                   "--modes", "full", "--num_val_steps", "10"]
CACHE_SERVE_ARGV = ["--dataset", "cifar100", "--arch", "CIFAR_ResNet18", "--batch_size", "64",
                    "--latency_bench", "--bench_batches", "30"]
NORMALIZE_SHAPE = (64, 224, 224, 3)
NORMALIZE_TOL = 1e-6


def write_cifar100(data_dir: str) -> None:
    """CIFAR-100-shaped ``.npy`` files (32 x 32 x 3 uint8, labels 0-99):
    each class a fixed random pattern plus noise, from ``DATA_SEED``."""
    import os

    rng = np.random.default_rng(DATA_SEED)
    base = os.path.join(data_dir, "cifar100")
    os.makedirs(base, exist_ok=True)
    patterns = rng.integers(0, 256, (100, 32, 32, 3)).astype(np.int16)
    for split, n in (("train", DATA_TRAIN), ("test", DATA_TEST)):
        labels = np.arange(n) % 100
        noise = rng.integers(-64, 64, (n, 32, 32, 3), dtype=np.int16)
        images = np.clip(patterns[labels] // 2 + 64 + noise, 0, 255).astype(np.uint8)
        np.save(os.path.join(base, f"{split}_images.npy"), images)
        np.save(os.path.join(base, f"{split}_labels.npy"), labels)


def fc_phase(data_dir: str, workdir: str) -> dict:
    """``python -m nwhead_tpu_torch.train --train_method fchead`` on the
    files (CIFAR_ResNet18, D=512, C=100, B=128): an eval and 10 steps, the
    first step's log-probs held to the same weights on the CPU; then
    ``--resume`` for a second epoch (no sampler sidecar, the step count
    carried on)."""
    import os

    import torch

    from nwhead_tpu_torch import train
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.nw.fc import FCNet
    from nwhead_tpu_torch.train.config import featurizer_name
    from nwhead_tpu_torch.train.trainer import FCTrainer

    argv = FC_ARGV + ["--data_dir", data_dir, "--models_dir", os.path.join(workdir, "fc")]
    args, trainer, start = train.setup(argv + ["--num_epochs", "1"])
    if not isinstance(trainer, FCTrainer):
        raise AssertionError("--train_method fchead did not build an FCTrainer")
    first = {}

    def pre(module, inputs):
        if module.training and "x" not in first:
            first.update(x=inputs[0].detach().clone(),
                         state={k: v.detach().cpu().clone()
                                for k, v in module.state_dict().items()})

    def post(module, inputs, output):
        if module.training and "out" not in first:
            first["out"] = output.detach().clone()

    hooks = [trainer.model.register_forward_pre_hook(pre),
             trainer.model.register_forward_hook(post)]
    _counts(reset=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train.run_epochs(args, trainer, start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for h in hooks:
        h.remove()
    launches = {k: v for k, v in _counts().items() if v}
    losses = trainer.step_losses
    if len(losses) != FC_STEPS or not np.isfinite(losses).all() or trainer.step != FC_STEPS:
        raise AssertionError(f"fchead: {trainer.step} steps, losses {losses}")
    ckpt = train.latest_checkpoint(args.ckpt_dir)
    if not ckpt.endswith("model.0001") or os.path.exists(ckpt + ".sampler.json"):
        raise AssertionError(f"fchead checkpoint {ckpt}")

    cpu = FCNet(load_model(featurizer_name(args.arch, args.dataset), device="cpu"), 100)
    cpu.load_state_dict(first["state"])
    with torch.no_grad():
        want = cpu.train()(first["x"].cpu())
    got = first["out"].cpu()
    cpu_err = float((got - want).abs().max())
    print(f"fchead: batch {tuple(first['x'].shape)}, log-probs {tuple(got.shape)}; card vs CPU "
          f"(same weights, train mode) max|err| {cpu_err:.3e} (tolerance {FC_CPU_TOL:g})")
    if (tuple(got.shape) != (args.batch_size, 100)
            or not within(got, want, FC_CPU_TOL, FC_CPU_TOL)):
        raise AssertionError("the card's FC step disagrees with the CPU")
    first_ms = trainer.train_seconds / FC_STEPS * 1e3
    del trainer, cpu
    torch.cuda.empty_cache()

    args, trainer, start = train.setup(argv + ["--num_epochs", "2", "--resume"])
    if start != 2 or trainer.step != FC_STEPS:
        raise AssertionError(f"resume: start epoch {start}, step {trainer.step}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train.run_epochs(args, trainer, start)
    torch.cuda.synchronize()
    resumed_peak = torch.cuda.max_memory_allocated()
    ms = trainer.train_seconds / FC_STEPS * 1e3
    ckpt = train.latest_checkpoint(args.ckpt_dir)
    if (trainer.step != 2 * FC_STEPS or not ckpt.endswith("model.0002")
            or not np.isfinite(trainer.step_losses).all()):
        raise AssertionError(f"resumed fchead: step {trainer.step}, {ckpt}")
    # Where a step's time goes: the host's gather and CIFAR transform of one
    # batch, and the step on a batch already on the card (CUDA events).
    ds, bs = trainer.train_dataset, args.batch_size
    t0 = time.perf_counter()
    img = ds.gather(np.arange(bs))
    gather_ms = (time.perf_counter() - t0) * 1e3
    x = torch.from_numpy(img).cuda()
    y = torch.from_numpy(np.asarray(ds.targets[:bs], np.int64)).cuda()
    for _ in range(3):
        trainer.train_step(x, y)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(FC_STEPS):
        trainer.train_step(x, y)
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / FC_STEPS
    print(f"fchead: {FC_STEPS} steps of {bs} in {first_ms:.2f} ms/step (host clock, first "
          f"step included), resumed epoch {ms:.2f} ms/step; a step on a batch on the card "
          f"{device_ms:.2f} ms (CUDA events, {FC_STEPS} in a row); the host's gather + CIFAR "
          f"transform of {bs} images {gather_ms:.2f} ms; eval + train {wall:.2f}s; peak device "
          f"memory {peak / 2**30:.2f} GiB (resumed {resumed_peak / 2**30:.2f}); losses "
          f"{['%.4f' % v for v in losses]}; library launches {launches or 'none'} (cuDNN "
          f"convs, cuBLAS linear)")
    out = {"ms_per_step": ms, "first_ms_per_step": first_ms, "device_ms": device_ms,
           "gather_ms": gather_ms, "peak_bytes": peak, "cpu_err": cpu_err}
    del trainer
    torch.cuda.empty_cache()
    return out


def nw_cifar_phase(data_dir: str, workdir: str) -> dict:
    """The training CLI's ``nwhead`` path on the same files: episodes of
    100 classes x 11 shots (1,100 rows: K1, dq and ds once a step), the
    full-mode eval on K2; the first step's head held to the plain
    versions."""
    import os

    import torch

    from nwhead_tpu_torch import train

    argv = NW_CIFAR_ARGV + ["--data_dir", data_dir, "--models_dir", os.path.join(workdir, "nw")]
    args, trainer, start = train.setup(argv)
    net = trainer.net
    captured, handle = capture_head_inputs(net)
    _counts(reset=True)
    t0 = time.perf_counter()
    train.run_epochs(args, trainer, start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    handle.remove()
    print(f"nwhead on cifar100 files: episode {tuple(captured['s'].shape)}, launches "
          f"{ {k: v for k, v in launches.items() if v} }; {NW_CIFAR_STEPS} steps "
          f"{trainer.train_seconds / NW_CIFAR_STEPS * 1e3:.1f} ms/step (host clock, first step "
          f"included); eval + train {wall:.2f}s; losses "
          f"{['%.4f' % v for v in trainer.step_losses]}")
    for name in RAW_WRAPPERS:
        if launches[name] != NW_CIFAR_STEPS:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{NW_CIFAR_STEPS} steps on the cifar100 files")
    if launches["nw_prepared_cuda"] == 0 or not np.isfinite(trainer.step_losses).all():
        raise AssertionError("the cifar100 NW run launched no K2 or lost finiteness")
    errs = first_step_head(net, captured, "cifar100 first-step")
    out = {"launches": launches, "errs": errs, "ckpt": train.latest_checkpoint(args.ckpt_dir)}
    del trainer, net, captured
    torch.cuda.empty_cache()
    return out


def bank_cache_phase(data_dir: str, workdir: str, ckpt: str) -> dict:
    """``python -m nwhead_tpu_torch.eval --modes full --bank_cache DIR`` on
    the NW run's checkpoint, twice, in process: the first run saves the
    bank, the second restores it; their results must be equal and each
    must launch K2."""
    import os
    from unittest import mock

    import torch

    from nwhead_tpu_torch import eval as eval_cli

    cache = os.path.join(workdir, "eval_bank")
    argv = CACHE_EVAL_ARGV + ["--data_dir", data_dir, "--ckpt", ckpt, "--bank_cache", cache]
    install = eval_cli.install_bank
    runs = []

    def recording(net, cache_dir=None):
        install(net, cache_dir)
        runs[-1].update(seconds=net.bank_seconds, rows=len(net.full_y), net=net)

    for what in ("saved", "restored"):
        runs.append({"what": what})
        _counts(reset=True)
        with mock.patch.object(eval_cli, "install_bank", recording):
            runs[-1]["results"] = eval_cli.main(argv)["full"]
        torch.cuda.synchronize()
        runs[-1]["launches"] = _counts()["nw_prepared_cuda"]
    saved, restored = runs
    # One batch of the restored bank through K2 against the plain head.
    net = restored.pop("net")
    saved.pop("net")
    x = net.support_dataset.gather(np.arange(64))  # any 64 images: the train set's
    got = net.predict(x, "full")
    with torch.inference_mode():
        plain = plain_head(net, net.model.featurize(torch.from_numpy(x).to(net.device)))
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    print(f"eval --bank_cache: precompute {saved['seconds']:.3f}s, restore "
          f"{restored['seconds']:.3f}s ({restored['rows']} rows, reading the files included); "
          f"K2 launches {saved['launches']} / {restored['launches']}; saved {saved['results']}, "
          f"restored {restored['results']}; restored K2 vs plain max|err| {err:.3e}")
    if saved["results"] != restored["results"]:
        raise AssertionError("the restored bank's results differ from the saved run's")
    if min(saved["launches"], restored["launches"]) == 0:
        raise AssertionError("the eval CLI's full mode launched no K2")
    if not within(got, plain, **TOL["f32"]):
        raise AssertionError("K2 over the restored bank disagrees with the plain head")
    del net
    torch.cuda.empty_cache()
    return {"launches": saved["launches"] + restored["launches"], "err": err,
            "precompute_s": saved["seconds"], "restore_s": restored["seconds"]}


def cache_serving_phase(data_dir: str, workdir: str) -> dict:
    """``python -m nwhead_tpu_torch.serve --latency_bench --bank_cache DIR``
    on the files, twice through the serve module's functions: the first
    server featurizes and saves the bank with its tag, the second restores
    it and is timed; one K2 launch a request, the served log-probs against
    the plain head. (The eval CLI's cache carries no tag, as JAX's, so the
    server refuses it.)"""
    import os

    import torch

    from nwhead_tpu_torch import serve

    cache = os.path.join(workdir, "serve_bank")
    args = serve.parse_args(CACHE_SERVE_ARGV + ["--data_dir", data_dir, "--bank_cache", cache])
    train_ds, val_ds = serve.build_datasets(args)
    first = serve.build_server(args, train_ds)
    precompute_s = first.precompute_seconds
    del first
    torch.cuda.empty_cache()
    _counts(reset=True)
    net = serve.build_server(args, train_ds)
    if not net.bank_restored:
        raise AssertionError("the second server did not restore the cached bank")
    torch.cuda.synchronize()
    built = _counts()["nw_prepared_cuda"]
    report = serve.latency_bench(net, val_ds, args)
    torch.cuda.synchronize()
    requests = report["batches"] + 3  # the bench's three warm-up requests
    launches = _counts()["nw_prepared_cuda"] - built
    x = val_ds.gather(np.arange(args.batch_size))
    served = net.make_serving_fn()(x)
    with torch.inference_mode():
        plain = plain_head(net, net.model.featurize(torch.from_numpy(x).to(net.device)))
    torch.cuda.synchronize()
    err = float((served - plain).abs().max())
    print(f"serve --bank_cache: precompute {precompute_s:.3f}s, restore "
          f"{net.precompute_seconds:.3f}s ({len(net.full_y)} rows); {launches} K2 launches in "
          f"{requests} requests; p50 {report['p50_ms']:.3f} ms, p95 {report['p95_ms']:.3f} ms, "
          f"{report['queries_per_sec']:.1f} q/s ({report['pixels']} pixels); served vs plain "
          f"max|err| {err:.3e}")
    if launches != requests:
        raise AssertionError(f"{launches} K2 launches for {requests} requests")
    if not bool(torch.isfinite(served).all()) or not within(served, plain, **TOL["f32"]):
        raise AssertionError("served log-probs over the restored bank disagree with the plain head")
    # The restored server stays up for the serving-surface phase's
    # images_b64 request.
    return {"launches": launches, "err": err, "report": report, "precompute_s": precompute_s,
            "restore_s": net.precompute_seconds, "net": net, "args": args,
            "datasets": (train_ds, val_ds)}


def normalize_phase() -> dict:
    """``device_normalize_fn`` on a 64 x 224 x 224 x 3 uint8 batch on the
    card against numpy's ``normalize(to_float(x))``; timed by CUDA events
    beside its bound (1 byte in, 4 out, per value)."""
    import torch

    from nwhead_tpu_torch.data import transforms as T

    u8 = np.random.default_rng(DATA_SEED).integers(0, 256, NORMALIZE_SHAPE, dtype=np.uint8)
    fn = T.device_normalize_fn()
    x = torch.from_numpy(u8).cuda()
    got = fn(x)
    want = T.normalize(T.to_float(u8), T.IMAGENET_MEAN, T.IMAGENET_STD)
    torch.cuda.synchronize()
    err = float(np.abs(got.cpu().numpy() - want).max())
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    ms = time_ms(lambda: fn(x), flush)
    del flush
    bound = u8.size * 5 / HBM_BYTES_PER_S * 1e3
    print(f"device_normalize_fn {NORMALIZE_SHAPE}: max|err| vs numpy {err:.3e} (tolerance "
          f"{NORMALIZE_TOL:g}); {ms:.4f} ms, bound {bound:.4f} ms (bytes)")
    if got.dtype != torch.float32 or tuple(got.shape) != NORMALIZE_SHAPE or err > NORMALIZE_TOL:
        raise AssertionError("device_normalize_fn disagrees with numpy's normalize")
    return {"err": err, "ms": ms, "bound_ms": bound}


def data_fc_phase(workdir: str) -> dict:
    """The data layer and the FC baseline at CIFAR-100's shape (see the
    functions it calls)."""
    import os

    data_dir = os.path.join(workdir, "data")
    t0 = time.perf_counter()
    write_cifar100(data_dir)
    print(f"cifar100 .npy files: {DATA_TRAIN:,} / {DATA_TEST:,} images of 32 x 32 x 3 uint8, 100 "
          f"classes (cut from CIFAR-100's 50,000 / 10,000), written in "
          f"{time.perf_counter() - t0:.1f}s")
    out = {"fc": fc_phase(data_dir, workdir)}
    out["nw"] = nw_cifar_phase(data_dir, workdir)
    out["cache"] = bank_cache_phase(data_dir, workdir, out["nw"]["ckpt"])
    out["serve"] = cache_serving_phase(data_dir, workdir)
    out["normalize"] = normalize_phase()
    return out


def data_update_entries(entries: list, data: dict) -> None:
    """The data phase's launches and errors added to the K1, dq, ds and K2
    f32 entries of the ``kernels`` line."""
    by_name = {e["name"]: e for e in entries}
    for k in ("nw_fwd", "nw_bwd_dq", "nw_bwd_ds"):
        e = by_name[f"{k}_f32"]
        e["launches"] += data["nw"]["launches"][f"{k}_cuda"]
        e["max_abs_err"] = max(e["max_abs_err"], data["nw"]["errs"][k])
    e = by_name["nw_prepared_f32"]
    e["launches"] += (data["nw"]["launches"]["nw_prepared_cuda"] + data["cache"]["launches"]
                      + data["serve"]["launches"])
    e["max_abs_err"] = max(e["max_abs_err"], data["cache"]["err"], data["serve"]["err"])


# ---------------------------------------------------------------------------
# The serving surface: --ckpt, --queries/--explain, --microbatch_bench, the
# HTTP daemon with live bank edits, --jpeg_bench and the decoder benchmark.
# ---------------------------------------------------------------------------

SURFACE_ARGV = ["--dataset", "synthetic_cub", "--arch", "resnet18", "--batch_size", "64",
                "--decoder", "pil", "--workers", "8"]
SURFACE_QUERIES = 70  # a chunk of 64 and a ragged one of 6
SURFACE_EXPLAIN = 8  # files explained, 3 neighbours each
HTTP_BURST, HTTP_THREADS = 32, 16  # one-image predicts, client threads
HTTP_EDIT_ROUNDS, HTTP_EDIT_ROWS, HTTP_EDIT_CLIENTS = 2, 8, 4
JPEG_BENCH_ARGS = dict(workers=8, bench_batches=4)
DECODE_BENCH_N = 64  # JPEGs of the pipeline_bench leg


def _http(url: str, body: bytes = None, ctype: str = "application/json"):
    """``(status, JSON reply)`` of one request (GET without a body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _finite_predictions(reply: dict, n: int) -> bool:
    preds = reply.get("predictions", [])
    probs = [t["prob"] for p in preds for t in p["topk"]]
    return len(preds) == n and bool(np.isfinite(probs).all())


def _surface_plain(net, x) -> "torch.Tensor":
    """The plain prepared head on the net's features of host images."""
    import torch

    with torch.inference_mode():
        return plain_head(net, net._featurize_eval(torch.as_tensor(x).to(net.device)))


def _k2_between(fn) -> tuple:
    """``(fn(), K2 launches during it)``: every count set to 0 just before
    the call and K2's read just after, the card synchronized."""
    import torch

    torch.cuda.synchronize()
    _counts(reset=True)
    out = fn()
    torch.cuda.synchronize()
    return out, _counts()["nw_prepared_cuda"]


def surface_queries(net, train_ds, args, workdir: str) -> dict:
    """``--queries`` with ``--topk 5 --temperature 1.5`` on 70 written
    JPEGs, then ``--explain 3`` on 8 of them (see the phase)."""
    import glob
    import os

    import torch

    from nwhead_tpu_torch import serve
    from nwhead_tpu_torch.data import transforms as T
    from nwhead_tpu_torch.data.datasets import ImageFileDataset
    from nwhead_tpu_torch.ops.calibrate import apply_temperature
    from nwhead_tpu_torch.utils.pipeline import synth_photo_jpegs

    qdir = os.path.join(workdir, "queries")
    os.makedirs(qdir)
    paths = synth_photo_jpegs(SURFACE_QUERIES, seed=DATA_SEED, dir=qdir)
    pattern = os.path.join(os.path.dirname(paths[0]), "*.jpg")
    args.queries, args.topk, args.temperature, args.explain = pattern, 5, 1.5, 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # a JSON line a file
        results, k2 = _k2_between(lambda: serve.answer_queries(net, train_ds, args))
    seconds = time.perf_counter() - t0
    chunks = -(-SURFACE_QUERIES // args.batch_size)
    # The same files decoded as answer_queries decodes them, through the
    # serving callable chunk by chunk.
    files = sorted(glob.glob(pattern))
    qds = ImageFileDataset(files, np.zeros(len(files), np.int64), train_ds.num_classes,
                           transform=T.imagenet_eval_transform(device_normalize=True),
                           workers=args.workers, decoder=args.decoder)
    fn = serve.serving_fn(net, uint8_normalize=True)
    mismatch, prob_err = 0, 0.0
    for start in range(0, len(files), args.batch_size):
        n = min(args.batch_size, len(files) - start)
        imgs = qds.gather(np.arange(start, start + n))
        imgs = np.concatenate([imgs, np.zeros((args.batch_size - n,) + imgs.shape[1:],
                                              imgs.dtype)])
        lp = apply_temperature(fn(imgs).cpu()[:n], args.temperature).numpy()
        top = np.argsort(-lp, axis=-1)[:, :args.topk]
        for r, row, t in zip(results[start:start + n], lp, top):
            mismatch += [c["class"] for c in r["topk"]] != [int(c) for c in t]
            prob_err = max(prob_err, max(abs(c["prob"] - float(np.exp(row[c["class"]])))
                                         for c in r["topk"]))
    print(f"serve --queries: {len(results)} files (480 x 640 JPEGs, pil) in {chunks} chunks of "
          f"{args.batch_size} (the last {SURFACE_QUERIES % args.batch_size} padded), "
          f"{seconds:.2f}s; K2 launches {k2}; top-5 vs the serving callable's argsort: "
          f"{mismatch} differ, max|prob err| {prob_err:.2e} (printed to 4 places)")
    if len(results) != SURFACE_QUERIES or k2 != chunks or mismatch or prob_err > 1e-4:
        raise AssertionError("--queries disagrees with the serving callable")

    # --explain 3 on 8 of the files.
    args.queries = os.path.join(os.path.dirname(paths[0]), "[0-7].jpg")
    args.temperature, args.explain = 1.0, 3
    with contextlib.redirect_stdout(io.StringIO()):
        explained, k2_explain = _k2_between(lambda: serve.answer_queries(net, train_ds, args))
    ok = len(explained) == SURFACE_EXPLAIN
    for r in explained:
        e = r["explain"]
        ws = [nb["weight"] for nb in e["neighbors"]]
        ok &= (len(ws) == 3 and ws == sorted(ws, reverse=True)
               and e["predicted_class"] == r["topk"][0]["class"]
               and all("dataset_index" in nb for nb in e["neighbors"]))
    hds = ImageFileDataset(sorted(glob.glob(args.queries)), np.zeros(SURFACE_EXPLAIN, np.int64),
                           train_ds.num_classes, transform=T.imagenet_eval_transform(),
                           workers=args.workers, decoder=args.decoder)
    imgs = hds.gather(np.arange(SURFACE_EXPLAIN))
    lp, _ = serve._build_explainer(net, train_ds)(imgs, 3)
    plain = _surface_plain(net, imgs)
    torch.cuda.synchronize()
    lp = torch.from_numpy(lp).to(plain.device)
    err = float((lp - plain).abs().max())
    print(f"serve --queries --explain 3: {len(explained)} files, 3 neighbours each (weights "
          f"descending, the predicted class on top: {ok}); the explainer's f32 head over the raw "
          f"bank vs the plain prepared head max|err| {err:.3e}; K2 launches {k2_explain}")
    if not ok or not within(lp, plain, **TOL["f32"]) or k2_explain != 0:
        raise AssertionError("--explain disagrees with the plain head or is malformed")
    args.queries, args.explain = None, 0
    return {"launches": k2, "err": err}


def surface_microbatch(net, val_ds, args) -> dict:
    """``--latency_bench`` (one client) and ``--microbatch_bench
    --concurrency 16 --bench_batches 1``: each request's row against a
    direct B=64 call that holds its image."""
    from unittest import mock

    import torch

    from nwhead_tpu_torch import serve
    from nwhead_tpu_torch.utils.batching import MicroBatcher

    # latency_bench's one client at B=64, the yardstick of the batcher's qps.
    args.bench_batches = 20
    with contextlib.redirect_stdout(io.StringIO()):
        single, k2_single = _k2_between(lambda: serve.latency_bench(net, val_ds, args))
    if k2_single != single["batches"] + 3:
        raise AssertionError(f"--latency_bench: {k2_single} K2 launches")
    args.concurrency, args.bench_batches = 16, 1
    sent = []
    submit = MicroBatcher.submit

    def recording(self, item):
        f = submit(self, item)
        sent.append((item, f))
        return f

    with mock.patch.object(MicroBatcher, "submit", recording):
        report, k2 = _k2_between(lambda: serve.microbatch_bench(net, val_ds, args))
    fn = serve.serving_fn(net)
    got, want = [], []
    for start in range(0, len(sent), args.batch_size):
        part = sent[start:start + args.batch_size]
        x = np.stack([item for item, _ in part])
        if len(x) < args.batch_size:
            x = np.concatenate([x, np.zeros((args.batch_size - len(x),) + x.shape[1:], x.dtype)])
        want.append(fn(x).cpu().numpy()[:len(part)])
        got.append(np.stack([f.result() for _, f in part]))
    got, want = torch.from_numpy(np.concatenate(got)), torch.from_numpy(np.concatenate(want))
    err = float((got - want).abs().max())
    rel_ok = within(got, want, **TOL["f32"])
    print(f"serve --microbatch_bench: {report['requests']} one-image requests from "
          f"{report['concurrency']} clients, {report['achieved_qps']:.1f} q/s, request p50 "
          f"{report['request_p50_ms']:.3f} ms, p95 {report['request_p95_ms']:.3f} ms, mean "
          f"occupancy {report['mean_batch_occupancy']:.2f} of {args.batch_size} over "
          f"{report['batches_dispatched']} batches; K2 launches {k2} (the warm-up and one a "
          f"batch); every row vs a direct B=64 call max|err| {err:.3e}; --latency_bench in "
          f"this process: p50 {single['p50_ms']:.3f} ms, {single['queries_per_sec']:.1f} q/s "
          f"(the batcher reaches {report['achieved_qps'] / single['queries_per_sec']:.3f} of it)")
    if (k2 != report["batches_dispatched"] + 1 or len(sent) != report["requests"]
            or not rel_ok):
        raise AssertionError("--microbatch_bench: rows or launches disagree")
    return {"launches": k2 + k2_single, "err": err, "report": report, "latency": single}


def surface_http(net, train_ds, val_ds, args) -> dict:
    """The HTTP daemon on port 0 on a thread (see the phase)."""
    import threading

    import torch

    from nwhead_tpu_torch import serve

    args.http = 0
    server = serve.build_http_server(net, train_ds, val_ds, args)
    url = f"http://127.0.0.1:{server.port}"
    imgs = val_ds.gather(np.arange(16))
    direct = serve.serving_fn(net)(imgs[:2]).cpu().numpy()  # before the counted window
    bodies = [json.dumps({"inputs": [imgs[i].tolist()]}).encode() for i in range(8)]
    replies, lock = [], threading.Lock()

    def predict(body: bytes):
        code, reply = _http(f"{url}/predict", body)
        with lock:
            replies.append((code, reply))

    _counts(reset=True)
    server.start()
    t0 = time.perf_counter()
    health = _http(f"{url}/healthz")[1]
    code, one = _http(f"{url}/predict", json.dumps({"inputs": imgs[:2].tolist()}).encode())
    labels_ok = code == 200 and [p["label"] for p in one["predictions"]] == \
        [int(i) for i in direct.argmax(1)]

    def burst(c: int) -> None:
        for r in range(HTTP_BURST // HTTP_THREADS):
            predict(bodies[(c + r) % len(bodies)])

    threads = [threading.Thread(target=burst, args=(c,)) for c in range(HTTP_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    burst_s = time.perf_counter() - t0
    # Live edits while 4 clients keep predicting.
    stop = threading.Event()

    def keep_predicting(c: int) -> None:
        while not stop.is_set():
            predict(bodies[c])

    add = json.dumps({"inputs": imgs[8:8 + HTTP_EDIT_ROWS].tolist(),
                      "labels": [int(y) for y in val_ds.targets[8:8 + HTTP_EDIT_ROWS]]}).encode()
    clients = [threading.Thread(target=keep_predicting, args=(c,))
               for c in range(HTTP_EDIT_CLIENTS)]
    edits, edit_s, rows0 = [], [], health["bank_rows"]
    for t in clients:
        t.start()
    try:
        for _ in range(HTTP_EDIT_ROUNDS):
            t1 = time.perf_counter()
            code_a, added = _http(f"{url}/add_support", add)
            n = added.get("bank_rows", 0)
            rows = list(range(n - HTTP_EDIT_ROWS, n))
            code_r, removed = _http(f"{url}/remove_support", json.dumps({"rows": rows}).encode())
            edit_s.append(time.perf_counter() - t1)
            edits.append((code_a, n, code_r, removed.get("bank_rows")))
            time.sleep(0.2)  # predictions on the edited bank before the next round
    finally:
        stop.set()
        for t in clients:
            t.join(timeout=600)
    stats = _http(f"{url}/stats")[1]
    server.shutdown()
    server.batcher.close()
    torch.cuda.synchronize()
    k2 = _counts()["nw_prepared_cuda"]
    dispatches = server.batcher.dispatches
    codes = [c for c, _ in replies] + [code]
    bad = [c for c in codes if c != 200]
    finite = all(_finite_predictions(r, 1) for c, r in replies if c == 200)
    edits_ok = all(e == (200, rows0 + HTTP_EDIT_ROWS, 200, rows0) for e in edits)
    lat = stats.get("latency_ms", {})
    print(f"serve --http: /healthz {health}; one /predict of 2 images, labels as the direct "
          f"call {labels_ok}; a burst of {HTTP_BURST} one-image predicts from {HTTP_THREADS} "
          f"threads and {len(replies) - HTTP_BURST} more during {HTTP_EDIT_ROUNDS} rounds of "
          f"/add_support {HTTP_EDIT_ROWS} + /remove_support {HTTP_EDIT_ROWS} "
          f"({', '.join(f'{s:.2f}' for s in edit_s)} s a round) from {HTTP_EDIT_CLIENTS} "
          f"threads: {len(codes)} responses, {len(bad)} not 200 ({sum(c >= 500 for c in bad)} "
          f"5xx), finite {finite}; burst {burst_s:.2f}s; /stats requests {stats['requests']}, "
          f"items {stats['items']}, errors {stats['errors']}, edits {stats['support_edits']}, "
          f"p50 {lat.get('p50')} ms, p95 {lat.get('p95')} ms, p99 {lat.get('p99')} ms, "
          f"{stats.get('device_batches')} batches, mean occupancy "
          f"{stats.get('mean_batch_occupancy')}; K2 launches {k2} in {dispatches} batches")
    if (bad or not finite or not labels_ok or not edits_ok or stats["errors"]
            or stats["requests"] != len(codes) or stats["support_edits"] != 2 * HTTP_EDIT_ROUNDS
            or not stats.get("mean_batch_occupancy") or k2 != dispatches):
        raise AssertionError("the HTTP daemon failed a request, an edit or a count")
    return {"launches": k2, "stats": stats, "burst_s": burst_s, "edit_s": edit_s,
            "responses": len(codes)}


def surface_cifar_b64(cifar: dict, data_dir: str) -> dict:
    """One ``images_b64`` ``/predict`` of 8 PIL-encoded JPEGs of the CIFAR
    test images on the data phase's restored server, against the serving
    callable on the same decoded images."""
    import base64
    import os

    import torch
    from PIL import Image

    from nwhead_tpu_torch import serve

    net, args = cifar["net"], cifar["args"]
    train_ds, val_ds = cifar["datasets"]
    args.http = 0
    server = serve.build_http_server(net, train_ds, val_ds, args)
    raw = np.load(os.path.join(data_dir, "cifar100", "test_images.npy"))[:8]
    jpegs = []
    for img in raw:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90)
        jpegs.append(buf.getvalue())
    decoded = np.stack([server.decode_query(b) for b in jpegs])
    x = np.concatenate([decoded, np.zeros((args.batch_size - 8,) + decoded.shape[1:],
                                          decoded.dtype)])
    direct = serve.serving_fn(net)(x).cpu().numpy()[:8]
    _counts(reset=True)
    server.start()
    code, reply = _http(f"http://127.0.0.1:{server.port}/predict",
                        json.dumps({"images_b64": [base64.b64encode(b).decode()
                                                   for b in jpegs]}).encode())
    server.shutdown()
    server.batcher.close()
    torch.cuda.synchronize()
    k2 = _counts()["nw_prepared_cuda"]
    preds = reply.get("predictions", [])
    err = max((abs(p["topk"][0]["prob"] - float(np.exp(row.max())))
               for p, row in zip(preds, direct)), default=float("inf"))
    labels_ok = [p["label"] for p in preds] == [int(i) for i in direct.argmax(1)]
    print(f"serve --http on the restored CIFAR-100 server ({args.arch}, {len(net.full_y)} "
          f"rows): one images_b64 /predict of 8 PIL JPEGs -> {code}, labels as the serving "
          f"callable on the same decoded images {labels_ok}, top prob max|err| {err:.2e}; K2 "
          f"launches {k2} in {server.batcher.dispatches} batches")
    if code != 200 or not labels_ok or err > 1e-4 or k2 != server.batcher.dispatches:
        raise AssertionError("the images_b64 predict disagrees with the serving callable")
    return {"launches": k2}


def surface_jpeg(net, train_ds, args, workdir: str) -> dict:
    """``--jpeg_bench --decoder pil --workers 8 --bench_batches 4``, then the
    ``pil`` leg of ``labs/pipeline_bench`` at 8 workers on 64 JPEGs."""
    import os

    from nwhead_tpu_torch import serve
    from nwhead_tpu_torch.labs import pipeline_bench
    from nwhead_tpu_torch.utils.pipeline import photo_jpegs

    args.workers, args.bench_batches = JPEG_BENCH_ARGS["workers"], JPEG_BENCH_ARGS["bench_batches"]
    report, k2 = _k2_between(lambda: serve.jpeg_bench(net, train_ds, args))
    print(f"jpeg source: {report['jpeg_source']}")
    print(f"serve --jpeg_bench (pil, {args.workers} workers, {args.bench_batches} batches of "
          f"{args.batch_size}, {report['jpeg_hw']}): decode {report['decode_img_per_sec']} img/s, "
          f"copy {report['transfer_img_per_sec']} img/s ({report['transfer_mb_per_sec']} MB/s), "
          f"device {report['device_wall_qps']} q/s, pipelined {report['e2e_qps_from_jpeg']} q/s, "
          f"bound by {report['bound_by']}; K2 launches {k2}")
    if k2 != 2 * args.bench_batches + 1 or report["e2e_qps_from_jpeg"] <= 0:
        raise AssertionError("--jpeg_bench launched K2 other than once a batch")
    ddir = os.path.join(workdir, "decode_bench")
    os.makedirs(ddir)
    paths, source = photo_jpegs(DECODE_BENCH_N, dir=ddir)
    dec = pipeline_bench.time_decoder(paths, "pil", 8)
    print(f"pipeline_bench pil workers=8 ({source} 480 x 640 JPEGs): {dec['ms_per_batch']:.1f} "
          f"ms/batch{DECODE_BENCH_N} ({dec['img_per_sec']:,.0f} img/s)")
    return {"launches": k2, "report": report, "decode": dec}


def serving_surface_phase(datasets, workdir: str, ckpt: str, cifar: dict) -> dict:
    """The serve module's actions on the eval CLI phase's checkpoint (see
    17g in the module's docstring); the K2 launches and the largest error
    against the plain head, for the kernels line."""
    import os

    import torch

    from nwhead_tpu_torch import serve

    train_ds, val_ds = datasets
    args = serve.parse_args(SURFACE_ARGV + ["--ckpt", ckpt, "--latency_bench"])
    t0 = time.perf_counter()
    net = serve.build_server(args, train_ds, val_ds=val_ds)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tag = serve.bank_tag(args)
    x = val_ds.gather(np.arange(args.batch_size))
    served, k2 = _k2_between(lambda: serve.serving_fn(net)(x))
    plain = _surface_plain(net, x)
    torch.cuda.synchronize()
    err = float((served - plain).abs().max())
    print(f"serve --ckpt {os.path.basename(ckpt)}: built in {build_s:.2f}s (S={len(net.full_y)}, "
          f"D={net.full_feat.shape[1]}, C={net.n_classes}); tag ckpt {tag['ckpt'] == ckpt}, "
          f"seed {tag['seed']!r}; served vs plain max|err| {err:.3e}; K2 launches {k2}")
    if (tag["ckpt"] != ckpt or tag["seed"] != "" or k2 != 1
            or not bool(torch.isfinite(served).all()) or not within(served, plain, **TOL["f32"])):
        raise AssertionError("the --ckpt server disagrees with the plain head")
    out = {"launches": k2, "err": err}
    steps = (("queries", lambda: surface_queries(net, train_ds, args, workdir)),
             ("microbatch", lambda: surface_microbatch(net, val_ds, args)),
             ("http", lambda: surface_http(net, train_ds, val_ds, args)),
             ("cifar", lambda: surface_cifar_b64(cifar, os.path.join(workdir, "data"))),
             ("jpeg", lambda: surface_jpeg(net, train_ds, args, workdir)))
    for name, step in steps:
        r = step()
        out[name] = r
        out["launches"] += r["launches"]
        out["err"] = max(out["err"], r.get("err", 0.0))
    del net, cifar["net"]
    torch.cuda.empty_cache()
    return out


def surface_update_entries(entries: list, surface: dict) -> None:
    """The serving-surface phase's K2 launches and errors added to the K2
    f32 entry of the ``kernels`` line."""
    e = next(e for e in entries if e["name"] == "nw_prepared_f32")
    e["launches"] += surface["launches"]
    e["max_abs_err"] = max(e["max_abs_err"], surface["err"])


# ---------------------------------------------------------------------------
# The AOT serving artifact: six serving callables exported, loaded in a
# fresh process, held to their live callables; the CLI both ways.
# ---------------------------------------------------------------------------

ARTIFACT_ARGV = ["--dataset", "synthetic_cub", "--arch", "resnet18", "--batch_size", "64"]
ARTIFACT_VIT = (  # name, the ViT serve flags
    ("vit_bf16_fused", ["--featurizer_precision", "bf16_fused"]),
    ("vit_int8", ["--featurizer_precision", "int8", "--head_precision", "int8"]))
ARTIFACT_PROBE = 2  # --serve_mode ivf's tiles a query
ARTIFACT_DEVICE = "cuda"  # the card (the (1, 4) mesh's four times)
ARTIFACT_CALLS = 3  # calls of each artifact in the fresh process whose launches count
ARTIFACT_TIMED = 10  # timed calls of each artifact in the fresh process
ARTIFACT_BENCH = 20  # --bench_batches of the CLI's and the live latency benches
ARTIFACT_QUERIES = 70  # JPEGs the CLI answers from the artifact: a chunk of 64, one of 6
ARTIFACT_TOL = 1e-6  # max |log-prob| difference of an artifact and its live callable
# Per artifact: its ops (``ops/library.py``) and their launches a request.
ARTIFACT_LAUNCHES = {
    "f32": {"nw_prepared": 1},
    "ivf": {"nw_prepared_sel": 1},
    "int8_head": {"nw_prepared_int8": 1},
    "vit_bf16_fused": {"attention_block_bf16": 12, "mlp_block_bf16": 12, "nw_prepared": 1},
    "vit_int8": {"attention_block_int8": 12, "mlp_block_int8": 12, "nw_prepared_int8": 1},
    "mesh_1x4": {"nw_prepared_partials": SHARDS},
}
# The fresh process: loads every artifact with ``utils.aot`` alone, answers
# the saved batch, counts its ops' launches, times it, and names any
# model-building or JAX module it imported. Then the profiling phase:
# ``PROFILE_REQUESTS`` requests of the f32 artifact (ResNet-18, K2) inside
# ``utils.profiling.trace``, each in an ``annotate`` span and a
# ``StepTimer(block=True)`` phase; the same request by CUDA events; the
# trace file read back for the spans and K2's kernel.
ARTIFACT_LOADER = """
import glob, json, os, sys, time
import numpy as np
import torch
from nwhead_tpu_torch.utils import aot

cases, calls, timed = json.loads(sys.argv[1]), int(sys.argv[3]), int(sys.argv[4])
q = np.load(sys.argv[2])
logdir, n_prof = sys.argv[5], int(sys.argv[6])
out, fns = {}, {}
for name, art in cases.items():
    t0 = time.perf_counter()
    fn = fns[name] = aot.load_any_serving_artifact(art["dir"])
    load_s = time.perf_counter() - t0
    before = aot.library.launches()
    for _ in range(calls):
        got = fn(q)
    torch.cuda.synchronize()
    after = aot.library.launches()
    got = got.cpu().numpy()
    want = np.load(art["want"])
    lat = []
    for _ in range(timed):
        t0 = time.perf_counter()
        fn(q).cpu()
        lat.append(time.perf_counter() - t0)
    out[name] = {"load_s": load_s, "err": float(np.abs(got - want).max()),
                 "argmax_equal": bool((got.argmax(1) == want.argmax(1)).all()),
                 "finite": bool(np.isfinite(got).all()), "shape": list(got.shape),
                 "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
                 "p50_ms": float(np.percentile(np.asarray(lat) * 1e3, 50))}

from nwhead_tpu_torch.utils.profiling import StepTimer, annotate, trace

fn, marker = fns["f32"], torch.empty(1, device="cuda")
before = aot.library.launches()["nw_prepared"]
timer = StepTimer()
with trace(logdir):
    for _ in range(n_prof):
        with annotate("serving_request"), timer.phase("request", result=marker, block=True):
            got = fn(q)
launches = aot.library.launches()["nw_prepared"] - before
starts = [torch.cuda.Event(enable_timing=True) for _ in range(n_prof)]
ends = [torch.cuda.Event(enable_timing=True) for _ in range(n_prof)]
for s, e in zip(starts, ends):
    s.record()
    fn(q)
    e.record()
torch.cuda.synchronize()
files = glob.glob(os.path.join(logdir, "*.json"))
with open(files[0]) as f:
    events = json.load(f)["traceEvents"]
spans = [e for e in events if e.get("name") == "serving_request"
         and e.get("cat") == "user_annotation"]
gpu_spans = [e for e in events if e.get("name") == "serving_request"
             and e.get("cat") == "gpu_user_annotation"]
k2 = [e for e in events if "nw_prepared_tc_kernel" in str(e.get("name"))
      and e.get("cat") == "kernel"]
profile = {
    "files": len(files), "spans": len(spans), "gpu_spans": len(gpu_spans),
    "k2_events": len(k2), "launches": launches,
    "k2_us": float(np.median([e["dur"] for e in k2])) if k2 else None,
    "shape": list(got.shape), "finite": bool(torch.isfinite(got).all()),
    "summary": timer.summary()["request"],
    "event_p50_ms": float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))}
mods = [m for m in ("jax", "nwhead_tpu", "nwhead_tpu_torch.nw.net", "nwhead_tpu_torch.models",
                    "nwhead_tpu_torch.data") if m in sys.modules]
print(json.dumps({"cases": out, "modules": mods, "profile": profile}))
"""


def _op_counts(reset: bool = False) -> dict:
    """Each custom op's launches (its wrapper's count), then set to 0 with
    ``reset``."""
    from nwhead_tpu_torch.ops import library

    out = library.launches()
    if reset:
        for module, attr in library.WRAPPERS.values():
            getattr(module, attr).launches = 0
    return out


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _p50_ms(fn, x, n: int) -> float:
    """The host-clock p50 of ``fn(x)`` with its readback, after 3 warm calls."""
    for _ in range(3):
        fn(x).cpu()
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(x).cpu()
        lat.append(time.perf_counter() - t0)
    return float(np.percentile(np.asarray(lat) * 1e3, 50))


def _export_case(name: str, fn, export, q, workdir: str, live: dict) -> None:
    """One live callable: its launches on one request (held to
    ``ARTIFACT_LAUNCHES``), its log-probs saved, and its artifact exported
    (timed) into ``workdir/name``."""
    import os

    import torch

    _op_counts(reset=True)
    want = fn(q)
    torch.cuda.synchronize()
    per_request = {k: v for k, v in _op_counts().items() if v}
    if per_request != ARTIFACT_LAUNCHES[name]:
        raise AssertionError(f"artifact {name}: the live callable launched {per_request} a "
                             f"request, want {ARTIFACT_LAUNCHES[name]}")
    want = want.cpu().numpy()
    if want.shape != (q.shape[0], want.shape[1]) or not np.isfinite(want).all():
        raise AssertionError(f"artifact {name}: live log-probs {want.shape} not finite")
    art = os.path.join(workdir, name)
    t0 = time.perf_counter()
    meta = export(art)
    export_s = time.perf_counter() - t0
    np.save(os.path.join(workdir, f"{name}_want.npy"), want)
    live[name] = {"dir": art, "want": os.path.join(workdir, f"{name}_want.npy"),
                  "export_s": export_s, "bytes": _dir_bytes(art),
                  "n_operand_leaves": meta["n_operand_leaves"]}
    print(f"artifact {name}: live launches a request {per_request}; exported in "
          f"{export_s:.2f}s, {meta['n_operand_leaves']} stored tensors, "
          f"{live[name]['bytes'] / 2**20:.1f} MiB on disk ({meta['device']} "
          f"{meta['capability']})")


def artifact_phase(datasets, workdir: str) -> dict:
    """The AOT serving artifact on the card (see the module docstring, 18):
    six artifacts exported from live callables, loaded in one fresh
    process and held there to the live log-probs and launch counts; the
    CLI's export (in process, on the phase's datasets) and
    ``--serve_artifact --latency_bench``. Returns each artifact's
    fresh-process launches and the CLI's figures."""
    import os
    from unittest import mock

    import torch

    from nwhead_tpu_torch import serve
    from nwhead_tpu_torch.data import transforms as T
    from nwhead_tpu_torch.parallel.mesh import make_mesh
    from nwhead_tpu_torch.utils.aot import (
        export_mesh_serving_artifact, export_serving_artifact,
    )

    train_ds, val_ds = datasets
    stats = (T.IMAGENET_MEAN, T.IMAGENET_STD)
    art_dir = os.path.join(workdir, "artifacts")
    os.makedirs(art_dir)
    args = serve.parse_args(ARTIFACT_ARGV + ["--latency_bench", "--bench_batches",
                                             str(ARTIFACT_BENCH)])
    B = args.batch_size
    hw = val_ds.gather(np.arange(1)).shape[1:3]
    q = np.random.default_rng(IVF_SEED).integers(0, 256, size=(B, *hw, 3)).astype(np.uint8)
    live = {}

    def single(fn):
        return lambda art: export_serving_artifact(fn, q, art)

    base = serve.build_server(args, train_ds)
    fn = serve.serving_fn(base, uint8_normalize=True)
    _export_case("f32", fn, single(fn), q, art_dir, live)
    live_bench = serve.latency_bench(base, val_ds, args)
    live_uint8_p50 = _p50_ms(fn, q, ARTIFACT_BENCH)
    base.ivf_n_probe = ARTIFACT_PROBE
    fn = serve.serving_fn(base, uint8_normalize=True, mode="ivf")
    _export_case("ivf", fn, single(fn), q, art_dir, live)
    net, _ = _edit_net(base, "int8")
    fn = serve.serving_fn(net, uint8_normalize=True)
    _export_case("int8_head", fn, single(fn), q, art_dir, live)
    mesh = make_mesh(1, SHARDS, devices=[torch.device(ARTIFACT_DEVICE)] * SHARDS)
    net, _ = _edit_net(base, "f32", mesh=mesh)
    _export_case("mesh_1x4", net.make_serving_fn(normalize=stats),
                 lambda art: export_mesh_serving_artifact(net, q, art, normalize=stats),
                 q, art_dir, live)
    del base, net, fn
    torch.cuda.empty_cache()
    for name, flags in ARTIFACT_VIT:
        vargs = serve.parse_args(VIT_SERVE_ARGV + flags)
        vnet = serve.build_server(vargs, train_ds, edit=_set_gammas)
        fn = serve.serving_fn(vnet, uint8_normalize=True)
        _export_case(name, fn, single(fn), q, art_dir, live)
        del vnet, fn
        torch.cuda.empty_cache()

    # One fresh process loads all six and answers the saved batch.
    np.save(os.path.join(art_dir, "q.npy"), q)
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", ARTIFACT_LOADER,
         json.dumps({k: {"dir": v["dir"], "want": v["want"]} for k, v in live.items()}),
         os.path.join(art_dir, "q.npy"), str(ARTIFACT_CALLS), str(ARTIFACT_TIMED),
         os.path.join(workdir, "profile"), str(PROFILE_REQUESTS)],
        cwd=repo, env={**os.environ, "PYTHONPATH": repo}, capture_output=True, text=True,
        timeout=900)
    fresh_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the artifact loader failed:\n{proc.stderr[-4000:]}")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    if fresh["modules"]:
        raise AssertionError(f"the artifact loader imported {fresh['modules']}")
    ok = True
    for name, r in fresh["cases"].items():
        want = {k: v * ARTIFACT_CALLS for k, v in ARTIFACT_LAUNCHES[name].items()}
        good = (r["err"] <= ARTIFACT_TOL and r["argmax_equal"] and r["finite"]
                and r["shape"][0] == B and r["launches"] == want)
        ok &= good
        print(f"artifact {name} (fresh process): loaded in {r['load_s']:.2f}s; {ARTIFACT_CALLS} "
              f"calls launched {r['launches']} (want {want}); max|d| vs live {r['err']:.3e}, "
              f"argmax equal {r['argmax_equal']} {'ok' if good else 'FAIL'}; p50 "
              f"{r['p50_ms']:.3f} ms over {ARTIFACT_TIMED} calls")
    print(f"artifact loader: one fresh process, {fresh_s:.1f}s, imported no JAX and no "
          "model-building module")
    if not ok:
        raise AssertionError("an artifact disagrees with its live callable or its launches")
    profile = check_profile(fresh["profile"], B)

    # The CLI both ways: export, then serve in a fresh process: the latency
    # bench and JPEG files (PIL: no libjpeg on the card's machine).
    from nwhead_tpu_torch.utils.pipeline import photo_jpegs

    cli_dir = os.path.join(workdir, "cli_artifact")
    with mock.patch.object(serve, "build_datasets", lambda a: datasets):  # the same arrays
        rep = serve.main(ARTIFACT_ARGV + ["--export_artifact", cli_dir])
    jpeg_dir = os.path.join(workdir, "artifact_jpegs")
    os.makedirs(jpeg_dir)
    jpegs, _ = photo_jpegs(ARTIFACT_QUERIES, dir=jpeg_dir)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nwhead_tpu_torch.serve", "--dataset", "synthetic_cub",
         "--serve_artifact", cli_dir, "--latency_bench", "--bench_batches", str(ARTIFACT_BENCH),
         "--queries", os.path.join(os.path.dirname(jpegs[0]), "*.jpg"), "--decoder", "pil",
         "--topk", "5"],
        cwd=repo, env={**os.environ, "PYTHONPATH": repo}, capture_output=True, text=True,
        timeout=900)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"--serve_artifact failed:\n{proc.stderr[-4000:]}")
    lines = [json.loads(line) for line in proc.stdout.strip().splitlines()
             if line.startswith("{")]
    cli = next(r for r in lines if "p50_ms" in r)
    answers = [r for r in lines if "topk" in r]
    if (cli["batch_size"] != B or not cli["queries_per_sec"] > 0
            or cli["backend"] != torch.device(ARTIFACT_DEVICE).type
            or sorted(a["file"] for a in answers) != sorted(jpegs)
            or any(len(a["topk"]) != min(5, rep["n_classes"])
                   or not 0 < sum(t["prob"] for t in a["topk"]) <= 1.001
                   for a in answers)):
        raise AssertionError(f"--serve_artifact report {cli}, {len(answers)} answers")
    print(f"artifact CLI: --export_artifact {rep['input_shape']} {rep['input_dtype']}, "
          f"{_dir_bytes(cli_dir) / 2**20:.1f} MiB on disk; --serve_artifact --latency_bench "
          f"(fresh process, {cli_s:.1f}s in all): p50 {cli['p50_ms']:.3f} ms, p95 "
          f"{cli['p95_ms']:.3f} ms, {cli['queries_per_sec']:.1f} q/s on uint8 pixels, "
          f"--queries {len(answers)} JPEGs answered (top-5 each); the live "
          f"--latency_bench p50 {live_bench['p50_ms']:.3f} ms on float32 pixels, the live "
          f"callable's p50 {live_uint8_p50:.3f} ms on the same uint8 batch "
          f"({nvidia_smi_line()})")
    return {"launches": {k: r["launches"] for k, r in fresh["cases"].items()},
            "profile": profile, "cli": cli, "live_p50_ms": live_bench["p50_ms"], "live_uint8_p50_ms": live_uint8_p50,
            "cases": fresh["cases"], "export": live}


def artifact_update_entries(entries: list, art: dict) -> None:
    """The artifact phase's fresh-process launches added to the entries of
    the ``kernels`` line of the kernels they ran (the f32 bank's ops to the
    ``_f32`` entries)."""
    by_name = {e["name"]: e for e in entries}
    for launches in art["launches"].values():
        for op, n in launches.items():
            key = f"{op}_f32" if op in ("nw_prepared", "nw_prepared_sel",
                                        "nw_prepared_partials") else op
            by_name[key]["launches"] += n


# ---------------------------------------------------------------------------
# Data-parallel training over a mesh (NWTrainer(mesh=), sync BatchNorm,
# distributed precompute, the sharded full-mode eval) and the profiling
# hooks (utils/profiling.py) in a fresh process.
# ---------------------------------------------------------------------------

MESH_SHORT = ["--num_steps_per_epoch", "3", "--num_val_steps_per_epoch", "2"]
MESH_CLI_STEPS = 3  # train --mesh 1,1 through the CLI's functions
MESH_SHAPE = (2, 2)  # data x support over [cuda:0] * 4: two data replicas of 4 queries
MESH_STEPS = 3
# The CPU tests' tolerances (tests/test_torch_mesh_train.py): a step's loss
# from the same state; its update within 1% of the meshless step's (in norm
# here: at ResNet-18's width single tensors' f32 gradients sit up to 4% of
# their largest entry from the f64 step's, in the meshless step as in the
# mesh one, so each tensor is held instead to the meshless step's own
# distance from f64, MESH_F64_SLACK times); distributed precompute's
# features.
MESH_LOSS_RTOL = 1e-4
MESH_STATE_REL = 1e-2
MESH_F64_SLACK = 1.5
MESH_FEAT_REL = 1e-5


def _epoch_on_card(trainer, steps: int) -> dict:
    """One epoch of ``steps`` steps from counts at 0: its launches, seconds
    (host clock, the card synchronized) and peak device memory."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counts(reset=True)
    t0 = time.perf_counter()
    trainer.train_epoch(num_steps=steps)
    torch.cuda.synchronize()
    return {"launches": _counts(), "seconds": time.perf_counter() - t0,
            "peak_bytes": torch.cuda.max_memory_allocated(), "losses": trainer.step_losses}


def _sync_trainer(dst, src) -> None:
    """``dst`` takes ``src``'s weights, running statistics, momentum, step
    and generators, so that its next step is ``src``'s on the same
    episode."""
    dst.net.model.load_state_dict(src.net.model.state_dict())
    # A copy: load_state_dict keeps tensors already on the right device and
    # dtype, so both optimizers would step one momentum buffer.
    dst.optimizer.load_state_dict(copy.deepcopy(src.optimizer.state_dict()))
    dst.step = src.step
    dst.rng.bit_generator.state = src.rng.bit_generator.state
    dst.net.support_train.set_rng_state(src.net.support_train.rng_state())


def _f64_gradients(model, episode) -> dict:
    """The gradient of one step's loss in f64 (the model copied, the naive
    head) on the episode ``(qimg, qy, simg, sy)``."""
    import torch

    from nwhead_tpu_torch.ops import metrics as M

    ref = copy.deepcopy(model).double().train()
    ref.head.use_fused = False
    qimg, qy, simg, sy = episode
    loss = M.nll_loss(ref(qimg.double(), simg.double(), sy), qy)
    names = [n for n, p in ref.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for p in ref.parameters() if p.requires_grad])
    out = {n: g.float() for n, g in zip(names, grads)}
    del ref, grads, loss
    torch.cuda.empty_cache()
    return out


def _stepwise(base, meshed) -> dict:
    """``MESH_STEPS`` steps of the meshless and the mesh trainer, each from
    the same state (the mesh trainer synced to the meshless one before each
    step) on the same episode: the losses (rtol ``MESH_LOSS_RTOL``), each
    step's update against the meshless one (in norm, ``MESH_STATE_REL``;
    each tensor's share of its move and its gradient's max |d| / max are
    printed), and the first step's gradients of both against the f64
    step's (the mesh's worst tensor within ``MESH_F64_SLACK`` times the
    meshless one's)."""
    import torch

    episodes = []
    train_step = base.train_step

    def recording(*batch):
        episodes.append(tuple(t.detach().clone() for t in batch))
        return train_step(*batch)

    failed, rows = [], []
    for i in range(MESH_STEPS):
        _sync_trainer(meshed, base)
        start = {k: v.clone() for k, v in base.net.model.state_dict().items()}
        ref_model = copy.deepcopy(base.net.model) if i == 0 else None
        base.train_step = recording
        base.train_epoch(num_steps=1)
        base.train_step = train_step
        meshed.train_epoch(num_steps=1)
        losses = (meshed.step_losses[0], base.step_losses[0])
        if not np.isclose(*losses, rtol=MESH_LOSS_RTOL, atol=0.0):
            failed.append(f"step {i + 1}'s loss {losses}")
        gm = {n: p.grad for n, p in meshed.net.model.named_parameters() if p.grad is not None}
        gb = {n: p.grad for n, p in base.net.model.named_parameters() if p.grad is not None}
        grad_rel = {n: rel_err(gm[n], g) for n, g in gb.items()}
        want, got = base.net.model.state_dict(), meshed.net.model.state_dict()
        keys = [k for k, v in want.items() if v.is_floating_point()]
        move = torch.cat([(want[k] - start[k]).flatten() for k in keys])
        diff = torch.cat([(got[k] - want[k]).flatten() for k in keys])
        update_rel = float(diff.norm() / move.norm())
        if update_rel > MESH_STATE_REL:
            failed.append(f"step {i + 1}'s update, {update_rel:.3e} of its norm")
        if any(not torch.equal(got[k], v) for k, v in want.items() if k not in keys):
            failed.append(f"step {i + 1}'s batch counts")
        frac = max((float((got[k] - want[k]).abs().max())
                    / max(float((want[k] - start[k]).abs().max()), 1e-12), k) for k in keys)
        worst_grad = max((v, n) for n, v in grad_rel.items())
        rows.append({"losses": losses, "update_rel": update_rel, "tensor_frac": frac[0],
                     "grad_rel": worst_grad[0]})
        print(f"step {i + 1} from the same state: loss {losses[0]:.6f} (mesh) / "
              f"{losses[1]:.6f}; the update's norm differs by {update_rel:.3e}; the farthest "
              f"tensor by {frac[0]:.3e} of its step's move ({frac[1]}); gradients, each "
              f"tensor's max |d| / max: worst {worst_grad[0]:.3e} ({worst_grad[1]}), median "
              f"{float(np.median(list(grad_rel.values()))):.3e}")
        if ref_model is not None:
            g64 = _f64_gradients(ref_model, episodes[0])
            del ref_model
            e_mesh = {n: rel_err(gm[n], g) for n, g in g64.items()}
            e_base = {n: rel_err(gb[n], g) for n, g in g64.items()}
            wm, wb = max(e_mesh.values()), max(e_base.values())
            if wm > MESH_F64_SLACK * wb:
                failed.append(f"step 1's gradients, {wm:.3e} from f64 against the meshless "
                              f"step's {wb:.3e}")
            print(f"step 1 against the f64 step, each tensor's max |d| / max: mesh worst "
                  f"{wm:.3e}, median {float(np.median(list(e_mesh.values()))):.3e}; meshless "
                  f"worst {wb:.3e}, median {float(np.median(list(e_base.values()))):.3e}; the "
                  f"mesh nearer f64 on {sum(e_mesh[n] <= e_base[n] for n in g64)} of "
                  f"{len(g64)} tensors")
            rows[0].update(f64_mesh=wm, f64_meshless=wb)
    return {"failed": failed, "stepwise": rows, "episode": episodes[0]}


def mesh_training_phase(datasets, workdir: str) -> dict:
    """The mesh's training half at the slice configuration (ResNet-18,
    ``synthetic_cub``, B=8, 1,200 support rows): ``train --mesh 1,1``
    through the CLI's functions, then ``NWTrainer`` over a (2, 2) mesh of
    the one card against the meshless trainer from the same weights and
    episodes: K1, dq and ds twice a step, losses, parameters and running
    statistics, the first step's per-shard head (B=4, S=1,200) against the
    plain versions, distributed precompute's features, the full-mode eval
    through the sharded bank's partials."""
    import torch
    from unittest import mock

    from nwhead_tpu_torch import serve, train
    from nwhead_tpu_torch.parallel import make_mesh

    argv = TRAIN_ARGV + ["--models_dir", workdir, "--log_interval", "1000"] + MESH_SHORT
    args, trainer, start = train.setup(argv + ["--mesh", "1,1"], datasets=datasets)
    if trainer.mesh is None or trainer.mesh.size != 1 or trainer.net.mesh is not trainer.mesh:
        raise AssertionError("train --mesh 1,1 built no mesh trainer")
    _counts(reset=True)
    t0 = time.perf_counter()
    train.run_epochs(args, trainer, start)
    torch.cuda.synchronize()
    cli = _counts()
    print(f"train --mesh 1,1 (CLI): {MESH_CLI_STEPS} steps and the eval in "
          f"{time.perf_counter() - t0:.2f}s; launches {cli}; losses "
          f"{['%.4f' % v for v in trainer.step_losses]}")
    if any(cli[n] != MESH_CLI_STEPS for n in RAW_WRAPPERS):
        raise AssertionError(f"train --mesh 1,1 did not launch K1/K3 once a step: {cli}")
    if cli["nw_prepared_partials_cuda"] == 0 or cli["nw_prepared_cuda"] != 0:
        raise AssertionError("the --mesh 1,1 full-mode eval did not run on the sharded "
                             "bank's partials")
    if trainer.net.sharded_bank is None or not np.isfinite(trainer.step_losses).all():
        raise AssertionError(f"--mesh 1,1: losses {trainer.step_losses}")
    out = {"cli_launches": cli}
    del trainer
    torch.cuda.empty_cache()

    _, base, _ = train.setup(argv, datasets=datasets)
    mesh = make_mesh(*MESH_SHAPE, devices=[torch.device("cuda", 0)] * 4)
    with mock.patch.object(serve, "build_mesh", lambda a, d: mesh):
        _, meshed, _ = train.setup(argv + ["--mesh", ",".join(map(str, MESH_SHAPE))],
                                   datasets=datasets)
    if meshed.mesh is not mesh:
        raise AssertionError("the mesh trainer is not over the (2, 2) mesh")
    before = {k: v.clone() for k, v in base.net.model.state_dict().items()}
    got = meshed.net.model.state_dict()
    if any(not torch.equal(got[k], v) for k, v in before.items()):
        raise AssertionError("the mesh and meshless trainers start from other weights")
    n_data = MESH_SHAPE[0]
    captured, handle = capture_head_inputs(meshed.net)
    stepwise = _stepwise(base, meshed)
    handle.remove()
    failed = stepwise.pop("failed")
    episode = stepwise.pop("episode")

    # Free-running from one state: launches, time and memory; the runs part
    # step by step by f32 rounding that grows at lr 1e-2, beside a second
    # meshless run's drift (the card's own nondeterminism).
    _, again, _ = train.setup(argv, datasets=datasets)
    for t in (meshed, again):
        _sync_trainer(t, base)
    plain = _epoch_on_card(base, MESH_STEPS)
    meshed_run = _epoch_on_card(meshed, MESH_STEPS)
    again_run = _epoch_on_card(again, MESH_STEPS)
    del again
    print(nvidia_smi_line())
    for name, r in (("meshless", plain), (f"mesh {MESH_SHAPE}", meshed_run)):
        print(f"train {name}: {MESH_STEPS} steps in {r['seconds']:.2f}s "
              f"({r['seconds'] / MESH_STEPS * 1e3:.1f} ms/step, first step included), peak "
              f"device memory {r['peak_bytes'] / 2**30:.2f} GiB; launches "
              f"{ {n: r['launches'][n] for n in RAW_WRAPPERS} }; losses "
              f"{['%.6f' % v for v in r['losses']]}")
    for n in RAW_WRAPPERS:
        if meshed_run["launches"][n] != n_data * MESH_STEPS:
            raise AssertionError(f"{n} launched {meshed_run['launches'][n]} times in "
                                 f"{MESH_STEPS} mesh steps, want {n_data} a step")
    drift = {name: [abs(a - b) / abs(b) for a, b in zip(r["losses"], plain["losses"])]
             for name, r in (("mesh", meshed_run), ("meshless again", again_run))}
    print("free-running loss drift from the meshless run, a step: " + "; ".join(
        f"{k} {['%.2e' % v for v in d]}" for k, d in drift.items()))
    if drift["mesh"][0] > MESH_LOSS_RTOL:
        failed.append("the free-running first step's loss")
    # A step on an episode already on the card (the host gather of the
    # 1,208 images left out: under a mesh they come from the host, as JAX's).
    step_ms = {}
    for name, t in (("meshless", base), ("mesh", meshed)):
        t.train_step(*episode)
        lat = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train_step(*episode)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        step_ms[name] = float(np.median(lat))
    print(f"a step on a device-resident episode (host clock, card synchronized, median of "
          f"3): meshless {step_ms['meshless']:.1f} ms, mesh {MESH_SHAPE} "
          f"{step_ms['mesh']:.1f} ms")
    if captured["q"].shape[0] != 8 // n_data:
        raise AssertionError(f"the first head call took {tuple(captured['q'].shape)} queries")
    errs = first_step_head(meshed.net, captured, f"mesh shard B={captured['q'].shape[0]}")
    out.update(launches=meshed_run["launches"], errs=errs, steps=MESH_STEPS,
               ms_per_step=meshed_run["seconds"] / MESH_STEPS * 1e3,
               meshless_ms_per_step=plain["seconds"] / MESH_STEPS * 1e3,
               peak_bytes=meshed_run["peak_bytes"], meshless_peak_bytes=plain["peak_bytes"],
               drift=drift, device_step_ms=step_ms, **stepwise)

    # Distributed precompute and the sharded full-mode eval, from the same weights.
    meshed.net.model.load_state_dict(base.net.model.state_dict())
    calls = []
    hook = meshed.net.model.featurizer.register_forward_hook(
        lambda m, i, o: calls.append(i[0].shape[0]))
    t0 = time.perf_counter()
    meshed.net.precompute()
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    hook.remove()
    t0 = time.perf_counter()
    base.net.precompute()
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    feat_err = rel_err(meshed.net.full_feat, base.net.full_feat)
    pieces = meshed.net.precompute_batch // mesh.size
    print(f"distributed precompute: {meshed.net.full_feat.shape[0]} rows in {mesh_s:.2f}s "
          f"({len(calls)} featurizer calls of {sorted(set(calls))} images) vs meshless "
          f"{base_s:.2f}s; features rel err {feat_err:.2e}")
    if set(calls) != {pieces} or feat_err > MESH_FEAT_REL:
        raise AssertionError("distributed precompute did not split or disagrees")
    _counts(reset=True)
    meshed.eval_epoch("full", num_steps=2)
    torch.cuda.synchronize()
    ev = _counts()
    x = meshed.val_dataset.gather(np.arange(meshed.batch_size))
    got, want = meshed.net.predict(x, "full"), base.net.predict(x, "full")
    eval_err = float((got - want).abs().max())
    print(f"mesh full-mode eval: 2 batches, launches K2 partials "
          f"{ev['nw_prepared_partials_cuda']}, K2 {ev['nw_prepared_cuda']}; a batch vs the "
          f"meshless prepared bank max|err| {eval_err:.3e}")
    if (ev["nw_prepared_partials_cuda"] != 2 * mesh.size or ev["nw_prepared_cuda"] != 0
            or not within(got, want, **TOL["f32"])):
        raise AssertionError("the mesh full-mode eval did not run on the sharded bank's "
                             "partials or disagrees")
    out.update(feat_err=feat_err, eval_launches=ev, eval_err=eval_err)
    del base, meshed
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"the mesh step disagrees with the meshless one: {failed}")
    return out


def mesh_update_entries(entries: list, mesh: dict) -> None:
    """The mesh phase's launches and errors added to the K1, dq, ds and K2
    ``partials`` f32 entries of the ``kernels`` line, its per-shard head's
    times (B=4, S=1,200) as ``shard_*``."""
    by_name = {e["name"]: e for e in entries}
    for k in ("nw_fwd", "nw_bwd_dq", "nw_bwd_ds"):
        e = by_name[f"{k}_f32"]
        e["launches"] += mesh["cli_launches"][f"{k}_cuda"] + mesh["launches"][f"{k}_cuda"]
        e["max_abs_err"] = max(e["max_abs_err"], mesh["errs"][k])
    e = by_name["nw_prepared_partials_f32"]
    e["launches"] += (mesh["cli_launches"]["nw_prepared_partials_cuda"]
                      + mesh["eval_launches"]["nw_prepared_partials_cuda"])
    e["max_abs_err"] = max(e["max_abs_err"], mesh["eval_err"])


# ---------------------------------------------------------------------------
# The last two lab scripts: the big-bank lab (labs/bigbank_lab.py: K1 partials,
# K2, K4, K5, K6, K13) at its full width, and gate 2's kill-and-resume run
# (labs/endurance_run.py: K1, dq, ds, K2 in the training CLI's processes) on
# CIFAR-100-shaped files whose accuracy moves.
# ---------------------------------------------------------------------------

BIGBANK_RUNS = (  # name, argv, the gates it returns (every one ok)
    # 4 oracle gates and 4 plain checks at 131,072 rows, 8 plain checks at
    # 1,000,000 (4 precisions x B=64, 256)
    ("scale", ["--hnsw", "--hnsw_s", "8192"], 16),
    ("giant", ["--giant", "8000000"], 3),  # centroid, plain at B=64 and 256
    ("giant_ivf", ["--giant", "8000000", "--giant_ivf"], 6),  # + routed, its plain x 2
    ("stream_host", ["--stream_host", "1048576"], 1),  # finite
)
# K2's launches over f32 and bf16 banks count together (one wrapper): the
# phase books them on the f32 entry.
BIGBANK_KERNELS = ("nw_fwd_partials_cuda", "nw_prepared_cuda", "nw_prepared_int8_cuda",
                   "nw_prepared_int4_cuda", "nw_prepared_sel_quant_cuda")
ENDURANCE_SEED = 28
ENDURANCE_DATA = (1100, 400)  # train / test images: 11 a class, the episode's whole support
ENDURANCE_SIGNAL = 0.5  # the class pattern's weight beside unit noise
ENDURANCE_ARGV = ["--dataset", "cifar100", "--arch", "resnet18", "--n_way", "0", "--n_shot", "11",
                  "--epochs", "6", "--kill_at", "4", "--log_interval", "2",
                  "--num_steps_per_epoch", "24", "--num_val_steps_per_epoch", "50",
                  "--poll_s", "0.25"]
ENDURANCE_KERNELS = ("nw_fwd_cuda", "nw_bwd_dq_cuda", "nw_bwd_ds_cuda", "nw_prepared_cuda")
# The training CLI in a process that prints, on a resume, the digest of the
# state it restored, and its kernel launches when it ends, by an interrupt
# too (SIGINT raises KeyboardInterrupt through ``run_epochs``).
COUNTING_TRAIN = """
import json, sys
from chip_smoke import state_digest
from nwhead_tpu_torch import train
from nwhead_tpu_torch.ops import fused_nw as F
try:
    args, trainer, start = train.setup(sys.argv[1:])
    if args.resume:
        print("restored state digest: " + state_digest(trainer.state_dict()), flush=True)
    train.run_epochs(args, trainer, start)
finally:
    print("kernel launches: " + json.dumps({n: getattr(F, n).launches for n in %r}), flush=True)
""" % (ENDURANCE_KERNELS,)


def state_digest(state) -> str:
    """SHA-256 of a trainer state (nested dicts and lists of tensors and
    numbers) in key order: the same for the same values on any device."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def add(x):
        if isinstance(x, dict):
            for k in sorted(x, key=repr):
                h.update(repr(k).encode())
                add(x[k])
        elif isinstance(x, (list, tuple)):
            h.update(b"[")
            for v in x:
                add(v)
            h.update(b"]")
        elif isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(x).encode())

    add(state)
    return h.hexdigest()


def bigbank_phase() -> dict:
    """``python -m nwhead_tpu_torch.labs.bigbank_lab`` as a user runs it,
    its ``run`` in this process so that the launches count: the defaults
    (S = 1,000,000, ``S_check`` 131,072, D = 512, C = 1,000) with ``--hnsw
    --hnsw_s 8192``, ``--giant 8000000`` (int8), ``--giant 8000000
    --giant_ivf`` and ``--stream_host 1048576`` (16 host chunks). Every
    head the lab times is held to its plain version there. A run that
    returns a failed gate or fewer gates than ``BIGBANK_RUNS`` names, or
    launches no kernel of its legs, fails the phase."""
    import torch

    from nwhead_tpu_torch.labs import bigbank_lab, lab_wrapper

    out = {"launches": {}, "seconds": {}}
    stream = lab_wrapper("stream")
    for name, argv, n_gates in BIGBANK_RUNS:
        print(f"--- python -m nwhead_tpu_torch.labs.bigbank_lab {' '.join(argv)}", flush=True)
        _counts(BIGBANK_KERNELS, reset=True)
        stream.launches = 0
        t0 = time.perf_counter()
        res = bigbank_lab.run(argv)
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        launches = {**_counts(BIGBANK_KERNELS), "stream_cuda": stream.launches}
        out["launches"][name], out[name] = launches, res
        failed = [g for g, ok in res["gates"] if not ok]
        if not res["ok"] or failed or len(res["gates"]) != n_gates:
            raise AssertionError(f"bigbank_lab {argv}: {len(res['gates'])} gates of {n_gates}, "
                                 f"failed {failed}")
        print(f"bigbank_lab {name}: {n_gates} gates ok, launches {launches}, "
              f"{out['seconds'][name]:.1f}s", flush=True)
    want = {"scale": ("nw_fwd_partials_cuda", "nw_prepared_cuda", "nw_prepared_int8_cuda",
                      "nw_prepared_int4_cuda", "stream_cuda"),
            "giant": ("nw_prepared_int8_cuda", "stream_cuda"),
            "giant_ivf": ("nw_prepared_int8_cuda", "nw_prepared_sel_quant_cuda", "stream_cuda"),
            "stream_host": ("nw_fwd_partials_cuda",)}
    missing = [f"{run} {k}" for run, ks in want.items() for k in ks
               if not out["launches"][run][k]]
    if missing:
        raise AssertionError(f"the big-bank lab launched no {missing}")
    sc, g, gi, sh = (out[k] for k in ("scale", "giant", "giant_ivf", "stream_host"))
    times = {**sc["scale"]["times"], **g["giant"]["times"], **gi["giant"]["times"]}
    print("bigbank figures: " + "; ".join(
        f"{k} {v['ms']:.4f} ms" + (f" {v['qps']:.0f} q/s" if "qps" in v else
                                   f" {v['gbps']:.1f} GB/s")
        + (f" frac_vs_stream {v['frac_vs_stream']:.3f} frac_vs_peak {v['frac_vs_peak']:.3f}"
           if "frac_vs_peak" in v else "") for k, v in times.items()), flush=True)
    print(f"bigbank: HNSW over {sc['hnsw']['rows']} rows built in {sc['hnsw']['build_s']:.1f}s, "
          f"{sc['hnsw']['qps']:.0f} q/s, recall@10 {sc['hnsw']['recall']:.3f} (exact int8 head "
          f"{sc['hnsw']['int8_head_qps']:.0f} q/s); resident GB "
          f"{ {k: round(v, 3) for k, v in sc['resident_gb'].items()} }, giant "
          f"{g['giant']['gbytes']:.3f} / IVF {gi['giant']['gbytes']:.3f}; host link "
          f"{sh['stream_host']['link_mbps']:.1f} MB/s ({sh['stream_host']['chunks']} chunks)",
          flush=True)
    return out


def write_endurance_cifar100(data_dir: str, signal: float = ENDURANCE_SIGNAL) -> None:
    """CIFAR-100-shaped ``.npy`` files whose full-mode accuracy moves with
    training: each class a fixed pattern of 4 x 4 blocks of 8 px at
    ``signal`` beside unit per-pixel noise, from ``ENDURANCE_SEED``. A
    random network reads them at a few points; the weaker the signal, the
    more steps training takes to read it. The full-mode bank is featurized
    through the training transform (a crop of up to 4 px and a flip), so
    the patterns are mirror-symmetric and their blocks wider than the
    crop: two draws of the transform then give nearly the same bank, and
    the same weights nearly the same accuracy (gate 2's check 4)."""
    import os

    rng = np.random.default_rng(ENDURANCE_SEED)
    base = os.path.join(data_dir, "cifar100")
    os.makedirs(base, exist_ok=True)
    half = rng.standard_normal((100, 4, 2, 3))
    patterns = np.kron(np.concatenate([half, half[:, :, ::-1]], axis=2), np.ones((1, 8, 8, 1)))
    for split, n in zip(("train", "test"), ENDURANCE_DATA):
        labels = np.arange(n) % 100
        noise = rng.standard_normal((n, 32, 32, 3))
        images = 128 + 40 * (signal * patterns[labels] + noise)
        np.save(os.path.join(base, f"{split}_images.npy"),
                np.clip(images, 0, 255).astype(np.uint8))
        np.save(os.path.join(base, f"{split}_labels.npy"), labels)


def endurance_phase(workdir: str) -> dict:
    """``python -m nwhead_tpu_torch.labs.endurance_run`` on the files of
    ``write_endurance_cifar100`` (CIFAR_ResNet18, 1,100-row episodes: K1,
    dq and ds once a step; K2 in the full-mode evals), its ``run`` in this
    process, each phase of the training CLI in a process of its own that
    prints its launches when it ends. Every check must be OK, and every
    kernel must launch. Check 4 reads accuracy, which a partial restore
    (the BatchNorm statistics or the momentum left out) could keep within
    its tolerance: phase B's digest of the state it restored must also
    equal the digest of the checkpoint it resumed from, bit for bit."""
    import os
    import re

    from nwhead_tpu_torch.labs import endurance_run
    from nwhead_tpu_torch.train.checkpoint import load_checkpoint

    data_dir = os.path.join(workdir, "endurance_data")
    write_endurance_cifar100(data_dir)
    args = endurance_run.parser().parse_args(
        ENDURANCE_ARGV + ["--data_dir", data_dir, "--models_dir",
                          os.path.join(workdir, "endurance")])
    res = endurance_run.run(args, train_cmd=[sys.executable, "-c", COUNTING_TRAIN])
    with open(res["log"]) as f:
        text = f.read()
    counts = [json.loads(m) for m in re.findall(r"^kernel launches: (.*)$", text, re.M)]
    launches = {k: sum(c[k] for c in counts) for k in ENDURANCE_KERNELS}
    restored = re.findall(r"^restored state digest: (\w+)$", text, re.M)
    ckpt = load_checkpoint(os.path.join(res["ckpt_dir"], f"model.{res['resumed_at'] - 1:04d}"))
    del ckpt["epoch"]
    want = state_digest(ckpt)
    same_state = restored == [want]
    print(f"  {'OK  ' if same_state else 'FAIL'} restored state: phase B's digest {restored} vs "
          f"model.{res['resumed_at'] - 1:04d}'s {want}", flush=True)
    print(f"endurance: {len(counts)} training processes, launches {launches}; phase A "
          f"{res['phase_a_s']:.1f}s, phase B {res['phase_b_s']:.1f}s", flush=True)
    with open(res["summary"]) as f:
        print("endurance summary:\n" + f.read().rstrip(), flush=True)
    if not res["ok"] or not same_state or len(counts) != 2 or not all(launches.values()):
        raise AssertionError(f"the endurance run failed a check ({res['ok']}, restored state "
                             f"{same_state}) or launched no kernel ({launches}, {len(counts)} "
                             "processes reported)")
    return {**res, "launches": launches, "same_state": same_state}


def bigbank_update_entries(entries: list, big: dict, endurance: dict) -> None:
    """The big-bank phase's launches added to K1 ``partials``, K2 (f32 and
    bf16 banks on the f32 entry), K4, K5, K6 int8 and K13; the endurance
    run's to K1, dq, ds and K2 f32; each entry's big-bank figures under
    ``bigbank``."""
    by_name = {e["name"]: e for e in entries}
    runs = big["launches"].values()
    add = {"nw_fwd_partials_f32": sum(r["nw_fwd_partials_cuda"] for r in runs),
           "nw_prepared_int8": sum(r["nw_prepared_int8_cuda"] for r in runs),
           "nw_prepared_int4": sum(r["nw_prepared_int4_cuda"] for r in runs),
           "nw_prepared_sel_int8": sum(r["nw_prepared_sel_quant_cuda"] for r in runs),
           "stream_f32": sum(r["stream_cuda"] for r in runs),
           "nw_fwd_f32": endurance["launches"]["nw_fwd_cuda"],
           "nw_bwd_dq_f32": endurance["launches"]["nw_bwd_dq_cuda"],
           "nw_bwd_ds_f32": endurance["launches"]["nw_bwd_ds_cuda"],
           "nw_prepared_f32": (sum(r["nw_prepared_cuda"] for r in runs)
                               + endurance["launches"]["nw_prepared_cuda"])}
    for name, n in add.items():
        by_name[name]["launches"] += n
    times = {**big["scale"]["scale"]["times"], **big["giant"]["giant"]["times"],
             **big["giant_ivf"]["giant"]["times"]}
    for name, key in (("nw_prepared_f32", "head B=64 f32"), ("nw_prepared_bf16", "head B=64 bf16"),
                      ("nw_prepared_int8", "giant B=64 int8"), ("nw_prepared_int4", "head B=64 int4"),
                      ("nw_prepared_sel_int8", "giant ivf-p4 B=64 int8 skew")):
        by_name[name]["bigbank"] = {"case": key, **{k: v for k, v in times[key].items()
                                                    if k != "bytes"}}
    by_name["stream_f32"]["bigbank"] = {"case": "stream 402.7MB", **times["stream 402.7MB"]}


PROFILE_REQUESTS = 10


def check_profile(r: dict, batch: int) -> dict:
    """The profiling phase's results (``utils/profiling.py`` on the card, in
    the artifact loader's fresh process: late in this one
    ``torch.profiler`` has recorded no device time): the trace file holds
    the ``annotate`` span of every request and K2's kernel events; the
    ``StepTimer(block=True)`` p50 is printed beside CUDA events on the same
    request."""
    s = r["summary"]
    print(f"profiling (the artifact loader's fresh process): {r['files']} trace file, "
          f"{r['spans']} 'serving_request' spans on the host and {r['gpu_spans']} on the "
          f"card's timeline, {r['k2_events']} nw_prepared_tc_kernel events (median "
          f"{r['k2_us']} us) for {r['launches']} K2 launches; StepTimer(block=True) p50 "
          f"{s['p50_ms']:.3f} ms (mean {s['mean_ms']:.3f}, p95 {s['p95_ms']:.3f}, n "
          f"{s['count']}) vs CUDA events {r['event_p50_ms']:.3f} ms a B={batch} request "
          f"of the f32 artifact")
    if (r["files"] != 1 or r["spans"] != PROFILE_REQUESTS or r["launches"] != PROFILE_REQUESTS
            or r["k2_events"] < PROFILE_REQUESTS or not r["finite"] or r["shape"][0] != batch
            or s["count"] != PROFILE_REQUESTS):
        raise AssertionError(f"the profiling trace lacks the span or K2's kernel: {r}")
    return r


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    import nwhead_tpu_torch
    from nwhead_tpu_torch import train
    from nwhead_tpu_torch.ops import _cuda

    print(nvidia_smi_line())
    print(f"device: {torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"capabilities: {json.dumps(nwhead_tpu_torch.capabilities())}")

    t0 = time.perf_counter()
    for name, info in _cuda.build().items():
        print(f"build {name}: {'cached' if info['cached'] else 'compiled'} in "
              f"{info['seconds']:.1f}s -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "smem")):
                print(f"  ptxas: {line.strip()}")
    print(f"build wall time {time.perf_counter() - t0:.1f}s")
    lib = _cuda.load_library()
    fused = _cuda.load_library("nw_fused")
    print(f"  shared memory per K2/K4/K5 pass-1 block (every bank precision, 32 queries): "
          f"{lib.nw_prepared_tc_smem_bytes(32, 200, 0)} bytes (dynamic) at C=200, "
          f"{lib.nw_prepared_tc_smem_bytes(32, 1000, 0)} at C=1,000, K6 "
          f"{lib.nw_prepared_tc_smem_bytes(32, 1000, 1)}; largest C on this card: "
          f"{lib.nw_prepared_max_classes(0)}; "
          f"K3 dq block {fused.nw_fused_dq_smem_bytes(8, 512)} bytes at 8 queries, D=512 "
          f"({fused.nw_fused_dq_smem_bytes(32, 512)} at 32; largest D "
          f"{fused.nw_fused_dq_max_features(0)})")
    from nwhead_tpu_torch.ops import fused_nw as F

    optin = F._smem_optin(lib, torch.device("cuda"))
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    # The FFMA ds kernel this one replaced kept t for all of B: 12,544 bytes
    # besides, 4,096 a 16-query tile.
    ffma_cap = (optin - 12_544) // 4096 * 16
    for B, S, D, elem in ((8, 1200, 512, 4), (8, 1200, 512, 2), (64, 5994, 512, 4),
                          (64, 5994, 512, 2)):
        qb, cl, group = F._ds_plan(B, S, D, elem, optin, n_sms)
        print(f"  K3 ds plan at B={B}, S={S}, D={D} {'f32' if elem == 4 else 'bf16'}: query "
              f"tile {qb}, clusters of {cl} on {-(-S // 64)} tiles ({cl * -(-S // 64)} blocks), "
              f"group {group}, {fused.nw_fused_ds_smem_bytes(qb, cl, group)} bytes a block "
              f"(largest group {fused.nw_fused_ds_max_group(qb, cl, 0)}, a larger B in groups: "
              f"no B cap; the FFMA kernel's cap was {ffma_cap}; D cap "
              f"{fused.nw_fused_dq_max_features(0)}, dq's)")

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' products in full f32
    phase_s = {}
    t0 = time.perf_counter()
    kern = kernel_phase(flush)
    raw = raw_kernel_phase(flush)
    phase_s["K1-K3 kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zoo_kern = zoo_kernel_phase(flush)
    phase_s["zoo kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grouped_route_phase(flush)
    phase_s["grouped int8 conv routes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vit_kern = vit_kernel_phase(flush)
    phase_s["ViT kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    quant = quant_kernel_phase(flush)
    vit_int8_kern = vit_int8_kernel_phase(flush)
    phase_s["K4/K5, K10/K11 int8 kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vit_train_kern = vit_train_kernel_phase(flush)
    phase_s["ViT training kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bank = _ivf_bank_features(torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"million-row bank: {tuple(bank[0].shape)}, C={IVF_BANK[2]}, drawn in "
          f"{time.perf_counter() - t0:.1f}s")
    ivf_kern = ivf_kernel_phase(flush, bank)
    phase_s["K6 kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded_kern = sharded_kernel_phase(flush)
    phase_s["partials and K12 kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded_served = sharded_serving_phase(flush, bank)
    phase_s["sharded serving and streaming"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    big_edits = bigbank_edit_phase(bank)
    phase_s["million-row bank edits"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lab_kern = lab_kernel_phase(flush)
    phase_s["lab kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    labs = lab_phase()
    phase_s["labs"] = time.perf_counter() - t0
    del flush, bank
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    big = bigbank_phase()
    phase_s["big-bank lab"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    args = train.Parser().parse_args(TRAIN_ARGV)
    datasets = train.build_datasets(args)
    print(f"datasets built in {time.perf_counter() - t0:.1f}s")
    # The ResNet-18 serving phases featurize the bank once (the first slice
    # configuration) and restore it from this cache.
    bank_cache = tempfile.mkdtemp(prefix="chip_smoke_bank_")
    try:
        t0 = time.perf_counter()
        sl = slice_phase(datasets, bank_cache)
        phase_s["ResNet serving"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ivf_served = ivf_serving_phase(datasets, bank_cache)
        phase_s["IVF serving"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh_served = mesh_serving_phase(datasets, bank_cache)
        phase_s["--mesh 1,1 serving"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(bank_cache, ignore_errors=True)
    t0 = time.perf_counter()
    edits = bank_edit_phase(datasets)
    phase_s["bank edits"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vit_served = vit_serving_phase(datasets)
    phase_s["ViT serving"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vit_int8_served = vit_serving_phase(datasets, VIT_INT8_CONFIGS)
    phase_s["ViT int8 serving"] = time.perf_counter() - t0
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        tr = training_phase(datasets, workdir)
        phase_s["ResNet training"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh_tr = mesh_training_phase(datasets, workdir)
        phase_s["mesh training"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev = eval_phase(datasets, workdir)
        phase_s["eval CLI"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ret = retrieval_phase(datasets)
        phase_s["retrieval"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vit_tr = vit_training_phase(datasets, workdir)
        phase_s["ViT training"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        zoo_served = zoo_serving_phase(datasets, workdir)
        phase_s["zoo serving"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        zoo_trained = zoo_training_phase(datasets, workdir)
        phase_s["zoo training"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        int8_cnn_served = int8_cnn_serving_phase(datasets, workdir, zoo_served)
        phase_s["int8 CNN serving"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = data_fc_phase(workdir)
        phase_s["data and FC"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        surface = serving_surface_phase(datasets, workdir, ev["ckpt"], data["serve"])
        phase_s["serving surface"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        artifacts = artifact_phase(datasets, workdir)
        phase_s["AOT artifacts"] = time.perf_counter() - t0
        del datasets
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        endurance = endurance_phase(workdir)
        phase_s["endurance (kill and resume)"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    request_split(vit_served["bf16_fused"], vit_kern, "bf16_fused", "attention_block_bf16",
                  "mlp_block_bf16")
    for name in ("int8_int8", "int8_int4"):
        request_split(vit_int8_served[name], vit_int8_kern, name, "attention_block_int8",
                      "mlp_block_int8")

    print(nvidia_smi_line())
    entries = [
        {"name": f"nw_prepared_{p}", "route": "cuda", "source": PREPARED_SOURCE,
         "replaces": REPLACES["nw_prepared"],
         "launches": sl[p]["launches"] + (ev["launches"]["nw_prepared_cuda"] if p == "f32" else 0),
         "max_abs_err": max(kern[p]["max_abs_err"], sl[p]["served_err"],
                            tr["eval_err"] if p == "f32" else 0.0,
                            ev["full_err"] if p == "f32" else 0.0),
         "ms": kern[p]["ms"], "plain_ms": kern[p]["plain_ms"], "bound_ms": kern[p]["bound_ms"],
         "bound_by": kern[p]["bound_by"], "library_ms": None, "splits": kern[p]["splits"],
         "c1000_ms": kern[p]["c1000"]["ms"], "c1000_plain_ms": kern[p]["c1000"]["plain_ms"],
         "c1000_bound_ms": kern[p]["c1000"]["bound_ms"]}
        for p in TOL
    ]
    for k in ("nw_fwd", "nw_bwd_dq", "nw_bwd_ds"):
        for p in TOL:
            r = raw[k][p]
            err = max(r["max_abs_err"], tr["errs"][k]) if p == "f32" else r["max_abs_err"]
            launches = tr["launches"][p][f"{k}_cuda"]
            if k == "nw_fwd" and p == "f32":  # the eval CLI's cluster and ensemble, retrieval
                err = max(err, ev["cluster_err"], ret["errs"]["ensemble"], ret["errs"]["knn"],
                          ret["errs"]["hnsw"])
                launches += ev["launches"]["nw_fwd_cuda"] + sum(
                    ret["launches"][m]["nw_fwd_cuda"] for m in ("ensemble", "knn", "hnsw"))
            entries.append({
                "name": f"{k}_{p}", "route": "cuda", "source": RAW_KERNELS[k][0],
                "device_functions": RAW_KERNELS[k][1],
                "replaces": REPLACES[k], "launches": launches,
                "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None})
    entries += vit_entries(vit_kern, vit_served)
    entries += vit_train_entries(vit_train_kern, vit_tr)
    entries += quant_entries(quant, vit_int8_kern, vit_int8_served, sl)
    entries += ivf_entries(ivf_kern, ivf_served)
    entries += sharded_entries(sharded_kern, sharded_served, mesh_served, ret)
    entries += lab_entries(lab_kern, labs)
    zoo_update_entries(entries, zoo_kern, zoo_served, zoo_trained)
    int8_cnn_update_entries(entries, int8_cnn_served)
    bank_edit_update_entries(entries, edits, big_edits)
    data_update_entries(entries, data)
    surface_update_entries(entries, surface)
    artifact_update_entries(entries, artifacts)
    mesh_update_entries(entries, mesh_tr)
    bigbank_update_entries(entries, big, endurance)
    for k in ("nw_fwd", "nw_bwd_dq", "nw_bwd_ds"):
        for p in TOL:
            e = next(e for e in entries if e["name"] == f"{k}_{p}")
            e.update({f"shard_{key}": raw[k][p]["shard"][key]
                      for key in ("ms", "plain_ms", "bound_ms")})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class _LastLine:
    """Standard output that remembers its last complete line, so that a
    failure names the last check that passed: a device-side assert floods
    standard error with one line per failing thread, and its traceback names
    only the call that reported it, not the kernel that failed."""

    def __init__(self, out):
        self.out, self.last, self._part = out, "", ""

    def write(self, text: str) -> int:
        lines = (self._part + text).split("\n")
        self._part = lines[-1]
        done = [line for line in lines[:-1] if line.strip()]
        if done:
            self.last = done[-1]
        return self.out.write(text)

    def __getattr__(self, name):
        return getattr(self.out, name)


if __name__ == "__main__":
    sys.stdout = _LastLine(sys.stdout)
    try:
        rc = main()
    except BaseException:
        sys.stdout.flush()
        traceback.print_exc()
        print(f"chip_smoke: failed after the line: {sys.stdout.last[:300]}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
