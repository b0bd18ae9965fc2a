#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every hand-written kernel from ``flink_ml_tpu_torch/csrc``, holds each
against its plain PyTorch version, and drives the port's main paths on the
card — dense, sparse, MLP, KMeans, feature-chain, Imputer and
self-attention serving, wide-sparse, MLP, KMeans and self-attention
training, and Pipelines fitted, transformed in the batch tier and served;
checkpointed training killed and resumed, LinearSVC and LinearRegression,
a published version hot-swapped into a serving server, text pipelines
(the host featurizers and the ``entries`` convention), data-parallel
training on ``train.mesh`` in worlds of 1, 2 and 4 ranks, tensor,
sequence and expert parallelism in gloo worlds of 2 and 4 ranks,
streamed fits out of a host-tier cache larger than a window, the
serving and batch plans on a shard grid (``serving.mesh``, ``batch.mesh``),
and online training over an unbounded stream with its versions published
to a server.
Phases, one JSON line each (the numbers give the order of description; main
runs 34 and 35 after 7, 25–29 and 36 after 9, 30–33 after 36, and 22–24
after 17):

1. device    — the card, its power limit;
2. build     — nvcc for every kernel source, all started together, with the
               ``-Xptxas -v`` resource lines;
3. kernels   — the scale → logistic megakernel's registers and spills
               (ptxas -v), then the kernel against its plain version over
               rows (1 … 4096 and past one pass of its persistent grid) × d
               (1, 3, 4, 8, 100, 128, 129, 1000, 4099: each lanes-a-row
               case, the model held in registers and not, both paths' edges)
               × chain (the four scaler flag combinations, LR alone), and x
               as a view one float into its buffer: scaled bit-equal, raw
               within the fast tier's envelope, prediction equal where
               |margin| > 1e-4, each configuration's path (16-byte or
               scalar) counted; then CUDA-event times, cold and warm, at 1,
               1024, 2048 and 4096 × 100 with the scaler, LR alone at 4096 ×
               100 beside ``torch.mv(x, coef)`` (the margin only) and 4096 ×
               1000, each with its bound, and the plain version at 4096 × 100;
4. serve     — a StandardScaler → LogisticRegression pipeline (d=100) served
               by ``InferenceServer`` with ``fusion.mode=fast``: 64 requests
               from 4 client threads, every response checked against float64
               numpy; megakernel launches, fallbacks, post-warmup builds;
5. crossings — the four one-hot row crossings of sparse SGD against their
               plain versions over a grid of (n_sub, row_hi, n): mult
               bit-equal, dot within 1e-5 · Σ_row |q|, build-form dot
               bit-equal to premat dot;
6. train     — LogisticRegression.fit on the headline wide-sparse workload
               (250,000 rows of 39 hashed features, d = 2^22, batch 65,536,
               20 iterations; data from seed 1): premat crossings launched 20
               times each and no plain crossing called; then SGD.optimize
               with onehot_premat "off" (build-form crossings, 20 launches
               each) and "on" on one DeviceDataCache — all three
               coefficients bit-identical, and held against a float64 numpy
               SGD of the same schedule, whose copy with bf16-hi-only
               crossings must fall outside the tolerance; steady-state
               ms/step of both forms by differencing two iteration counts;
7. crossings — the four crossings at the headline unit shape taken from the
               real layout: checks as in 5, and CUDA-event times of kernel,
               plain version and one PyTorch library call, with the bound;
8. kernels_sparse — the sparse IDF → logistic megakernel against its plain
               version over rows × nnz caps (1 … 64, caps off 16-byte rows,
               one past a tile) × d × chain (IDF kept, IDF dropped, no IDF),
               rows shorter than the cap included: tfidf and margin
               bit-equal, prediction equal; then cold and warm CUDA-event
               times at 4096 × 64, 1024 × 16 and 203 × 8 (rows × cap) at
               d = 2^22 on the headline rows' ids, of the kernel, its head
               alone, ``F.embedding_bag`` (the head's margin), ``coef[ids]``
               (one vector's gather) and, at 4096 × 64, the plain version,
               with the bytes bound; the kernel's registers and spills;
9. serve_sparse — the wide-sparse model served: IDF fitted on the headline
               rows, IDFModel.transform on the card, LogisticRegression.fit on
               the tf-idf column (the train phase's schedule), both models
               saved and loaded back through ``load_servable`` into one
               pipeline, served by ``InferenceServer`` (fusion.mode=fast,
               warmed on a sparse template over the nnz-cap ladder 1…64): 64
               requests of 1–4096 new rows from 4 clients, every response
               checked against float64 numpy; megakernel launches equal the
               batches whose (bucket, cap) key is hot, 0 fallbacks, 0 chains
               built after warmup, the plain version never called;
10. kernels_mlp — the MLP megakernel on ("scale", "mlp") (a one-op table
               prologue) and ("mlp",) (an empty one) against its plain
               version over rows × networks (256→512→512→8, 100→64→2, 8→16→3 and one at
               the kernel's layer, width and class limits) × chain (the four
               scaler flag combinations, the MLP alone): scaled bit-equal,
               probabilities within the fast tier's envelope, prediction
               equal where the plain top-two logits differ by more than a
               margin; the rows of small batches (every grid row count,
               at three offsets) bit-equal to the same rows inside a
               4096-row batch, every network; the kernel's registers and
               spills (ptxas -v) and its SASS's HGMMA and FFMA counts
               (cuobjdump; HGMMA required and no wgmma serialized by ptxas:
               the layers' products are wgmma in 3×TF32); then CUDA-event times at 4096 ×
               256→512→512→8 of kernel, plain version and the chain's three
               products as ``torch.addmm`` (float32, TF32 off), cold and
               warm, and at the small batch sizes beside the same
               ``addmm``, with the bound as 3×TF32 operations at the TF32
               peak (the float32 bound beside it) and the share of the TF32
               peak reached;
11. serve_mlp — the MLP classifier trained and served: 100,000 rows × 256 of
               8 classes from a random teacher, StandardScaler fitted and
               applied on the card, MLPClassifier fitted at the published
               paramMap (hiddenLayers [512, 512], maxIter 10,
               globalBatchSize 4096), held against a float64 fit of the same
               schedule on the card (the bfloat16 fit must land outside the
               tolerance), ms per epoch; both models saved, loaded through
               ``load_servable`` into one pipeline and served by
               ``InferenceServer`` (fusion.mode=fast): 64 requests of 1–4096
               rows from 4 clients checked against float64 numpy; megakernel
               launches equal the batches of bucket ≥ 2, 0 fallbacks, 0
               chains built after warmup, the plain version never called;
12. kernels_kmeans — the kernel's registers and spills (ptxas -v), then the
               scale → kmeans megakernel against its plain version over rows
               (1 … 4096, ragged, and 67,585: past one pass of its
               persistent grid) × d (1, 7, 100, 256) × k
               (2, 10, 64) × measure (euclidean, manhattan, cosine) × chain
               (the four scaler flag combinations, KMeans alone), with a NaN
               feature, a zero row and a duplicate centroid in the grid:
               scaled bit-equal, prediction equal where the float64 top-two
               distance gap exceeds a margin; then CUDA-event times at 4096
               × d 100 × k 10 of kernel, plain version, the head alone and
               ``torch.cdist`` + ``argmin`` (the head's library yardstick),
               with the bytes bound;
13. fit_kmeans — KMeans.fit at the published config (kmeans-benchmark.json:
               100,000 × 100 uniform rows from seed 2, k 10, maxIter 10),
               nothing cut: two fits bit-identical; every epoch replayed and
               held against float64 from its own starting centroids
               (assignments equal outside the margin, counts equal, new
               centroids within a tolerance of the float64 means), with
               bfloat16-rounded features as a control that must fail; ms per
               epoch from 10 against 60 epochs on one cache; a
               ``torch.profiler`` trace of a 10-epoch fit for the device's
               idle share;
14. serve_kmeans — StandardScaler → KMeans fitted on the published rows,
               saved, loaded back through ``load_servable`` and served by
               ``InferenceServer`` (fusion.mode=fast, max batch 4096): 64
               requests of 1–4096 new rows from 4 clients checked against
               float64 numpy; megakernel launches equal the batches of bucket
               ≥ 512, 0 fallbacks, 0 chains built after warmup, the plain
               version never called; a 4096-row batch's host breakdown;
15. kernels_rowlocal — the kernel's registers and spills (ptxas -v), then
               the row-local megakernel (any chain of scale,
               normalize, elementwise_product, idf, binarize and impute, ±
               a logistic head) against its plain version over 15 chains
               (scale under the four flag pairs, normalize at p 1, 2, 3, the
               product, idf, a three-column binarize, impute with a NaN and
               with a 0.1 placeholder, feature6, feature6 → logistic, a head
               reading a column other than its predecessor's) × d (1, 2, 7,
               16, 17, 32, 33, 100, 257, 1024: each lanes-a-row case) × rows
               (1, 33, 4096 and past one pass of its persistent grid), with
               zero, NaN and ±inf entries: bit-equal
               until a normalize, then within the feature6 envelope, bin equal
               outside a margin; then CUDA-event times at 4096 × 100 of
               feature6 → logistic, normalize alone against
               ``F.normalize`` (the library yardstick) and a 15-column impute,
               with the bytes bound;
16. serve_feature6 — bench.py's feature6 chain (StandardScaler → Normalizer
               → ElementwiseProduct → IDF → StandardScaler → Binarizer) →
               LogisticRegression at d 100 from seeded model data, each stage
               saved and loaded back through ``load_servable`` and served by
               ``InferenceServer`` (fusion.mode=fast): 64 requests of 1–4096
               rows from 4 clients checked against float64 numpy; launches
               equal the batches of bucket ≥ 512, 0 fallbacks, 0 chains built
               after warmup, no plain version called; a 4096-row batch's
               host breakdown;
17. serve_imputer — Imputer (mean, NaN) fitted on imputer-benchmark.json's
               rows (15 DoubleGenerator columns, arity 100, seed 2, 100,000
               rows), saved, loaded and served with
               ``fusion.megakernel.min.score`` 1.0 to 64 requests whose
               entries are a seeded tenth NaN: every output exact; launches
               equal the batches;
18. kernels_flash — the ring-attention fold (``csrc/flash_fold.cu``) against
               the plain fold over B·H (1, 3, 8) × Tq (1, 63, 256, 1000) × Tk
               (1, 200, 256, 2048) × D (8, 64, 128, 256) × seven cases of
               causal, n_valid, first-fold / carried / partly -inf state and
               block positions (the block before, after and across the
               queries): m within 1e-6, l and acc within 1e-5 relative, rows
               with no attendable key exact, no NaN; the same contract with
               every key equal (one repeated token) at D 8, 64, 100, 128 and
               256, and at D 100 on inputs 4 bytes past a 16-byte boundary
               (the kernel's 4-byte loads); one Q block folded against four
               K/V blocks in ring order (causal, n_valid) for each of four
               shards, held against float64 dense attention; the fold
               kernel's registers and spills at each template width (ptxas
               -v) and its SASS's HGMMA and HMMA count (cuobjdump; HGMMA,
               the wgmma instructions, required); then CUDA-event times at
               bench.py's ring_attention_causal_T8192_h4_d128 (B 1, T 8192,
               H 4, D 128), causal and not, of the kernel, the plain fold
               and ``scaled_dot_product_attention`` (the library yardstick
               of fold + acc / l), with the bound as 3×TF32 operations at
               the TF32 peak (the float32 bound beside it) and the share of
               the TF32 peak reached; at that shape the kernel's (m, l, acc)
               are held against the plain fold's at the grid's tolerances
               first;
19. serve_attention — SelfAttentionClassifierModel at E 512, H 4, vocab
               1024, 8 classes (bench.py's attention width) from seeded
               weights, saved and loaded back, ``transform`` on the card of
               8 × 8192, 8 × 8000 and 1 × 8192 tokens. Every fold the path
               launched (B·H 32 or 4, T 8192 or 8000, D 128) is held, a
               document at a time, against the plain fold at the grid's
               tolerances, and its output acc / l against float64 dense
               attention within 1e-7 absolute, which a uniform-attention
               control (every score equal) and a bfloat16-q/k/v control
               must both miss; probabilities within 1e-7 of the float64
               forward, whose bfloat16 control must land outside (the
               uniform control's probability error is a reading: at these
               seeded weights attention is within ~0.1% of uniform, so the
               probabilities cannot see the fold's weighting); prediction
               equal past a 1e-4 float64 logit gap; one fold launch per
               transform, the plain fold never called;
               ms per document and a ``torch.profiler`` trace of one
               8-document transform (idle share, the fold's share);
20. kernels_flash_bwd — the fold's two backward kernels
               (``csrc/flash_fold_bwd.cu``: the one-pass dq kernel, then dkv
               from dq's row quantities; every product in 3×TF32 on the
               tensor cores) against the plain VJP ``reference_fold_bwd`` over
               the forward's grid plus a ties case (every key duplicated, the
               carried m equal to the block max on every third row), q and k
               on a 1/8 grid so every score is exact and both find the same
               maxima: every gradient within 2e-5 of |plain| + its largest
               magnitude, rows with no attendable key and keys no query
               attends exact, no NaN; a max-key census off that grid (q and k
               standard normal at BH 4, Tq 1000, Tk 2048, D 128, m -inf and
               carried): dkv run with dq's ``dbc`` on the rows whose float64
               top-two score gap passes 1e-4 and with ``dbc`` zeroed, the dk
               difference equal to ``dbc · q · scale`` at each row's float64
               argmax, so both kernels find the same max keys (rows checked
               reported); every key equal (every score of a row tied, dq a
               difference of two sums ~Tk times larger) at D 8, 128, 256,
               first and carried, causal and not, held as the grid is, with
               dq's error against float64 read beside the plain float32
               VJP's; then CUDA-event times at B 1, T 8192, H
               4, D 128, causal and not, with the cotangents of out = acc / l, of each
               kernel, the plain VJP and the float32 backward of
               ``scaled_dot_product_attention`` (the library yardstick of the
               two kernels plus the divide's backward), with the operations
               bounds: 6·D and 8·D per attendable pair, three TF32 operations
               each at 495 TFLOP/s (``bound_ms``) and, comparable with the
               earlier float32 kernels, one float32 operation at 67 TFLOP/s
               (``bound_ms_f32``);
21. fit_attention — SelfAttentionClassifier.fit on the card at bench.py's
               attention training width (E 512, H 4, vocab 1024, 8 classes, T
               8192, lr 1e-3; 15 seeded documents, each class planting its own
               signal token; two a step, 8 steps, the last the zero-weighted
               tail): the fold, dq and dkv kernels launched once a step and
               the plain versions never called, every launch held against
               the plain version on its inputs a document at a time; step 1's
               gradients against float64 autograd of dense attention, and the
               loss history against a float64 fit of the same schedule, each
               with a bfloat16-q/k/v control that must land outside; ms per
               step (8 against 24 steps), tokens/s and a ``torch.profiler``
               trace of one step that must hold all three kernels (idle
               share, each fold kernel's share); the
               fitted model's probabilities on 8 held-out documents against
               float64 (its bfloat16 control outside, the uniform-attention
               control read);
22. kernels_chains — the chains of the Pipeline slice against their plain
               versions: ("normalize", "kmeans") and ("scale", "normalize",
               "kmeans") on the row-local kernel's kmeans op over rows
               (CHECK_ROWS) × d (8, 100, 256, 1000) × k (1, 10, 1024) × the
               three measures, with a zero row, a NaN feature and a duplicate
               centroid (scaled bit-equal, normalized within the feature6
               envelope, the index equal past a 1e-4 float64 top-two gap);
               ("normalize", "mlp") and ("elementwise_product", "scale",
               "mlp") on the MLP kernel's table prologue over the MLP grid's
               rows × networks (the published one, 100→64→2, 8→16→3 and the
               kernel's limits); ("sparse_idf",) on the sparse kernel's
               head-less mode over rows × nnz caps 1…64 × d (bit-equal to
               float32 values * idf[ids]); the table's last four classes
               against the plain table — sparse with dense (IDF → LR →
               scale, scale → IDF → LR, IDF beside a normalize), other
               sparse runs (IDF → IDF, IDF → IDF → LR, two sparse heads) on
               the row-local kernel over rows (1, 33, 4096) × dense widths
               (1 … 1024) × nnz caps (1, 2, 8, 33, 64) × d (1000, 2^22), with zero,
               NaN and ±inf entries, short rows and padding; ops after an
               MLP head (mlp → scale, normalize → mlp → binarize on
               rawPrediction, mlp → kmeans, two heads) on the MLP kernel
               over rows × the MLP grid's networks; ops reading a kmeans
               index (kmeans → binarize, kmeans → impute, scale → kmeans →
               binarize) over rows × widths × measures — elementwise ops
               before a normalize or a head bit-equal, tf-idf bit-equal,
               the sparse heads' prediction and rawPrediction bit-equal,
               the others' outputs as the chains above, binarize and
               impute of the index exact
               and int32 / float32; then cold and warm CUDA-event times of
               normalize → kmeans at 4096 × 100, k 10, normalize → mlp at
               4096 × 256→512→512→8, sparse_idf at serve_sparse's hot key
               (4096 rows, cap 64, d = 2^22), IDF → LR → scale there beside
               a dense 100-wide column, normalize → mlp → binarize at the
               published network and kmeans → binarize at 4096 × 100, k
               10, each beside its plain version, the merged program of
               the new chains and its bound (a sparse chain's gathers as
               each distinct 32-byte sector once, as in kernels_sparse; no
               single PyTorch call computes any of them);
23. pipeline_kmeans — Pipeline([StandardScaler, Normalizer(p 2), KMeans(k 10,
               maxIter 10)]) fitted by ``Pipeline.fit`` on kmeans-benchmark.json's
               100,000 × 100 rows; ``PipelineModel.transform`` under
               fusion.mode=fast in the batch tier at 65,536-row chunks (two,
               the second ragged): the chain ("scale", "normalize") on the
               row-local kernel once a chunk, one build per chunk signature
               (none on a second call), held against the per-stage path and
               float64 numpy (clusters past a 1e-4 gap); then saved,
               ``PipelineModel.load_servable``d and served by
               ``InferenceServer`` to 64 requests of 1–4096 rows from 4
               clients: the chain ("scale", "normalize", "kmeans") on the
               row-local kernel once per batch of bucket ≥ 512, no plain
               version called, 0 fallbacks, 0 post-warmup builds;
24. pipeline_mlp — Pipeline([Normalizer(p 2), MLPClassifier]) fitted by
               ``Pipeline.fit`` at mlpclassifier-benchmark.json (256 → [512,
               512] → 8, 100,000 rows, maxIter 10, batch 4096), saved, loaded
               and served the same way: ("normalize", "mlp") on the MLP
               kernel's prologue once per batch of bucket ≥ 2, probabilities
               within 1e-5 of a float64 forward on the same weights;
25. pipeline_sparse — PipelineModel([IDF, LogisticRegression]) (serve_sparse's
               fitted models) transformed over the 250,000 headline rows in
               the batch tier: ("sparse_idf", "sparse_logistic") on the sparse
               kernel once a 65,536-row chunk, tf-idf bit-equal to the
               per-stage path and to float32 values * idf[ids], the
               probabilities against float64; and a one-stage
               PipelineModel([IDFModel]) saved, loaded and served as a TF-IDF
               featurization service: ("sparse_idf",) on the head-less
               kernel once per batch of a hot (bucket, cap) key, every value
               bit-equal to float32 values * idf[ids];
26. pipeline_mixed — the slice's path, after 25: PipelineModel([IDF,
               LogisticRegression, StandardScaler]) — serve_sparse's IDF and
               LR on the headline tf column (d = 2^22, cap ≤ 64) and a
               StandardScaler fitted on a seeded dense 100-wide column of
               the same rows — saved, loaded through ``load_servable`` and
               served by ``InferenceServer`` (fusion.mode=fast) to 64
               requests of 1–4096 rows, each with both columns, from 4
               clients: every response against float64 numpy; the run
               ("sparse_idf", "sparse_logistic", "scale") on the row-local
               kernel once per batch of a hot (bucket, cap) key, 0
               fallbacks, 0 chains built after warmup, the plain table
               never called; a 4096-row batch's host breakdown. Then the
               batch tier, one launch per 65,536-row chunk, each held
               against the per-stage path on the card: the same model over
               the 250,000 headline rows; Normalizer → the published MLP
               (256 → 512 → 512 → 8) → Binarizer on rawPrediction on the
               MLP kernel; the published KMeans pipeline (StandardScaler →
               Normalizer → KMeans, k 10, d 100) → Binarizer on prediction
               and IDF → IDF on the headline rows on the row-local kernel;
27. fit_checkpoint — checkpointed SGD killed by a listener and resumed
               from its newest intact snapshot (``CheckpointManager``, every 5
               epochs): dense LeastSquare SGD on 100,000 × 100 seeded rows
               (batch 4096, 30 iterations, killed at epoch 17), the resumed
               coefficient against the uninterrupted fused fit (bit-equal
               reported, within 1e-6 required) and the fused fit against
               float64; a copy of the killed run's directory with its newest
               snapshot truncated, quarantined and resumed from the one
               before; a different config refused with
               ``FingerprintMismatchError``; then the headline rows on the
               host loop (the scatter step, 20 iterations, killed at epoch 12
               and resumed): the resumed and the uninterrupted fused scatter
               coefficients each within 1e-5 of the float64 SGD, no one-hot
               crossing launched; ms/epoch of the host loop and the fused
               scatter path on one cache (10 against 30 epochs), and the
               save and restore times of the 16 MB coefficient;
28. fit_linear_family — LinearSVC().fit on the headline rows through the
               estimator (the one-hot path; the form it ran and its crossing
               launches, 20 each), its coefficient and loss history against
               float64 hinge SGD of the same schedule and its transform of
               65,536 rows against float64 margins; LinearRegression().fit on
               fit_checkpoint's dense rows (the fused SGD's coefficient) and
               its transform, against float64;
29. hot_swap — serve_sparse's PipelineModel([IDF, LogisticRegression])
               published as v1 with ``publish_servable`` and served by
               ``InferenceServer`` (fusion.mode=fast) through
               ``attach_poller``; 4 clients send 64 requests of 1–4096 rows
               and keep sending until the flip; v2 (the same IDF, the LR
               coefficient of fit_checkpoint's resumed sparse fit) and a v3
               with truncated model data are published mid-traffic: every
               response against float64 numpy of the version it names, the
               batches' versions in dispatch order never going back, 8
               requests after the flip all v2, v3 in ``poller.failed``,
               ``ml.serving.swaps`` and ``ml.serving.swap.failures`` each up
               by exactly 1, 0 fallbacks, 0 chains built after warmup, sparse
               kernel launches equal to the hot batches served plus v2's hot
               warmup batches; v2's publish time, the time from its publish
               to the first response it served, and each version's load and
               warmup time on the poller's thread;
30. text     — Tokenizer → HashingTF (numFeatures 2^18, the default) → IDF
               → LogisticRegression (globalBatchSize 8192, 20 iterations)
               fitted by ``Pipeline.fit`` on hashingtf-benchmark.json's rows
               (RandomStringArrayGenerator: seed 2, 100,000 rows of 10
               strings over 10 values, joined by spaces), labelled by a
               seeded rule over the tokens: 13 windows, so the one-hot path
               (the form it took and its crossing launches, 20 of each of
               that form's kernels, none of the other, no plain crossing);
               the IDF against float64 document frequencies, the
               coefficient and loss history against float64 SGD on the
               fit's tf-idf rows with the bf16-hi-only control outside, as
               in 6; ms/step of SGD in that form on one cache (20 against
               60 iterations); the fitted PipelineModel in the batch tier
               (exact, 65,536-row chunks): every row on the chain, no
               kernel, bit-equal to the per-stage path, tf and tf-idf
               exact against float64 numpy of murmur3, counts and idf; then
               saved, ``load_servable``d and served by ``InferenceServer``
               (fusion.mode=fast, the sparse fast path, warmed over 13
               buckets × nnz caps 1…64) to 64 requests of 1–4096 new
               documents from 4 clients: keys ``(bucket, cap)``, 0
               fallbacks, 0 chains built after warmup; tf and tf-idf exact
               against float64 numpy, probabilities within 1e-5, prediction
               equal to the per-stage path and rawPrediction within the
               fast tier's envelope of it; p50/p99 and a 4096-document
               batch's breakdown (tokenize, featurize, upload, chain, the
               chain's device time by CUDA events, readback);
31. featurize — two legs in the batch tier (exact, 65,536-row chunks), each
               bit-equal to the per-stage path with every row on the chain:
               CountVectorizer fitted on countvectorizer-benchmark.json's
               rows (seed 2, 20,000 rows of 100 strings over 100 values;
               the leg raises ``sparse.nnz.cap.max`` to 128), the counts
               against numpy, then one more transform at the default cap of
               64, which falls back per stage once under ``off_ladder``
               with the same bits; FeatureHasher at
               featurehasher-benchmark.json (5 DoubleGenerator columns,
               f0–f2 categorical, numFeatures 1000, seed 2, 100,000 rows),
               each row's values summing to 3 + f3 + f4.
32. sharded  — data-parallel training on ``train.mesh``: worlds of 1 rank
               (NCCL) and 2 and 4 ranks (gloo on CUDA tensors: the ranks
               share the one card, where NCCL refuses them), spawned after
               the kernels are built, every rank handed the same whole input.
               Each world fits LogisticRegression at
               logisticregression-benchmark.json (100,000 × 100, batch
               100,000, 20 iterations) and KMeans at kmeans-benchmark.json
               on the deterministic tier — coefficient, centroids and counts
               bit-equal on every rank and across the widths; the dense
               coefficient within 1e-5 of float64, every KMeans epoch of
               the width-1 program against float64 as in 13 — and SGD on
               the headline wide-sparse rows on the psum path: every rank
               launches each crossing of the form taken 20 times and no
               plain crossing, each width within 1e-5 of float64 of its own
               schedule. Width 2 also fits MLPClassifier at
               mlpclassifier-benchmark.json (serve_mlp's rows, standardised
               on the host; losses against float64 of the width-2 schedule
               under 11's limits) and a checkpointed dense SGD fit killed at
               epoch 10 by a listener and resumed from a
               ``ShardedCheckpointManager``, bit-equal to its clean fit;
               width 4 restores that snapshot. Every world also runs 36's
               OnlineKMeans stream on the deterministic tier, every version
               bit-equal on every rank and across the widths. Readings, with no scaling
               claim (the ranks share one card): each world's backend,
               ms/epoch, the mapreduce ``all_gather`` ms, each rank's peak
               memory beside the card's, and whether cuBLAS's bits for a
               row change with the row count (the products the tier avoids).
33. model_parallel — tensor, sequence and expert parallelism on gloo worlds
               sharing the card: 4 ranks (train.mesh 2 × train.mesh.model
               2), then 2 (1 × 2). Each world fits the headline wide-sparse
               rows (train's schedule) with the coefficient sharded over the
               model axis, premat and then build form on one cache: every
               rank launches each crossing of the form 20 times on its
               model-local stacks (``nblk_local`` < ``nblk``) and no plain
               crossing; rank 0's first launch of each crossing held
               against its plain version (the premat forms bit-equal to the
               build forms on the same q and multiplier); both forms'
               coefficients bit-equal, on every rank, within 1e-5 of
               float64 of the n_data schedule and within rtol 2e-3 / atol
               1e-4 of 32's n_model 1 fit at the same n_data. 2 × 2 also
               fits dense SGD (fit_checkpoint's rows) with a
               ``ShardedCheckpointManager`` that the 1 × 2 world restores
               equal; 1 × 2 fits LogisticRegression at
               logisticregression-benchmark.json (dense TP, within 1e-5 of
               float64) and the headline rows on the scatter path (1e-5).
               Each world then fits SelfAttentionClassifier at 21's
               configuration with its sequence split over the ranks: a
               fold, dq and dkv launch per rank and ring step, every one
               of rank 0's held against the plain versions, the chained
               folds' incoming state carrying gradient back; step 1's loss
               and gradients against the one-rank computation (21's
               limits), the fitted model's probabilities against float64
               (1e-7); and runs moe_ffn_sharded (8192 tokens, d 512, h
               2048, 8 experts) at capacity 1.25 T / E and at one that
               drops tokens: routing exact, outputs within 1e-5 of the
               dense computation of the same routing, dropped rows 0.
               Readings: each rank's launches, ms/step, rotation ms a step
               and peak memory, MoE ms, the phase's seconds.
34. streamed — fits out of a host-tier cache, streamed onto the card a
               window at a time (``iteration/streaming.py``): the headline
               model (6's schedule) on 2^20 rows from TRAIN_SEED, appended
               in 65,536-row chunks under a 64 MiB budget so most chunks
               spill to a temporary directory, 262,144-row windows (4
               windows, 5 loads over 20 epochs). SGD in three legs: premat
               ("auto") and build ("off") on a ``NativeDataCache`` (the
               type asserted: ``create_capacity_cache`` falls back when g++
               fails), scatter on a ``HostDataCache``; each crossing of the
               leg's form launched 20 times and no plain crossing, the
               first launch of each held against its plain version as in
               33, premat and build bit-identical, every coefficient within
               1e-5 of 6's float64 SGD (losses 1e-5 relative), the
               bf16-hi-only control outside; each leg's ms an epoch of the
               window loop, host ms of each window load, device ms of each
               run (CUDA events) and each load's parts (the cache's
               ``rows``, the host fill, the upload call), the idle share
               and the peak memory beside two windows' forecast. One
               window's ``rows`` timed 3 times on each cache, the first
               window and the last (all spilled, the page cache warm). The
               premat leg again with a ``CheckpointManager`` every 4
               epochs, its newest snapshot deleted and resumed: bit-equal
               to the clean fit, its loss history equal.
               KMeans.fit_stream at kmeans-benchmark.json in 16,384-row
               chunks from a spilled cache: each epoch (its centroids
               snapshotted every epoch) against float64 as in 13 and
               against the resident epoch from the same centroids, with
               bf16-rounded centroids as the control that must fail.
               MLPClassifier.fit_stream at mlpclassifier-benchmark.json
               (32's standardised rows) in 16,384-row windows against the
               resident fit under 11's limits, bit-equality reported. A
               gloo world of 2 on the card at 2^18 rows: the streamed
               one-hot fit on the data axis bit-equal on both ranks and to
               the world's resident fit, within 1e-5 of float64 of the
               width-2 schedule, and KMeans.fit_stream on the
               deterministic tier bit-equal to width 1.
35. sharded_serving — the plan tiers on a shard grid, every shard on the
               one card (``servable/sharding.py``; the shards time-share
               it, so no gain over mesh 1 is expected). Three models served
               by ``InferenceServer`` at ``serving.mesh`` 1, 2 and 4, in the
               exact and the fast tier, max batch 4096, 64 requests of
               1–4096 rows from 4 clients: the published KMeans pipeline
               (StandardScaler → Normalizer → KMeans, fitted on
               kmeans-benchmark.json's 100,000 × 100 rows, k 10), the
               published MLP 256→512→512→8 (seeded weights) and IDF → LR
               on SparseVector rows (d 2^22, nnz cap 64, seeded). Every
               response bit-equal per row to the mesh-1 plan at its
               bucket — at mesh 2 and 4 to it run inside
               ``rowstable.required()``, the row-stable forms a plan with
               data shards takes on the card, with how far the default
               (cuBLAS) mesh-1 plan lies from that recorded —, mesh 1
               against float64 (KMeans and MLP); in the fast
               tier the chain's megakernel launched once per data shard of
               every hot batch (launches = N × hot batches), none in the
               exact tier, no plain version called, 0 fallbacks, 0 chains
               built and 0 model arrays uploaded after warmup, every shard
               16-byte aligned. The MLP at mesh 4 (fast) swapped v1 → v2,
               rolled back to v1 and swapped on to v3 under traffic: every
               response bit-equal to the mesh-1 plan of the version it
               names, each version flipped in after its warmup of every
               bucket on every shard, no model upload on the batcher's
               thread, every client's last response v3. Tensor
               parallelism: the MLP at ``serving.mesh`` 2 ×
               ``serving.mesh.model`` 2 (W0 and W1 split, W2 replicated),
               rawPrediction within rtol 1e-5 / atol 1e-6 of mesh 1 and
               within 1e-5 of float64. The batch tier: the KMeans pipeline
               on 100,000, 100,008 and 100,003 rows at ``batch.mesh`` 1, 2
               and 4 in 65,536-row chunks, both tiers — tails of 34,464
               (no pad rows), 34,472 (8 pad rows at 2, 24 at 4) and 34,467
               (replicated), bit-equal to ``batch.mesh`` 1 (in the
               row-stable forms, the default's drift recorded), launches one a
               shard of each hot chunk — and IDF → LR on 100,008 sparse
               rows at ``batch.mesh`` 2. Readings: p50/p99 and rows/s at
               each mesh and tier, seconds per transform.
36. online   — OnlineLogisticRegression over an unbounded stream
               (``QueueBatchStream``, one FTRL step a 4096-row batch at d
               256, alpha 0.5, beta 0.1: bench.py's continuous loop), 64
               versions a leg on the card: A at reg 0, B at reg 0.01 and
               elasticNet 0.5 (L1 zeroes the faint three quarters of the
               features). Every version's coefficient against a float64
               numpy FTRL of the same batches (rtol 1e-5 / atol 1e-6, the
               zero pattern equal, the float64 run more than 1e-4 from the
               L1 threshold everywhere), with a bf16-feature control that
               must land outside; the FTRL state float32; ms a version
               (host clock, versions 33 against 64), and over versions
               17–32 a ``torch.profiler`` trace: the upload and coefficient
               readback ms a version and the device's idle share. Leg A
               again under traffic: every 8th version published with
               ``publish_servable`` into a directory an ``InferenceServer``
               (fusion.mode=fast, max batch 4096) polls, 4 closed-loop
               clients sending 1–4096-row requests throughout; each
               version's publish to its first response, p50/p99, every
               response against float64 of the version that served it,
               scale → logistic launches equal to the hot batches plus
               the new versions' hot warmup batches, 0 fallbacks, 0 chains
               built after warmup, the plain version never called; then a
               4096-row batch of each published version through the kernel
               and its plain version (largest ulp distance). Leg A with a
               ``CheckpointManager`` every 4 versions, dropped after 20 and
               resumed from a replaying source: versions 21–64, each
               bit-equal to the uninterrupted run. OnlineKMeans at
               kmeans-benchmark.json's width (d 100, k 10, uniform rows),
               decayFactor 0.5, 32 versions of 4096 rows: each version
               against float64 from its own starting model (assignments
               past the margin, weights, centroids); its train.mesh leg
               runs in 32's worlds, bit-equal across the widths.
               OnlineStandardScaler at d 100 over 16 event-time windows of
               1000 ms (4096 rows each): ms a window, and the gated
               transform at maxAllowedModelDelayMs 0 and 500, each row
               served by the version installed or the earliest later one
               fresh enough for it, against float64 of its statistics, the
               rest buffered and served once their version arrives.

Then a ``{"kernels": [...]}`` line for every kernel (twelve) with its
launches on each path that runs it, the ``nvidia-smi`` name/power-limit line,
and as the last line ``{"ok": true, "device": {...}}``.
Any failure exits nonzero without that last line; so does a machine without
a CUDA device.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

SEED = 0
D = 100  # vectorDim of the reference's published LogisticRegression / StandardScaler benchmark configs
MAX_BATCH = 4096
CHECK_ROWS = (1, 7, 203, 1024, 4096)  # and rows past one pass of the persistent grid (_logistic_past_one_pass)
# the two paths' edges (d % 4 != 0 and x one float into its buffer take the
# scalar one), the model in registers up to 512 and walked in chunks past it;
# _logistic_check_widths adds the widest d of each instance of the kernel's
# dispatch on either path, so every instance is launched
CHECK_WIDTHS = (1, 3, 4, 8, 100, 128, 129, 256, 1000, 4099)
LOGISTIC_MODEL_FLOATS = 16  # csrc/megakernel_scale_logistic.cu kModelFloats: a lane's floats of each model vector
LOGISTIC_ROW_FLOATS = 16  # and kRowFloats: a lane's floats of x in flight for one task
# (chain label, with_mean, with_std, write_scaled): the four scaler flag
# combinations of the scale→logistic chain, and LR alone.
CHAINS = (
    ("scale_logistic", True, True, True),
    ("scale_logistic", True, False, True),
    ("scale_logistic", False, True, True),
    ("scale_logistic", False, False, True),
    ("logistic", False, False, False),
)
TIMED_SHAPE = (4096, 100)
# (rows, d, with_mean, with_std, write_scaled): the serving buckets that reach
# the kernel and one row (the launch's floor) with the scaler, LR alone, and
# a row past the model's registers
LOGISTIC_TIMED = ((1, D, True, True, True), (1024, D, True, True, True), (2048, D, True, True, True),
                  (4096, D, True, True, True), (4096, D, False, False, False), (4096, 1000, True, True, True))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
N_CLIENTS = 4
REQUESTS_PER_CLIENT = 16
PREDICTION_MARGIN = 1e-4
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
# The headline wide-sparse workload (bench.py bench_logreg_sparse): Criteo's
# 39 feature fields hashed into 2^22 features, 250,000 rows, values 1.0.
TRAIN_ROWS, TRAIN_DIM, TRAIN_NNZ = 250_000, 1 << 22, 39
TRAIN_BATCH, TRAIN_LR, TRAIN_ITERS, TRAIN_SEED = 65_536, 0.5, 20, 1
STEP_ITERS = (20, 120)  # the two iteration counts differenced for ms/step
PROFILE_ITERS = 10  # iterations of each form traced with torch.profiler
PROFILE_LEAD_LAUNCHES, PROFILE_LEAD_S = 64, 0.2  # a trace's lead-in (_profile_steps)
CROSS_GRID = [(s, h, n) for s in (1, 4) for h in (1, 4, 128) for n in (1, 1000, 8192 + 7)]
# (n_sub, row_hi, n, case) beside the grid: "one_row" puts every entry on one
# row (a build-form dot tile whose range is many stages long); "dead" adds
# q = 0, ids past the row space and negative ids at an odd n, and runs the
# build-form kernels on views of entry_of and rowid off 16-byte boundaries.
CROSS_EDGES = [(4, 4, 20000, "one_row"), (4, 128, 8192 + 7, "one_row"), (4, 4, 8192 + 7, "dead"),
               (4, 256, 8192 + 7, "dead"), (1, 128, 7, "dead")]
DOT_RTOL = 1e-5  # |kernel - plain| <= DOT_RTOL * sum_row |q| + 1e-6: another summation order
# fit_checkpoint: dense SGD on d 100 rows killed at epoch 17 and resumed, and
# the headline rows on the host loop killed at epoch 12 and resumed.
CKPT_DENSE_ROWS, CKPT_DENSE_D, CKPT_DENSE_BATCH, CKPT_DENSE_LR = 100_000, 100, 4096, 0.1
CKPT_DENSE_ITERS, CKPT_DENSE_KILL, CKPT_SPARSE_KILL, CKPT_INTERVAL = 30, 17, 12, 5
CKPT_SEED = 12
CKPT_DENSE_ATOL = 1e-6  # the resumed dense fit against the fused one, if not bit-equal
CKPT_EPOCH_ITERS = (10, 30)  # the two epoch counts differenced for ms/epoch
CKPT_IO_REPS = 5
# LinearSVC's margins on the headline rows are ~1e-4 (20 steps from zero):
# past 1e-8 a float32 sum of 39 terms (error <= 39 * 2^-24 * 1e-4) cannot
# land on the wrong side of the threshold.
SVC_MARGIN = 1e-8
HOT_SWAP_SEED = TRAIN_SEED + 12  # new rows of the headline generator
HOT_SWAP_POLL_MS = 20.0
HOT_SWAP_AFTER = 16  # responses before v2 is published
HOT_SWAP_POST = 8  # requests sent after the flip, each to be served by v2
HOT_SWAP_RESEND_S = 0.02  # a client's pause between requests once its 16 are served, until the flip
# max |f32 fit - float64 SGD| / max |coef|: between the split-bf16 fit and
# the float64 SGD whose crossings keep only the bf16 hi half (asserted apart)
COEF_TOL = 1e-5
# the sparse megakernel's check grid (rows shorter than the cap included)
SPARSE_ROWS = (1, 7, 203, 1024, 2048, 4096)
SPARSE_CAPS = (1, 2, 3, 8, 13, 16, 32, 64, 65, 1500)  # 3, 13, 65: off 16-byte rows; 1500: past a tile
SPARSE_TIMED = ((MAX_BATCH, 64), (1024, 16), (203, 8))  # rows × cap: the serving shape, two small buckets
SPARSE_DIMS = (8, 1000, TRAIN_DIM)
SPARSE_CHAINS = (("idf_kept", True, True), ("idf_dropped", True, False), ("no_idf", False, False))
SPARSE_SERVE_SEED = TRAIN_SEED + 1  # new rows from the headline generator
# The MLP classifier: bench.py's mlp / mlp_serving_throughput network and
# flink_ml_tpu/benchmark/configs/mlpclassifier-benchmark.json (vectorDim 256,
# hiddenLayers [512, 512], labelArity 8, 100,000 rows, maxIter 10,
# globalBatchSize 4096).
MLP_WIDTHS = (256, 512, 512, 8)
MLP_CHECK_ROWS = (1, 2, 7, 64, 203, 1024, 4096)
MLP_CHECK_NETWORKS = {"256-512-512-8": MLP_WIDTHS, "100-64-2": (100, 64, 2), "8-16-3": (8, 16, 3)}
# (chain label, with_mean, with_std, write_scaled), as CHAINS
MLP_CHAINS = (
    ("scale_mlp", True, True, True),
    ("scale_mlp", True, False, True),
    ("scale_mlp", False, True, True),
    ("scale_mlp", False, False, True),
    ("mlp", False, False, False),
)
MLP_ROWS, MLP_ITERS, MLP_BATCH, MLP_SEED = 100_000, 10, 4096, 3
MLP_SERVE_SEED = MLP_SEED + 1  # new rows of the same population
MLP_EPOCH_ITERS = (10, 60)  # the two iteration counts differenced for ms/epoch
MLP_HOLDOUT_ROWS = 4096
MLP_SMALL_ROWS = (2, 32, 256, 1024)  # times below the serving shape: one 64-row tile on a cluster of 8 up to 64 rows
MLP_EQUAL_OFFSETS = (0, 37, None)  # where a small batch's rows sit in the 4096-row one (None: its end)
# The fit against its float64 twin. The first epoch's loss is the forward
# pass at the shared initial weights: float32 rounding of 512-term sums
# (~1e-7 relative) against bfloat16's 2^-9 per operand (the CPU read 9e-10
# and 2.6e-5). From the second epoch on, the default learning rate 0.1
# explodes the loss (2.7 -> ~900) before it settles, which amplifies
# last-bit differences of float32 gradients: the largest relative
# difference of the later losses and the mean |difference| of the held-out
# probabilities get a wider bound. An independent float32 fit of the same
# schedule (the float32 floor) is reported beside the fit: on the CPU both
# read ~1e-4, on the card the fit read 1.16e-3; bfloat16 5.3e-2 and 6.1e-4
# on the CPU.
FIT_FIRST_LOSS_RTOL = 1e-6
FIT_LOSS_RTOL = 1e-2
FIT_PROB_MEAN_ATOL = 1e-4
# KMeans: flink_ml_tpu/benchmark/configs/kmeans-benchmark.json — k 10,
# maxIter 10 on DenseVectorGenerator rows (seed 2, 100,000 x vectorDim 100,
# uniform [0, 1)); nothing cut.
KMEANS_ROWS, KMEANS_D, KMEANS_K, KMEANS_ITERS, KMEANS_DATA_SEED = 100_000, 100, 10, 10, 2
KMEANS_SERVE_SEED = KMEANS_DATA_SEED + 1  # new rows from the same generator
# More rows than one pass of a persistent grid holds: an H100's 132 SMs x 64
# resident warps x the rows a warp takes at once (the kmeans kernel: at most
# 8; the row-local kernel: 32 / its lanes a row).
SMS_WARPS = 132 * 64
KMEANS_CHECK_ROWS = (1, 7, 203, 1024, 4096, SMS_WARPS * 8 + 1)
KMEANS_CHECK_DIMS = (1, 7, 100, 256)
KMEANS_CHECK_KS = (2, 10, 64)
KMEANS_MEASURES = ("euclidean", "manhattan", "cosine")
# (chain label, with_mean, with_std, write_scaled), as CHAINS
KMEANS_CHAINS = (
    ("scale_kmeans", True, True, True),
    ("scale_kmeans", True, False, True),
    ("scale_kmeans", False, True, True),
    ("scale_kmeans", False, False, True),
    ("kmeans", False, False, False),
)
KMEANS_EPOCH_ITERS = (10, 60)  # the two epoch counts differenced for ms/epoch
# StandardScaler → KMeans at d 100, k 10 scores 3016 per row against the
# default bar of 10^6: buckets from 512 rows run the megakernel
KMEANS_HOT_FROM = 512
# Assignments are compared where the float64 top-two distance gap exceeds
# this margin (the MLP slice's): below it two summation orders may round the
# two nearest distances either way. At the published rows the distances are
# ~4.1 and their float32 rounding ~1e-6.
KMEANS_MARGIN = 1e-4
# |a fitted epoch's centroids - the float64 means over its own assignment|:
# float32 sums of ~10,000 values in [0, 1) through the GEMM, ~1e-6.
KMEANS_CENTROID_ATOL = 1e-5

# the row-local kernel: chains, shapes and comparison rules
ROWLOCAL_CASES = (
    "scale_11", "scale_10", "scale_01", "scale_00", "normalize_1", "normalize_2", "normalize_3",
    "product", "idf", "binarize", "impute_nan", "impute_value", "feature6", "feature6_logistic",
    "head_off_chain",
)
ROWLOCAL_CHECK_WIDTHS = (1, 2, 7, 16, 17, 32, 33, 100, 257, 1024)
ROWLOCAL_CHECK_ROWS = (1, 33, 4096)  # and rows past one grid pass (_rowlocal_past_one_pass)
# Where a binarize's input carries a normalize's rounding, entries within
# this margin of the threshold may round either way: they are not compared,
# nor anything downstream of them in their row. 1e-5 is ~100x the feature6
# envelope (1024 ulps) at the magnitudes of the feature6 chain (~0.1).
BIN_MARGIN = 1e-5
# feature6 (bench.py _make_feature6_stages, n_docs 400,000) -> logistic at
# the vectorDim of standardscaler-benchmark.json / logisticregression-benchmark.json
FEATURE6_D, FEATURE6_SEED, FEATURE6_SERVE_SEED, FEATURE6_N_DOCS = 100, 77, 78, 400_000
# feature6 -> logistic at d 100 scores 3556 per row against the default bar
# of 10^6: buckets from 512 rows run the megakernel
FEATURE6_HOT_FROM = 512
# imputer-benchmark.json: 15 DoubleGenerator columns (arity 100, seed 2),
# 100,000 rows; the traffic sets a seeded tenth of its entries to NaN
IMPUTER_COLS = tuple(f"f{i}" for i in range(15))
IMPUTER_ROWS, IMPUTER_ARITY, IMPUTER_SEED, IMPUTER_SERVE_SEED = 100_000, 100, 2, 3
IMPUTER_MISSING_SHARE = 0.1

# the Pipeline slice: a row-local prefix before kmeans and mlp, sparse_idf
# alone. The kmeans chains' grid (rows CHECK_ROWS):
CHAIN_KMEANS_NAMES = ("normalize_kmeans", "scale_normalize_kmeans")
CHAIN_KMEANS_DIMS = (8, 100, 256, 1000)
CHAIN_KMEANS_KS = (1, 10, 1024)
CHAIN_MLP_NAMES = ("normalize_mlp", "product_scale_mlp")
# StandardScaler → Normalizer → KMeans at d 100, k 10 scores 208 + 8 + 2008
# + 3 · 400 = 3424 per row against the default bar of 10^6: buckets from
# 512 rows run the megakernel; Normalizer → MLP 256→512→512→8 scores
# ~797,000 per row: buckets from 2 rows
PIPELINE_KMEANS_HOT_FROM = 512
PIPELINE_MLP_HOT_FROM = 2
PIPELINE_MLP_PROB_ATOL = 1e-5  # serve_mlp's bound: probabilities vs the float64 forward
PIPELINE_CHUNK_ROWS = 65_536  # batch.chunk.rows' default: the published 100,000 rows are two chunks
# the table's last four classes (servable/megakernels.py): chains, the grid
# they are held on, and the pipeline_mixed phase's dense column
RESIDUE_CHAINS = {
    "sparse_with_dense": ("idf_lr_scale", "scale_idf_lr", "idf_normalize"),
    "other_sparse_run": ("idf_idf", "idf_idf_lr", "two_sparse_heads"),
    "mlp_not_last": ("mlp_scale", "normalize_mlp_binarize", "mlp_kmeans", "mlp_mlp"),
    "reads_kmeans_index": ("kmeans_binarize", "kmeans_impute", "scale_kmeans_binarize"),
}
RESIDUE_ROWS = (1, 33, 4096)
RESIDUE_WIDTHS = (1, 7, 100, 1024)  # the dense column's width (MLP chains: MLP_CHECK_NETWORKS)
RESIDUE_CAPS = (1, 2, 8, 33, 64)  # 33: the table's sparse fold past one warp chunk
RESIDUE_DIMS = (1000, TRAIN_DIM)  # the sparse column's dimension
RESIDUE_K = 10
RESIDUE_MLP_THRESHOLD = 0.125  # the binarize of 8 classes' probabilities
MIXED_DENSE_D, MIXED_DENSE_SEED = 100, 12  # the mixed pipeline's dense column (bench.py's d)

# the ring-attention fold: bench.py's bench_attention shape, and the grid
FLASH_TIMED = (1, 8192, 4, 128)  # B, T, H, D: ring_attention_causal_T8192_h4_d128
FLASH_GRID_BH = (1, 3, 8)
FLASH_GRID_TQ = (1, 63, 256, 1000)
FLASH_GRID_TK = (1, 200, 256, 2048)
FLASH_GRID_D = (8, 64, 128, 256)
# (causal, n_valid, state, positions): n_valid "inside" is half the block,
# "before" masks every key of the block; positions place the block
FLASH_FLAG_CASES = (
    (False, None, "first", "aligned"),
    (True, None, "first", "aligned"),
    (True, "inside", "carried", "kv_before"),
    (False, "inside", "mixed", "aligned"),
    (False, "before", "mixed", "straddle"),
    (True, None, "mixed", "kv_after"),
    (True, "inside", "carried", "straddle"),
)
FLASH_M_RTOL = 1e-6  # of |m| + the scores' term magnitudes: the dot products sum in another order
FLASH_RTOL = 1e-5  # l and acc; atol FLASH_RTOL times the tensor's largest magnitude
# the grid's added cases: every key equal at these head dims, and D 100 on
# inputs that start 4 bytes past a 16-byte boundary (BH, Tq, Tk)
FLASH_EQUAL_KEYS_D = (8, 64, 100, 128, 256)
FLASH_UNALIGNED_D = 100
FLASH_EXTRA_SHAPE = (3, 1000, 2048)
FLASH_CHAIN = (4, 2048, 4, 128)  # shards, T per shard, B·H, D
FLASH_CHAIN_RTOL, FLASH_CHAIN_ATOL = 2e-5, 2e-5
# SelfAttentionClassifier at bench.py's _attention_train_step_ms width
ATTN_E, ATTN_H, ATTN_VOCAB, ATTN_CLASSES, ATTN_PARAM_SEED = 512, 4, 1024, 8, 5
ATTN_FRAMES = ((8, 8192), (8, 8000), (1, 8192))  # documents × tokens
ATTN_TOKEN_SEED = 9
ATTN_PROB_ATOL = 1e-7  # float32 path vs float64; the bf16-q/k/v control must exceed it
# the fold's output acc / l vs float64 dense attention, per document: at these
# weights the outputs are ~1e-3, so float32 is ~1e-9 off, and weights 0.1% off
# uniform (scores ~1.3e-3) move them by ~1e-5: both controls must land outside
ATTN_OUT_ATOL = 1e-7
ATTN_MARGIN = 1e-4
# the fold's backward kernels: the forward's grid plus a ties case (every
# key duplicated, the carried m equal to the block max on every third row)
FLASH_BWD_TIES_CASE = ((False, "inside", "ties", "aligned"),)
FLASH_BWD_NAMES = ("dq", "dk", "dv", "dm", "dl", "dacc")
# of |plain| + the tensor's largest magnitude: a first chip run of the two
# kernels over this grid's shapes read at most 2.4e-6 (products and row sums
# in another order), so 2e-5 holds them with a margin of 8; PERF.md gives
# the 3xTF32 kernels' readings against it
FLASH_BWD_RTOL = 2e-5
# the max-key census: a mid shape off the 1/8 grid (BH, Tq, Tk, D), and the
# float64 top-two score gap past which both kernels must pick float64's max
FLASH_BWD_CENSUS = (4, 1000, 2048, 128)
FLASH_BWD_CENSUS_GAP = 1e-4
# SelfAttentionClassifier.fit at bench.py's attention training width
# (_attention_train_step_ms: E 512, H 4, vocab 1024, 8 classes, lr 1e-3; T
# 8192 as bench_attention_train's fit_T8192_single_chip): 15 documents, two a
# step, so step 8 is the clamped tail (one re-read document weighted 0)
FIT_ATTN_T, FIT_ATTN_DOCS, FIT_ATTN_BATCH, FIT_ATTN_ITERS, FIT_ATTN_LR = 8192, 15, 2, 8, 1e-3
FIT_ATTN_TOKEN_SEED, FIT_ATTN_SIGNAL, FIT_ATTN_HELD = 11, 0.05, 8
FIT_ATTN_STEP_ITERS = (8, 24)  # the two iteration counts differenced for ms/step
# step-1 gradients vs float64, of each gradient's largest magnitude: float32
# through the kernels reads ~6e-6, a bf16-q/k/v control ~3e-3
FIT_ATTN_GRAD_RTOL = 1e-4
# every step's loss vs the float64 fit's, relative: float32 reads ~2e-7 (the
# loss's own float32 rounding; lr 1e-3 does not blow up), the bf16 fit ~5e-6
FIT_ATTN_LOSS_RTOL = 1e-6
FIT_ATTN_PROB_ATOL = 1e-7  # the fitted model's probabilities vs float64: serve_attention's bound
# text: hashingtf-benchmark.json's RandomStringArrayGenerator (seed 2,
# 100,000 rows of arraySize 10 over numDistinctValues 10, the default), each
# row's strings joined by spaces for the Tokenizer; HashingTF at numFeatures
# 2^18 (the default); LogisticRegression at globalBatchSize 8192, 13
# windows, so the 'auto' gate takes the one-hot path
TEXT_SEED, TEXT_ROWS, TEXT_ARRAY, TEXT_DISTINCT = 2, 100_000, 10, 10
TEXT_DIM, TEXT_BATCH, TEXT_ITERS, TEXT_LR = 1 << 18, 8192, 20, 0.5
TEXT_LABEL_SEED = 21  # the seeded weights of the label rule over the tokens
TEXT_SERVE_SEED = 22  # new documents from the same generator
TEXT_STEP_ITERS = (20, 60)  # the two iteration counts differenced for ms/step
TEXT_PROB_ATOL = 1e-5  # served probabilities vs float64 numpy
# featurize: countvectorizer-benchmark.json (seed 2, 20,000 rows of
# arraySize 100 over numDistinctValues 100; 100 raw entries a row, so the
# leg raises sparse.nnz.cap.max to 128) and featurehasher-benchmark.json (5
# DoubleGenerator columns at arity 0, f0–f2 categorical, numFeatures 1000,
# seed 2, 100,000 rows)
CV_SEED, CV_ROWS, CV_ARRAY, CV_DISTINCT, CV_CAP_MAX = 2, 20_000, 100, 100, 128
FH_SEED, FH_ROWS, FH_DIM = 2, 100_000, 1000
FH_COLS, FH_CATEGORICAL = ("f0", "f1", "f2", "f3", "f4"), ("f0", "f1", "f2")
# sharded: worlds of 1 (NCCL), 2 and 4 ranks (gloo: the ranks share the one
# card) on train.mesh; logisticregression-benchmark.json (100,000 × 100,
# LabeledPointWithWeightGenerator at seed 2, globalBatchSize 100,000, maxIter
# 20, learningRate 0.1, tol 1e-6), kmeans-benchmark.json (fit_kmeans' rows),
# the headline wide-sparse fit (train's), mlpclassifier-benchmark.json at width
# 2 (serve_mlp's rows, standardised on the host) and a checkpointed dense SGD
# fit at width 2 restored at width 4
SHARDED_WIDTHS = (1, 2, 4)
SHARDED_MLP_WIDTH, SHARDED_CKPT_WIDTH, SHARDED_RESTORE_WIDTH = 2, 2, 4
LR_ROWS, LR_D, LR_BATCH, LR_ITERS, LR_LR, LR_TOL, LR_SEED = 100_000, 100, 100_000, 20, 0.1, 1e-6, 2
SHARDED_EPOCH_ITERS = (20, 40)  # the two iteration counts differenced for ms/epoch
SHARDED_CKPT_BATCH, SHARDED_CKPT_ITERS, SHARDED_CKPT_KILL = 8192, 20, 10
SHARDED_GATHER_REPS = 20
SHARDED_COEF_TOL = 1e-5  # dense and sparse fits against float64 of their schedule
# model_parallel: gloo worlds of 4 (train.mesh 2 × train.mesh.model 2) and 2
# (1 × 2) ranks sharing the card; the headline sparse fit (train's), dense LR
# at logisticregression-benchmark.json's config and the scatter path at 1 ×
# 2, a checkpointed dense fit at 2 × 2 restored at 1 × 2; the classifier at
# fit_attention's configuration with its sequence split over the world; MoE
# at T 8192 tokens, d 512, h 2048, 8 experts, capacity 1.25 T / E and one
# that drops tokens
MP_WORLDS, MP_MODEL = (4, 2), 2
MP_INV_RTOL, MP_INV_ATOL = 2e-3, 1e-4  # n_model 2 vs 1: JAX's invariance bound (test_onehot_sparse.py:543)
MP_ATTN_STEP_ITERS = (8, 16)  # the two iteration counts differenced for ms/step
MOE_T, MOE_D, MOE_H, MOE_E, MOE_SEED = 8192, 512, 2048, 8, 14
MOE_CAPACITY_FACTOR, MOE_SMALL_CAPACITY = 1.25, 64
MOE_ATOL = 1e-5  # outputs vs the dense computation of the same routing
# streamed: the headline model (train's: d 2^22, 39 hashed features, batch
# 65,536, lr 0.5, 20 iterations) on 2^20 rows from TRAIN_SEED in a host-tier
# cache of 65,536-row chunks under a 64 MiB budget (most chunks spill),
# 262,144-row windows (4 windows, 5 window loads over 20 epochs); Criteo's
# billions of rows cut to 2^20 for the run's time. kmeans-benchmark.json in
# 16,384-row chunks from a spilled cache; mlpclassifier-benchmark.json in
# 16,384-row windows; a gloo world of 2 at 2^18 rows
STREAM_ROWS, STREAM_CHUNK_ROWS, STREAM_BUDGET = 1 << 20, 65_536, 64 << 20
STREAM_WINDOW_ROWS, STREAM_CKPT_INTERVAL = 262_144, 4
STREAM_KMEANS_CHUNK, STREAM_KMEANS_BUDGET, STREAM_MLP_WINDOW = 16_384, 8 << 20, 16_384
STREAM_WORLD, STREAM_WORLD_ROWS, STREAM_WORLD_WINDOW = 2, 1 << 18, 65_536
STREAM_ROWS_REPS = 3

# Phase 35 (sharded_serving): the three served models at serving.mesh 1, 2, 4
# in both tiers (the shards share the one card), the MLP at serving.mesh 2 ×
# serving.mesh.model 2, and the KMeans pipeline in the batch tier at 100,000,
# 100,008 and 100,003 rows: 65,536-row chunks leave tails of 34,464 (shards
# with no pad rows), 34,472 (8 pad rows at batch.mesh 2, 24 at 4) and 34,467
# (replicated).
SHARDED_SERVING_SEED = 35
SHARDED_SERVING_MESHES = (1, 2, 4)
SHARDED_TP_MESH = (2, 2)
SHARDED_BATCH_ROWS = (KMEANS_ROWS, KMEANS_ROWS + 8, KMEANS_ROWS + 3)
SHARDED_SWAP_POST = 4  # requests each client sends after the last flip, each to be served by v3

# Phase 36 (online): OnlineLogisticRegression over an unbounded stream at
# bench.py's continuous-loop shape (bench_continuous_loop: d 256, 4096-row
# global batches, alpha 0.5, beta 0.1), one FTRL step a batch, 64 versions a
# leg: A at reg 0, B at reg 0.01 / elasticNet 0.5 (the last three quarters of
# the features scaled by 1e-2, so L1 zeroes them). Leg A again under traffic,
# every 8th version published to a served directory; a checkpointed run at
# interval 4 killed after 20 versions and resumed. OnlineKMeans at
# kmeans-benchmark.json's width (d 100, k 10, uniform rows), 4096-row
# batches, decayFactor 0.5, 32 versions; OnlineStandardScaler at d 100,
# EventTimeTumblingWindows(1000), 16 windows of 4096 rows, gated at
# maxAllowedModelDelayMs 0 and 500.
ONLINE_D, ONLINE_BATCH, ONLINE_VERSIONS, ONLINE_SEED = 256, 4096, 64, 36
ONLINE_ALPHA, ONLINE_BETA = 0.5, 0.1
ONLINE_LEGS = (("A", 0.0, 0.0), ("B", 0.01, 0.5))  # (leg, reg, elasticNet)
ONLINE_PROFILE_VERSIONS = 16  # versions traced for the idle share (after as many warm ones)
ONLINE_PUBLISH_EVERY = 8
ONLINE_CKPT_INTERVAL, ONLINE_KILL_AT = 4, 20
ONLINE_CONTROL_VERSIONS = 16  # versions of the bf16-feature control
ONLINE_COEF_RTOL, ONLINE_COEF_ATOL = 1e-5, 1e-6  # every version's coefficient against float64 FTRL
ONLINE_L1_MARGIN = 1e-4  # leg B's float64 least | |z| - l1 |: no threshold flip hides in the tolerance
ONLINE_REQUESTS = 64  # request payloads the clients cycle through, 1-4096 rows
ONLINE_KMEANS_VERSIONS, ONLINE_KMEANS_DECAY = 32, 0.5
ONLINE_SCALER_D, ONLINE_SCALER_WINDOWS, ONLINE_SCALER_WINDOW_MS = 100, 16, 1000
ONLINE_SCALER_DELAYS = (0, 500)
ONLINE_SCALER_ATOL = 1e-5  # served scaled values against float64 of the version that served them



def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_build(kernels):
    from flink_ml_tpu_torch.native import build

    t0 = time.perf_counter()
    sources = sorted({k.source for k in kernels})
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        results = dict(zip(sources, pool.map(build, sources)))
    for source, res in results.items():
        emit(
            "build",
            kernels=[k.name for k in kernels if k.source == source],
            source=source,
            seconds=res.seconds,
            cached=res.cached,
            # each kernel's (mangled) name, then its registers, shared memory, stack and spills
            ptxas=[ln.strip() for ln in res.log.splitlines()
                   if ("ptxas info" in ln and ("Used" in ln or "Compiling entry function" in ln)) or "spill" in ln],
        )
    emit("build", total_seconds=time.perf_counter() - t0)


def _cold_times(fn, iters: int, flush, hold_cycles: int = 0) -> list:
    """Per-call device milliseconds of ``fn`` with L2 cold: each call runs
    after zeroing ``flush`` (larger than L2), between its own CUDA events.
    The flush keeps the device busy while the host enqueues the call, so
    host launch overhead does not enter the time — for a wrapper whose host
    work outlasts the flush, ``hold_cycles`` of ``torch.cuda._sleep`` after
    it hold the device longer (the sleep touches no memory)."""
    import torch

    pairs = []
    for _ in range(iters):
        flush.zero_()
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def _warm_time(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn`` back to back (inputs in
    L2): a sleep kernel holds the device while the host enqueues all calls."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of device time at H100 clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _logistic_plan(d, path):
    """(lanes, slots, held, depth) of the scale → logistic kernel's launch at
    width d on ``path`` ("16-byte" or "scalar"), as its dispatch and
    depth_for pick them (csrc/megakernel_scale_logistic.cu): lanes a row, the
    next power of two at or above the row's groups (d / 4 or d), at most 32;
    slots, a lane's groups (a chunk's past the registers); held, the model in
    the lane's registers; depth, R's ceiling."""
    vec = 4 if path == "16-byte" else 1
    groups = d // vec
    lanes = min(32, 1 << (groups - 1).bit_length())
    slots = 1 << (-(-groups // lanes) - 1).bit_length()
    held = slots * vec <= LOGISTIC_MODEL_FLOATS
    if not held:
        slots = LOGISTIC_MODEL_FLOATS // vec
    depth = min(lanes, LOGISTIC_ROW_FLOATS // (slots * vec)) if held else 1
    return lanes, slots, held, depth


def _logistic_instances():
    """{(path, lanes, slots, held): the widest d ≤ max(CHECK_WIDTHS) that
    launches that instance of the kernel}; a d % 4 == 0 takes the scalar
    path when x starts one float into its buffer."""
    widest = {}
    for d in range(1, max(CHECK_WIDTHS) + 1):
        for path in ("16-byte", "scalar") if d % 4 == 0 else ("scalar",):
            widest[(path, *_logistic_plan(d, path)[:3])] = d
    return widest


def _logistic_check_widths():
    """CHECK_WIDTHS and the widest d of every instance of the dispatch."""
    return tuple(sorted(set(CHECK_WIDTHS) | set(_logistic_instances().values())))


def _logistic_past_one_pass(d, offset=0):
    """Rows past one pass of the scale → logistic kernel's persistent grid at
    width d, x ``offset`` floats into its buffer (the other tensors fresh):
    SMS_WARPS warps at most, each taking 32 / L rows side by side and R of
    each at most (_logistic_plan)."""
    lanes, _, _, depth = _logistic_plan(d, "16-byte" if d % 4 == 0 and not offset else "scalar")
    return SMS_WARPS * (32 // lanes) * depth + 1


def _logistic_inputs(rng, rows, d, dev, offset=0):
    """x [rows, d] (a contiguous view ``offset`` floats into its buffer),
    mean, inv_std (feature 0's std 0: it scales to 0) and coef."""
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    x = rng.normal(size=rows * d + offset)
    mean = rng.normal(size=d)
    std = np.abs(rng.normal(size=d)) + 0.5
    std[0] = 0.0
    std32 = std.astype(np.float32)
    inv_std = np.where(std32 == 0.0, 0.0, 1.0 / np.where(std32 == 0.0, 1.0, std32))
    coef = rng.normal(size=d) * (3.0 / np.sqrt(d))
    return t(x)[offset:].view(rows, d), t(mean), t(inv_std), t(coef)


def _logistic_bound(rows, d, with_mean, with_std, write_scaled):
    """(bytes, operations, bound ms, bound_by) of one call: x read, scaled
    written when kept, the heads (prediction, raw) written, each model vector
    in use read once; sub and mul where flagged and an FMA (2) an element,
    the compare and sigmoid (8) a row."""
    vectors = 1 + int(with_mean) + int(with_std)
    bytes_moved = 4 * (rows * d * (1 + int(write_scaled)) + 3 * rows + vectors * d)
    ops = rows * d * (2 + int(with_mean) + int(with_std)) + 8 * rows
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return bytes_moved, ops, max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _logistic_compiled():
    """What the compiler made of the scale → logistic kernel's source (the
    importing tree's): for each instance, its registers and spill bytes
    (ptxas -v) and, from its SASS (cuobjdump), its global loads (LDG; those
    of 16 bytes), its FFMAs and the loads issued before its first FFMA."""
    import re

    from flink_ml_tpu_torch.servable.megakernels import SCALE_LOGISTIC

    res, sass = _built_sass(SCALE_LOGISTIC)

    def instance(mangled):
        args = re.search(r"scale_logistic_kernelI(.*?)EEv", mangled)
        if not args:
            return "scale_logistic_kernel"
        vec, lanes, slots, held = re.findall(r"L[ib](\d+)E", args.group(1) + "E")
        return f"vec{vec}_lanes{lanes}_slots{slots}_{'held' if held == '1' else 'wide'}"

    out, current = {}, None
    for line in res.log.splitlines():
        hit = re.search(r"Compiling entry function '([^']*)'", line)
        if hit:
            current = out.setdefault(instance(hit.group(1)), {})
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if current is not None and spill:
            current["spill_store_bytes"], current["spill_load_bytes"] = int(spill.group(1)), int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if current is not None and regs:
            current["registers"] = int(regs.group(1))
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        entry = out.setdefault(instance(block.split("\n", 1)[0]), {})
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", block)
        first_ffma = next((n for n, op in enumerate(ops) if op.startswith("FFMA")), len(ops))
        entry["ldg"] = sum(op.startswith("LDG") for op in ops)
        entry["ldg_128"] = sum(op.startswith("LDG") and ".128" in op for op in ops)
        entry["ffma"] = sum(op.startswith("FFMA") for op in ops)
        entry["ldg_before_first_ffma"] = sum(op.startswith("LDG") for op in ops[:first_ffma])
    return {"source": SCALE_LOGISTIC.source_path, "by_instance": out}


def _time_logistic(rng):
    """Cold and warm CUDA-event times of the scale → logistic kernel at each
    LOGISTIC_TIMED shape, in turns (each shape, then each again in reverse
    order), with the plain version and ``torch.mv(x, coef)`` at 4096 × 100
    around them. Uses only the wrapper both the kernel's designs take, so it
    times another tree's package as well."""
    import torch

    from flink_ml_tpu_torch.servable import megakernels as mk

    dev = torch.device("cuda", 0)
    path = getattr(mk, "scale_logistic_path", None)  # a tree before the 16-byte path has one path
    cases = []
    for rows, d, with_mean, with_std, write_scaled in LOGISTIC_TIMED:
        x, mean, inv_std, coef = _logistic_inputs(rng, rows, d, dev)
        kw = dict(with_mean=with_mean, with_std=with_std, write_scaled=write_scaled)
        cases.append(((rows, d, with_mean, with_std, write_scaled), x, mean, inv_std, coef, kw))
    _, x, mean, inv_std, coef, _ = next(c for c in cases if c[0] == (*TIMED_SHAPE, True, True, True))
    x_lr, coef_lr = next((c[1], c[4]) for c in cases if c[0] == (*TIMED_SHAPE, False, False, False))
    fns = {"plain": lambda: mk.scale_logistic_plain(x, mean, inv_std, coef, with_mean=True, with_std=True),
           "library": lambda: torch.mv(x_lr, coef_lr)}
    for key, xc, m, s, c, ckw in cases:
        fns[key] = (lambda xc=xc, m=m, s=s, c=c, ckw=ckw: mk.scale_logistic(xc, m, s, c, **ckw))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    for fn in fns.values():  # warm-up
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    keys = [c[0] for c in cases]
    order = ["plain", "library", *keys, *keys[::-1], "library", "plain"]
    times = {k: {"cold": [], "warm": []} for k in fns}
    for k in order:  # a 0.5 ms sleep before each cold call holds the device past the wrapper's host work
        times[k]["cold"] += _cold_times(fns[k], 100, flush, hold_cycles=1_000_000)
        times[k]["warm"].append(_warm_time(fns[k], 200))
    shapes = []
    for key, xc, m, s, c, ckw in cases:
        rows, d, with_mean, with_std, write_scaled = key
        bytes_moved, ops, bound_ms, bound_by = _logistic_bound(*key)
        shapes.append({
            "rows": rows, "d": d, "with_mean": with_mean, "with_std": with_std, "write_scaled": write_scaled,
            "path": path(xc, m if with_mean else None, s if with_std else None, c) if path else "scalar",
            "ms": _median(times[key]["cold"]), "ms_l2_warm": _median(times[key]["warm"]),
            "warm_runs": times[key]["warm"], "bytes": bytes_moved, "ops": ops, "bound_ms": bound_ms,
            "bound_by": bound_by,
        })
    return {
        "shapes": shapes,
        "plain_ms": _median(times["plain"]["cold"]),
        "plain_ms_l2_warm": _median(times["plain"]["warm"]),
        "library_margin_ms": _median(times["library"]["cold"]),
        "library_margin_ms_l2_warm": _median(times["library"]["warm"]),
        "library_margin": "torch.mv(x, coef) at 4096 × 100: the margin only (hold it against LR alone)",
    }


def phase_kernels(rng, card: str):
    import numpy as np
    import torch

    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
    from flink_ml_tpu_torch.servable.megakernels import (
        SCALE_LOGISTIC,
        scale_logistic,
        scale_logistic_path,
        scale_logistic_plain,
    )

    dev = torch.device("cuda", 0)
    envelope = ULP_ENVELOPE["scale_logistic"]
    emit("kernels", kernel=SCALE_LOGISTIC.name, compiled=_logistic_compiled())

    max_abs_err = 0.0
    max_ulps = 0
    past_raw_ulps = 0  # both columns' ulps past one pass: read, not held
    checked = 0
    paths = {"16-byte": [], "scalar": []}  # the (rows, d, offset) shapes each path took
    instances = _logistic_instances()
    launched = set()  # the dispatch's instances this grid launched
    widths = _logistic_check_widths()
    shapes = [(rows, d, 0) for d in widths for rows in (*CHECK_ROWS, _logistic_past_one_pass(d))]
    shapes += [(203, d, 1) for d in widths if d % 4 == 0]  # x one float into its buffer
    for rows, d, offset in shapes:
        x, mean, inv_std, coef = _logistic_inputs(rng, rows, d, dev, offset)
        for label, with_mean, with_std, write_scaled in CHAINS:
            path = scale_logistic_path(x, mean if with_mean else None, inv_std if with_std else None, coef)
            if offset and path != "scalar":
                raise AssertionError(f"x {offset} float(s) into its buffer took the {path} path")
            if [rows, d, offset] not in paths[path]:
                paths[path].append([rows, d, offset])
            launched.add((path, *_logistic_plan(d, path)[:3]))
            scaled, pred, raw = scale_logistic(
                x, mean, inv_std, coef,
                with_mean=with_mean, with_std=with_std, write_scaled=write_scaled,
            )
            p_scaled, p_pred, p_raw = scale_logistic_plain(
                x, mean, inv_std, coef, with_mean=with_mean, with_std=with_std
            )
            torch.cuda.synchronize()
            where = (f"{label} rows={rows} d={d} offset={offset} with_mean={with_mean} "
                     f"with_std={with_std} path={path}")
            if write_scaled:
                if not torch.equal(scaled, p_scaled):
                    raise AssertionError(f"scaled not bit-equal to the plain version: {where}")
            else:
                assert scaled is None, where
            if rows in CHECK_ROWS:
                ulps = ulp_diff(raw.cpu().numpy(), p_raw.cpu().numpy())
            else:  # past one pass: the table's rule (_check_rowlocal), 1 - p ill-conditioned where p rounds near 1
                ulps = ulp_diff(raw[:, 1].cpu().numpy(), p_raw[:, 1].cpu().numpy())
                if not (_same_bits(raw[:, 0], 1.0 - raw[:, 1]) and _same_bits(p_raw[:, 0], 1.0 - p_raw[:, 1])):
                    raise AssertionError(f"rawPrediction[:, 0] is not 1 - rawPrediction[:, 1]: {where}")
                past_raw_ulps = max(past_raw_ulps, ulp_diff(raw.cpu().numpy(), p_raw.cpu().numpy()))
            if ulps > envelope:
                raise AssertionError(f"rawPrediction {ulps} ulps > {envelope}: {where}")
            margin = (p_scaled @ coef).cpu().numpy()
            decided = np.abs(margin) > PREDICTION_MARGIN
            if not np.array_equal(pred.cpu().numpy()[decided], p_pred.cpu().numpy()[decided]):
                raise AssertionError(f"prediction differs where |margin| > {PREDICTION_MARGIN}: {where}")
            errs = [(raw - p_raw).abs().max(), (pred - p_pred).abs().max()]
            if write_scaled:
                errs.append((scaled - p_scaled).abs().max())
            max_abs_err = max(max_abs_err, max(float(e) for e in errs))
            max_ulps = max(max_ulps, ulps)
            checked += 1
        del x, mean, inv_std, coef, scaled, pred, raw, p_scaled, p_pred, p_raw
    if launched != set(instances):
        raise AssertionError(f"instances of the dispatch not checked: {sorted(set(instances) - launched)}")
    emit("kernels", kernel=SCALE_LOGISTIC.name, configurations=checked, widths=list(widths),
         instances=[f"{path} lanes {lanes} slots {slots}{' held' if held else ' wide'}: d {d}"
                    for (path, lanes, slots, held), d in sorted(instances.items(), key=lambda kv: kv[1])],
         max_abs_err=max_abs_err, max_raw_ulps=max_ulps, raw_ulp_envelope=envelope,
         raw=(f"within the envelope at rows {list(CHECK_ROWS)}; past one pass p = raw[:, 1] within it and "
              "raw[:, 0] = 1 - p in float32 on both sides"),
         past_one_pass_raw_ulps=past_raw_ulps,
         scaled="bit-equal", prediction=f"equal where |margin| > {PREDICTION_MARGIN}",
         paths={"16-byte": paths["16-byte"], "scalar": paths["scalar"], "shape": "[rows, d, x's offset in floats]"})

    times = _time_logistic(rng)
    emit("kernels", kernel=SCALE_LOGISTIC.name, card=card, **times)
    head = next(t for t in times["shapes"]
                if (t["rows"], t["d"], t["with_mean"], t["with_std"]) == (*TIMED_SHAPE, True, True))
    timing = {
        "shape": list(TIMED_SHAPE),
        "ms": head["ms"],
        "ms_l2_warm": head["ms_l2_warm"],
        "plain_ms": times["plain_ms"],
        "plain_ms_l2_warm": times["plain_ms_l2_warm"],
        "bytes": head["bytes"],
        "ops": head["ops"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the fused chain (torch.mv: the margin only)
    }
    emit("kernels", kernel=SCALE_LOGISTIC.name, card=card, **timing)
    return {"max_abs_err": max_abs_err, **timing}


def _median(v):
    v = sorted(v)
    return v[len(v) // 2]


def _count_calls(module, names):
    """Wrap ``module``'s functions ``names`` so a run can show none was
    called; returns the call list and a function that restores them."""
    saved = {n: getattr(module, n) for n in names}
    calls = []

    def wrap(name, fn):
        def counted(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return counted

    for n in names:
        setattr(module, n, wrap(n, saved[n]))

    def restore():
        for n, fn in saved.items():
            setattr(module, n, fn)

    return calls, restore


def _count_plain_calls():
    """The crossings' plain versions, counted (``_count_calls``)."""
    import flink_ml_tpu_torch.linalg.onehot_sparse as oh

    return _count_calls(oh, ("dot_crossing_plain", "mult_crossing_plain",
                             "dot_crossing_premat_plain", "mult_crossing_premat_plain"))


def _check_crossings(q, rowid, m3, row_hi, order, oh, where):
    """Each crossing kernel against its plain version on one input set;
    returns {kernel name: max |kernel - plain|}."""
    import torch

    from flink_ml_tpu_torch.linalg import onehot_sparse as O

    n_sub, n = q.shape
    dot_b = O.dot_crossing(q, rowid, row_hi, order)
    dot_p = O.dot_crossing_premat(q, *oh)
    dot_plain = O.dot_crossing_plain(q, rowid, row_hi)
    mult_b = O.mult_crossing(m3, rowid)
    mult_p = O.mult_crossing_premat(m3, *oh)
    mult_plain = O.mult_crossing_plain(m3, rowid)
    mult_p_plain = O.mult_crossing_premat_plain(m3, *oh)
    torch.cuda.synchronize()
    rows = row_hi * 128
    rid = rowid.long()  # rows may be 32,768, past int16
    flat = (torch.arange(n_sub, device=q.device)[:, None] * rows + rid).reshape(-1)
    live = (rid >= 0) & (rid < rows)
    absum = torch.zeros(n_sub * rows, dtype=torch.float64, device=q.device).index_add_(
        0, flat[live.reshape(-1)], q.abs().double().reshape(-1)[live.reshape(-1)])
    tol = DOT_RTOL * absum.reshape(n_sub, row_hi, 128) + 1e-6
    err = (dot_b.double() - dot_plain.double()).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"dot crossing off its plain version by {float(err.max())}: {where}")
    if not torch.equal(dot_b, dot_p):
        raise AssertionError(f"build-form dot not bit-equal to premat dot: {where}")
    if not torch.equal(mult_b, mult_plain):
        raise AssertionError(f"mult crossing not bit-equal to its plain version: {where}")
    if not torch.equal(mult_p, mult_p_plain) or not torch.equal(mult_p[:, :n], mult_b):
        raise AssertionError(f"premat mult crossing not bit-equal: {where}")
    return {
        O.DOT_CROSSING.name: float(err.max()),
        O.MULT_CROSSING.name: float((mult_b - mult_plain).abs().max()),
        O.DOT_CROSSING_PREMAT.name: float(err.max()),  # dot_p == dot_b, bit for bit
        O.MULT_CROSSING_PREMAT.name: float((mult_p - mult_p_plain).abs().max()),
    }


def phase_crossings_grid(rng, card: str):
    """The four crossings against their plain versions over CROSS_GRID."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.linalg import onehot_sparse as O

    dev = torch.device("cuda", 0)
    errs = {}

    def off_word(t, words):  # t's values ``words`` elements past a 16-byte boundary
        buf = torch.zeros(t.numel() + 8, dtype=t.dtype, device=dev)
        view = buf[words:words + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    for n_sub, row_hi, n, case in [c + ("uniform",) for c in CROSS_GRID] + CROSS_EDGES:
        rows = row_hi * 128
        ids = rng.integers(0, rows, (n_sub, n)).astype(np.int16)
        qn = rng.normal(size=(n_sub, n)).astype(np.float32)
        if case == "one_row":
            ids[:] = 37 % rows
        elif case == "dead":
            pick = rng.random((n_sub, n))
            qn[pick < 0.1] = 0.0
            ids[(pick >= 0.1) & (pick < 0.15)] = -1
            ids[(pick >= 0.15) & (pick < 0.18)] = -32768
            if rows < 32768:
                ids[(pick >= 0.18) & (pick < 0.22)] = rng.integers(rows, 32768)
        rowid, q = torch.from_numpy(ids).to(dev), torch.from_numpy(qn).to(dev)
        m3 = torch.from_numpy(rng.normal(size=(n_sub, row_hi, 128)).astype(np.float32)).to(dev)
        where = f"n_sub={n_sub} row_hi={row_hi} n={n} {case}"
        row_ptr, entry_of = O.row_order(rowid, row_hi)
        if case == "dead":  # the build-form kernels on views off a 16-byte boundary
            entry_of, rowid = off_word(entry_of, 3), off_word(rowid, 5)
        got = _check_crossings(q, rowid, m3, row_hi, (row_ptr, entry_of),
                               O.premat_row_onehots(rowid, row_hi), where)
        for k, v in got.items():
            errs[k] = max(errs.get(k, 0.0), v)
    emit("crossings", card=card, configurations=len(CROSS_GRID) + len(CROSS_EDGES), edges=CROSS_EDGES,
         max_abs_err=errs, mult="bit-equal", dot=f"within {DOT_RTOL} * sum_row |q| + 1e-6",
         build_vs_premat_dot="bit-equal")
    return errs


def _hashed_rows(rng, rows, nnz):
    """``rows`` rows of ``nnz`` distinct hashed features in [0, TRAIN_DIM),
    sorted: the headline generator."""
    import numpy as np

    idx = np.sort(rng.integers(0, TRAIN_DIM, size=(rows, nnz)), axis=1)
    while True:  # redraw the rows where two hashes collide
        dup = np.flatnonzero((np.diff(idx, axis=1) == 0).any(axis=1))
        if not dup.size:
            return idx
        idx[dup] = np.sort(rng.integers(0, TRAIN_DIM, size=(dup.size, nnz)), axis=1)


def _headline_data(rows=TRAIN_ROWS):
    """The headline dataset from TRAIN_SEED: 39 distinct hashed features per
    row, value 1.0, labels from a sparse random separator (bench.py);
    ``rows`` rows of it."""
    import numpy as np

    rng = np.random.default_rng(TRAIN_SEED)
    idx = _hashed_rows(rng, rows, TRAIN_NNZ)
    w_true = (rng.random(TRAIN_DIM) < 0.001) * rng.standard_normal(TRAIN_DIM)
    y = (w_true[idx].sum(axis=1) > 0).astype(np.float64)
    return idx, y


def _sparse_frame(idx_rows, **columns):
    """A DataFrame of SparseVector rows (value 1.0) from rows of ids, with
    any further ``columns``."""
    import numpy as np

    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.linalg.vectors import SparseVector

    ones = np.ones(idx_rows.shape[1])
    return DataFrame.from_dict({
        "features": [SparseVector(TRAIN_DIM, row, ones) for row in idx_rows], **columns,
    })


def _bf16(x):
    """``x`` rounded to bfloat16 (to nearest even), as float64."""
    import numpy as np

    b = np.asarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32).astype(np.float64)


def _reference_sgd(indices, values, y, dim, hi_only=False, hinge=False,
                   batch=TRAIN_BATCH, iters=TRAIN_ITERS, lr=TRAIN_LR, n_data=1):
    """Float64 numpy SGD of SGD's schedule and update (BinaryLogisticLoss,
    or HingeLoss with ``hinge``; no regularization) at ``batch``, ``iters``
    and ``lr``: the coefficient and the loss history. Padding slots (value
    0) add nothing. On ``n_data`` ranks (the psum paths) each epoch's batch
    is every rank's ``ceil(batch / n_data)`` rows of its contiguous share,
    the share's padding past the last row weighted 0. With
    ``hi_only`` the crossings keep only their bf16 hi half (each entry's
    term of the margin and each row's multiplier rounded to bf16): the
    control that shows the coefficient check can tell a crossing that drops
    its lo half from the split-bf16 one."""
    import numpy as np

    from flink_ml_tpu_torch.ops.schedule import offset_schedule

    def cross(x):
        return _bf16(x) if hi_only else x

    n = y.shape[0]
    m = -(-n // n_data)
    batch = min(-(-batch // n_data), m)
    coef = np.zeros(dim)
    losses = []
    idx = indices.astype(np.int64)
    val = values.astype(np.float64)
    for start, offset in zip(*offset_schedule(m, batch, iters)):
        local = start + np.arange(batch)
        rows = np.concatenate([k * m + local for k in range(n_data)])
        real = rows < n
        rows = np.minimum(rows, n - 1) if n_data > 1 else slice(start, start + batch)
        ib, vb, yb = idx[rows], val[rows], y[rows].astype(np.float64)
        wb = (np.tile(local, n_data) >= offset).astype(np.float64) * real
        ys = 2.0 * yb - 1.0
        z = cross(vb * coef[ib]).sum(axis=1) * ys
        if hinge:
            loss = (wb * np.maximum(0.0, 1.0 - z)).sum()
            mult = cross(np.where(1.0 - z > 0.0, -ys * wb, 0.0))
        else:
            loss = (wb * np.logaddexp(0.0, -z)).sum()
            mult = cross(wb * (-ys / (1.0 + np.exp(z))))
        grad = np.bincount(ib.ravel(), weights=(vb * mult[:, None]).ravel(), minlength=dim)
        coef -= lr / wb.sum() * grad
        losses.append(loss / wb.sum())
    return coef, losses


def _profile_steps(run, expect=()):
    """Device time by kernel name over one ``run()`` under torch.profiler:
    the top entries, the device-busy total and the wall time (whose
    difference is the device's idle share while the host drives it).

    In a process that has already held a few profiler sessions, a session
    keeps no device record of the kernels launched in its first
    milliseconds (a full run of this script lost 5, 9, 8 and 15 launches
    in its third to sixth sessions; in fit_attention's step they were the
    embedding, the projections and the fold). So each
    session opens with PROFILE_LEAD_LAUNCHES spin kernels
    (``torch.cuda._sleep``) and a PROFILE_LEAD_S pause before the clock
    starts, and the spin kernels are left out. ``expect``: a substring of
    the name of each kernel ``run`` is known to launch; a trace without a
    device record of one raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm: layout, one-hots and kernels built
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD_LAUNCHES):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_LEAD_S)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    # device-side events only (kernels, copies): an operator's own entry
    # carries its kernels' time again
    events = [(e.key, device_us(e) / 1e3, e.count) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key]
    events = sorted((e for e in events if e[1] > 0), key=lambda e: -e[1])
    missing = [tag for tag in expect if not any(tag in name for name, _, _ in events)]
    if missing:
        raise AssertionError(f"the trace holds no device record of {missing}, which the traced run launched")
    busy_ms = sum(ms for _, ms, _ in events)
    return {
        "iterations": PROFILE_ITERS, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if wall_ms > 0 else None,
        "copy_ms": {kind: sum(ms for name, ms, _ in events if f"Memcpy {kind}" in name)
                    for kind in ("HtoD", "DtoH")},
        "top": [{"name": k[:80], "ms": ms, "calls": n} for k, ms, n in events[:12]],
    }


def phase_train(card: str, headline):
    """LogisticRegression.fit on the headline workload, then SGD.optimize
    with the build-form and premat crossings on one cache."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.iteration import DeviceDataCache
    from flink_ml_tpu_torch.linalg import onehot_sparse as O
    from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegression
    from flink_ml_tpu_torch.models.common import extract_labeled_data
    from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss
    from flink_ml_tpu_torch.ops.optimizer import SGD

    premat_k = (O.DOT_CROSSING_PREMAT, O.MULT_CROSSING_PREMAT)
    build_k = (O.DOT_CROSSING, O.MULT_CROSSING)
    t0 = time.perf_counter()
    idx, y = headline
    df = _sparse_frame(idx, label=y)
    data_s = time.perf_counter() - t0

    # Main path 1: LogisticRegression.fit — the premat crossings.
    est = (LogisticRegression().set_max_iter(TRAIN_ITERS).set_global_batch_size(TRAIN_BATCH)
           .set_learning_rate(TRAIN_LR).set_tol(0.0))
    calls, restore = _count_plain_calls()
    try:
        for k in premat_k + build_k:
            k.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = est.fit(df)
        fit_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in premat_k + build_k}
    finally:
        restore()
    fit_peak = torch.cuda.max_memory_allocated()
    if not est.onehot_premat_active:
        raise AssertionError("the fit did not take the premat one-hot path")
    for k in premat_k:
        if launches[k.name] != TRAIN_ITERS:
            raise AssertionError(f"{k.name} launched {launches[k.name]} times in the fit, not {TRAIN_ITERS}")
    for k in build_k:
        if launches[k.name] != 0:
            raise AssertionError(f"{k.name} launched {launches[k.name]} times in the premat fit")
    if calls:
        raise AssertionError(f"plain crossings were called on the card: {sorted(set(calls))}")
    coef_fit = model.coefficient
    losses = est.loss_history
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss_history does not fall: {losses[0]} -> {losses[-1]}")

    # Main path 2: SGD.optimize, build form ("off") then premat ("on"), one cache.
    cols = extract_labeled_data(df, "features", "label", None, allow_sparse=True)
    dim = cols.pop("dim")
    cache = DeviceDataCache(cols)
    del df

    def sgd(premat, iters=TRAIN_ITERS):
        opt = SGD(max_iter=iters, global_batch_size=TRAIN_BATCH, tol=0.0,
                  learning_rate=TRAIN_LR, onehot_premat=premat)
        return opt, opt.optimize(np.zeros(dim, np.float32), cache, BinaryLogisticLoss.INSTANCE)

    runs = {}
    for premat, ks in (("off", build_k), ("on", premat_k)):
        calls, restore = _count_plain_calls()
        try:
            for k in premat_k + build_k:
                k.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            opt, coef = sgd(premat)
            seconds = time.perf_counter() - t0
            got = {k.name: k.launches for k in premat_k + build_k}
        finally:
            restore()
        if calls:
            raise AssertionError(f"plain crossings were called on the card: {sorted(set(calls))}")
        if opt.onehot_premat_active != (premat == "on"):
            raise AssertionError(f"onehot_premat={premat} ran premat={opt.onehot_premat_active}")
        for k in premat_k + build_k:
            want = TRAIN_ITERS if k in ks else 0
            if got[k.name] != want:
                raise AssertionError(f"{k.name} launched {got[k.name]} times with premat {premat}, not {want}")
        runs[premat] = {"coef": coef, "launches": got, "seconds": seconds,
                        "layout_s": opt.layout_seconds, "peak_bytes": torch.cuda.max_memory_allocated()}
    for name, coef in (("off", runs["off"]["coef"]), ("on", runs["on"]["coef"])):
        if not np.array_equal(coef.view(np.int32), coef_fit.view(np.int32)):
            raise AssertionError(f"SGD premat={name} coefficient is not bit-identical to the fit's")

    ref, ref_losses = _reference_sgd(cols["indices"], cols["values"], cols["labels"], dim)
    control, _ = _reference_sgd(cols["indices"], cols["values"], cols["labels"], dim, hi_only=True)
    scale = float(np.abs(ref).max())
    coef_err = float(np.abs(coef_fit.astype(np.float64) - ref).max())
    control_err = float(np.abs(control - ref).max())
    loss_err = float(np.max(np.abs(np.asarray(losses) - ref_losses) / np.abs(ref_losses)))
    if not coef_err <= COEF_TOL * scale:
        raise AssertionError(f"coefficient off the float64 SGD by {coef_err} (scale {scale})")
    if not control_err > COEF_TOL * scale:
        raise AssertionError(f"the hi-half-only control is within the tolerance ({control_err}, "
                             f"scale {scale}): the coefficient check cannot tell the two apart")
    if not loss_err <= 1e-5:
        raise AssertionError(f"loss history off the float64 SGD by {loss_err} (relative)")

    # Steady-state ms/step of both forms: difference two iteration counts.
    step_ms = {}
    for premat in ("on", "off", "off", "on"):  # ends on "on": the premat memo stays for phase 7
        t = []
        for iters in STEP_ITERS:
            t0 = time.perf_counter()
            sgd(premat, iters)
            t.append(time.perf_counter() - t0)
        step_ms.setdefault(premat, []).append((t[1] - t[0]) / (STEP_ITERS[1] - STEP_ITERS[0]) * 1e3)
    profile = {premat: _profile_steps(lambda: sgd(premat, PROFILE_ITERS)) for premat in ("off", "on")}
    lay = cache._onehot_memo[1]
    result = {
        "rows": TRAIN_ROWS, "dim": TRAIN_DIM, "nnz_per_row": TRAIN_NNZ, "batch": TRAIN_BATCH,
        "iterations": TRAIN_ITERS, "data_s": data_s, "fit_s": fit_s, "fit_peak_bytes": fit_peak,
        "fit_launches": launches, "premat_active": True,
        "layout": {"n_windows": lay.n_windows, "n_sub": lay.n_sub, "sub_batch": lay.sub_batch,
                   "row_hi": lay.row_hi, "n_flat": lay.n_flat,
                   "live_slots_per_unit": float(np.count_nonzero(lay.lvals)) / (lay.n_windows * lay.n_sub),
                   "classes": [[f, w] for f, w, _, _ in lay.class_meta]},
        "layout_build_s": runs["off"]["layout_s"],
        "sgd": {k: {kk: v[kk] for kk in ("launches", "seconds", "peak_bytes")} for k, v in runs.items()},
        "coefficients": "fit == SGD premat on == SGD premat off, bit for bit",
        "coef_max_abs_err_vs_f64": coef_err, "coef_scale": scale,
        "coef_tol": COEF_TOL, "hi_only_control_max_abs_err_vs_f64": control_err,
        "loss_max_rel_err_vs_f64": loss_err, "loss_first": losses[0], "loss_last": losses[-1],
        "ms_per_step": {k: _median(v) for k, v in step_ms.items()},
        "ms_per_step_runs": step_ms,
        "rows_per_s": {k: TRAIN_BATCH / (_median(v) / 1e3) for k, v in step_ms.items()},
        "profile": profile,
    }
    emit("train", card=card, **result)
    return cache, {
        O.DOT_CROSSING.name: runs["off"]["launches"][O.DOT_CROSSING.name],
        O.MULT_CROSSING.name: runs["off"]["launches"][O.MULT_CROSSING.name],
        O.DOT_CROSSING_PREMAT.name: launches[O.DOT_CROSSING_PREMAT.name],
        O.MULT_CROSSING_PREMAT.name: launches[O.MULT_CROSSING_PREMAT.name],
    }


def _crossings_compiled():
    """Registers a thread and spill bytes of the crossings' kernels (ptxas
    -v of their source's build): the build-form dot and mult, the premat dot's
    gather-and-accumulate kernel and the premat mult on 16-byte rows
    (row_hi a multiple of 8, at most 128) and on 2-byte rows. Raises if a
    build-form kernel spills."""
    import re

    from flink_ml_tpu_torch.linalg import onehot_sparse as O
    from flink_ml_tpu_torch.native import build

    log = build(O.DOT_CROSSING_PREMAT.source).log
    names = {"dot_crossing_kernel": "build_dot", "mult_crossing_kernel": "build_mult",
             "dot_premat_partial_kernel": "dot", "mult_premat_kernelILb1E": "mult_16_byte_rows",
             "mult_premat_kernelILb0E": "mult_2_byte_rows"}
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        fn = chunk.split("'", 1)[0]
        for frag, label in names.items():
            if frag in fn:
                regs = re.search(r"Used (\d+) registers", chunk)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
                out[label] = {"registers": int(regs.group(1)) if regs else None,
                              "spill_store_bytes": int(spill.group(1)) if spill else None,
                              "spill_load_bytes": int(spill.group(2)) if spill else None}
    if sorted(out) != sorted(names.values()):
        raise AssertionError(f"ptxas lines of the crossing kernels not found: {sorted(out)}")
    for label in ("build_dot", "build_mult"):
        if out[label]["spill_store_bytes"] or out[label]["spill_load_bytes"]:
            raise AssertionError(f"the {label} kernel spills: {out[label]}")
    return out


def phase_crossings_headline(cache, card: str):
    """The crossings at the headline unit shape (window 0 of the real
    layout): checks, then L2-cold and warm times of kernel, plain version
    and one library call, the bound, the bytes a second each kernel's time
    gives and their share of HBM's 3.35 TB/s; beside the build-form dot its
    q gathered in walk order by one ``torch.take`` (the gathers alone); the
    four kernels' ptxas registers and spills, and each route's facts (the
    build-form dot's tiles, stage and pieces, the mult's groups, the premat
    dot's reads)."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.linalg import onehot_sparse as O

    dev = torch.device("cuda", 0)
    lay, (lidx, rowid, lvals, row_ptr, entry_of) = cache._onehot_memo[1:]
    oh_hi, oh_lo = cache._onehot_premat_memo[1]
    wi = 0
    rng = np.random.default_rng(SEED + 1)
    coef_perm = torch.from_numpy(rng.normal(size=lay.nblk * O.BLOCK).astype(np.float32)).to(dev)
    q = lvals[wi] * O.gather_round(coef_perm, lidx[wi], lay.class_meta)
    m3 = torch.from_numpy(rng.normal(size=(lay.n_sub, lay.row_hi, 128)).astype(np.float32)).to(dev)
    rid, order, prem = rowid[wi], (row_ptr[wi], entry_of[wi]), (oh_hi, oh_lo, wi)
    errs = _check_crossings(q, rid, m3, lay.row_hi, order, prem, "headline unit shape")

    n_sub, n = (int(v) for v in q.shape)
    n_pad, row_hi, rows = int(oh_hi.shape[2]), lay.row_hi, lay.row_hi * 128
    live = int(order[0][:, -1].sum())
    # library calls: one PyTorch call each on the same inputs, operands prepared outside
    flat = (torch.arange(n_sub, device=dev)[:, None] * rows + rid.long()).reshape(-1)
    acc = torch.zeros(n_sub * rows, device=dev)
    q_flat = q.reshape(-1)
    rid_long = rid.long()
    m3_flat = m3.reshape(n_sub, rows)
    hi_t = oh_hi[wi].transpose(1, 2)
    q_hi = q.to(torch.bfloat16).float()
    q_pad = torch.nn.functional.pad(torch.cat([q_hi, (q - q_hi)], 0), (0, n_pad - n))
    lo_q = torch.cat([oh_lo[wi] * q_pad[:n_sub, :, None].to(torch.bfloat16),
                      oh_lo[wi] * q_pad[n_sub:, :, None].to(torch.bfloat16)], dim=2)
    m_hi = m3.to(torch.bfloat16)
    m_cat = torch.cat([m_hi, (m3 - m_hi.float()).to(torch.bfloat16)], dim=2)
    del q_pad
    # the build-form dot's q in its walk order: the gathers alone, one call
    walk = torch.cat([order[1][s, :int(order[0][s, -1])].long() + s * n for s in range(n_sub)])
    cases = {
        O.DOT_CROSSING.name: (
            lambda: O.dot_crossing(q, rid, row_hi, order),
            lambda: O.dot_crossing_plain(q, rid, row_hi),
            lambda: acc.index_add_(0, flat, q_flat),
            4 * live * 2 + 4 * n_sub * (rows + 1) + 4 * n_sub * rows,  # q + entry_of (live), row_ptr, out
            5 * 2 * live,  # split and add per live entry and half (f32)
            F32_OPS_PER_S,
            {"gather": lambda: torch.take(q, walk)},
        ),
        O.MULT_CROSSING.name: (
            lambda: O.mult_crossing(m3, rid),
            lambda: O.mult_crossing_plain(m3, rid),
            lambda: torch.gather(m3_flat, 1, rid_long),
            2 * n_sub * n + 4 * n_sub * n + 4 * n_sub * rows,  # rowid in, u out, mult3
            4 * n_sub * n,
            F32_OPS_PER_S,
            {},
        ),
        O.DOT_CROSSING_PREMAT.name: (
            lambda: O.dot_crossing_premat(q, *prem),
            lambda: O.dot_crossing_premat_plain(q, *prem),
            lambda: torch.bmm(hi_t, lo_q),
            # q at every slot, the one-hot rows of live entries (padding slots
            # carry q = 0 and add nothing), out; as the build-form dot
            4 * n_sub * n + 2 * live * (row_hi + 128) + 4 * n_sub * rows,
            2 * 2 * live * row_hi * 128,  # two halves of the dense contraction, live entries
            BF16_OPS_PER_S,
            {},
        ),
        O.MULT_CROSSING_PREMAT.name: (
            lambda: O.mult_crossing_premat(m3, *prem),
            lambda: O.mult_crossing_premat_plain(m3, *prem),
            lambda: torch.bmm(oh_hi[wi], m_cat),
            # every slot's output is read off its own one-hot rows, padding too
            2 * n_sub * n_pad * (row_hi + 128) + 4 * n_sub * rows + 4 * n_sub * n_pad,
            2 * 2 * n_sub * n_pad * row_hi * 128,
            BF16_OPS_PER_S,
            {},
        ),
    }
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for name, (kernel, plain, library, nbytes, ops, peak, extra) in cases.items():
        reps = 10 if "premat" in name else 50
        fns = {"kernel": kernel, "plain": plain, "library": library, **extra}
        for fn in fns.values():
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        t = {which: {"cold": [], "warm": []} for which in fns}
        turns = list(fns.items())
        for which, fn in turns + turns[::-1]:  # A B C ... C B A
            t[which]["cold"] += _cold_times(fn, reps, flush)
            t[which]["warm"].append(_warm_time(fn, reps))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / peak * 1e3
        out[name] = {
            "max_abs_err": errs[name],
            "ms": _median(t["kernel"]["cold"]),
            "ms_l2_warm": _median(t["kernel"]["warm"]),
            "plain_ms": _median(t["plain"]["cold"]),
            "library_ms": _median(t["library"]["cold"]),
            "library_ms_l2_warm": _median(t["library"]["warm"]),
            "bytes": nbytes,
            "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        for which in extra:
            out[name][f"{which}_ms"] = _median(t[which]["cold"])
            out[name][f"{which}_ms_l2_warm"] = _median(t[which]["warm"])
        # the bytes the bound counts, over the kernel's cold and warm times
        for key, ms in (("", out[name]["ms"]), ("_l2_warm", out[name]["ms_l2_warm"])):
            out[name][f"bytes_per_s{key}"] = nbytes / (ms / 1e3)
            out[name][f"hbm_peak_share{key}"] = nbytes / (ms / 1e3) / HBM_BYTES_PER_S
    # the build-form dot's tiles: a range is walked in pieces of DOT_STAGE
    # entries from the 16-byte word of entry_of that holds its first entry
    b, e = order[0][:, :-1:O.DOT_ROWS].long(), order[0][:, O.DOT_ROWS::O.DOT_ROWS].long()
    mis = (order[1].data_ptr() // 4 + torch.arange(n_sub, device=dev)[:, None] * n) % 4
    first = (b + mis) // 4 * 4 - mis
    pieces = torch.where(e > first, (e - first + O.DOT_STAGE - 1) // O.DOT_STAGE, 0)
    tile_ranges = (e - b).reshape(-1)
    emit("crossings", card=card, shape={"n_sub": n_sub, "n": n, "n_pad": n_pad, "row_hi": row_hi,
                                        "live_entries": live}, timing=out,
         compiled=_crossings_compiled(),
         build_routes={
             "dot": {"rows_a_warp": O.DOT_ROWS, "warps_a_block": O.DOT_WARPS,
                     "blocks": -(-rows // (O.DOT_ROWS * O.DOT_WARPS)) * n_sub,
                     "stage_entries_a_warp": O.DOT_STAGE, "stage_bytes_a_warp": 4 * O.DOT_STAGE,
                     "stage_bytes_a_block": 4 * O.DOT_STAGE * O.DOT_WARPS,
                     "q_in_flight_a_lane": O.DOT_BATCH,
                     "entries_a_tile_mean": float(tile_ranges.double().mean()),
                     "entries_a_tile_max": int(tile_ranges.max()),
                     "tiles": int(tile_ranges.numel()), "pieces": int(pieces.sum()),
                     "tiles_past_one_piece": int((pieces > 1).sum())},
             "mult": {"mult3": "read through L1", "mult3_bytes_a_sub_batch": 4 * rows,
                      "slots_a_thread": O.MULT_GROUP},
         },
         # the premat dot reads the rows of live entries only (q != 0): live
         # (row_hi + 128) * 2 bytes of the n_pad slots' one-hot rows
         premat_dot_route={"route": "live-only gather", "dot_chunk": O.DOT_CHUNK,
                           "row_bytes_read": 2 * live * (row_hi + 128),
                           "row_bytes_all_slots": 2 * n_sub * n_pad * (row_hi + 128)})
    return out


def phase_serve(rng, card: str):
    import numpy as np

    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.servable import (
        LogisticRegressionModelServable,
        PipelineModelServable,
        StandardScalerModelServable,
    )
    from flink_ml_tpu_torch.servable.megakernels import SCALE_LOGISTIC
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    scaler = (
        StandardScalerModelServable()
        .set_input_col("features").set_output_col("scaled").set_with_mean(True)
    )
    scaler.mean = rng.normal(size=D)
    scaler.std = np.abs(rng.normal(size=D)) + 0.5
    lr = LogisticRegressionModelServable().set_features_col("scaled")
    lr.coefficient = rng.normal(size=D) * (3.0 / np.sqrt(D))
    pipeline = PipelineModelServable([scaler, lr])

    mean32 = np.asarray(scaler.mean, np.float32).astype(np.float64)
    inv_std = scaler._inv_std().astype(np.float64)
    coef32 = np.asarray(lr.coefficient, np.float32).astype(np.float64)

    def reference(x):
        x64 = np.asarray(x, np.float32).astype(np.float64)
        scaled = (x64 - mean32) * inv_std
        margin = scaled @ coef32
        p = 1.0 / (1.0 + np.exp(-margin))
        return scaled, margin, np.stack([1.0 - p, p], axis=1)

    sizes = [int(min(MAX_BATCH, max(1, round(2 ** rng.uniform(0, 12)))))
             for _ in range(N_CLIENTS * REQUESTS_PER_CLIENT)]
    sizes[::16] = [4096, 1500, 2048, 1024][: len(sizes[::16])]  # hot buckets on every run
    payloads = [rng.normal(size=(n, D)) for n in sizes]

    config = ServingConfig(
        max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast",
    )
    server = InferenceServer(
        pipeline,
        name="chip-smoke",
        serving_config=config,
        warmup_template=DataFrame.from_dict({"features": payloads[0][:1]}),
        device="cuda",
    )
    scope = server.scope
    with server:
        kinds = chain_kinds(pipeline._fastpath_plan)
        hot = sorted(b for b, k in kinds.items() if "megakernel" in k)
        # The main path's run starts here: counts to 0, then traffic.
        SCALE_LOGISTIC.reset_launches()
        batches_before = len(server.executed_batch_sizes)
        fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
        latencies = [None] * len(sizes)
        failures = []

        def client(c):
            for i in range(c, len(sizes), N_CLIENTS):
                t0 = time.perf_counter()
                try:
                    resp = server.predict(DataFrame.from_dict({"features": payloads[i]}))
                    latencies[i] = (time.perf_counter() - t0) * 1000.0
                    out = resp.dataframe
                    scaled, margin, raw = reference(payloads[i])
                    np.testing.assert_allclose(out["scaled"], scaled, rtol=1e-6, atol=1e-6)
                    np.testing.assert_allclose(out["rawPrediction"], raw, rtol=0, atol=1e-5)
                    decided = np.abs(margin) > PREDICTION_MARGIN
                    np.testing.assert_array_equal(
                        np.asarray(out["prediction"])[decided], (margin >= 0).astype(np.float64)[decided]
                    )
                except BaseException as e:  # noqa: BLE001 — reported below, fails the run
                    failures.append(f"request {i} ({sizes[i]} rows): {type(e).__name__}: {e}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("serve clients did not finish within 600 s")
        launches = SCALE_LOGISTIC.launches
        batches = server.executed_batch_sizes[batches_before:]
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    hot_batches = sum(1 for _, bucket in batches if bucket in hot)
    fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
    compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    if not launches > 0:
        raise AssertionError("the megakernel never launched on the main path")
    if launches != hot_batches:
        raise AssertionError(f"megakernel launches {launches} != batches in hot buckets {hot_batches}")
    if fallback != 0:
        raise AssertionError(f"{fallback} batches fell back to the per-stage path")
    if compiles != 0:
        raise AssertionError(f"{compiles} chains were built after warmup")
    lat = sorted(latencies)
    result = {
        "requests": len(sizes),
        "rows": sum(sizes),
        "batches": len(batches),
        "hot_buckets": hot,
        "hot_batches": hot_batches,
        "megakernel_launches": launches,
        "fallback_batches": fallback,
        "post_warmup_builds": compiles,
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(sizes) / wall,
        "wall_s": wall,
    }
    emit("serve", card=card, **result)
    return launches


def _packed_headline(idx_rows, cap):
    """The headline rows' ids packed at ``cap`` (value 1.0, padding id 0 /
    value 0): ``(values f32, ids i32, live slots)``."""
    import numpy as np

    rows = len(idx_rows)
    ids = np.zeros((rows, cap), np.int32)
    vals = np.zeros((rows, cap), np.float32)
    k = min(cap, idx_rows.shape[1])
    ids[:, :k] = idx_rows[:, :k]
    vals[:, :k] = 1.0
    return vals, ids, rows * k


def phase_kernels_sparse(rng, card: str, headline_idx):
    """The sparse IDF → logistic megakernel against its plain version over
    the check grid, then its times at SPARSE_TIMED (``_time_sparse``) and
    its registers and spills."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
    from flink_ml_tpu_torch.servable.megakernels import (
        SPARSE_IDF_LOGISTIC,
        sparse_idf_logistic,
        sparse_idf_logistic_plain,
    )

    dev = torch.device("cuda", 0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def same_bits(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    checked, max_ulps, max_abs_err = 0, 0, 0.0
    for d in SPARSE_DIMS:
        idf = t(np.abs(rng.normal(size=d)).astype(np.float32) + np.float32(0.1))
        coef = t((rng.normal(size=d) * 0.3).astype(np.float32))
        for rows in SPARSE_ROWS:
            for cap in SPARSE_CAPS:
                nnz = rng.integers(0, cap + 1, rows)  # rows shorter than the cap
                ids = np.sort(rng.integers(0, d, (rows, cap)), axis=1).astype(np.int32)
                vals = rng.normal(size=(rows, cap)).astype(np.float32)
                dead = np.arange(cap)[None, :] >= nnz[:, None]
                ids[dead], vals[dead] = 0, 0.0
                v_t, i_t = t(vals), t(ids)
                for label, with_idf, keep in SPARSE_CHAINS:
                    m_idf = idf if with_idf else None
                    tfidf, margin, pred, raw = sparse_idf_logistic(v_t, i_t, m_idf, coef, write_tfidf=keep)
                    p_tfidf, p_margin, p_pred, p_raw = sparse_idf_logistic_plain(v_t, i_t, m_idf, coef)
                    torch.cuda.synchronize()
                    where = f"{label} rows={rows} cap={cap} d={d}"
                    if keep and not same_bits(tfidf, p_tfidf):
                        raise AssertionError(f"tfidf not bit-equal to the plain version: {where}")
                    if (tfidf is None) == keep:
                        raise AssertionError(f"tfidf kept={tfidf is not None}, asked {keep}: {where}")
                    if not same_bits(margin, p_margin):
                        raise AssertionError(f"margin not bit-equal to the plain version: {where}")
                    if not torch.equal(pred, p_pred):
                        raise AssertionError(f"prediction differs from the plain version: {where}")
                    ulps = ulp_diff(raw.cpu().numpy(), p_raw.cpu().numpy())
                    if ulps > ULP_ENVELOPE["sparse_idf_logistic"]:
                        raise AssertionError(f"rawPrediction {ulps} ulps from the plain version: {where}")
                    max_ulps = max(max_ulps, ulps)
                    max_abs_err = max(max_abs_err, float((raw - p_raw).abs().max()))
                    checked += 1
    emit("kernels_sparse", kernel=SPARSE_IDF_LOGISTIC.name, configurations=checked,
         tfidf="bit-equal", margin="bit-equal", prediction="equal",
         max_raw_ulps=max_ulps, max_abs_err=max_abs_err)

    timing = _time_sparse(headline_idx, rng)
    emit("kernels_sparse", kernel=SPARSE_IDF_LOGISTIC.name, card=card, compiled=_sparse_compiled(), **timing)
    return {"max_abs_err": max_abs_err, **timing}


def _sparse_compiled():
    """The sparse kernel's registers and spills, as ptxas reported them in
    its build (cached: the build phase made it)."""
    from flink_ml_tpu_torch.servable.megakernels import SPARSE_IDF_LOGISTIC

    out = _ptxas(SPARSE_IDF_LOGISTIC)
    del out["source"]
    return out


def _time_sparse(headline_idx, rng):
    """Cold (L2 flushed) and warm CUDA-event times of the sparse kernel —
    IDF → LR with tf-idf kept, and the head alone — beside
    ``F.embedding_bag`` (the head's margin in one call), ``coef[ids]`` (one
    model vector's gather alone) and, at the serving shape, the plain
    version, at each shape of SPARSE_TIMED on the headline rows' ids (value
    1.0, padding id 0) at d = 2^22, with the bytes bound. It uses nothing of
    the package but the sparse kernel's wrappers, whose interface has not
    changed since the kernel was ported, so ``tools/flash_turns.py`` runs it
    against other trees. Returns the serving shape's numbers, and the other
    shapes' under ``smaller_shapes``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from flink_ml_tpu_torch.servable.megakernels import sparse_idf_logistic, sparse_idf_logistic_plain

    dev = torch.device("cuda", 0)
    d = TRAIN_DIM
    idf = torch.from_numpy(np.abs(rng.normal(size=d)).astype(np.float32) + np.float32(0.1)).to(dev)
    coef = torch.from_numpy((rng.normal(size=d) * 0.3).astype(np.float32)).to(dev)
    coef_col = coef[:, None]  # the library call's operands, prepared outside
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = []
    for rows, cap in SPARSE_TIMED:
        vals_np, ids_np, live = _packed_headline(headline_idx[:rows], cap)
        values, ids = (torch.from_numpy(a).to(dev) for a in (vals_np, ids_np))
        ids_long = ids.long()
        fns = {
            "kernel": lambda v=values, i=ids: sparse_idf_logistic(v, i, idf, coef, write_tfidf=True),
            "kernel_head": lambda v=values, i=ids: sparse_idf_logistic(v, i, None, coef, write_tfidf=False),
            "library": lambda v=values, i=ids_long: F.embedding_bag(i, coef_col, per_sample_weights=v,
                                                                    mode="sum"),
            "gather": lambda i=ids_long: coef[i],
        }
        if rows == MAX_BATCH:
            fns["plain"] = lambda v=values, i=ids: sparse_idf_logistic_plain(v, i, idf, coef)
        lib_margin = fns["library"]()[:, 0]
        head_margin = fns["kernel_head"]()[1]
        lib_err = float((lib_margin - head_margin).abs().max())
        for fn in fns.values():
            for _ in range(10):
                fn()
        torch.cuda.synchronize()
        times = {k: {"cold": [], "warm": []} for k in fns}
        for name in list(fns) + list(fns)[::-1]:  # each in turns, twice
            reps = 20 if name == "plain" else 100
            # the sleep keeps the host's launch work (and any pause of the
            # process) out of the time: without it, cold readings taken
            # after the check grid came out up to 6× the others
            times[name]["cold"] += _cold_times(fns[name], reps, flush, hold_cycles=2_000_000)
            times[name]["warm"].append(_warm_time(fns[name], reps))
        # Bytes the chain must move: values and ids read once, tfidf and the
        # three heads written once, and for each gathered model vector (idf,
        # coef) each distinct 32-byte sector that this run's ids touch, once (a
        # repeat hits L2). nnz is not read: the kernel folds all K slots.
        sectors = np.unique(ids_np // 8).size
        nbytes = 4 * rows * cap * 2 + 4 * rows * cap + 4 * rows * 4 + 2 * 32 * sectors
        ops = 3 * rows * cap + 8 * rows  # two multiplies and an add per slot; the head per row
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        t = {
            "shape": {"rows": rows, "cap": cap, "d": d, "live_slots": live, "distinct_sectors": sectors},
            "ms": _median(times["kernel"]["cold"]),
            "ms_l2_warm": _median(times["kernel"]["warm"]),
            "ms_head_only": _median(times["kernel_head"]["cold"]),
            "ms_head_only_l2_warm": _median(times["kernel_head"]["warm"]),
            "library_ms": _median(times["library"]["cold"]),
            "library_ms_l2_warm": _median(times["library"]["warm"]),
            "library_margin_max_abs_err": lib_err,
            "gather_ms": _median(times["gather"]["cold"]),
            "gather_ms_l2_warm": _median(times["gather"]["warm"]),
            "bytes": nbytes,
            "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        if "plain" in fns:
            t.update(plain_ms=_median(times["plain"]["cold"]), plain_ms_l2_warm=_median(times["plain"]["warm"]))
        out.append(t)
    del flush
    return {
        **out[0],
        "library": "F.embedding_bag(ids, coef[:, None], per_sample_weights=values, mode='sum'): "
                   "the head's margin, to hold against ms_head_only; gather: coef[ids], one model "
                   "vector's gather alone",
        "smaller_shapes": out[1:],
    }


def _sparse_batch_breakdown(plan, df, ingest, reps=5):
    """Where one full-bucket batch's time goes on the plan's path (host
    clock, the device synchronised after each step; median of ``reps``):
    packing the SparseVectors, the upload, the chain on the card, and the
    readback with the tf-idf SparseVectors rebuilt."""
    import torch

    from flink_ml_tpu_torch.servable.planner import PlanExecution, run_segment
    from flink_ml_tpu_torch.servable.sparse import resolve_nnz_cap_max

    (segment,) = plan.segments
    steps = {"pack": [], "pack_and_upload": [], "chain": [], "readback": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        segment.gather_sparse(df, "features", cap_max=resolve_nnz_cap_max())
        t1 = time.perf_counter()
        inputs, key = ingest(segment, df, len(df))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        outputs = run_segment(segment, key, inputs)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        PlanExecution(df, segment.pending(outputs)).finalize()
        t4 = time.perf_counter()
        for name, dt in zip(steps, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            steps[name].append(dt * 1e3)
    return {"rows": len(df), "key": list(key), "kinds": list(segment.plan_kinds[key]),
            **{name: _median(v) for name, v in steps.items()}}


def phase_serve_sparse(card: str, headline):
    """The wide-sparse model served on the card: IDF → LogisticRegression
    fitted on the headline rows, saved, loaded, and served."""
    import tempfile

    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.iteration import DeviceDataCache
    from flink_ml_tpu_torch.linalg import onehot_sparse as O
    from flink_ml_tpu_torch.linalg.sparse_batch import ladder_cap
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegression
    from flink_ml_tpu_torch.models.common import extract_labeled_data
    from flink_ml_tpu_torch.models.feature.idf import IDF
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss
    from flink_ml_tpu_torch.ops.optimizer import SGD
    from flink_ml_tpu_torch.servable import PipelineModelServable, load_servable
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    idx, y = headline
    t0 = time.perf_counter()
    df = _sparse_frame(idx, label=y)
    data_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    idf_model = IDF().set_input_col("features").set_output_col("tfidf").fit(df)
    idf_fit_s = time.perf_counter() - t0
    doc_freq = np.bincount(idx.ravel(), minlength=TRAIN_DIM)
    if not np.array_equal(idf_model.doc_freq, doc_freq):
        raise AssertionError("IDF doc_freq differs from the rows' document counts")
    t0 = time.perf_counter()
    tfidf_df = idf_model.transform(df)  # on the card
    idf_transform_s = time.perf_counter() - t0
    idf32 = np.asarray(idf_model.idf, np.float32)
    for i in (0, len(idx) // 2, len(idx) - 1):
        v = tfidf_df.column("tfidf")[i]
        if not (np.array_equal(v.indices, idx[i]) and np.array_equal(v.values, idf32[idx[i]].astype(np.float64))):
            raise AssertionError(f"IDFModel.transform row {i} is not the f32 product")

    premat_k = (O.DOT_CROSSING_PREMAT, O.MULT_CROSSING_PREMAT)

    est = (LogisticRegression().set_features_col("tfidf").set_max_iter(TRAIN_ITERS)
           .set_global_batch_size(TRAIN_BATCH).set_learning_rate(TRAIN_LR).set_tol(0.0))
    for k in premat_k:
        k.reset_launches()
    t0 = time.perf_counter()
    lr_model = est.fit(tfidf_df)
    fit_s = time.perf_counter() - t0
    fit_launches = {k.name: k.launches for k in premat_k}
    if any(n != TRAIN_ITERS for n in fit_launches.values()) or not est.onehot_premat_active:
        raise AssertionError(f"the tf-idf fit did not run the premat crossings each step: {fit_launches}")
    if not est.loss_history[-1] < est.loss_history[0]:
        raise AssertionError(f"tf-idf fit loss does not fall: {est.loss_history[0]} -> {est.loss_history[-1]}")
    # Steady ms/step as in the train phase: SGD on one cache of the tf-idf
    # column (its layout and one-hots built once), two iteration counts
    # differenced; at the fit's schedule its coefficient is the fit's.
    cols = extract_labeled_data(tfidf_df, "tfidf", "label", None, allow_sparse=True)
    dim = cols.pop("dim")
    cache = DeviceDataCache(cols)
    del df, tfidf_df, cols

    def sgd(iters):
        opt = SGD(max_iter=iters, global_batch_size=TRAIN_BATCH, tol=0.0, learning_rate=TRAIN_LR)
        t0 = time.perf_counter()
        coef = opt.optimize(np.zeros(dim, np.float32), cache, BinaryLogisticLoss.INSTANCE)
        return coef, time.perf_counter() - t0

    coef, _ = sgd(TRAIN_ITERS)
    if not np.array_equal(coef.view(np.int32), np.asarray(lr_model.coefficient, np.float32).view(np.int32)):
        raise AssertionError("SGD on the tf-idf cache is not bit-identical to the fit")
    t_runs = [sgd(iters)[1] for iters in STEP_ITERS]
    fit_ms_per_step = (t_runs[1] - t_runs[0]) / (STEP_ITERS[1] - STEP_ITERS[0]) * 1e3
    del cache

    with tempfile.TemporaryDirectory() as tmp:
        idf_model.save(f"{tmp}/idf")
        lr_model.save(f"{tmp}/lr")
        pipeline = PipelineModelServable([load_servable(f"{tmp}/idf"), load_servable(f"{tmp}/lr")])
    if not np.array_equal(pipeline.servables[1].coefficient, lr_model.coefficient):
        raise AssertionError("the loaded coefficient differs from the fitted one")
    coef32 = np.asarray(lr_model.coefficient, np.float32).astype(np.float64)

    # Traffic: new rows of the headline generator under another seed.
    rng = np.random.default_rng(SPARSE_SERVE_SEED)
    n_req = N_CLIENTS * REQUESTS_PER_CLIENT
    sizes = [int(min(MAX_BATCH, max(1, round(2 ** rng.uniform(0, 12))))) for _ in range(n_req)]
    hot_sizes = [MAX_BATCH, MAX_BATCH * 1500 // 4096, MAX_BATCH // 2, MAX_BATCH // 4]
    sizes[::16] = hot_sizes[: len(sizes[::16])]  # hot keys on every run (4096, 1500, 2048, 1024)
    nnz = [TRAIN_NNZ] * n_req
    short = rng.choice([i for i in range(n_req) if i % 16], n_req // 4, replace=False)
    for j, i in enumerate(short):  # a quarter with 1-38 features: caps 1-32 as well
        nnz[i] = (1, 2, 3, 5, 9, 17, 24, 38)[j % 8]
    payload_ids = [_hashed_rows(rng, n, k) for n, k in zip(sizes, nnz)]
    payloads = [_sparse_frame(ids) for ids in payload_ids]

    def check(i, out):
        ids = payload_ids[i]
        want = idf32[ids]  # value 1.0 × idf: the f32 product
        got = out["tfidf"]
        if len(got) != len(ids):
            raise AssertionError(f"{len(got)} rows back for {len(ids)}")
        for r in range(len(ids)):
            if not (np.array_equal(got[r].indices, ids[r]) and np.array_equal(got[r].values, want[r])):
                raise AssertionError(f"row {r}: tfidf is not the f32 product")
        margin = (want.astype(np.float64) * coef32[ids]).sum(axis=1)
        p = 1.0 / (1.0 + np.exp(-margin))
        np.testing.assert_allclose(out["rawPrediction"], np.stack([1.0 - p, p], axis=1), rtol=0, atol=1e-5)
        decided = np.abs(margin) > PREDICTION_MARGIN
        np.testing.assert_array_equal(np.asarray(out["prediction"])[decided],
                                      (margin >= 0).astype(np.float64)[decided])

    config = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
    t0 = time.perf_counter()
    server = InferenceServer(pipeline, name="chip-smoke-sparse", serving_config=config,
                             warmup_template=payloads[0].take([0]), device="cuda")
    warmup_s = time.perf_counter() - t0
    scope = server.scope
    with server:
        plan = pipeline._fastpath_plan
        kinds = chain_kinds(plan)
        keys = []  # the key of every batch the plan ingests from here on
        ingest = plan._ingest

        def recording_ingest(segment, df, bucket, cap=None, warm=False):
            got = ingest(segment, df, bucket, cap=cap, warm=warm)
            keys.append(got[1])
            return got

        plan._ingest = recording_ingest
        # The main path's run starts here: counts to 0, then traffic.
        for k in KERNELS:
            k.reset_launches()
        plain_calls, restore = _count_calls(mk, ("sparse_idf_logistic_plain", "scale_logistic_plain"))
        batches_before = len(server.executed_batch_sizes)
        fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
        latencies = [None] * n_req
        failures = []

        def client(c):
            for i in range(c, n_req, N_CLIENTS):
                t_req = time.perf_counter()
                try:
                    resp = server.predict(payloads[i])
                    latencies[i] = (time.perf_counter() - t_req) * 1000.0
                    check(i, resp.dataframe)
                except BaseException as e:  # noqa: BLE001 — reported below, fails the run
                    failures.append(f"request {i} ({sizes[i]} rows): {type(e).__name__}: {e}")

        try:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            restore()
        if any(th.is_alive() for th in threads):
            raise AssertionError("serve_sparse clients did not finish within 600 s")
        launches = mk.SPARSE_IDF_LOGISTIC.launches
        other = {k.name: k.launches for k in KERNELS if k is not mk.SPARSE_IDF_LOGISTIC}
        batches = server.executed_batch_sizes[batches_before:]
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    breakdown = _sparse_batch_breakdown(plan, payloads[sizes.index(MAX_BATCH)], ingest)
    hot = sorted(k for k, kind in kinds.items() if "megakernel" in kind)
    hot_batches = sum(1 for k in keys if k in hot)
    fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
    compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    if not launches > 0:
        raise AssertionError("the sparse megakernel never launched on the main path")
    if launches != hot_batches:
        raise AssertionError(f"sparse megakernel launches {launches} != batches with hot keys {hot_batches}")
    if len(keys) != len(batches):
        raise AssertionError(f"{len(keys)} batches ingested, {len(batches)} executed")
    if fallback != 0:
        raise AssertionError(f"{fallback} batches fell back to the per-stage path")
    if compiles != 0:
        raise AssertionError(f"{compiles} chains were built after warmup")
    if plain_calls:
        raise AssertionError(f"plain megakernel versions were called: {sorted(set(plain_calls))}")
    if any(other.values()):
        raise AssertionError(f"other kernels launched during sparse serving: {other}")
    lat = sorted(latencies)
    result = {
        "dim": TRAIN_DIM, "train_rows": len(idx), "data_s": data_s,
        "idf_fit_s": idf_fit_s, "idf_transform_s": idf_transform_s,
        "lr_fit_s": fit_s, "lr_fit_ms_per_step": fit_ms_per_step, "lr_fit_launches": fit_launches,
        "lr_loss_first": est.loss_history[0], "lr_loss_last": est.loss_history[-1],
        "warmup_s": warmup_s, "warmed_keys": len(kinds),
        "requests": n_req, "rows": sum(sizes),
        "caps_requested": sorted({ladder_cap(k) for k in nnz}),
        "caps_served": sorted({k[1] for k in keys}),
        "batches": len(batches),
        "hot_keys": hot,
        "hot_batches": hot_batches,
        "megakernel_launches": launches,
        "fallback_batches": fallback,
        "post_warmup_builds": compiles,
        "plain_calls": len(plain_calls),
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(sizes) / wall,
        "wall_s": wall,
        "hot_batch_breakdown_ms": breakdown,
    }
    emit("serve_sparse", card=card, **result)
    return launches, idf_model, lr_model


def _mlp_inputs(rng, rows, widths, dev):
    """A scaler (zero-std guard included), a He-initialised network with
    small biases, class values and ``rows`` input rows, on ``dev``."""
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    d = widths[0]
    std = (np.abs(rng.normal(size=d)) + 0.5).astype(np.float32)
    std[0] = 0.0  # the zero-std guard: that feature scales to 0
    inv_std = np.where(std == 0.0, 0.0, 1.0 / np.where(std == 0.0, 1.0, std))
    layers = [(t(rng.normal(size=(a, b)) * np.sqrt(2.0 / a)), t(rng.normal(size=b) * 0.1))
              for a, b in zip(widths[:-1], widths[1:])]
    labels = t(rng.permutation(widths[-1]) + 1.0)
    return t(rng.normal(size=(rows, d))), t(rng.normal(size=d)), t(inv_std), layers, labels


def _mlp_head(fn, inputs, ops, head_src, layers, labels):
    """The table ``ops`` then one MLP head on slot ``head_src`` through
    ``fn`` (``rowlocal_mlp`` or its plain version): ``(the table's outputs,
    prediction, probabilities)``."""
    from flink_ml_tpu_torch.servable.megakernels import RowLocalOp

    outs = fn(inputs, list(ops) + [RowLocalOp("mlp", head_src, labels, layers=layers)])
    return outs[:-2], outs[-2], outs[-1]


def _top_two_gap(layers, h):
    """The gap between the two largest float32 logits of each row (the
    plain version's products); infinite with one class."""
    import torch

    for W, b in layers[:-1]:
        h = torch.relu(h @ W + b)
    logits = h @ layers[-1][0] + layers[-1][1]
    if logits.shape[1] < 2:
        return torch.full((logits.shape[0],), float("inf"), device=logits.device)
    top = torch.topk(logits, 2, dim=1).values
    return top[:, 0] - top[:, 1]


def _mlp_bound(rows, widths, ms):
    """The bound of ``scale → mlp`` on ``rows`` rows of ``widths``: the three
    products' operations (the scale, bias, relu and softmax add under 0.3%)
    as 3×TF32 at the TF32 peak (``bound_ms``) and as float32 outside the
    tensor cores (``bound_ms_f32``), against each input, output and weight
    byte once; and the share of the TF32 peak that ``ms`` reaches."""
    weights = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    ops = 2 * rows * weights
    bytes_moved = 4 * (2 * rows * widths[0] + weights + sum(widths[1:]) + 2 * widths[0]
                       + widths[-1] + rows * widths[-1] + rows)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * ops / TF32_OPS_PER_S * 1e3
    return {"bytes": bytes_moved, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_ms_f32": max(bytes_ms, ops / F32_OPS_PER_S * 1e3),
            "tf32_peak_share": 3 * ops / (ms * 1e-3) / TF32_OPS_PER_S}


def _mlp_compiled(kernel):
    """What the compiler made of the MLP kernel's source: the registers a
    thread and the spill bytes of its entries and of every function they
    call (ptxas -v), whether ptxas serialized any wgmma, and its SASS's
    HGMMA (wgmma) and FFMA counts (cuobjdump; the FFMAs are the table's row
    ops and the softmax, no product loop). Raises without HGMMA or if ptxas
    serialized the wgmma; the spills are a reading."""
    import re

    res, sass = _built_sass(kernel)
    spills = [(int(a), int(b)) for a, b in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", res.log)]
    out = {
        "source": kernel.source_path,
        "registers": max((int(r) for r in re.findall(r"Used (\d+) registers", res.log)), default=None),
        "spill_store_bytes": sum(a for a, _ in spills),
        "spill_load_bytes": sum(b for _, b in spills),
        "wgmma_serialized": "wgmma.mma_async instructions are serialized" in res.log,
    }
    out["hgmma"] = len(re.findall(r"\bHGMMA\.", sass))
    out["ffma"] = len(re.findall(r"\bFFMA\b", sass))
    if not out["hgmma"] or out["wgmma_serialized"]:
        raise AssertionError(f"{kernel.name}: no HGMMA in its SASS, or its wgmma serialized: {out}")
    return out


def phase_kernels_mlp(rng, card: str):
    """The MLP megakernel on ("scale", "mlp") and ("mlp",) against its plain
    version over rows × networks × chains, then its times at the serving
    shape."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
    from flink_ml_tpu_torch.servable.megakernels import (
        MLP_MAX_CLASSES,
        MLP_MAX_LAYERS,
        MLP_MAX_WIDTH,
        ROWLOCAL_MLP,
        RowLocalOp,
        rowlocal_mlp,
        rowlocal_mlp_plain,
    )

    def scale_mlp(fn, x, mean, inv_std, layers, labels, *, with_mean, with_std, write_scaled):
        """(scaled or None, prediction, probabilities) of the chain through
        ``fn``: a one-op scale table, or the MLP alone on ``x``."""
        if not write_scaled:
            assert not (with_mean or with_std), "the MLP alone reads its input unscaled"
            _, pred, probs = _mlp_head(fn, [x], [], 0, layers, labels)
            return None, pred, probs
        ops = [RowLocalOp("scale", 0, mean, inv_std, {"with_mean": with_mean, "with_std": with_std})]
        (scaled,), pred, probs = _mlp_head(fn, [x], ops, 1, layers, labels)
        return scaled, pred, probs

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain and library products in full float32
    envelope = ULP_ENVELOPE["scale_mlp"]
    networks = dict(MLP_CHECK_NETWORKS, limits=(MLP_MAX_WIDTH,) * MLP_MAX_LAYERS + (MLP_MAX_CLASSES,))
    max_abs_err, max_ulps, checked = 0.0, 0, 0
    for rows in MLP_CHECK_ROWS:
        for net, widths in networks.items():
            x, mean, inv_std, layers, labels = _mlp_inputs(rng, rows, widths, dev)
            for label, with_mean, with_std, write_scaled in MLP_CHAINS:
                kw = dict(with_mean=with_mean, with_std=with_std)
                scaled, pred, probs = scale_mlp(rowlocal_mlp, x, mean, inv_std, layers, labels,
                                                write_scaled=write_scaled, **kw)
                p_scaled, p_pred, p_probs = scale_mlp(rowlocal_mlp_plain, x, mean, inv_std, layers,
                                                      labels, write_scaled=write_scaled, **kw)
                if p_scaled is None:
                    p_scaled = x
                torch.cuda.synchronize()
                where = f"{label} rows={rows} net={net} with_mean={with_mean} with_std={with_std}"
                if write_scaled:
                    if not torch.equal(scaled, p_scaled):
                        raise AssertionError(f"scaled not bit-equal to the plain version: {where}")
                else:
                    assert scaled is None, where
                ulps = ulp_diff(probs.cpu().numpy(), p_probs.cpu().numpy())
                if ulps > envelope:
                    raise AssertionError(f"probabilities {ulps} ulps > {envelope}: {where}")
                decided = (_top_two_gap(layers, p_scaled) > PREDICTION_MARGIN).cpu().numpy()
                if not np.array_equal(pred.cpu().numpy()[decided], p_pred.cpu().numpy()[decided]):
                    raise AssertionError(
                        f"prediction differs where the top-two logit gap > {PREDICTION_MARGIN}: {where}")
                errs = [(probs - p_probs).abs().max()]
                if write_scaled:
                    errs.append((scaled - p_scaled).abs().max())
                max_abs_err = max(max_abs_err, max(float(e) for e in errs))
                max_ulps = max(max_ulps, ulps)
                checked += 1
    # a row's outputs do not depend on the batch it came in (nor on the cluster size it got)
    equal_checked = 0
    for net, widths in networks.items():
        x, mean, inv_std, layers, labels = _mlp_inputs(rng, MAX_BATCH, widths, dev)
        kw = dict(with_mean=True, with_std=True, write_scaled=True)
        _, big_pred, big_probs = scale_mlp(rowlocal_mlp, x, mean, inv_std, layers, labels, **kw)
        for rows in MLP_CHECK_ROWS[:-1]:
            for off in MLP_EQUAL_OFFSETS:
                o = MAX_BATCH - rows if off is None else off
                _, pred, probs = scale_mlp(rowlocal_mlp, x[o:o + rows].contiguous(), mean, inv_std, layers,
                                           labels, **kw)
                if not (torch.equal(pred, big_pred[o:o + rows]) and torch.equal(probs, big_probs[o:o + rows])):
                    raise AssertionError(f"rows {o}..{o + rows} of net={net} differ from the same rows "
                                         f"inside a {MAX_BATCH}-row batch")
                equal_checked += 1
    emit("kernels_mlp", kernel=ROWLOCAL_MLP.name, configurations=checked, networks=
         {k: list(v) for k, v in networks.items()}, max_abs_err=max_abs_err,
         max_probability_ulps=max_ulps, probability_ulp_envelope=envelope, scaled="bit-equal",
         prediction=f"equal where the plain top-two logit gap > {PREDICTION_MARGIN}",
         rows_bit_equal_across_batches=equal_checked, compiled=_mlp_compiled(ROWLOCAL_MLP))

    rows, widths = MAX_BATCH, MLP_WIDTHS
    x, mean, inv_std, layers, labels = _mlp_inputs(rng, rows, widths, dev)
    kw = dict(with_mean=True, with_std=True, write_scaled=True)
    scaled = scale_mlp(rowlocal_mlp_plain, x, mean, inv_std, layers, labels, **kw)[0]

    def kernel():
        scale_mlp(rowlocal_mlp, x, mean, inv_std, layers, labels, **kw)

    def plain():
        scale_mlp(rowlocal_mlp_plain, x, mean, inv_std, layers, labels, **kw)

    def library():  # the chain's three products only: no single call computes the chain
        h = scaled
        for W, b in layers:
            h = torch.addmm(b, h, W)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    for fn in (kernel, plain, library):  # warm-up
        for _ in range(5):
            fn()
    torch.cuda.synchronize()
    times = {n: {"cold": [], "warm": []} for n in ("kernel", "plain", "library")}
    for name, fn in (("plain", plain), ("library", library), ("kernel", kernel),
                     ("kernel", kernel), ("library", library), ("plain", plain)):
        times[name]["cold"] += _cold_times(fn, 50, flush)
        times[name]["warm"].append(_warm_time(fn, 100))
    by_rows = {}
    for r in MLP_SMALL_ROWS:
        xr, sr = x[:r].contiguous(), scaled[:r].contiguous()

        def kernel_r():
            scale_mlp(rowlocal_mlp, xr, mean, inv_std, layers, labels, **kw)

        def library_r():
            h = sr
            for W, b in layers:
                h = torch.addmm(b, h, W)

        for fn in (kernel_r, library_r):
            for _ in range(5):
                fn()
        # the wrapper's host work outlasts the flush at these sizes: the sleep holds the device
        ms = _median(_cold_times(kernel_r, 25, flush, hold_cycles=4_000_000))
        by_rows[r] = {"ms": ms, "ms_l2_warm": _warm_time(kernel_r, 100),
                      "library_ms": _median(_cold_times(library_r, 25, flush, hold_cycles=4_000_000)),
                      "library_ms_l2_warm": _warm_time(library_r, 100), **_mlp_bound(r, widths, ms)}
    ms = _median(times["kernel"]["cold"])
    timing = {
        "shape": [rows, *widths],
        "ms": ms,
        "ms_l2_warm": _median(times["kernel"]["warm"]),
        "plain_ms": _median(times["plain"]["cold"]),
        "plain_ms_l2_warm": _median(times["plain"]["warm"]),
        "library_ms": _median(times["library"]["cold"]),
        "library_ms_l2_warm": _median(times["library"]["warm"]),
        "library": "three torch.addmm, float32, TF32 off: the chain's products only",
        "small_batches": by_rows,
        **_mlp_bound(rows, widths, ms),
    }
    emit("kernels_mlp", kernel=ROWLOCAL_MLP.name, card=card, **timing)
    return {"max_abs_err": max_abs_err, **timing}


def _mlp_population():
    """The population of the MLP rows: per-feature location and spread, and
    a random linear teacher whose argmax over the standardised features is
    the class, so the classes are learnable."""
    import numpy as np

    rng = np.random.default_rng(MLP_SEED)
    d, classes = MLP_WIDTHS[0], MLP_WIDTHS[-1]
    return rng.normal(size=d) * 3.0, np.abs(rng.normal(size=d)) + 0.5, rng.normal(size=(d, classes))


def _mlp_rows(rng, population, rows):
    """``rows`` rows of the population: features [rows, 256] and class values."""
    import numpy as np

    loc, spread, teacher = population
    X = rng.normal(size=(rows, loc.shape[0])) * spread + loc
    return X, np.argmax(((X - loc) / spread) @ teacher, axis=1).astype(np.float64)


def _reference_mlp_fit(X, y_idx, dims, seed, lr, batch, iters, dtype, device, n_data=1):
    """The MLP fit written out plainly in ``dtype``: the same initial draws,
    windows (the tail clamped and its re-read rows weighted 0) and adam
    formula, the gradient of the window's mean loss by autograd. On
    ``n_data`` ranks each epoch's window is every rank's ``ceil(batch /
    n_data)`` rows of its contiguous share (the share's padding weighted 0).
    Returns the per-epoch mean losses and the ``(W, b)`` layers."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        W = (rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
        params += [torch.tensor(W, dtype=dtype, device=device, requires_grad=True),
                   torch.zeros(b, dtype=dtype, device=device, requires_grad=True)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    X = torch.as_tensor(X, device=device).to(dtype)
    y = torch.as_tensor(y_idx, device=device).long()
    n, offset, losses = X.shape[0], 0, []
    m = -(-n // n_data)
    batch = min(-(-batch // n_data), m) if n_data > 1 else batch
    for t in range(1, iters + 1):
        start = min(offset, m - batch)
        local = start + torch.arange(batch, device=device)
        w = (local >= offset).to(dtype)
        if n_data > 1:
            at = torch.cat([k * m + local for k in range(n_data)])
            w = w.repeat(n_data) * (at < n).to(dtype)
            at = at.clamp_max(n - 1)
            h, yb = X[at], y[at]
        else:
            h, yb = X[start:start + batch], y[start:start + batch]
        for i in range(0, len(params) - 2, 2):
            h = torch.relu(h @ params[i] + params[i + 1])
        logits = h @ params[-2] + params[-1]
        rows = torch.logsumexp(logits, dim=1) - logits.gather(1, yb[:, None])[:, 0]
        loss = (rows * w).sum() / w.sum()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, grads)):
                mu[i] = 0.1 * g + 0.9 * mu[i]
                nu[i] = 0.001 * g * g + 0.999 * nu[i]
                p -= lr * (mu[i] / (1 - 0.9 ** t)) / (torch.sqrt(nu[i] / (1 - 0.999 ** t)) + 1e-8)
        losses.append(float(loss.detach()))
        offset = 0 if offset + batch >= m else offset + batch
    return losses, [(params[i].detach(), params[i + 1].detach()) for i in range(0, len(params), 2)]


def _dense_batch_breakdown(plan, df, ingest, reps=5, col="features"):
    """Where one full-bucket batch's time goes on the plan's path (host
    clock, the device synchronised after each step; median of ``reps``):
    the host gather (of ``col``), the gather and upload, the chain on the
    card, and the readback."""
    import torch

    from flink_ml_tpu_torch.servable.planner import PlanExecution, run_segment

    (segment,) = plan.segments
    steps = {"gather": [], "gather_and_upload": [], "chain": [], "readback": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        segment.gather(df, col)
        t1 = time.perf_counter()
        inputs, key = ingest(segment, df, len(df))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        outputs = run_segment(segment, key, inputs)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        PlanExecution(df, segment.pending(outputs)).finalize()
        t4 = time.perf_counter()
        for name, dt in zip(steps, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            steps[name].append(dt * 1e3)
    medians = {name: _median(v) for name, v in steps.items()}
    total = medians["gather_and_upload"] + medians["chain"] + medians["readback"]
    return {"rows": len(df), "key": key, "kinds": list(segment.plan_kinds[key]), **medians,
            "chain_share": medians["chain"] / total}


def phase_serve_mlp(card: str):
    """The MLP classifier trained and served on the card (see the module
    docstring, phase 11)."""
    import tempfile

    import numpy as np
    import torch

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.device import resolve_device
    from flink_ml_tpu_torch.iteration import DeviceDataCache
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.classification.mlp_classifier import MLPClassifier
    from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScaler
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.servable import PipelineModelServable, load_servable
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    dev = resolve_device()
    population = _mlp_population()
    t0 = time.perf_counter()
    X, y = _mlp_rows(np.random.default_rng(MLP_SEED + 10), population, MLP_ROWS)
    df = DataFrame.from_dict({"features": X, "label": y})
    data_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    scaler = (StandardScaler().set_input_col("features").set_output_col("scaled")
              .set_with_mean(True).set_with_std(True).fit(df))
    scaler_fit_s = time.perf_counter() - t0
    X32 = X.astype(np.float32).astype(np.float64)
    # float32 column sums of 100,000 values, then float64: a few float32 ulps
    np.testing.assert_allclose(scaler.mean, X32.mean(axis=0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(scaler.std, X32.std(axis=0, ddof=1), rtol=1e-5)
    t0 = time.perf_counter()
    scaled_df = scaler.transform(df)
    scaler_transform_s = time.perf_counter() - t0
    mean32 = np.asarray(scaler.mean, np.float32).astype(np.float64)
    inv_std = np.where(np.asarray(scaler.std, np.float32) == 0, 0.0,
                       1.0 / np.asarray(scaler.std, np.float32)).astype(np.float32).astype(np.float64)
    np.testing.assert_allclose(scaled_df.column("scaled"), (X32 - mean32) * inv_std, rtol=1e-6, atol=1e-6)

    def estimator(compute_type="float32", iters=MLP_ITERS):
        return (MLPClassifier().set_features_col("scaled").set_hidden_layers(*MLP_WIDTHS[1:-1])
                .set_max_iter(iters).set_global_batch_size(MLP_BATCH).set_compute_type(compute_type))

    est = estimator()
    t0 = time.perf_counter()
    model = est.fit(scaled_df)
    fit_s = time.perf_counter() - t0
    est_bf16 = estimator("bfloat16")
    model_bf16 = est_bf16.fit(scaled_df)

    # the float64 twin of the fit, on the card, on the same float32 features
    Xs = scaled_df.vectors("scaled").astype(np.float32)
    classes = np.unique(y)
    y_idx = np.searchsorted(classes, y)
    ref_losses, ref_layers = _reference_mlp_fit(
        Xs, y_idx, list(MLP_WIDTHS), est.get_seed(), est.get_learning_rate(), MLP_BATCH,
        MLP_ITERS, torch.float64, dev)
    holdout_X, _ = _mlp_rows(np.random.default_rng(MLP_SEED + 20), population, MLP_HOLDOUT_ROWS)
    holdout = scaler.transform(DataFrame.from_dict({"features": holdout_X}))
    h = torch.from_numpy(holdout.vectors("scaled").astype(np.float32)).to(dev).double()
    for W, b in ref_layers[:-1]:
        h = torch.relu(h @ W + b)
    ref_probs = torch.softmax(h @ ref_layers[-1][0] + ref_layers[-1][1], dim=1).cpu().numpy()

    def against_reference(losses, probs):
        rel = np.abs(np.asarray(losses) - ref_losses) / np.abs(ref_losses)
        diff = np.abs(probs - ref_probs)
        return {"first_loss_rel": float(rel[0]), "loss_max_rel": float(rel.max()),
                "loss_rel_by_epoch": rel.tolist(), "prob_mean_abs": float(diff.mean()),
                "prob_max_abs": float(diff.max())}

    def within(dev):
        return (dev["first_loss_rel"] <= FIT_FIRST_LOSS_RTOL and dev["loss_max_rel"] <= FIT_LOSS_RTOL
                and dev["prob_mean_abs"] <= FIT_PROB_MEAN_ATOL)

    f32_dev = against_reference(est.loss_history, model.transform(holdout).column("rawPrediction"))
    bf16_dev = against_reference(est_bf16.loss_history, model_bf16.transform(holdout).column("rawPrediction"))
    # the float32 floor: the plain fit of the same schedule in float32
    floor_losses, floor_layers = _reference_mlp_fit(
        Xs, y_idx, list(MLP_WIDTHS), est.get_seed(), est.get_learning_rate(), MLP_BATCH,
        MLP_ITERS, torch.float32, dev)
    h = torch.from_numpy(holdout.vectors("scaled").astype(np.float32)).to(dev)
    for W, b in floor_layers[:-1]:
        h = torch.relu(h @ W + b)
    floor_dev = against_reference(
        floor_losses, torch.softmax(h @ floor_layers[-1][0] + floor_layers[-1][1], dim=1).cpu().numpy())
    fit_check = {
        "loss_history": est.loss_history, "loss_history_float64": ref_losses,
        "loss_history_bf16": est_bf16.loss_history, "loss_history_plain_float32": floor_losses,
        "float32_vs_float64": f32_dev, "bf16_vs_float64": bf16_dev,
        "plain_float32_vs_float64": floor_dev,
        "tolerance": {"first_loss_rel": FIT_FIRST_LOSS_RTOL, "loss_max_rel": FIT_LOSS_RTOL,
                      "prob_mean_abs": FIT_PROB_MEAN_ATOL},
    }
    emit("serve_mlp", card=card, fit_check=fit_check)  # before the gates, so a failure shows its numbers
    if len(est.loss_history) != MLP_ITERS:
        raise AssertionError(f"the fit ran {len(est.loss_history)} epochs, expected {MLP_ITERS}")
    if not within(f32_dev):
        raise AssertionError(f"the float32 fit is off its float64 twin: {f32_dev}")
    if within(bf16_dev):
        raise AssertionError(f"the bfloat16 control lies inside the float64 tolerance: {bf16_dev}")

    # steady ms/epoch: two iteration counts on one cache, differenced
    cache = DeviceDataCache({"x": Xs, "y": y_idx.astype(np.float32),
                             "w": np.ones(len(Xs), np.float32)})
    deltas = []
    for _ in range(3):
        spans = []
        for iters in MLP_EPOCH_ITERS:
            t0 = time.perf_counter()
            estimator(iters=iters).fit_cache(cache, classes)  # ends in a readback
            spans.append(time.perf_counter() - t0)
        deltas.append((spans[1] - spans[0]) / (MLP_EPOCH_ITERS[1] - MLP_EPOCH_ITERS[0]) * 1e3)
    fit_ms_per_epoch = _median(deltas)
    fit_profile = _profile_steps(lambda: estimator(iters=PROFILE_ITERS).fit_cache(cache, classes))
    del cache, Xs, scaled_df

    with tempfile.TemporaryDirectory() as tmp:
        scaler.save(f"{tmp}/scaler")
        model.save(f"{tmp}/mlp")
        pipeline = PipelineModelServable([load_servable(f"{tmp}/scaler"), load_servable(f"{tmp}/mlp")])
    layers64 = [(np.asarray(W, np.float32).astype(np.float64), np.asarray(b, np.float32).astype(np.float64))
                for W, b in model.params]
    for (W, b), (lW, lb) in zip(model.params, pipeline.servables[1].layers):
        if not (np.array_equal(W, lW) and np.array_equal(b, lb)):
            raise AssertionError("the loaded network differs from the fitted one")
    labels = np.asarray(model.labels)

    rng = np.random.default_rng(MLP_SERVE_SEED)
    n_req = N_CLIENTS * REQUESTS_PER_CLIENT
    sizes = [int(min(MAX_BATCH, max(1, round(2 ** rng.uniform(0, 12))))) for _ in range(n_req)]
    sizes[::16] = [MAX_BATCH, MAX_BATCH * 1500 // 4096, MAX_BATCH // 2, 1][: len(sizes[::16])]
    payloads = [_mlp_rows(rng, population, n)[0] for n in sizes]

    def check(i, out):
        scaled = (payloads[i].astype(np.float32).astype(np.float64) - mean32) * inv_std
        np.testing.assert_allclose(out["scaled"], scaled, rtol=1e-6, atol=1e-6)
        h = scaled
        for W, b in layers64[:-1]:
            h = np.maximum(h @ W + b, 0.0)
        logits = h @ layers64[-1][0] + layers64[-1][1]
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        np.testing.assert_allclose(out["rawPrediction"], e / e.sum(axis=1, keepdims=True), rtol=0, atol=1e-5)
        top = np.sort(logits, axis=1)
        decided = top[:, -1] - top[:, -2] > PREDICTION_MARGIN
        np.testing.assert_array_equal(np.asarray(out["prediction"])[decided],
                                      labels[np.argmax(logits, axis=1)][decided])

    config = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
    t0 = time.perf_counter()
    server = InferenceServer(pipeline, name="chip-smoke-mlp", serving_config=config,
                             warmup_template=DataFrame.from_dict({"features": payloads[0][:1]}),
                             device="cuda")
    warmup_s = time.perf_counter() - t0
    scope = server.scope
    with server:
        plan = pipeline._fastpath_plan
        kinds = chain_kinds(plan)
        ingest = plan._ingest
        # The main path's run starts here: counts to 0, then traffic.
        for k in KERNELS:
            k.reset_launches()
        plain_calls, restore = _count_calls(mk, ("rowlocal_mlp_plain", "scale_logistic_plain",
                                                 "sparse_idf_logistic_plain"))
        batches_before = len(server.executed_batch_sizes)
        fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
        latencies = [None] * n_req
        failures = []

        def client(c):
            for i in range(c, n_req, N_CLIENTS):
                t_req = time.perf_counter()
                try:
                    resp = server.predict(DataFrame.from_dict({"features": payloads[i]}))
                    latencies[i] = (time.perf_counter() - t_req) * 1000.0
                    check(i, resp.dataframe)
                except BaseException as e:  # noqa: BLE001 — reported below, fails the run
                    failures.append(f"request {i} ({sizes[i]} rows): {type(e).__name__}: {e}")

        try:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            restore()
        if any(th.is_alive() for th in threads):
            raise AssertionError("serve_mlp clients did not finish within 600 s")
        launches = mk.ROWLOCAL_MLP.launches
        other = {k.name: k.launches for k in KERNELS if k is not mk.ROWLOCAL_MLP}
        batches = server.executed_batch_sizes[batches_before:]
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    breakdown = _dense_batch_breakdown(
        plan, DataFrame.from_dict({"features": payloads[sizes.index(MAX_BATCH)]}), ingest)
    hot = sorted(b for b, kind in kinds.items() if "megakernel" in kind)
    if hot != [b for b in kinds if b >= 2]:
        raise AssertionError(f"hot buckets {hot}: the cost model should mark every bucket from 2 rows")
    hot_batches = sum(1 for _, bucket in batches if bucket >= 2)
    fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
    compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    if not launches > 0:
        raise AssertionError("the MLP megakernel never launched on the main path")
    if launches != hot_batches:
        raise AssertionError(f"MLP megakernel launches {launches} != batches of bucket >= 2 {hot_batches}")
    if fallback != 0:
        raise AssertionError(f"{fallback} batches fell back to the per-stage path")
    if compiles != 0:
        raise AssertionError(f"{compiles} chains were built after warmup")
    if plain_calls:
        raise AssertionError(f"plain megakernel versions were called: {sorted(set(plain_calls))}")
    if any(other.values()):
        raise AssertionError(f"other kernels launched during MLP serving: {other}")
    lat = sorted(latencies)
    result = {
        "train_rows": MLP_ROWS, "widths": list(MLP_WIDTHS), "data_s": data_s,
        "scaler_fit_s": scaler_fit_s, "scaler_transform_s": scaler_transform_s,
        "fit_s": fit_s, "fit_ms_per_epoch": fit_ms_per_epoch, "fit_profile": fit_profile,
        "loss_first": est.loss_history[0], "loss_last": est.loss_history[-1],
        "warmup_s": warmup_s, "warmed_buckets": len(kinds),
        "requests": n_req, "rows": sum(sizes),
        "batches": len(batches),
        "hot_buckets": hot,
        "hot_batches": hot_batches,
        "megakernel_launches": launches,
        "fallback_batches": fallback,
        "post_warmup_builds": compiles,
        "plain_calls": len(plain_calls),
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(sizes) / wall,
        "wall_s": wall,
        "hot_batch_breakdown_ms": breakdown,
    }
    emit("serve_mlp", card=card, **result)
    return launches


def _kmeans_distances64(measure, X, C):
    """Float64 distances [rows, k] of ``X`` to ``C`` on their device, in the
    measure's direct form (``torch.cdist`` for euclidean and manhattan)."""
    import torch

    X, C = X.double(), C.double()
    if measure == "euclidean":
        return torch.cdist(X, C)
    if measure == "manhattan":
        return torch.cdist(X, C, p=1)
    return 1.0 - (X @ C.T) / X.norm(dim=1, keepdim=True) / C.norm(dim=1)[None, :]


def _kmeans_decided(dist):
    """Rows of float64 distances whose top-two gap exceeds KMEANS_MARGIN; a
    row with a NaN distance is decided (the first NaN wins)."""
    import torch

    nan = torch.isnan(dist).any(dim=1)
    if dist.shape[1] < 2:
        return torch.ones_like(nan)
    top = torch.topk(torch.nan_to_num(dist, nan=0.0), 2, dim=1, largest=False).values
    return nan | (top[:, 1] - top[:, 0] > KMEANS_MARGIN)


def _same_bits(a, b):
    """Bit-equal, a NaN matching any NaN (its payload aside)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a.masked_fill(na, 0.0).view(torch.int32), b.masked_fill(nb, 0.0).view(torch.int32)))


def _kmeans_inputs(rng, rows, d, k, dev):
    """Uniform [0, 1) rows (the published generator's kind), a scaler with
    the zero-std guard, and centroids drawn as scaled rows of the same
    population — so the distances concentrate as a fitted model's do."""
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    mean = (rng.random(d) * 0.5).astype(np.float32)
    std = (rng.random(d) * 0.3 + 0.2).astype(np.float32)
    std[0] = 0.0  # the zero-std guard: that feature scales to 0
    inv_std = np.where(std == 0.0, 0.0, 1.0 / np.where(std == 0.0, 1.0, std)).astype(np.float32)
    C = (rng.random((k, d)).astype(np.float32) - mean) * inv_std
    return t(rng.random((rows, d))), t(mean), t(inv_std), t(C)


def _kmeans_grid(rng, dev):
    """The kmeans megakernel (``scale_kmeans`` on ``dev``) against its plain
    version over rows × d × k × measure × chain: scaled bit-equal, the
    prediction equal on every row whose float64 top-two gap exceeds the
    margin. A NaN feature (row 1), a row equal to the mean (row 2: zero
    after centring, NaN under cosine) and a duplicate centroid (the last
    equals centroid 1, so ties take the first index) are in every grid
    cell that has room for them. Returns the totals."""
    import torch

    from flink_ml_tpu_torch.servable.megakernels import scale_kmeans, scale_kmeans_plain

    checked, inside, compared, max_abs_err = 0, 0, 0, 0.0
    for rows in KMEANS_CHECK_ROWS:
        for d in KMEANS_CHECK_DIMS:
            for k in KMEANS_CHECK_KS:
                x, mean, inv_std, C = _kmeans_inputs(rng, rows, d, k, dev)
                if rows >= 7:
                    x[1, d // 2] = float("nan")
                    x[2] = mean
                distinct = k
                if k >= 3:
                    C[k - 1] = C[1]
                    distinct = k - 1
                for measure in KMEANS_MEASURES:
                    for label, with_mean, with_std, write_scaled in KMEANS_CHAINS:
                        kw = dict(measure=measure, with_mean=with_mean, with_std=with_std)
                        scaled, pred = scale_kmeans(x, mean, inv_std, C, write_scaled=write_scaled, **kw)
                        p_scaled, p_pred = scale_kmeans_plain(x, mean, inv_std, C, **kw)
                        where = f"{label} {measure} rows={rows} d={d} k={k} " \
                                f"with_mean={with_mean} with_std={with_std}"
                        if write_scaled:
                            if not _same_bits(scaled, p_scaled):
                                raise AssertionError(f"scaled not bit-equal to the plain version: {where}")
                            max_abs_err = max(max_abs_err, float(torch.nan_to_num(scaled - p_scaled).abs().max()))
                        elif scaled is not None:
                            raise AssertionError(f"scaled written though not asked for: {where}")
                        if pred.dtype != torch.int32 or tuple(pred.shape) != (rows,):
                            raise AssertionError(f"prediction {pred.dtype} {tuple(pred.shape)}: {where}")
                        decided = _kmeans_decided(_kmeans_distances64(measure, p_scaled, C[:distinct]))
                        bad = int(((pred != p_pred) & decided).sum())
                        if bad:
                            raise AssertionError(f"{bad} predictions differ outside the margin: {where}")
                        if rows >= 7 and not (pred[1] == 0 and p_pred[1] == 0):
                            raise AssertionError(f"a NaN row is not assigned index 0: {where}")
                        diff = (pred.long() - p_pred.long()).abs()[decided]
                        if diff.numel():
                            max_abs_err = max(max_abs_err, float(diff.max()))
                        inside += int((~decided).sum())
                        compared += int(decided.sum())
                        checked += 1
    return {"configurations": checked, "rows_compared": compared, "rows_inside_margin": inside,
            "max_abs_err": max_abs_err}


def phase_kernels_kmeans(rng, card: str):
    """The scale → kmeans megakernel against its plain version over the grid
    (``_kmeans_grid``), then its times at the serving shape."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.servable.megakernels import SCALE_KMEANS, scale_kmeans, scale_kmeans_plain

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain and library products in full float32
    emit("kernels_kmeans", kernel=SCALE_KMEANS.name, compiled=_ptxas(SCALE_KMEANS))
    grid = _kmeans_grid(rng, dev)
    emit("kernels_kmeans", kernel=SCALE_KMEANS.name, **grid,
         grid={"rows": list(KMEANS_CHECK_ROWS), "d": list(KMEANS_CHECK_DIMS), "k": list(KMEANS_CHECK_KS),
               "measures": list(KMEANS_MEASURES), "chains": [c[:3] for c in KMEANS_CHAINS]},
         scaled="bit-equal", prediction=f"equal where the float64 top-two distance gap > {KMEANS_MARGIN}")

    rows, d, k = MAX_BATCH, KMEANS_D, KMEANS_K
    x, mean, inv_std, C = _kmeans_inputs(rng, rows, d, k, dev)
    kw = dict(measure="euclidean", with_mean=True, with_std=True)
    scaled = scale_kmeans_plain(x, mean, inv_std, C, **kw)[0]

    def kernel():
        scale_kmeans(x, mean, inv_std, C, write_scaled=True, **kw)

    def plain():
        scale_kmeans_plain(x, mean, inv_std, C, **kw)

    def head():  # the assignment alone, on the scaled rows: the library call's work
        scale_kmeans(scaled, None, None, C, measure="euclidean", with_mean=False, with_std=False,
                     write_scaled=False)

    def library():  # the head alone: no single call computes the chain
        torch.argmin(torch.cdist(scaled, C), dim=1)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    for fn in (kernel, plain, head, library):  # warm-up
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    names = ("kernel", "plain", "head", "library")
    times = {n: {"cold": [], "warm": []} for n in names}
    for name, fn in (("plain", plain), ("library", library), ("head", head), ("kernel", kernel),
                     ("kernel", kernel), ("head", head), ("library", library), ("plain", plain)):
        times[name]["cold"] += _cold_times(fn, 100, flush)
        times[name]["warm"].append(_warm_time(fn, 200))
    by_measure = {}
    for measure in KMEANS_MEASURES:
        def kernel_m():
            scale_kmeans(x, mean, inv_std, C, measure=measure, with_mean=True, with_std=True,
                         write_scaled=True)
        by_measure[measure] = _warm_time(kernel_m, 200)
    bytes_moved = 4 * (rows * d + rows * d + rows + k * d + 2 * d)  # x, scaled, index, centroids, mean/inv_std
    # sub, mul and the row's |h|^2 FMA per element; a dot FMA per element and
    # centroid plus add, sub, mul, compare, sqrt per distance; |c|^2 once
    ops = 4 * rows * d + rows * k * (2 * d + 5) + 2 * k * d
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    timing = {
        "shape": {"rows": rows, "d": d, "k": k, "measure": "euclidean", "with_mean": True, "with_std": True},
        "ms": _median(times["kernel"]["cold"]),
        "ms_l2_warm": _median(times["kernel"]["warm"]),
        "plain_ms": _median(times["plain"]["cold"]),
        "plain_ms_l2_warm": _median(times["plain"]["warm"]),
        "head_alone_ms": _median(times["head"]["cold"]),
        "head_alone_ms_l2_warm": _median(times["head"]["warm"]),
        "library_ms": _median(times["library"]["cold"]),
        "library_ms_l2_warm": _median(times["library"]["warm"]),
        "library": "torch.cdist + torch.argmin on the scaled rows: the head only (hold it against head_alone)",
        "ms_l2_warm_by_measure": by_measure,
        "bytes": bytes_moved,
        "ops": ops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    emit("kernels_kmeans", kernel=SCALE_KMEANS.name, card=card, **timing)
    return {"max_abs_err": grid["max_abs_err"], **timing}


def _kmeans_published_rows():
    """The published rows: DenseVectorGenerator(seed 2) — uniform [0, 1),
    100,000 × 100, float64 as the generator makes them."""
    import numpy as np

    return np.random.default_rng(KMEANS_DATA_SEED).random((KMEANS_ROWS, KMEANS_D))


def _kmeans_epoch_check(X, init, measure, epochs, control=None, sharded=False):
    """Replay ``epochs`` epochs of the port's fit (``_epoch_update``, or with
    ``sharded`` the deterministic tier's width-1 epoch, ``_sharded_epoch_tot``
    on distances by ``_fixed_order_pairwise``) from ``init`` on ``X``
    (float32, on the card) — with ``control`` applied to the features first,
    if given — and hold each epoch against float64 from its own starting
    centroids: assignments equal to the float64 argmin wherever the gap
    exceeds the margin, counts equal to its assignment's, and the new
    centroids within KMEANS_CENTROID_ATOL of the float64 means of the exact
    features over its assignment. Returns ``(final centroids, per-epoch
    readings, whether every epoch passed)``."""
    import torch

    from flink_ml_tpu_torch.models.clustering.kmeans import (
        _epoch_update,
        _fixed_order_pairwise,
        _sharded_epoch_tot,
        _tot_update,
    )
    from flink_ml_tpu_torch.ops.distance import DistanceMeasure

    m = DistanceMeasure.get_instance(measure)
    k = int(init.shape[0])
    X64 = X.double()
    feats = X if control is None else control(X)
    mask = torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    c, readings, ok = init, [], True
    for _ in range(epochs):
        if sharded:
            new, counts = _tot_update(_sharded_epoch_tot(measure, k, c, feats, mask, None), c)
            assign = torch.argmin(_fixed_order_pairwise(measure, feats, c), dim=1)
        else:
            new, counts = _epoch_update(m, k, c, feats, mask)
            assign = m.find_closest(feats, c)
        reading, epoch_ok = _kmeans_epoch_reading(X64, measure, c, assign, new, counts)
        readings.append(reading)
        ok = ok and epoch_ok
        c = new
    return c, readings, ok


def _kmeans_epoch_reading(X64, measure, c, assign, new, counts=None):
    """One epoch from centroids ``c`` against float64: ``assign`` equal to
    the float64 argmin wherever the gap exceeds the margin, ``new`` within
    KMEANS_CENTROID_ATOL of the float64 means of the exact features over
    ``assign``, and ``counts`` (when given) equal to its sizes. Returns
    ``(reading, passed)``."""
    import torch

    k = int(c.shape[0])
    dist = _kmeans_distances64(measure, X64, c)
    decided = _kmeans_decided(dist)
    mismatched = int(((assign != torch.argmin(dist, dim=1)) & decided).sum())
    hot = (assign[:, None] == torch.arange(k, device=X64.device)).double()
    n_assigned = hot.sum(dim=0)
    means = torch.where(n_assigned[:, None] > 0, (hot.T @ X64) / n_assigned.clamp_min(1.0)[:, None],
                        c.double())
    err = float((new.double() - means).abs().max())
    counts_equal = counts is None or bool(torch.equal(counts.double(), n_assigned))
    reading = {"mismatched": mismatched, "inside_margin": int((~decided).sum()),
               "centroid_err": err, "counts_equal": counts_equal}
    return reading, mismatched == 0 and err <= KMEANS_CENTROID_ATOL and counts_equal


def phase_fit_kmeans(card: str):
    """KMeans.fit on the published config (module docstring, phase 13)."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.device import resolve_device
    from flink_ml_tpu_torch.iteration import DeviceDataCache
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans

    dev = resolve_device()
    t0 = time.perf_counter()
    X = _kmeans_published_rows()
    df = DataFrame.from_dict({"features": X})
    data_s = time.perf_counter() - t0

    def estimator(iters=KMEANS_ITERS):
        return KMeans().set_k(KMEANS_K).set_max_iter(iters)

    est = estimator()
    t0 = time.perf_counter()
    model = est.fit(df)
    fit_s = time.perf_counter() - t0
    again = estimator().fit(df)
    if not (np.array_equal(again.centroids, model.centroids) and np.array_equal(again.weights, model.weights)):
        raise AssertionError("two fits of the same rows differ")
    if model.weights.sum() != KMEANS_ROWS or model.centroids.shape != (KMEANS_K, KMEANS_D):
        raise AssertionError(f"fit shapes {model.centroids.shape}, weights sum {model.weights.sum()}")

    # each epoch against float64 from the port's own centroids of that epoch
    X32 = torch.from_numpy(X.astype(np.float32)).to(dev)
    pick = np.random.default_rng(est.get_seed()).choice(KMEANS_ROWS, size=KMEANS_K, replace=False)
    init = X32[torch.from_numpy(pick).to(dev)]
    final, readings, ok = _kmeans_epoch_check(X32, init, est.get_distance_measure(), KMEANS_ITERS)
    if not np.array_equal(final.cpu().numpy().astype(np.float64), model.centroids):
        raise AssertionError("the replayed epochs do not land on the fitted centroids")
    _, control, control_ok = _kmeans_epoch_check(
        X32, init, est.get_distance_measure(), KMEANS_ITERS,
        control=lambda a: a.to(torch.bfloat16).to(torch.float32))
    fit_check = {
        "epochs": readings, "control_bf16_features": control,
        "margin": KMEANS_MARGIN, "centroid_atol": KMEANS_CENTROID_ATOL,
    }
    emit("fit_kmeans", card=card, fit_check=fit_check)  # before the gates, so a failure shows its numbers
    if not ok:
        raise AssertionError(f"the fit's epochs are off float64: {readings}")
    if control_ok:
        raise AssertionError(f"the bfloat16-feature control passes the float64 check: {control}")

    # steady ms/epoch: two epoch counts on one cache, differenced
    cache = DeviceDataCache({"x": X.astype(np.float32)})
    deltas = []
    for _ in range(3):
        spans = []
        for iters in KMEANS_EPOCH_ITERS:
            t0 = time.perf_counter()
            estimator(iters).fit_cache(cache)  # ends in a readback
            spans.append(time.perf_counter() - t0)
        deltas.append((spans[1] - spans[0]) / (KMEANS_EPOCH_ITERS[1] - KMEANS_EPOCH_ITERS[0]) * 1e3)
    profile = _profile_steps(lambda: estimator(PROFILE_ITERS).fit_cache(cache))
    del cache, X32
    result = {
        "rows": KMEANS_ROWS, "d": KMEANS_D, "k": KMEANS_K, "max_iter": KMEANS_ITERS,
        "measure": est.get_distance_measure(), "seed": est.get_seed(),
        "data_s": data_s, "fit_s": fit_s,
        "ms_per_epoch": _median(deltas), "ms_per_epoch_runs": deltas, "fit_profile": profile,
        # the trace's device time per epoch against the untraced epoch time:
        # the profiler's own host work stretches the traced wall clock
        "idle_share_steady": 1.0 - profile["device_busy_ms"] / PROFILE_ITERS / _median(deltas),
        "weights": model.weights.tolist(),
        "inside_margin_by_epoch": [r["inside_margin"] for r in readings],
        "max_centroid_err": max(r["centroid_err"] for r in readings),
        "control_mismatched_by_epoch": [r["mismatched"] for r in control],
    }
    emit("fit_kmeans", card=card, **result)


def phase_serve_kmeans(card: str):
    """StandardScaler → KMeans fitted, saved, loaded and served (module
    docstring, phase 14)."""
    import tempfile

    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
    from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScaler
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.servable import PipelineModelServable, load_servable
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    X = _kmeans_published_rows()
    df = DataFrame.from_dict({"features": X})
    t0 = time.perf_counter()
    scaler = (StandardScaler().set_input_col("features").set_output_col("scaled")
              .set_with_mean(True).set_with_std(True).fit(df))
    scaled_df = scaler.transform(df)
    model = KMeans().set_features_col("scaled").set_k(KMEANS_K).set_max_iter(KMEANS_ITERS).fit(scaled_df)
    fit_s = time.perf_counter() - t0
    del scaled_df
    with tempfile.TemporaryDirectory() as tmp:
        scaler.save(f"{tmp}/scaler")
        model.save(f"{tmp}/kmeans")
        pipeline = PipelineModelServable([load_servable(f"{tmp}/scaler"), load_servable(f"{tmp}/kmeans")])
    if not np.array_equal(pipeline.servables[1].centroids, model.centroids):
        raise AssertionError("the loaded centroids differ from the fitted ones")
    mean32 = np.asarray(scaler.mean, np.float32).astype(np.float64)
    inv_std = pipeline.servables[0]._inv_std().astype(np.float64)
    C64 = np.asarray(model.centroids, np.float32).astype(np.float64)

    rng = np.random.default_rng(KMEANS_SERVE_SEED)
    n_req = N_CLIENTS * REQUESTS_PER_CLIENT
    sizes = [int(min(MAX_BATCH, max(1, round(2 ** rng.uniform(0, 12))))) for _ in range(n_req)]
    sizes[::16] = [MAX_BATCH, MAX_BATCH * 1500 // 4096, MAX_BATCH // 2,
                   MAX_BATCH * 600 // 4096][: len(sizes[::16])]  # hot buckets on every run
    payloads = [rng.random((n, KMEANS_D)) for n in sizes]
    inside = [0] * n_req

    def check(i, out):
        scaled = (payloads[i].astype(np.float32).astype(np.float64) - mean32) * inv_std
        np.testing.assert_allclose(out["scaled"], scaled, rtol=1e-6, atol=1e-6)
        dist = np.sqrt(((scaled[:, None, :] - C64[None, :, :]) ** 2).sum(-1))
        top = np.sort(dist, axis=1)
        decided = top[:, 1] - top[:, 0] > KMEANS_MARGIN
        inside[i] = int((~decided).sum())
        np.testing.assert_array_equal(np.asarray(out["prediction"])[decided],
                                      np.argmin(dist, axis=1).astype(np.float64)[decided])

    config = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
    t0 = time.perf_counter()
    server = InferenceServer(pipeline, name="chip-smoke-kmeans", serving_config=config,
                             warmup_template=DataFrame.from_dict({"features": payloads[0][:1]}),
                             device="cuda")
    warmup_s = time.perf_counter() - t0
    scope = server.scope
    with server:
        plan = pipeline._fastpath_plan
        kinds = chain_kinds(plan)
        ingest = plan._ingest
        # The main path's run starts here: counts to 0, then traffic.
        for k in KERNELS:
            k.reset_launches()
        plain_calls, restore = _count_calls(mk, ("scale_kmeans_plain", "rowlocal_mlp_plain",
                                                 "scale_logistic_plain", "sparse_idf_logistic_plain"))
        batches_before = len(server.executed_batch_sizes)
        fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
        latencies = [None] * n_req
        failures = []

        def client(c):
            for i in range(c, n_req, N_CLIENTS):
                t_req = time.perf_counter()
                try:
                    resp = server.predict(DataFrame.from_dict({"features": payloads[i]}))
                    latencies[i] = (time.perf_counter() - t_req) * 1000.0
                    check(i, resp.dataframe)
                except BaseException as e:  # noqa: BLE001 — reported below, fails the run
                    failures.append(f"request {i} ({sizes[i]} rows): {type(e).__name__}: {e}")

        try:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            restore()
        if any(th.is_alive() for th in threads):
            raise AssertionError("serve_kmeans clients did not finish within 600 s")
        launches = mk.SCALE_KMEANS.launches
        other = {k.name: k.launches for k in KERNELS if k is not mk.SCALE_KMEANS}
        batches = server.executed_batch_sizes[batches_before:]
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    breakdown = _dense_batch_breakdown(
        plan, DataFrame.from_dict({"features": payloads[sizes.index(MAX_BATCH)]}), ingest)
    hot = sorted(b for b, kind in kinds.items() if "megakernel" in kind)
    if hot != [b for b in kinds if b >= KMEANS_HOT_FROM]:
        raise AssertionError(
            f"hot buckets {hot}: the cost model should mark every bucket from {KMEANS_HOT_FROM} rows")
    hot_batches = sum(1 for _, bucket in batches if bucket >= KMEANS_HOT_FROM)
    fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
    compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    if not launches > 0:
        raise AssertionError("the kmeans megakernel never launched on the main path")
    if launches != hot_batches:
        raise AssertionError(
            f"kmeans megakernel launches {launches} != batches of bucket >= {KMEANS_HOT_FROM} {hot_batches}")
    if fallback != 0:
        raise AssertionError(f"{fallback} batches fell back to the per-stage path")
    if compiles != 0:
        raise AssertionError(f"{compiles} chains were built after warmup")
    if plain_calls:
        raise AssertionError(f"plain megakernel versions were called: {sorted(set(plain_calls))}")
    if any(other.values()):
        raise AssertionError(f"other kernels launched during KMeans serving: {other}")
    lat = sorted(latencies)
    result = {
        "fit_rows": KMEANS_ROWS, "d": KMEANS_D, "k": KMEANS_K, "fit_s": fit_s,
        "warmup_s": warmup_s, "warmed_buckets": len(kinds),
        "requests": n_req, "rows": sum(sizes), "rows_inside_margin": sum(inside),
        "batches": len(batches),
        "hot_buckets": hot,
        "hot_batches": hot_batches,
        "megakernel_launches": launches,
        "fallback_batches": fallback,
        "post_warmup_builds": compiles,
        "plain_calls": len(plain_calls),
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(sizes) / wall,
        "wall_s": wall,
        "hot_batch_breakdown_ms": breakdown,
    }
    emit("serve_kmeans", card=card, **result)
    return launches


def _rowlocal_past_one_pass(inputs, ops):
    """Rows past one pass of the row-local kernel's persistent grid for a
    table without MLP heads: its lanes a row follow the widest slot (the
    inputs', 2 for a logistic head's rawPrediction)."""
    widest = max([t.shape[1] if t.dim() == 2 else 1 for t in inputs]
                 + [2 for op in ops if op.op == "logistic"])
    lanes = 1 << (widest - 1).bit_length() if widest <= 16 else 32
    return SMS_WARPS * (32 // lanes) + 1


def _ptxas(kernel):
    """A kernel source's registers a thread (each instance, as ptxas -v
    reported them in its build; cached, the build phase made it) and its
    spill stores and loads in bytes, summed over the instances."""
    import re

    from flink_ml_tpu_torch.native import build

    log = build(kernel.source).log
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    return {"source": kernel.source_path,
            "registers": [int(r) for r in re.findall(r"Used (\d+) registers", log)],
            "spill_store_bytes": sum(int(a) for a, _ in spills),
            "spill_load_bytes": sum(int(b) for _, b in spills)}


def _rowlocal_case(name, rows, d, dev, rng):
    """``(inputs, ops)`` of one row-local chain on ``dev``: standard-normal
    rows with, from 5 rows on, a zero row, a NaN, +inf and -inf; scalers with
    the zero-std guard; scalar columns with a tenth of their entries missing
    (NaN, or a placeholder float32 cannot hold exactly, 0.1)."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.servable.megakernels import RowLocalOp

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    x = rng.standard_normal((rows, d)).astype(np.float32)
    if rows >= 5:
        x[1] = 0.0
        x[2, d // 2] = np.nan
        x[3, 0] = np.inf
        x[4, d - 1] = -np.inf

    def inv_std():
        std = np.abs(rng.standard_normal(d)).astype(np.float32) + np.float32(0.5)
        std[0] = 0.0
        return t(np.where(std == 0.0, 0.0, 1.0 / np.where(std == 0.0, 1.0, std)))

    def positive(lo):
        return t(np.abs(rng.standard_normal(d)) + lo)

    def scale(src, with_mean=True, with_std=True):
        return RowLocalOp("scale", src, t(rng.standard_normal(d)), inv_std(),
                          {"with_mean": with_mean, "with_std": with_std})

    if name.startswith("scale_"):
        return [t(x)], [scale(0, name[-2] == "1", name[-1] == "1")]
    if name.startswith("normalize_"):
        return [t(x)], [RowLocalOp("normalize", 0, params={"p": float(name[-1])})]
    if name in ("product", "idf"):
        op = "elementwise_product" if name == "product" else "idf"
        return [t(x)], [RowLocalOp(op, 0, positive(0.1))]
    if name == "binarize":
        return [t(x), t(rng.standard_normal(rows)), t(x * 0.5)], [
            RowLocalOp("binarize", 0, params={"threshold": 0.05}),
            RowLocalOp("binarize", 1, params={"threshold": -0.3}),
            RowLocalOp("binarize", 2, params={"threshold": 0.0}),
        ]
    if name.startswith("impute_"):
        missing_is_nan = name == "impute_nan"
        cols = [rng.integers(0, 100, rows).astype(np.float32) for _ in range(3)]
        for c in cols:
            c[rng.random(rows) < IMPUTER_MISSING_SHARE] = np.float32(np.nan if missing_is_nan else 0.1)
        surrogates = t(rng.standard_normal(3))
        return [t(c) for c in cols], [
            RowLocalOp("impute", k, surrogates, params={"missing_is_nan": missing_is_nan,
                                                        "missing_value": 0.0 if missing_is_nan else 0.1,
                                                        "column": k})
            for k in range(3)
        ]
    ops = [
        scale(0),
        RowLocalOp("normalize", 1, params={"p": 2.0}),
        RowLocalOp("elementwise_product", 2, positive(0.1)),
        RowLocalOp("idf", 3, positive(0.2)),
        scale(4, with_mean=False),
        RowLocalOp("binarize", 5, params={"threshold": 0.05}),
    ]
    coef = t(rng.standard_normal(d) * (3.0 / np.sqrt(d)))
    if name == "feature6":
        return [t(x)], ops
    if name == "feature6_logistic":
        return [t(x)], ops + [RowLocalOp("logistic", 6, coef)]
    if name == "head_off_chain":  # the head reads the scaler's output, not the binarizer's
        return [t(x)], [scale(0), RowLocalOp("binarize", 1, params={"threshold": 0.0}),
                        RowLocalOp("logistic", 1, coef)]
    raise ValueError(name)


def _check_rowlocal(inputs, ops, got, want, where):
    """Each output of the kernel against the plain version's: bit-equal
    until a normalize; from a normalize on within ULP_ENVELOPE["feature6"];
    a binarize of such an input equal outside BIN_MARGIN of its threshold,
    the rows with an entry inside left out of everything downstream; the
    head's probability (rawPrediction[:, 1]) within
    ULP_ENVELOPE["scale_logistic"], rawPrediction[:, 0] = 1 - it in float32
    on both sides, and its prediction equal where the float64 margin
    exceeds PREDICTION_MARGIN.
    Returns ``(entries inside the margin, max |kernel - plain| compared,
    max ulps of the outputs from a normalize on)``."""
    import torch

    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff

    def fail(what):
        raise AssertionError(f"{what}: {where}")

    plain = list(inputs) + list(want)
    rows = int(inputs[0].shape[0])
    rounded = [False] * len(inputs)  # carries a normalize's rounding
    decided = [torch.ones(rows, dtype=torch.bool, device=inputs[0].device)] * len(inputs)
    inside, max_abs_err, max_ulps, k = 0, 0.0, 0, 0
    for op in ops:
        dec = decided[op.src]
        if op.op == "logistic":
            pred, raw = got[k], got[k + 1]
            if pred.shape != (rows,) or raw.shape != (rows, 2):
                fail(f"head shapes {tuple(pred.shape)} {tuple(raw.shape)}")
            # the probability p = rawPrediction[:, 1] within the envelope; its
            # complement [:, 0] is 1 - p in float32 on both sides (the ulp
            # distance of 1 - p is ill-conditioned where p rounds near 1)
            if ulp_diff(raw[dec, 1].cpu().numpy(), want[k + 1][dec, 1].cpu().numpy()) > ULP_ENVELOPE["scale_logistic"]:
                fail("the probability outside the scale_logistic envelope")
            if not (_same_bits(raw[:, 0], 1.0 - raw[:, 1]) and _same_bits(want[k + 1][:, 0], 1.0 - want[k + 1][:, 1])):
                fail("rawPrediction[:, 0] is not 1 - rawPrediction[:, 1]")
            margin = plain[op.src].double() @ op.a.double()
            sure = dec & (margin.abs() > PREDICTION_MARGIN)
            if not torch.equal(pred[sure], want[k][sure]):
                fail("prediction differs outside the margin")
            max_abs_err = max(max_abs_err, float(torch.nan_to_num(raw[dec] - want[k + 1][dec]).abs().max()
                                                 if bool(dec.any()) else 0.0))
            rounded += [True, True]
            decided += [dec, dec]
            k += 2
            continue
        g, w = got[k], want[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"output {k} {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        row_mask = dec if g.dim() == 1 else dec[:, None].expand_as(g)
        if op.op == "binarize" and rounded[op.src]:
            near = (plain[op.src] - op.params["threshold"]).abs() <= BIN_MARGIN
            if not torch.equal(g[row_mask & ~near], w[row_mask & ~near]):
                fail(f"binarize output {k} differs outside the margin")
            inside += int((row_mask & near).sum())
            dec = dec & ~(near if near.dim() == 1 else near.any(dim=1))
            rounded.append(False)
        elif rounded[op.src] or op.op == "normalize":
            ulps = ulp_diff(g[row_mask].cpu().numpy(), w[row_mask].cpu().numpy())
            if ulps > ULP_ENVELOPE["feature6"]:
                fail(f"output {k} outside the feature6 envelope")
            max_ulps = max(max_ulps, ulps)
            rounded.append(True)
        else:
            if not _same_bits(g[row_mask], w[row_mask]):
                fail(f"output {k} not bit-equal to the plain version")
            rounded.append(False)
        diff = torch.nan_to_num(g[row_mask] - w[row_mask], nan=0.0, posinf=0.0, neginf=0.0)
        if diff.numel():
            max_abs_err = max(max_abs_err, float(diff.abs().max()))
        decided.append(dec)
        k += 1
    return inside, max_abs_err, max_ulps


def _rowlocal_bound(inputs, ops, outputs):
    """``(bytes, operations)`` one call must move and do: each input and
    model vector the chain reads once, each output written once; per element
    scale 2, normalize 3 (power, add, divide), product/idf/binarize/impute 1,
    the head's dot 2, and per row a root for normalize and 4 for the head's
    sigmoid and prediction."""
    bytes_moved = sum(4 * t.numel() for t in inputs) + sum(4 * t.numel() for t in outputs)
    ops_count = 0
    slots = list(inputs) + list(outputs)
    per_element = {"scale": 2, "normalize": 3, "elementwise_product": 1, "idf": 1, "binarize": 1,
                   "impute": 1, "logistic": 2}
    for op in ops:
        x = slots[op.src]
        rows = int(x.shape[0])
        if op.op == "scale":
            bytes_moved += 4 * x.shape[1] * (int(op.params["with_mean"]) + int(op.params["with_std"]))
        elif op.op in ("elementwise_product", "idf", "logistic"):
            bytes_moved += 4 * op.a.numel()
        elif op.op == "impute":
            bytes_moved += 4  # its column's surrogate
        ops_count += per_element[op.op] * x.numel()
        ops_count += rows * {"normalize": 1, "logistic": 4}.get(op.op, 0)
    return bytes_moved, ops_count


def phase_kernels_rowlocal(rng, card: str):
    """The row-local megakernel against its plain version over chains ×
    widths × rows, then its times at the serving shape (module docstring,
    phase 15)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from flink_ml_tpu_torch.servable.megakernels import (
        ROWLOCAL,
        RowLocalOp,
        rowlocal_chain,
        rowlocal_chain_plain,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain head's dot in full float32
    emit("kernels_rowlocal", kernel=ROWLOCAL.name, compiled=_ptxas(ROWLOCAL))
    configurations, inside, max_abs_err, max_ulps = 0, 0, 0.0, 0
    for name in ROWLOCAL_CASES:
        for d in ROWLOCAL_CHECK_WIDTHS:
            past = _rowlocal_past_one_pass(*_rowlocal_case(name, 1, d, dev, np.random.default_rng(0)))
            for rows in ROWLOCAL_CHECK_ROWS + (past,):
                inputs, ops = _rowlocal_case(name, rows, d, dev, rng)
                got = rowlocal_chain(inputs, ops)
                want = rowlocal_chain_plain(inputs, ops)
                n_in, err, ulps = _check_rowlocal(inputs, ops, got, want, f"{name} rows={rows} d={d}")
                inside += n_in
                max_abs_err = max(max_abs_err, err)
                max_ulps = max(max_ulps, ulps)
                configurations += 1
    emit("kernels_rowlocal", kernel=ROWLOCAL.name, configurations=configurations,
         entries_inside_margin=inside, max_abs_err=max_abs_err, max_ulps_from_a_normalize_on=max_ulps,
         grid={"chains": list(ROWLOCAL_CASES), "d": list(ROWLOCAL_CHECK_WIDTHS),
               "rows": list(ROWLOCAL_CHECK_ROWS) + ["past one grid pass"]},
         rule=("bit-equal until a normalize; from it on within ULP_ENVELOPE['feature6']; bin equal "
               f"outside |x - threshold| <= {BIN_MARGIN}, such rows left out downstream; the probability "
               "rawPrediction[:, 1] within ULP_ENVELOPE['scale_logistic'] and [:, 0] = 1 - it in float32; "
               f"prediction equal where |margin| > {PREDICTION_MARGIN}"))

    rows, d = MAX_BATCH, FEATURE6_D
    timed = {}
    for name in ("feature6_logistic", "normalize_2"):
        inputs, ops = _rowlocal_case(name, rows, d, dev, np.random.default_rng(FEATURE6_SEED))
        timed[name] = (inputs, ops)
    x = timed["normalize_2"][0][0]
    imp_rng = np.random.default_rng(IMPUTER_SERVE_SEED)
    cols = []
    for _ in IMPUTER_COLS:
        c = imp_rng.integers(0, IMPUTER_ARITY, rows).astype(np.float32)
        c[imp_rng.random(rows) < IMPUTER_MISSING_SHARE] = np.nan
        cols.append(torch.from_numpy(c).to(dev))
    surrogates = torch.from_numpy(imp_rng.random(len(IMPUTER_COLS)).astype(np.float32) * IMPUTER_ARITY).to(dev)
    timed["impute_15"] = (cols, [RowLocalOp("impute", k, surrogates, params={
        "missing_is_nan": True, "missing_value": 0.0, "column": k}) for k in range(len(cols))])

    fns = {}
    for name, (inputs, ops) in timed.items():
        fns[name] = (lambda i=inputs, o=ops: rowlocal_chain(i, o))
        fns[name + "_plain"] = (lambda i=inputs, o=ops: rowlocal_chain_plain(i, o))
    fns["library_normalize"] = lambda: F.normalize(x, p=2.0, dim=1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    for fn in fns.values():  # warm-up
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    times = {n: {"cold": [], "warm": []} for n in fns}
    order = list(fns)
    # the wrappers' host work (outputs, the op table, ~45 plain launches)
    # outlasts the flush: ~0.5 ms of sleep holds the device until the call
    # is queued, and 50 warm calls fit inside _warm_time's 50 ms sleep
    for name in order + order[::-1]:  # each side twice, in turns
        times[name]["cold"] += _cold_times(fns[name], 50, flush, hold_cycles=1_000_000)
        times[name]["warm"].append(_warm_time(fns[name], 50))
    cold = {n: _median(v["cold"]) for n, v in times.items()}
    warm = {n: _median(v["warm"]) for n, v in times.items()}
    host_us = {}
    for name in ("feature6_logistic", "impute_15"):  # host enqueue time of one wrapper call
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(50):
            fns[name]()
        host_us[name] = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
    bounds = {}
    for name, (inputs, ops) in timed.items():
        b, o = _rowlocal_bound(inputs, ops, rowlocal_chain_plain(inputs, ops))
        bounds[name] = {"bytes": b, "ops": o, "bytes_ms": b / HBM_BYTES_PER_S * 1e3,
                        "ops_ms": o / F32_OPS_PER_S * 1e3}
    main = bounds["feature6_logistic"]
    timing = {
        "shape": {"rows": rows, "d": d, "chain": "feature6 -> logistic"},
        "ms": cold["feature6_logistic"],
        "ms_l2_warm": warm["feature6_logistic"],
        "plain_ms": cold["feature6_logistic_plain"],
        "plain_ms_l2_warm": warm["feature6_logistic_plain"],
        "normalize_alone_ms": cold["normalize_2"],
        "normalize_alone_ms_l2_warm": warm["normalize_2"],
        "normalize_alone_plain_ms": cold["normalize_2_plain"],
        "library_ms": cold["library_normalize"],
        "library_ms_l2_warm": warm["library_normalize"],
        "library": "torch.nn.functional.normalize(x, p=2, dim=1): the normalize op only (hold it "
                   "against normalize_alone); no single PyTorch call computes the chain",
        "impute_15_ms": cold["impute_15"],
        "impute_15_ms_l2_warm": warm["impute_15"],
        "impute_15_plain_ms": cold["impute_15_plain"],
        "wrapper_host_us_per_call": host_us,
        "bounds": bounds,
        "bytes": main["bytes"],
        "ops": main["ops"],
        "bound_ms": max(main["bytes_ms"], main["ops_ms"]),
        "bound_by": "bytes" if main["bytes_ms"] >= main["ops_ms"] else "operations",
    }
    emit("kernels_rowlocal", kernel=ROWLOCAL.name, card=card, **timing)
    return {"max_abs_err": max_abs_err, **timing}


def _feature6_stages(d):
    """bench.py ``_make_feature6_stages`` in the port's classes, its model
    data drawn from a seeded rng in the same order, and the logistic head's
    coefficient after it (``cold_start_feature6_logistic``)."""
    import numpy as np

    from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegressionModel
    from flink_ml_tpu_torch.models.feature.binarizer import Binarizer
    from flink_ml_tpu_torch.models.feature.elementwise_product import ElementwiseProduct
    from flink_ml_tpu_torch.models.feature.idf import IDFModel
    from flink_ml_tpu_torch.models.feature.normalizer import Normalizer
    from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScalerModel

    rng = np.random.default_rng(FEATURE6_SEED)
    scaler = StandardScalerModel().set_input_col("input").set_output_col("scaled")
    scaler.set_with_mean(True)
    scaler.mean = rng.standard_normal(d)
    scaler.std = np.abs(rng.standard_normal(d)) + 0.5
    idf = IDFModel().set_input_col("weighted").set_output_col("tfidf")
    idf.idf = np.abs(rng.standard_normal(d)) + 0.2
    idf.doc_freq = np.ones(d)
    idf.num_docs = np.asarray(float(FEATURE6_N_DOCS))
    rescale = StandardScalerModel().set_input_col("tfidf").set_output_col("rescaled")
    rescale.set_with_mean(False)
    rescale.mean = np.zeros(d)
    rescale.std = np.abs(rng.standard_normal(d)) + 0.5
    stages = [
        scaler,
        Normalizer().set_input_col("scaled").set_output_col("norm"),
        ElementwiseProduct().set_scaling_vec(np.abs(rng.standard_normal(d)) + 0.1)
        .set_input_col("norm").set_output_col("weighted"),
        idf,
        rescale,
        Binarizer().set_input_cols("rescaled").set_output_cols("bin").set_thresholds(0.05),
    ]
    lr = LogisticRegressionModel().set_features_col("bin")
    lr.coefficient = rng.standard_normal(d)
    return stages + [lr]


def _serve_and_check(server, payloads, column, check, n_clients=N_CLIENTS):
    """Closed-loop clients, one request at a time each, every response
    checked; returns ``(latencies ms, wall s, failures)``. A payload is
    an array for ``column`` or a dict of columns."""
    from flink_ml_tpu_torch.api.dataframe import DataFrame

    latencies = [None] * len(payloads)
    failures = []

    def client(c):
        for i in range(c, len(payloads), n_clients):
            t_req = time.perf_counter()
            try:
                frame = payloads[i] if isinstance(payloads[i], dict) else {column: payloads[i]}
                resp = server.predict(DataFrame.from_dict(frame))
                latencies[i] = (time.perf_counter() - t_req) * 1000.0
                check(i, resp.dataframe)
            except BaseException as e:  # noqa: BLE001 — reported by the caller, fails the run
                failures.append(f"request {i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        raise AssertionError("clients did not finish within 600 s")
    return latencies, wall, failures


_PLAIN_MEGAKERNELS = ("rowlocal_chain_plain", "rowlocal_mlp_plain", "scale_kmeans_plain",
                      "scale_logistic_plain", "sparse_idf_logistic_plain", "sparse_idf_plain")


def phase_serve_feature6(card: str):
    """feature6 → LogisticRegression saved, loaded and served (module
    docstring, phase 16)."""
    import tempfile

    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.servable import PipelineModelServable, load_servable
    from flink_ml_tpu_torch.servable.fusion import chain_score
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    d = FEATURE6_D
    stages = _feature6_stages(d)
    with tempfile.TemporaryDirectory() as tmp:
        for i, stage in enumerate(stages):
            stage.save(f"{tmp}/{i}")
        pipeline = PipelineModelServable([load_servable(f"{tmp}/{i}") for i in range(len(stages))])
    specs = [s.kernel_spec() for s in pipeline.servables]
    per_row = chain_score(specs, 1, width=d)
    if not mk.chain_eligible(specs):
        raise AssertionError("feature6 -> logistic is not a row-local megakernel chain")
    scaler, _norm, product, idf, rescale, _bin, lr = pipeline.servables
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)  # noqa: E731
    mean, inv_std = f32(scaler.mean), scaler._inv_std().astype(np.float64)
    scaling, idf32, inv_std2 = f32(product._scaling_array()), f32(idf.idf), rescale._inv_std().astype(np.float64)
    coef = f32(lr.coefficient)
    threshold = float(np.float32(0.05))

    rng = np.random.default_rng(FEATURE6_SERVE_SEED)
    n_req = N_CLIENTS * REQUESTS_PER_CLIENT
    sizes = [int(min(MAX_BATCH, max(1, round(2 ** rng.uniform(0, 12))))) for _ in range(n_req)]
    sizes[::16] = [MAX_BATCH, MAX_BATCH * 1500 // 4096, MAX_BATCH // 2,
                   MAX_BATCH * 600 // 4096][: len(sizes[::16])]  # hot buckets on every run
    payloads = [rng.standard_normal((n, d)) for n in sizes]
    inside = [0] * n_req
    undecided_rows = [0] * n_req

    def check(i, out):
        x = payloads[i].astype(np.float32).astype(np.float64)
        scaled = (x - mean) * inv_std
        norm = scaled / np.linalg.norm(scaled, axis=1, keepdims=True)
        weighted = norm * scaling
        tfidf = weighted * idf32
        rescaled = tfidf * inv_std2
        for name, want in (("scaled", scaled), ("norm", norm), ("weighted", weighted),
                           ("tfidf", tfidf), ("rescaled", rescaled)):
            np.testing.assert_allclose(out[name], want, rtol=1e-5, atol=1e-6, err_msg=name)
        near = np.abs(rescaled - threshold) <= BIN_MARGIN
        inside[i] = int(near.sum())
        np.testing.assert_array_equal(np.asarray(out["bin"])[~near], (rescaled > threshold)[~near])
        rows_ok = ~near.any(axis=1)
        undecided_rows[i] = int((~rows_ok).sum())
        margin = (rescaled > threshold).astype(np.float64) @ coef
        p = 1.0 / (1.0 + np.exp(-margin))
        np.testing.assert_allclose(np.asarray(out["rawPrediction"])[rows_ok],
                                   np.stack([1.0 - p, p], axis=1)[rows_ok], rtol=0, atol=1e-5)
        sure = rows_ok & (np.abs(margin) > PREDICTION_MARGIN)
        np.testing.assert_array_equal(np.asarray(out["prediction"])[sure], (margin >= 0)[sure].astype(np.float64))

    config = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
    t0 = time.perf_counter()
    server = InferenceServer(pipeline, name="chip-smoke-feature6", serving_config=config,
                             warmup_template=DataFrame.from_dict({"input": payloads[0][:1]}), device="cuda")
    warmup_s = time.perf_counter() - t0
    scope = server.scope
    with server:
        plan = pipeline._fastpath_plan
        kinds = chain_kinds(plan)
        ingest = plan._ingest
        # The main path's run starts here: counts to 0, then traffic.
        for k in KERNELS:
            k.reset_launches()
        plain_calls, restore = _count_calls(mk, _PLAIN_MEGAKERNELS)
        batches_before = len(server.executed_batch_sizes)
        fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
        try:
            latencies, wall, failures = _serve_and_check(server, payloads, "input", check)
        finally:
            restore()
        launches = mk.ROWLOCAL.launches
        other = {k.name: k.launches for k in KERNELS if k is not mk.ROWLOCAL}
        batches = server.executed_batch_sizes[batches_before:]
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    breakdown = _dense_batch_breakdown(
        plan, DataFrame.from_dict({"input": payloads[sizes.index(MAX_BATCH)]}), ingest, col="input")
    hot = sorted(b for b, kind in kinds.items() if "megakernel" in kind)
    if per_row != 3556 or hot != [b for b in kinds if b >= FEATURE6_HOT_FROM]:
        raise AssertionError(f"the chain scores {per_row} per row, hot buckets {hot}: the cost model "
                             f"should mark every bucket from {FEATURE6_HOT_FROM} rows (3556 per row)")
    hot_batches = sum(1 for _, bucket in batches if bucket >= FEATURE6_HOT_FROM)
    fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
    compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    if not launches > 0:
        raise AssertionError("the row-local megakernel never launched on the main path")
    if launches != hot_batches:
        raise AssertionError(f"row-local launches {launches} != batches of bucket >= "
                             f"{FEATURE6_HOT_FROM} {hot_batches}")
    if fallback != 0:
        raise AssertionError(f"{fallback} batches fell back to the per-stage path")
    if compiles != 0:
        raise AssertionError(f"{compiles} chains were built after warmup")
    if plain_calls:
        raise AssertionError(f"plain megakernel versions were called: {sorted(set(plain_calls))}")
    if any(other.values()):
        raise AssertionError(f"other kernels launched during feature6 serving: {other}")
    lat = sorted(latencies)
    result = {
        "d": d, "chain_score_per_row": per_row, "warmup_s": warmup_s, "warmed_buckets": len(kinds),
        "requests": n_req, "rows": sum(sizes), "bin_entries_inside_margin": sum(inside),
        "rows_with_a_bin_inside_margin": sum(undecided_rows),
        "batches": len(batches), "hot_buckets": hot, "hot_batches": hot_batches,
        "megakernel_launches": launches, "fallback_batches": fallback, "post_warmup_builds": compiles,
        "plain_calls": len(plain_calls),
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(sizes) / wall,
        "wall_s": wall,
        "hot_batch_breakdown_ms": breakdown,
    }
    emit("serve_feature6", card=card, **result)
    return launches


def _imputer_rows(seed, rows):
    """DoubleGenerator (flink_ml_tpu/benchmark/datagenerator.py) at arity
    100: per column, uniform integers below the arity, as float64."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {name: rng.integers(0, IMPUTER_ARITY, rows).astype(np.float64) for name in IMPUTER_COLS}


def phase_serve_imputer(card: str):
    """Imputer fitted on the published rows, saved, loaded and served
    (module docstring, phase 17)."""
    import tempfile

    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.config import Options, config
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.feature.imputer import Imputer
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.servable import PipelineModelServable, load_servable
    from flink_ml_tpu_torch.servable.fusion import chain_score
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    out_cols = [f"outputCol{i}" for i in range(len(IMPUTER_COLS))]
    t0 = time.perf_counter()
    model = (Imputer().set_input_cols(*IMPUTER_COLS).set_output_cols(*out_cols)
             .fit(DataFrame.from_dict(_imputer_rows(IMPUTER_SEED, IMPUTER_ROWS))))
    fit_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        model.save(f"{tmp}/imputer")
        pipeline = PipelineModelServable([load_servable(f"{tmp}/imputer")])
    surrogates = np.asarray(pipeline.servables[0].surrogates, np.float32).astype(np.float64)
    if not np.array_equal(pipeline.servables[0].surrogates, model.surrogates):
        raise AssertionError("the loaded surrogates differ from the fitted ones")
    per_row = chain_score([pipeline.servables[0].kernel_spec()], 1)

    rng = np.random.default_rng(IMPUTER_SERVE_SEED)
    n_req = N_CLIENTS * REQUESTS_PER_CLIENT
    sizes = [int(min(MAX_BATCH, max(1, round(2 ** rng.uniform(0, 12))))) for _ in range(n_req)]
    sizes[::16] = [MAX_BATCH, MAX_BATCH * 1500 // 4096, MAX_BATCH // 2,
                   MAX_BATCH * 600 // 4096][: len(sizes[::16])]
    payloads = []
    for n in sizes:
        cols = _imputer_rows(int(rng.integers(1 << 31)), n)
        for c in cols.values():
            c[rng.random(n) < IMPUTER_MISSING_SHARE] = np.nan
        payloads.append(cols)
    missing = sum(int(np.isnan(c).sum()) for p in payloads for c in p.values())

    def check(i, out):
        for k, (name, o) in enumerate(zip(IMPUTER_COLS, out_cols)):
            x = payloads[i][name]
            want = np.where(np.isnan(x), surrogates[k], x.astype(np.float32).astype(np.float64))
            np.testing.assert_array_equal(np.asarray(out[o]), want, err_msg=o)

    # ("impute",) scores about 23 per row, far below the default bar of 10^6
    # at any bucket; the JAX package's own tests and bench lower it so
    config.set(Options.FUSION_MEGAKERNEL_MIN_SCORE, 1.0)
    try:
        cfg = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
        t0 = time.perf_counter()
        server = InferenceServer(pipeline, name="chip-smoke-imputer", serving_config=cfg,
                                 warmup_template=DataFrame.from_dict({n: c[:1] for n, c in payloads[0].items()}),
                                 device="cuda")
        warmup_s = time.perf_counter() - t0
        scope = server.scope
        with server:
            kinds = chain_kinds(pipeline._fastpath_plan)
            for k in KERNELS:
                k.reset_launches()
            plain_calls, restore = _count_calls(mk, _PLAIN_MEGAKERNELS)
            batches_before = len(server.executed_batch_sizes)
            fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
            compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
            try:
                latencies, wall, failures = _serve_and_check(server, payloads, None, check)
            finally:
                restore()
            launches = mk.ROWLOCAL.launches
            other = {k.name: k.launches for k in KERNELS if k is not mk.ROWLOCAL}
            batches = server.executed_batch_sizes[batches_before:]
    finally:
        config.unset(Options.FUSION_MEGAKERNEL_MIN_SCORE)
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
    compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    if any("megakernel" not in k for k in kinds.values()):
        raise AssertionError(f"at min score 1.0 every bucket should run the megakernel: {kinds}")
    if launches != len(batches) or not launches > 0:
        raise AssertionError(f"row-local launches {launches} != batches {len(batches)}")
    if fallback != 0 or compiles != 0:
        raise AssertionError(f"{fallback} fallback batches, {compiles} post-warmup builds")
    if plain_calls:
        raise AssertionError(f"plain megakernel versions were called: {sorted(set(plain_calls))}")
    if any(other.values()):
        raise AssertionError(f"other kernels launched during imputer serving: {other}")
    lat = sorted(latencies)
    result = {
        "columns": len(IMPUTER_COLS), "fit_rows": IMPUTER_ROWS, "fit_s": fit_s,
        "surrogates": surrogates.tolist(), "chain_score_per_row": per_row,
        "min_score": 1.0, "warmup_s": warmup_s, "warmed_buckets": len(kinds),
        "requests": n_req, "rows": sum(sizes), "missing_entries": missing,
        "batches": len(batches), "megakernel_launches": launches,
        "fallback_batches": fallback, "post_warmup_builds": compiles, "plain_calls": len(plain_calls),
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(sizes) / wall,
        "wall_s": wall,
        "checked": "exact: every output equals where(isnan(x), float32 surrogate, x)",
    }
    emit("serve_imputer", card=card, **result)
    return launches


def _flash_inputs(gen, BH, Tq, Tk, d, state, dev):
    """q, k, v, m, l, acc of one fold, drawn on the card from ``gen``:
    ``first`` is a first fold's state, ``carried`` a finite one, ``mixed``
    carried with every third row still at -inf."""
    import torch

    q, k, v = (torch.randn((1, BH, n, d), generator=gen, device=dev) for n in (Tq, Tk, Tk))
    if state == "first":
        m = torch.full((1, BH, Tq), -torch.inf, device=dev)
        l = torch.zeros((1, BH, Tq), device=dev)
        acc = torch.zeros((1, BH, Tq, d), device=dev)
    else:
        m = torch.randn((1, BH, Tq), generator=gen, device=dev)
        l = torch.randn((1, BH, Tq), generator=gen, device=dev).abs() + 1.0
        acc = torch.randn((1, BH, Tq, d), generator=gen, device=dev)
        if state == "mixed":
            m[..., ::3], l[..., ::3], acc[..., ::3, :] = -torch.inf, 0.0, 0.0
    return [q, k, v, m, l, acc]


def _flash_positions(name, Tq, Tk):
    return {"aligned": (0, 0), "kv_before": (Tk + 5, 0), "kv_after": (0, Tq + 5),
            "straddle": (37, 0)}[name]


def _check_flash(got, want, inputs, idle, s_mag, where):
    """The fold kernel against the plain fold: m within FLASH_M_RTOL of
    |m| + ``s_mag`` (the row's largest scale · Σ_d |q_d k_d|: a score is a
    dot product, and one that cancels to near 0 keeps the error of its
    terms), l and acc within FLASH_RTOL; rows with no attendable key exact
    (finite m in: m, l, acc unchanged bit for bit; -inf in: -inf, 0, 0);
    m_out >= m_in; no NaN. Returns (max |kernel - plain|, exact rows kept,
    exact rows reset)."""
    import torch

    m_in, l_in, acc_in = inputs
    gm, gl, ga = got
    wm, wl, wa = want
    for g in got:
        if torch.isnan(g).any():
            raise AssertionError(f"NaN in the kernel's output: {where}")
    if not torch.equal(torch.isneginf(gm), torch.isneginf(wm)):
        raise AssertionError(f"m is -inf on other rows than the plain fold's: {where}")
    if not torch.all(gm >= m_in):
        raise AssertionError(f"m_out < m_in: {where}")
    fin = torch.isfinite(wm)
    errs = []
    for name, g, w, rtol in (("m", gm[fin], wm[fin], FLASH_M_RTOL), ("l", gl, wl, FLASH_RTOL),
                             ("acc", ga, wa, FLASH_RTOL)):
        if not g.numel():
            continue
        scale = s_mag[fin] if name == "m" else max(1.0, float(w.abs().max()))
        err = (g - w).abs()
        if not torch.all(err <= rtol * w.abs() + rtol * scale):
            raise AssertionError(f"{name}: max |kernel - plain| {float(err.max())} past rtol {rtol}: {where}")
        errs.append(float(err.max()))
    seen = torch.isfinite(m_in)
    kept, fresh = seen & idle, ~seen & idle
    if not (torch.equal(gm[kept], m_in[kept]) and torch.equal(gl[kept], l_in[kept])
            and torch.equal(ga[kept], acc_in[kept])):
        raise AssertionError(f"a row with nothing attendable changed its finite state: {where}")
    if not (torch.all(torch.isneginf(gm[fresh])) and torch.all(gl[fresh] == 0) and torch.all(ga[fresh] == 0)):
        raise AssertionError(f"a row with nothing attendable and m -inf is not (-inf, 0, 0): {where}")
    return max(errs, default=0.0), int(kept.sum()), int(fresh.sum())


def _attends(Tq, Tk, q_pos0, k_pos0, causal, n_valid, dev):
    """[Tq, Tk]: whether each query attends each key of the block."""
    import torch

    q_pos = q_pos0 + torch.arange(Tq, device=dev)[:, None]
    k_pos = k_pos0 + torch.arange(Tk, device=dev)[None, :]
    keep = torch.ones((Tq, Tk), dtype=torch.bool, device=dev)
    if causal:
        keep &= q_pos >= k_pos
    if n_valid is not None:
        keep &= k_pos < n_valid
    return keep


def _idle_rows(BH, Tq, Tk, q_pos0, k_pos0, causal, n_valid, dev):
    """[1, BH, Tq]: the queries with no attendable key in the block."""
    return (~_attends(Tq, Tk, q_pos0, k_pos0, causal, n_valid, dev).any(dim=1))[None, None, :].expand(1, BH, Tq)


def _flash_bound(BH, Tq, Tk, d, causal):
    """Bytes (each input read once, each output written once) and the
    operations this run's masks leave: 4·D per attendable (query, key) pair
    (q·k and p·v, a multiply and an add each)."""
    bytes_moved = 4 * BH * (3 * Tq * d + 2 * Tk * d + 4 * Tq)
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk  # causal at q_pos0 = k_pos0 = 0, Tq == Tk
    ops = 4 * BH * pairs * d
    return bytes_moved, ops


def _flash_extra_cases(gen, dev):
    """The grid's contract on two more kinds of input, over the seven flag
    cases at FLASH_EXTRA_SHAPE: every key the same vector (a run of one
    token; every attendable score of a row ties) at FLASH_EQUAL_KEYS_D, and
    D FLASH_UNALIGNED_D with every tensor starting 4 bytes past a 16-byte
    boundary. Returns {kind: {"configurations", "max_abs_err"}}."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.parallel import fused_fold, reference_fold

    def shifted(x):
        y = torch.empty(x.numel() + 1, device=dev)[1:].view_as(x)
        y.copy_(x)
        if y.data_ptr() % 16 != 4:
            raise AssertionError("the shifted copy is not 4 bytes past a 16-byte boundary")
        return y

    BH, Tq, Tk = FLASH_EXTRA_SHAPE
    out = {}
    for kind, dims in (("every_key_equal", FLASH_EQUAL_KEYS_D), ("unaligned", (FLASH_UNALIGNED_D,))):
        configurations, max_abs_err = 0, 0.0
        for d in dims:
            for causal, nv_case, state, pos in FLASH_FLAG_CASES:
                q_pos0, k_pos0 = _flash_positions(pos, Tq, Tk)
                n_valid = {None: None, "inside": k_pos0 + max(1, Tk // 2), "before": k_pos0}[nv_case]
                inputs = _flash_inputs(gen, BH, Tq, Tk, d, state, dev)
                if kind == "every_key_equal":
                    inputs[1] = inputs[1][:, :, :1].expand(1, BH, Tk, d).contiguous()
                else:
                    inputs = [shifted(x) for x in inputs]
                scale = 1.0 / np.sqrt(d)
                got = fused_fold(*inputs, q_pos0, k_pos0, causal, n_valid, scale)
                want = reference_fold(*inputs, q_pos0, k_pos0, causal, n_valid, scale)
                where = f"{kind} d={d} causal={causal} n_valid={n_valid} {state} q_pos0={q_pos0} k_pos0={k_pos0}"
                idle = _idle_rows(BH, Tq, Tk, q_pos0, k_pos0, causal, n_valid, dev)
                s_mag = scale * torch.einsum("bhqd,bhkd->bhqk", inputs[0].abs(), inputs[1].abs()).amax(-1)
                err, _, _ = _check_flash(got, want, inputs[3:], idle, s_mag, where)
                max_abs_err = max(max_abs_err, err)
                configurations += 1
        out[kind] = {"configurations": configurations, "max_abs_err": max_abs_err}
    return out


def _built_sass(kernel):
    """``kernel``'s build (its library and nvcc's log, with the ptxas -v
    lines) and the SASS of its library (cuobjdump --dump-sass)."""
    from pathlib import Path

    from flink_ml_tpu_torch.native import _nvcc, build

    res = build(kernel.source)
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(res.library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    return res, sass


def _fold_compiled(kernel):
    """What the compiler made of ``kernel``'s source: for each template
    width, the registers a thread and the spill stores and loads (ptxas -v),
    and the tensor-core instructions in its SASS (cuobjdump): HGMMA is
    wgmma, HMMA mma.sync. Raises unless every fold kernel holds HGMMA."""
    import re

    res, sass = _built_sass(kernel)
    widths, current = {}, None
    for line in res.log.splitlines():
        hit = re.search(r"Compiling entry function '([^']*)'", line)
        if hit:
            width = re.search(r"kernelILi(\d+)E", hit.group(1))
            current = widths.setdefault(int(width.group(1)) if width else hit.group(1), {})
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            current["spill_store_bytes"], current["spill_load_bytes"] = int(spill.group(1)), int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            current["registers"] = int(regs.group(1))
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        width = re.search(r"kernelILi(\d+)E", block.split("\n", 1)[0])
        if width and int(width.group(1)) in widths:
            entry = widths[int(width.group(1))]
            entry["hgmma"] = len(re.findall(r"\bHGMMA\.", block))
            entry["hmma"] = len(re.findall(r"\bHMMA\.", block))
    for width, entry in widths.items():
        if not entry.get("hgmma"):
            raise AssertionError(f"{kernel.name} at width {width}: no HGMMA in its SASS: {entry}")
    return {"source": kernel.source_path, "by_width": widths}


def phase_kernels_flash(rng, card: str):
    """The ring-attention fold kernel against the plain fold over a grid,
    a four-fold ring chain against float64 dense attention, then its times
    at bench.py's attention shape (module docstring, phase 18)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from flink_ml_tpu_torch.parallel import FLASH_FOLD, fused_fold, reference_fold

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain fold's einsums in full float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    configurations, kept_rows, reset_rows, max_abs_err = 0, 0, 0, 0.0
    for BH in FLASH_GRID_BH:
        for Tq in FLASH_GRID_TQ:
            for Tk in FLASH_GRID_TK:
                for d in FLASH_GRID_D:
                    for causal, nv_case, state, pos in FLASH_FLAG_CASES:
                        q_pos0, k_pos0 = _flash_positions(pos, Tq, Tk)
                        n_valid = {None: None, "inside": k_pos0 + max(1, Tk // 2), "before": k_pos0}[nv_case]
                        inputs = _flash_inputs(gen, BH, Tq, Tk, d, state, dev)
                        scale = 1.0 / np.sqrt(d)
                        got = fused_fold(*inputs, q_pos0, k_pos0, causal, n_valid, scale)
                        want = reference_fold(*inputs, q_pos0, k_pos0, causal, n_valid, scale)
                        where = (f"BH={BH} Tq={Tq} Tk={Tk} d={d} causal={causal} n_valid={n_valid} "
                                 f"{state} q_pos0={q_pos0} k_pos0={k_pos0}")
                        idle = _idle_rows(BH, Tq, Tk, q_pos0, k_pos0, causal, n_valid, dev)
                        s_mag = scale * torch.einsum("bhqd,bhkd->bhqk", inputs[0].abs(), inputs[1].abs()).amax(-1)
                        err, kept, reset = _check_flash(got, want, inputs[3:], idle, s_mag, where)
                        max_abs_err = max(max_abs_err, err)
                        kept_rows += kept
                        reset_rows += reset
                        configurations += 1
    if not (kept_rows and reset_rows):
        raise AssertionError("the grid reached no row of one of the exact edges")
    extra = _flash_extra_cases(gen, dev)
    max_abs_err = max(max_abs_err, *(e["max_abs_err"] for e in extra.values()))
    emit("kernels_flash", kernel=FLASH_FOLD.name, configurations=configurations, max_abs_err=max_abs_err,
         m_rtol=FLASH_M_RTOL, l_acc_rtol=FLASH_RTOL, exact_rows_kept=kept_rows, exact_rows_reset=reset_rows,
         **extra)
    emit("kernels_flash", kernel=FLASH_FOLD.name, compiled=_fold_compiled(FLASH_FOLD))

    # one Q block folded against four K/V blocks in ring order, causal with
    # n_valid, at the positions a four-shard ring gives each shard
    shards, T, BH, d = FLASH_CHAIN
    q, k, v = (torch.from_numpy(rng.standard_normal((1, BH, shards * T, d)).astype(np.float32)).to(dev)
               for _ in range(3))
    n_valid = shards * T - T // 3 - 1  # inside the last block, off the tile grid
    chain_err = 0.0
    for me in range(shards):
        q_blk = q[:, :, me * T:(me + 1) * T].contiguous()
        m = torch.full((1, BH, T), -torch.inf, device=dev)
        l = torch.zeros((1, BH, T), device=dev)
        acc = torch.zeros((1, BH, T, d), device=dev)
        for step in range(shards):
            src = (me - step) % shards
            blk = slice(src * T, (src + 1) * T)
            m, l, acc = fused_fold(q_blk, k[:, :, blk].contiguous(), v[:, :, blk].contiguous(), m, l, acc,
                                   me * T, src * T, True, n_valid, 1.0 / np.sqrt(d))
        out = (acc / l.clamp(min=1e-30)[..., None]).double()
        s = torch.einsum("bhqd,bhkd->bhqk", q_blk.double(), k.double()) / np.sqrt(d)
        q_pos = me * T + torch.arange(T, device=dev)[:, None]
        k_pos = torch.arange(shards * T, device=dev)[None, :]
        s = torch.where((q_pos >= k_pos) & (k_pos < n_valid), s, -torch.inf)
        want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.double())
        err = (out - want).abs()
        if not torch.all(err <= FLASH_CHAIN_RTOL * want.abs() + FLASH_CHAIN_ATOL):
            raise AssertionError(f"four-fold chain, shard {me}: max error {float(err.max())} vs float64 dense")
        chain_err = max(chain_err, float(err.max()))
        del s, want
    emit("kernels_flash", chain={"shards": shards, "t_per_shard": T, "bh": BH, "d": d, "causal": True,
                                 "n_valid": n_valid, "max_abs_err_vs_float64": chain_err,
                                 "rtol": FLASH_CHAIN_RTOL, "atol": FLASH_CHAIN_ATOL})
    del q, k, v

    # times at ring_attention_causal_T8192_h4_d128, causal and not
    B, T, H, d = FLASH_TIMED
    scale = 1.0 / np.sqrt(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, d)).astype(np.float32)).to(dev) for _ in range(3))
    m0 = torch.full((B, H, T), -torch.inf, device=dev)
    l0 = torch.zeros((B, H, T), device=dev)
    acc0 = torch.zeros((B, H, T, d), device=dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    timings = {}
    for causal in (False, True):
        # the kernel against the plain fold at this shape, before timing it
        where = f"timed shape B={B} T={T} H={H} d={d} causal={causal}"
        got = fused_fold(q, k, v, m0, l0, acc0, 0, 0, causal, None, scale)
        want = reference_fold(q, k, v, m0, l0, acc0, 0, 0, causal, None, scale)
        idle = _idle_rows(B * H, T, T, 0, 0, causal, None, dev)
        s_mag = scale * torch.einsum("bhqd,bhkd->bhqk", q.abs(), k.abs()).amax(-1)
        timed_err, _, _ = _check_flash(got, want, [m0, l0, acc0], idle, s_mag, where)
        max_abs_err = max(max_abs_err, timed_err)
        del got, want, s_mag
        fns = {
            "kernel": lambda: fused_fold(q, k, v, m0, l0, acc0, 0, 0, causal, None, scale),
            "kernel_normalized": lambda: (lambda m, l, a: a / l.clamp(min=1e-30)[..., None])(
                *fused_fold(q, k, v, m0, l0, acc0, 0, 0, causal, None, scale)),
            "plain": lambda: reference_fold(q, k, v, m0, l0, acc0, 0, 0, causal, None, scale),
            "library": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
        }
        got = fns["kernel_normalized"]()
        lib = fns["library"]()
        torch.cuda.synchronize()
        lib_err = float((got - lib).abs().max())
        times = {n: {"cold": [], "warm": []} for n in fns}
        for fn in fns.values():  # warm-up
            fn()
        torch.cuda.synchronize()
        for name in ("plain", "kernel", "kernel_normalized", "library", "library", "kernel_normalized",
                     "kernel", "plain"):
            times[name]["cold"] += _cold_times(fns[name], 5, flush)
            times[name]["warm"].append(_warm_time(fns[name], 5))
        bytes_moved, ops = _flash_bound(B * H, T, T, d, causal)
        # the products are 3xTF32: three TF32 operations each at the TF32 peak; the
        # float32 CUDA-core bound of the same work stays beside it, comparable with float32-FMA kernels
        bytes_ms, ops_ms = bytes_moved / HBM_BYTES_PER_S * 1e3, 3 * ops / TF32_OPS_PER_S * 1e3
        ms = _median(times["kernel"]["cold"])
        timings["causal" if causal else "non_causal"] = {
            "ms": _median(times["kernel"]["cold"]), "ms_l2_warm": _median(times["kernel"]["warm"]),
            "ms_with_normalize": _median(times["kernel_normalized"]["cold"]),
            "plain_ms": _median(times["plain"]["cold"]), "plain_ms_l2_warm": _median(times["plain"]["warm"]),
            "library_ms": _median(times["library"]["cold"]),
            "library_ms_l2_warm": _median(times["library"]["warm"]),
            "library_max_abs_diff": lib_err, "max_abs_err_vs_plain": timed_err,
            "bytes": bytes_moved, "ops": ops, "tf32_ops": 3 * ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_ms_f32": max(bytes_ms, ops / F32_OPS_PER_S * 1e3),
            "achieved_tflops": ops / (ms * 1e-3) / 1e12,
            "achieved_tf32_tflops": 3 * ops / (ms * 1e-3) / 1e12,
            "tf32_peak_share": 3 * ops / (ms * 1e-3) / TF32_OPS_PER_S,
        }
    del q, k, v, flush
    torch.cuda.empty_cache()
    main = timings["non_causal"]  # the serving path's fold is non-causal
    timing = {
        "shape": {"B": B, "T": T, "H": H, "D": d, "name": "ring_attention_causal_T8192_h4_d128"},
        "ms": main["ms"], "ms_l2_warm": main["ms_l2_warm"], "plain_ms": main["plain_ms"],
        "library_ms": main["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention(q, k, v): one call for "
                   "fold + acc / l (hold it against ms_with_normalize)",
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "bound_ms_f32": main["bound_ms_f32"],
        "tf32_peak_share": main["tf32_peak_share"], "by_mask": timings,
    }
    emit("kernels_flash", kernel=FLASH_FOLD.name, card=card, **timing)
    return {"max_abs_err": max_abs_err, **timing}


def _attention_float64(params64, tok, n_heads, control=None):
    """Logits of one document [T] in float64 on the card, attention dense,
    and the attention output [H, T, D]: the reference the float32 path is
    held against. ``control`` "bf16_qkv" rounds the projections to bfloat16
    first; "uniform" gives every key the same weight (all scores equal),
    what a fold that ignored q · k would compute."""
    import torch

    T = tok.shape[0]
    E = params64["emb"].shape[1]
    h = params64["emb"][tok]  # [T, E]
    q, k, v = ((h @ params64[w]).reshape(T, n_heads, E // n_heads).transpose(0, 1) for w in ("wq", "wk", "wv"))
    if control == "bf16_qkv":
        q, k, v = (x.to(torch.bfloat16).to(torch.float64) for x in (q, k, v))
    if control == "uniform":
        attn = v.mean(dim=1, keepdim=True).expand(-1, T, -1)
    else:
        p = torch.softmax(torch.einsum("hqd,hkd->hqk", q, k) / (E // n_heads) ** 0.5, dim=-1)
        attn = torch.einsum("hqk,hkd->hqd", p, v)
        del p
    pooled = (attn.transpose(0, 1).reshape(T, E) @ params64["wo"] + h).mean(dim=0)
    return pooled @ params64["w_cls"] + params64["b_cls"], attn


def phase_serve_attention(card: str):
    """SelfAttentionClassifierModel at bench.py's width, saved, loaded and
    run on the card over three frames, held against float64 dense
    attention (module docstring, phase 19)."""
    import tempfile

    import numpy as np
    import torch

    import flink_ml_tpu_torch.parallel.flash as flash_mod
    import flink_ml_tpu_torch.parallel.ring as ring_mod
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.models.classification.attention_classifier import (
        SelfAttentionClassifierModel,
        _init_params,
    )
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.parallel import FLASH_FOLD, reference_fold
    from flink_ml_tpu_torch.utils import read_write as rw

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = SelfAttentionClassifierModel().set_embedding_dim(ATTN_E).set_num_heads(ATTN_H)
    model.set_vocab_size(ATTN_VOCAB)
    model.params = _init_params(np.random.default_rng(ATTN_PARAM_SEED), ATTN_VOCAB, ATTN_E, ATTN_CLASSES)
    model.labels = np.arange(ATTN_CLASSES, dtype=np.float64)
    with tempfile.TemporaryDirectory() as tmp:
        model.save(f"{tmp}/attn")
        loaded = SelfAttentionClassifierModel.load(f"{tmp}/attn")
        staged = rw.load_stage(f"{tmp}/attn")
    for name, a in model.params.items():
        if not (np.array_equal(loaded.params[name], a) and np.array_equal(staged.params[name], a)):
            raise AssertionError(f"{name} differs after save and load")
    model = loaded
    params64 = {n: torch.from_numpy(np.asarray(a, np.float64)).to(dev) for n, a in model.params.items()}
    rng = np.random.default_rng(ATTN_TOKEN_SEED)
    frames = [rng.integers(0, ATTN_VOCAB, size=shape) for shape in ATTN_FRAMES]
    dfs = [DataFrame.from_dict({"features": tok.astype(np.float64)}) for tok in frames]
    model.transform(dfs[2])  # warm: the library loaded, cuBLAS handles made
    torch.cuda.synchronize()

    # every fold the path runs is kept, inputs and outputs, to be held
    # against the plain fold and float64 attention after the run
    real_fold, captured = ring_mod.fused_fold, []

    def kept_fold(*args):
        out = real_fold(*args)
        captured.append((args, out))
        return out

    results, folds, launches = [], 0, 0
    for k in KERNELS:
        k.reset_launches()
    plain_calls, restore = _count_calls(flash_mod, ("reference_fold",))
    ring_mod.fused_fold = kept_fold
    try:
        for tok, df in zip(frames, dfs):
            before, n_captured = FLASH_FOLD.launches, len(captured)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.transform(df)
            wall = time.perf_counter() - t0  # ends with the readback
            folds += 1  # one fold per transform: the ring is one shard
            if len(captured) != n_captured + 1:
                raise AssertionError(f"{len(captured) - n_captured} folds in one transform, expected 1")
            results.append((tok, out, wall, FLASH_FOLD.launches - before, captured[-1]))
        launches = FLASH_FOLD.launches
        other = {k.name: k.launches for k in KERNELS if k is not FLASH_FOLD}
    finally:
        ring_mod.fused_fold = real_fold
        restore()
    del captured
    if launches != folds or any(r[3] != 1 for r in results):
        raise AssertionError(f"flash_fold launches {launches} != folds run {folds}")
    if plain_calls:
        raise AssertionError(f"the plain fold was called on the card's path: {plain_calls}")
    if any(other.values()):
        raise AssertionError(f"other kernels launched during attention serving: {other}")

    frames_out, worst, worst_bf16, undecided = [], 0.0, 0.0, 0
    fold_err, attn_err, attn_bf16, attn_uniform, prob_uniform = 0.0, 0.0, math.inf, math.inf, 0.0
    for tok, out, wall, _, (fold_args, fold_out) in results:
        probs = np.asarray(out.column("rawPrediction"))
        pred = np.asarray(out.column("prediction"))
        if probs.shape != (tok.shape[0], ATTN_CLASSES) or not np.all(np.isfinite(probs)):
            raise AssertionError(f"rawPrediction has shape {probs.shape} or a non-finite value")
        tensors, (q_pos0, k_pos0, causal, n_valid, scale) = fold_args[:6], fold_args[6:]
        if tensors[0].shape[:2] != (tok.shape[0], ATTN_H) or tensors[0].shape[2] != tok.shape[1]:
            raise AssertionError(f"the fold ran at {tuple(tensors[0].shape)} for a {tok.shape} frame")
        errs, errs_bf16 = [], []
        for i in range(tok.shape[0]):  # one document at a time: [4, T, T] float64 scores
            where = f"serve_attention frame {tok.shape}, document {i}"
            # the main path's own fold of this document against the plain fold
            ins = [x[i:i + 1] for x in tensors]
            got = [x[i:i + 1] for x in fold_out]
            want = reference_fold(*ins, q_pos0, k_pos0, causal, n_valid, scale)
            idle = _idle_rows(ATTN_H, tok.shape[1], tok.shape[1], q_pos0, k_pos0, causal, n_valid, dev)
            s_mag = scale * torch.einsum("bhqd,bhkd->bhqk", ins[0].abs(), ins[1].abs()).amax(-1)
            fold_err = max(fold_err, _check_flash(got, want, ins[3:], idle, s_mag, where)[0])
            del want, s_mag
            # its output against float64 dense attention, and the two controls
            t = torch.from_numpy(tok[i]).to(dev)
            logits, attn64 = _attention_float64(params64, t, ATTN_H)
            attn32 = (got[2] / got[1].clamp(min=1e-30)[..., None])[0].double()
            err = float((attn32 - attn64).abs().max())
            if not err <= ATTN_OUT_ATOL:
                raise AssertionError(f"fold output {err} from float64 attention > {ATTN_OUT_ATOL}: {where}")
            attn_err = max(attn_err, err)
            want = torch.softmax(logits, dim=-1).cpu().numpy()
            logits_bf16, attn_c = _attention_float64(params64, t, ATTN_H, control="bf16_qkv")
            attn_bf16 = min(attn_bf16, float((attn_c - attn64).abs().max()))
            control = torch.softmax(logits_bf16, dim=-1).cpu().numpy()
            logits_uniform, attn_c = _attention_float64(params64, t, ATTN_H, control="uniform")
            attn_uniform = min(attn_uniform, float((attn_c - attn64).abs().max()))
            prob_uniform = max(prob_uniform,
                               float(np.abs(torch.softmax(logits_uniform, dim=-1).cpu().numpy() - want).max()))
            del attn64, attn_c
            errs.append(float(np.abs(probs[i] - want).max()))
            errs_bf16.append(float(np.abs(control - want).max()))
            top2 = np.sort(logits.cpu().numpy())[-2:]
            if top2[1] - top2[0] > ATTN_MARGIN:
                if pred[i] != model.labels[int(np.argmax(logits.cpu().numpy()))]:
                    raise AssertionError(f"prediction differs past the {ATTN_MARGIN} logit gap: doc {i}")
            else:
                undecided += 1
        if max(errs) > ATTN_PROB_ATOL:
            raise AssertionError(f"probabilities {max(errs)} from float64 > {ATTN_PROB_ATOL}: {tok.shape}")
        worst, worst_bf16 = max(worst, max(errs)), max(worst_bf16, max(errs_bf16))
        frames_out.append({"docs": int(tok.shape[0]), "tokens": int(tok.shape[1]), "wall_ms": wall * 1e3,
                           "ms_per_doc": wall * 1e3 / tok.shape[0], "max_prob_err": max(errs),
                           "bf16_control_max_prob_err": max(errs_bf16)})
    if not worst_bf16 > ATTN_PROB_ATOL:
        raise AssertionError(f"the bf16 q/k/v control ({worst_bf16}) is inside the tolerance {ATTN_PROB_ATOL}")
    # each control must miss the attention check on every document
    if not (attn_bf16 > ATTN_OUT_ATOL and attn_uniform > ATTN_OUT_ATOL):
        raise AssertionError(f"a control is inside the attention tolerance {ATTN_OUT_ATOL}: "
                             f"bf16 {attn_bf16}, uniform {attn_uniform}")
    del results

    # steady time of the 8-document frame, and its device trace
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.transform(dfs[0])
        walls.append(time.perf_counter() - t0)
    profile = _profile_steps(lambda: model.transform(dfs[0]), expect=("flash_fold_kernel",))
    profile["iterations"] = 1
    fold_ms = sum(e["ms"] for e in profile["top"] if "flash_fold" in e["name"])
    result = {
        "config": {"E": ATTN_E, "H": ATTN_H, "head_dim": ATTN_E // ATTN_H, "vocab": ATTN_VOCAB,
                   "classes": ATTN_CLASSES, "param_seed": ATTN_PARAM_SEED, "token_seed": ATTN_TOKEN_SEED},
        "frames": frames_out, "flash_fold_launches": launches, "folds_run": folds,
        "plain_fold_calls": len(plain_calls), "max_prob_err": worst, "prob_atol": ATTN_PROB_ATOL,
        "bf16_control_max_prob_err": worst_bf16, "undecided_docs": undecided, "margin": ATTN_MARGIN,
        "fold_max_abs_err_vs_plain": fold_err, "attn_max_err_vs_float64": attn_err, "attn_atol": ATTN_OUT_ATOL,
        "bf16_control_min_attn_err": attn_bf16, "uniform_control_min_attn_err": attn_uniform,
        "uniform_control_max_prob_err": prob_uniform,
        "uniform_control_inside_prob_atol": prob_uniform <= ATTN_PROB_ATOL,
        "ms_per_doc_8x8192": _median(walls) * 1e3 / ATTN_FRAMES[0][0],
        "transform_8x8192_ms": [w * 1e3 for w in walls],
        "device_idle_share": profile["idle_share"],
        "fold_share_of_device_time": fold_ms / profile["device_busy_ms"] if profile["device_busy_ms"] else None,
        "profile": profile,
    }
    emit("serve_attention", card=card, **result)
    return launches


def _flash_bwd_inputs(gen, BH, Tq, Tk, d, state, dev):
    """A fold's inputs and cotangents drawn on the card, as ``_flash_inputs``
    draws them, with q and k on a 1/8 grid in [-1, 1]: every score q · k is
    then exact in any summation order, so the kernels and the plain version
    find the same row maxima and ties (at a near-tie the fold's gradient
    jumps, and two summation orders could pick two keys). ``ties``: carried
    state, every key duplicated once (keys 2i and 2i + 1)."""
    import torch

    inputs = _flash_inputs(gen, BH, Tq, Tk, d, "carried" if state == "ties" else state, dev)
    inputs[0] = torch.randint(-8, 9, (1, BH, Tq, d), generator=gen, device=dev).float() / 8
    inputs[1] = torch.randint(-8, 9, (1, BH, Tk, d), generator=gen, device=dev).float() / 8
    if state == "ties":
        inputs[1][:, :, 1::2] = inputs[1][:, :, 0:Tk - 1:2]
    cot = [torch.randn(s, generator=gen, device=dev) for s in ((1, BH, Tq), (1, BH, Tq), (1, BH, Tq, d))]
    return inputs, cot


def _unattended_keys(BH, Tq, Tk, q_pos0, k_pos0, causal, n_valid, dev):
    """[1, BH, Tk]: the keys that no query of the block attends."""
    return (~_attends(Tq, Tk, q_pos0, k_pos0, causal, n_valid, dev).any(dim=0))[None, None, :].expand(1, BH, Tk)


def _check_flash_bwd(got, want, m_in, idle, unattended, where):
    """The backward kernels' (dq, dk, dv, dm_in, dl_in, dacc_in) against the
    plain VJP's: each within FLASH_BWD_RTOL of |plain| + the tensor's
    largest magnitude (products and row sums in another order); rows with
    no attendable key exact (dq 0; dl_in and dacc_in, the cotangent times a
    correction of exactly 1 or 0, bit-equal; dm_in bit-equal where m is
    -inf, dm · 0.5); keys that no query attends exactly 0 in dk and dv; no
    NaN. Returns ({name: max |kernel - plain|}, exact rows, exact keys)."""
    import torch

    errs = {}
    for name, g, w in zip(FLASH_BWD_NAMES, got, want):
        if torch.isnan(g).any():
            raise AssertionError(f"NaN in the kernel's {name}: {where}")
        if not g.numel():
            continue
        err = (g - w).abs()
        if not torch.all(err <= FLASH_BWD_RTOL * (w.abs() + max(1.0, float(w.abs().max())))):
            raise AssertionError(f"{name}: max |kernel - plain| {float(err.max())} past rtol {FLASH_BWD_RTOL}: "
                                 f"{where}")
        errs[name] = float(err.max())
    dq, dk, dv, dm_in, dl_in, dacc_in = got
    fresh = idle & torch.isneginf(m_in)
    if not (torch.all(dq[idle] == 0) and torch.equal(dl_in[idle], want[4][idle])
            and torch.equal(dacc_in[idle], want[5][idle]) and torch.equal(dm_in[fresh], want[3][fresh])):
        raise AssertionError(f"a row with nothing attendable is not exact: {where}")
    if not (torch.all(dk[unattended] == 0) and torch.all(dv[unattended] == 0)):
        raise AssertionError(f"a key that no query attends has a nonzero dk or dv: {where}")
    return errs, int(idle.sum()), int(unattended.sum())


def _flash_bwd_bound(BH, Tq, Tk, d, causal):
    """Bytes (each input read once, each output written once) and the
    operations this run's masks leave, per kernel: 6·D per attendable
    (query, key) pair for dq (q·kᵀ, dacc·vᵀ, ds·k, a multiply and an add
    each), 8·D for dkv (q·kᵀ, dacc·vᵀ, dsᵀ·q, Pᵀ·dacc). The kernels run
    every product in 3×TF32, three TF32 operations for each of these."""
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk  # causal at q_pos0 = k_pos0 = 0, Tq == Tk
    dq_bytes = 4 * BH * (5 * Tq * d + 2 * Tk * d + 9 * Tq)
    dkv_bytes = 4 * BH * (2 * Tq * d + 4 * Tk * d + 4 * Tq)
    return {"dq": (dq_bytes, 6 * BH * pairs * d), "dkv": (dkv_bytes, 8 * BH * pairs * d)}


def _flash_bwd_census(gen, dev):
    """The max-key census off the 1/8 grid: at FLASH_BWD_CENSUS, q and k
    standard normal, with m -inf and with m carried. The dkv kernel runs on
    the dq kernel's hand-off with ``dbc`` kept on the rows whose float64
    top-two score gap passes FLASH_BWD_CENSUS_GAP and with ``dbc`` zeroed;
    the dk difference must be ``dbc · q · scale`` scattered to each such
    row's float64 argmax (within FLASH_BWD_RTOL of |difference| + dk's
    largest magnitude: the two runs round ds · q apart), so the keys the
    dkv kernel's ``s == bmax`` finds are the ones the dq kernel counted.
    Returns {state: rows checked}."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.parallel import fold_bwd_dkv, fold_bwd_dq

    BH, Tq, Tk, d = FLASH_BWD_CENSUS
    scale = 1.0 / np.sqrt(d)
    checked = {}
    for state in ("first", "carried"):
        inputs = _flash_inputs(gen, BH, Tq, Tk, d, state, dev)
        q, k, v = inputs[:3]
        dm, dl, dacc = (torch.randn(s, generator=gen, device=dev) for s in ((1, BH, Tq), (1, BH, Tq), (1, BH, Tq, d)))
        safe, bmax, dbc = fold_bwd_dq(*inputs, 0, 0, False, None, scale, dm, dl, dacc)[4:]
        s64 = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * scale
        top2 = s64.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1] > FLASH_BWD_CENSUS_GAP) & (dbc != 0)
        where = f"census {state} BH={BH} Tq={Tq} Tk={Tk} d={d}"
        if int(clear.sum()) < 0.9 * BH * Tq:
            raise AssertionError(f"only {int(clear.sum())} rows have a clear max and a nonzero dbc: {where}")
        if not torch.all((bmax.double() - top2[..., 0]).abs() <= 1e-5 * (1.0 + top2[..., 0].abs())):
            raise AssertionError(f"the dq kernel's block max is not float64's: {where}")
        dbc_clear = torch.where(clear, dbc, torch.zeros_like(dbc))
        dk_with = fold_bwd_dkv(q, k, v, 0, 0, False, None, scale, dl, dacc, safe, bmax, dbc_clear)[0]
        dk_zero = fold_bwd_dkv(q, k, v, 0, 0, False, None, scale, dl, dacc, safe, bmax, torch.zeros_like(dbc))[0]
        diff = dk_with.double() - dk_zero.double()
        want = torch.zeros_like(diff)
        want.scatter_add_(2, s64.argmax(dim=-1)[..., None].expand(1, BH, Tq, d),
                          dbc_clear.double()[..., None] * q.double() * scale)
        err = (diff - want).abs()
        if not torch.all(err <= FLASH_BWD_RTOL * (want.abs() + float(dk_zero.abs().max()))):
            raise AssertionError(f"the dkv kernel's max keys are not the dq kernel's: max |err| {float(err.max())}: "
                                 f"{where}")
        checked[state] = int(clear.sum())
        del s64, diff, want, err
    return checked


def _flash_bwd_uniform(gen, dev):
    """Every key equal (a run of one repeated token: the classifier has no
    position embedding), so every attendable score of a row ties: on a first
    fold dq = scale · dm · k, the difference of two sums about Tk times
    larger. Both kernels against the plain VJP, held as the grid is, at BH 2,
    Tq 70, Tk 150 and D 8, 128, 256, first and carried, non-causal and
    causal with n_valid 100 (a causal row r has r + 1 tied keys: the dq
    kernel's slots up to 32, its second walk past them). Beside the gate, a
    reading: dq's largest |error| against the float64 VJP, and the plain
    float32 VJP's, each over |float64| + the tensor's largest magnitude (at
    least 1), in units of FLASH_BWD_RTOL. Returns (configurations, {name:
    max |kernel - plain|}, the reading)."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.parallel import fold_bwd_dkv, fold_bwd_dq, reference_fold_bwd

    BH, Tq, Tk = 2, 70, 150
    configurations, max_errs, reading = 0, {n: 0.0 for n in FLASH_BWD_NAMES}, {}
    for d in (8, 128, 256):
        for state in ("first", "carried"):
            inputs, (dm, dl, dacc) = _flash_bwd_inputs(gen, BH, Tq, Tk, d, state, dev)
            inputs[1] = inputs[1][:, :, :1].expand(1, BH, Tk, d).contiguous()
            scale = 1.0 / np.sqrt(d)
            for causal, n_valid in ((False, None), (True, 100)):
                args = (0, 0, causal, n_valid, scale)
                out = fold_bwd_dq(*inputs, *args, dm, dl, dacc)
                dk, dv = fold_bwd_dkv(*inputs[:3], *args, dl, dacc, *out[4:])
                want = reference_fold_bwd(*inputs, *args, dm, dl, dacc)
                where = f"every key equal: D={d} {state} causal={causal} n_valid={n_valid}"
                idle = _idle_rows(BH, Tq, Tk, 0, 0, causal, n_valid, dev)
                unattended = _unattended_keys(BH, Tq, Tk, 0, 0, causal, n_valid, dev)
                errs, _, _ = _check_flash_bwd((out[0], dk, dv, *out[1:4]), want, inputs[3], idle, unattended, where)
                for n, e in errs.items():
                    max_errs[n] = max(max_errs[n], e)
                configurations += 1
                want64 = reference_fold_bwd(*(x.double() for x in inputs), *args,
                                            *(x.double() for x in (dm, dl, dacc)))[0]
                bound = FLASH_BWD_RTOL * (want64.abs() + max(1.0, float(want64.abs().max())))
                key = f"D{d}_{state}_{'causal' if causal else 'full'}"
                reading[key] = {"kernels": float(((out[0].double() - want64).abs() / bound).max()),
                                "plain_float32": float(((want[0].double() - want64).abs() / bound).max())}
    return configurations, max_errs, reading


def phase_kernels_flash_bwd(rng, card: str):
    """The fold's two backward kernels against the plain VJP over the
    forward's grid plus a ties case, then their times at bench.py's
    attention shape (module docstring, phase 20)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from flink_ml_tpu_torch.parallel import (
        FLASH_FOLD_BWD_DKV,
        FLASH_FOLD_BWD_DQ,
        fold_bwd_dkv,
        fold_bwd_dq,
        fused_fold,
        reference_fold_bwd,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    configurations, exact_rows, exact_keys, tie_rows, m_ties = 0, 0, 0, 0, 0
    max_errs = {n: 0.0 for n in FLASH_BWD_NAMES}
    for BH in FLASH_GRID_BH:
        for Tq in FLASH_GRID_TQ:
            for Tk in FLASH_GRID_TK:
                for d in FLASH_GRID_D:
                    for causal, nv_case, state, pos in FLASH_FLAG_CASES + FLASH_BWD_TIES_CASE:
                        q_pos0, k_pos0 = _flash_positions(pos, Tq, Tk)
                        n_valid = {None: None, "inside": k_pos0 + max(1, Tk // 2), "before": k_pos0}[nv_case]
                        inputs, (dm, dl, dacc) = _flash_bwd_inputs(gen, BH, Tq, Tk, d, state, dev)
                        scale = 1.0 / np.sqrt(d)
                        if state == "ties":  # m equal to the block max on every third row
                            s = torch.einsum("bhqd,bhkd->bhqk", inputs[0], inputs[1]) * scale
                            if n_valid is not None:
                                s[..., max(0, n_valid - k_pos0):] = -torch.inf
                            block_max = s.amax(-1)
                            inputs[3][..., ::3] = block_max[..., ::3]
                            counts = (s == block_max[..., None]).sum(-1)
                            tie_rows += int(((counts >= 2) & torch.isfinite(block_max)).sum())
                            m_ties += int(((inputs[3] == block_max) & torch.isfinite(block_max)).sum())
                            del s
                        out = fold_bwd_dq(*inputs, q_pos0, k_pos0, causal, n_valid, scale, dm, dl, dacc)
                        dk, dv = fold_bwd_dkv(*inputs[:3], q_pos0, k_pos0, causal, n_valid, scale, dl, dacc,
                                              *out[4:])
                        want = reference_fold_bwd(*inputs, q_pos0, k_pos0, causal, n_valid, scale, dm, dl, dacc)
                        where = (f"BH={BH} Tq={Tq} Tk={Tk} d={d} causal={causal} n_valid={n_valid} "
                                 f"{state} q_pos0={q_pos0} k_pos0={k_pos0}")
                        idle = _idle_rows(BH, Tq, Tk, q_pos0, k_pos0, causal, n_valid, dev)
                        unattended = _unattended_keys(BH, Tq, Tk, q_pos0, k_pos0, causal, n_valid, dev)
                        errs, rows, keys = _check_flash_bwd((out[0], dk, dv, *out[1:4]), want, inputs[3], idle,
                                                            unattended, where)
                        for n, e in errs.items():
                            max_errs[n] = max(max_errs[n], e)
                        exact_rows += rows
                        exact_keys += keys
                        configurations += 1
    if not (exact_rows and exact_keys and tie_rows and m_ties):
        raise AssertionError("the grid reached no row of one of the exact edges or the ties")
    census = _flash_bwd_census(gen, dev)
    uniform_configurations, uniform_errs, uniform_reading = _flash_bwd_uniform(gen, dev)
    emit("kernels_flash_bwd", kernels=[FLASH_FOLD_BWD_DQ.name, FLASH_FOLD_BWD_DKV.name],
         configurations=configurations, max_abs_err=max_errs, rtol=FLASH_BWD_RTOL, exact_rows=exact_rows,
         exact_keys=exact_keys, tie_rows=tie_rows, rows_with_m_equal_to_the_block_max=m_ties,
         max_key_census={"shape": dict(zip(("BH", "Tq", "Tk", "D"), FLASH_BWD_CENSUS)),
                         "gap": FLASH_BWD_CENSUS_GAP, "rows_checked": census},
         every_key_equal={"configurations": uniform_configurations, "max_abs_err": uniform_errs,
                          "dq_err_vs_float64_in_rtols": uniform_reading})

    # times at ring_attention_causal_T8192_h4_d128, causal and not: the
    # one-fold case of ring attention, the cotangents those of out = acc / l
    B, T, H, d = FLASH_TIMED
    scale = 1.0 / np.sqrt(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, d)).astype(np.float32)).to(dev) for _ in range(3))
    g_out = torch.from_numpy(rng.standard_normal((B, H, T, d)).astype(np.float32)).to(dev)
    m0 = torch.full((B, H, T), -torch.inf, device=dev)
    l0 = torch.zeros((B, H, T), device=dev)
    acc0 = torch.zeros((B, H, T, d), device=dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    timings = {}
    for causal in (False, True):
        m, l, acc = fused_fold(q, k, v, m0, l0, acc0, 0, 0, causal, None, scale)
        dm = torch.zeros_like(m)
        dacc = g_out / l[..., None]
        dl = -(g_out * acc).sum(-1) / (l * l)
        out = fold_bwd_dq(q, k, v, m0, l0, acc0, 0, 0, causal, None, scale, dm, dl, dacc)
        dk, dv = fold_bwd_dkv(q, k, v, 0, 0, causal, None, scale, dl, dacc, *out[4:])
        want = reference_fold_bwd(q, k, v, m0, l0, acc0, 0, 0, causal, None, scale, dm, dl, dacc)
        where = f"timed shape B={B} T={T} H={H} d={d} causal={causal}"
        idle = _idle_rows(B * H, T, T, 0, 0, causal, None, dev)
        unattended = _unattended_keys(B * H, T, T, 0, 0, causal, None, dev)
        timed_errs, _, _ = _check_flash_bwd((out[0], dk, dv, *out[1:4]), want, m0, idle, unattended, where)
        for n, e in timed_errs.items():
            max_errs[n] = max(max_errs[n], e)
        del want
        # the library yardstick: float32 SDPA's backward for the same
        # attention, held against the two kernels plus the divide's backward
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        _, l_out, acc_out = fused_fold(*leaves, m0, l0, acc0, 0, 0, causal, None, scale)
        ours_out = acc_out / l_out.clamp(min=1e-30)[..., None]
        lib_grads = torch.autograd.grad(lib_out, leaves, g_out, retain_graph=True)
        our_grads = torch.autograd.grad(ours_out, leaves, g_out, retain_graph=True)
        lib_diff = max(float((a - b).abs().max()) for a, b in zip(our_grads, lib_grads))
        del lib_grads, our_grads
        fns = {
            "dq": lambda: fold_bwd_dq(q, k, v, m0, l0, acc0, 0, 0, causal, None, scale, dm, dl, dacc),
            "dkv": lambda: fold_bwd_dkv(q, k, v, 0, 0, causal, None, scale, dl, dacc, *out[4:]),
            "plain": lambda: reference_fold_bwd(q, k, v, m0, l0, acc0, 0, 0, causal, None, scale, dm, dl, dacc),
            "kernels_with_divide": lambda: torch.autograd.grad(ours_out, leaves, g_out, retain_graph=True),
            "library": lambda: torch.autograd.grad(lib_out, leaves, g_out, retain_graph=True),
        }
        times = {n: {"cold": [], "warm": []} for n in fns}
        for fn in fns.values():  # warm-up
            fn()
        torch.cuda.synchronize()
        for name in ("plain", "dq", "dkv", "kernels_with_divide", "library", "library", "kernels_with_divide",
                     "dkv", "dq", "plain"):
            times[name]["cold"] += _cold_times(fns[name], 3, flush)
            times[name]["warm"].append(_warm_time(fns[name], 3))
        bounds = _flash_bwd_bound(B * H, T, T, d, causal)
        per_kernel = {}
        for name in ("dq", "dkv"):
            bytes_moved, ops = bounds[name]
            # the kernels' products are 3xTF32: three TF32 operations each at the TF32 peak;
            # the float32 CUDA-core bound of the same work stays beside it, comparable with the earlier float32 kernels
            bytes_ms, ops_ms = bytes_moved / HBM_BYTES_PER_S * 1e3, 3 * ops / TF32_OPS_PER_S * 1e3
            ms = _median(times[name]["cold"])
            per_kernel[name] = {
                "ms": ms, "ms_l2_warm": _median(times[name]["warm"]), "bytes": bytes_moved, "ops": ops,
                "tf32_ops": 3 * ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bound_ms_f32": max(bytes_ms, ops / F32_OPS_PER_S * 1e3),
                "achieved_tf32_tflops": 3 * ops / (ms * 1e-3) / 1e12,
                "tf32_peak_share": 3 * ops / (ms * 1e-3) / TF32_OPS_PER_S,
                "max_abs_err_vs_plain": {n: timed_errs[n] for n in (("dq", "dm", "dl", "dacc") if name == "dq"
                                                                       else ("dk", "dv"))},
            }
        timings["causal" if causal else "non_causal"] = {
            **per_kernel,
            "plain_ms": _median(times["plain"]["cold"]), "plain_ms_l2_warm": _median(times["plain"]["warm"]),
            "kernels_with_divide_ms": _median(times["kernels_with_divide"]["cold"]),
            "library_ms": _median(times["library"]["cold"]),
            "library_ms_l2_warm": _median(times["library"]["warm"]),
            "library_max_abs_diff": lib_diff,
        }
        del out, dk, dv, leaves, lib_out, ours_out, l_out, acc_out, fns
    del q, k, v, g_out, flush
    torch.cuda.empty_cache()
    main = timings["non_causal"]  # the training path's fold is non-causal
    result = {}
    for kernel, name in ((FLASH_FOLD_BWD_DQ, "dq"), (FLASH_FOLD_BWD_DKV, "dkv")):
        errs = [max_errs[n] for n in (("dq", "dm", "dl", "dacc") if name == "dq" else ("dk", "dv"))]
        result[kernel.name] = {
            "max_abs_err": max(errs), "ms": main[name]["ms"], "ms_l2_warm": main[name]["ms_l2_warm"],
            "plain_ms": main["plain_ms"], "bound_ms": main[name]["bound_ms"], "bound_by": main[name]["bound_by"],
            "bound_ms_f32": main[name]["bound_ms_f32"], "library_ms": main["library_ms"],
        }
    emit("kernels_flash_bwd", card=card,
         shape={"B": B, "T": T, "H": H, "D": d, "name": "ring_attention_causal_T8192_h4_d128"},
         plain="reference_fold_bwd: the plain version of both kernels",
         library="torch.autograd.grad of scaled_dot_product_attention(q, k, v) in float32: the backward of "
                 "fold + acc / l; hold it against kernels_with_divide_ms",
         by_mask=timings, kernels=result)
    return result


def _attention_documents(n, seed):
    """``n`` documents of FIT_ATTN_T seeded tokens over the vocabulary, the
    label of document i class i mod 8, each class planting its own signal
    token (ATTN_VOCAB - 1 - class) at a seeded FIT_ATTN_SIGNAL share of the
    positions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y = np.arange(n) % ATTN_CLASSES
    tok = rng.integers(0, ATTN_VOCAB - ATTN_CLASSES, size=(n, FIT_ATTN_T))
    planted = rng.random((n, FIT_ATTN_T)) < FIT_ATTN_SIGNAL
    tok = np.where(planted, (ATTN_VOCAB - 1 - y)[:, None], tok)
    return tok, y.astype(np.float64)


def _attention_grads64(params64, tok, y_idx, w, control=None):
    """Loss and gradients of one window in float64, a document at a time
    (the gradient is a weighted sum over documents)."""
    import torch

    leaves = {n: p.detach().clone().requires_grad_(True) for n, p in params64.items()}
    grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
    loss = 0.0
    denom = torch.clamp(w.sum(), min=1e-30)
    for i in range(tok.shape[0]):
        if float(w[i]) == 0.0:
            continue
        logits, _ = _attention_float64(leaves, tok[i], ATTN_H, control=control)
        loss_i = w[i] * (torch.logsumexp(logits, dim=-1) - logits[y_idx[i]]) / denom
        for n, g in zip(leaves, torch.autograd.grad(loss_i, list(leaves.values()))):
            grads[n] += g
        loss += float(loss_i)
    return loss, grads


def _reference_attention_fit(init, tok, y_idx, control=None):
    """The fit written out plainly in float64 on the card: the same initial
    draws, window schedule (the clamped tail's re-read rows weighted 0) and
    adam formula, dense attention, gradients by autograd a document at a
    time. Returns the per-step losses."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    params = {n: torch.from_numpy(np.asarray(a, np.float64)).to(dev) for n, a in init.items()}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    n, offset, losses = tok.shape[0], 0, []
    for t in range(1, FIT_ATTN_ITERS + 1):
        lo = min(offset, n - FIT_ATTN_BATCH)
        w = torch.from_numpy((np.arange(FIT_ATTN_BATCH) + lo >= offset).astype(np.float64)).to(dev)
        loss, grads = _attention_grads64(params, tok[lo:lo + FIT_ATTN_BATCH], y_idx[lo:lo + FIT_ATTN_BATCH], w,
                                         control)
        with torch.no_grad():
            for name in params:
                mu[name] = 0.1 * grads[name] + 0.9 * mu[name]
                nu[name] = 0.001 * grads[name] * grads[name] + 0.999 * nu[name]
                params[name] = params[name] - FIT_ATTN_LR * (mu[name] / (1 - 0.9 ** t)) / (
                    torch.sqrt(nu[name] / (1 - 0.999 ** t)) + 1e-8)
        losses.append(loss)
        offset = 0 if offset + FIT_ATTN_BATCH >= n else offset + FIT_ATTN_BATCH
    return losses


def phase_fit_attention(card: str):
    """SelfAttentionClassifier.fit on the card at bench.py's attention
    training width, every launch of its fold kernels held against the plain
    versions, then the fitted model served (module docstring, phase 21)."""
    import numpy as np
    import torch

    import flink_ml_tpu_torch.parallel.flash as flash_mod
    import flink_ml_tpu_torch.parallel.ring as ring_mod
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.models.classification import attention_classifier as attn
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.parallel import (
        FLASH_FOLD,
        FLASH_FOLD_BWD_DKV,
        FLASH_FOLD_BWD_DQ,
        reference_fold,
        reference_fold_bwd,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    tok, y = _attention_documents(FIT_ATTN_DOCS, FIT_ATTN_TOKEN_SEED)
    df = DataFrame.from_dict({"features": tok.astype(np.float64), "label": y})

    def estimator(iters):
        return (attn.SelfAttentionClassifier().set_embedding_dim(ATTN_E).set_num_heads(ATTN_H)
                .set_vocab_size(ATTN_VOCAB).set_global_batch_size(FIT_ATTN_BATCH).set_learning_rate(FIT_ATTN_LR)
                .set_max_iter(iters).set_seed(ATTN_PARAM_SEED))

    estimator(1).fit(df)  # warm: libraries loaded, cuBLAS handles made
    torch.cuda.synchronize()

    # the main path, every fold kernel's inputs and outputs kept
    real = {"fold": ring_mod.fused_fold, "dq": flash_mod.fold_bwd_dq, "dkv": flash_mod.fold_bwd_dkv}
    captured = {"fold": [], "dq": [], "dkv": []}

    def keep(kind):
        def kept(*args):
            out = real[kind](*args)
            captured[kind].append((args, out))
            return out
        return kept

    for k in KERNELS:
        k.reset_launches()
    plain_calls, restore = _count_calls(flash_mod, ("reference_fold", "reference_fold_bwd"))
    ring_mod.fused_fold, flash_mod.fold_bwd_dq, flash_mod.fold_bwd_dkv = keep("fold"), keep("dq"), keep("dkv")
    try:
        est = estimator(FIT_ATTN_ITERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = est.fit(df)
        fit_wall = time.perf_counter() - t0  # ends with the parameters' readback
        launches = {k.name: k.launches for k in KERNELS}
    finally:
        ring_mod.fused_fold, flash_mod.fold_bwd_dq, flash_mod.fold_bwd_dkv = real["fold"], real["dq"], real["dkv"]
        restore()
    want_launches = {FLASH_FOLD.name: FIT_ATTN_ITERS, FLASH_FOLD_BWD_DQ.name: FIT_ATTN_ITERS,
                     FLASH_FOLD_BWD_DKV.name: FIT_ATTN_ITERS}
    if {n: c for n, c in launches.items() if c} != want_launches:
        raise AssertionError(f"kernel launches {launches}, expected one fold, dq and dkv launch a step")
    if plain_calls:
        raise AssertionError(f"a plain fold version was called on the card's path: {plain_calls}")
    if any(len(v) != FIT_ATTN_ITERS for v in captured.values()):
        raise AssertionError(f"captured {({k: len(v) for k, v in captured.items()})} calls")
    losses = np.asarray(est.loss_history)
    if losses.shape != (FIT_ATTN_ITERS,) or not np.all(np.isfinite(losses)):
        raise AssertionError(f"loss history {losses}")

    # every launch held against the plain version on its inputs, a
    # document at a time (no graph: the captured tensors carry the fit's)
    fold_err, bwd_errs = 0.0, {n: 0.0 for n in FLASH_BWD_NAMES}
    with torch.no_grad():
        for step in range(FIT_ATTN_ITERS):
            (f_args, f_out), (dq_args, dq_out), (dkv_args, dkv_out) = (captured[k][step] for k in ("fold", "dq", "dkv"))
            tensors, (q_pos0, k_pos0, causal, n_valid, scale) = f_args[:6], f_args[6:]
            if tuple(tensors[0].shape) != (FIT_ATTN_BATCH, ATTN_H, FIT_ATTN_T, ATTN_E // ATTN_H):
                raise AssertionError(f"the fold ran at {tuple(tensors[0].shape)}")
            for i in range(FIT_ATTN_BATCH):
                where = f"fit_attention step {step + 1}, document {i}"
                ins = [x[i:i + 1] for x in tensors]
                want = reference_fold(*ins, q_pos0, k_pos0, causal, n_valid, scale)
                idle = _idle_rows(ATTN_H, FIT_ATTN_T, FIT_ATTN_T, q_pos0, k_pos0, causal, n_valid, dev)
                s_mag = scale * torch.einsum("bhqd,bhkd->bhqk", ins[0].abs(), ins[1].abs()).amax(-1)
                fold_err = max(fold_err, _check_flash([x[i:i + 1] for x in f_out], want, ins[3:], idle, s_mag,
                                                      where)[0])
                del want, s_mag
                doc_in = [x[i:i + 1] for x in dq_args[:6]]
                doc_cot = [x[i:i + 1] for x in dq_args[11:]]
                want = reference_fold_bwd(*doc_in, *dq_args[6:11], *doc_cot)
                got = (dq_out[0][i:i + 1], dkv_out[0][i:i + 1], dkv_out[1][i:i + 1],
                       *(x[i:i + 1] for x in dq_out[1:4]))
                unattended = _unattended_keys(ATTN_H, FIT_ATTN_T, FIT_ATTN_T, q_pos0, k_pos0, causal, n_valid, dev)
                errs, _, _ = _check_flash_bwd(got, want, doc_in[3], idle, unattended, where)
                for n, e in errs.items():
                    bwd_errs[n] = max(bwd_errs[n], e)
                del want
            if not (dkv_args[0] is dq_args[0] and dkv_args[8] is dq_args[12]):
                raise AssertionError(f"step {step + 1}: the dkv kernel did not take the dq kernel's inputs")
    del captured
    torch.cuda.empty_cache()

    # step 1's gradients against float64 autograd of the plain path
    y_idx = np.searchsorted(model.labels, y)
    init = attn._init_params(np.random.default_rng(ATTN_PARAM_SEED), ATTN_VOCAB, ATTN_E, ATTN_CLASSES)
    params32 = {n: torch.from_numpy(a).to(dev) for n, a in init.items()}
    params64 = {n: p.double() for n, p in params32.items()}
    tok_w = torch.from_numpy(tok[:FIT_ATTN_BATCH]).to(dev).long()
    y_w = torch.from_numpy(y_idx[:FIT_ATTN_BATCH]).to(dev)
    w32 = torch.ones(FIT_ATTN_BATCH, device=dev)
    loss32, grads32 = attn._loss_and_grads(params32, tok_w, y_w, w32, FIT_ATTN_T, ATTN_H)
    loss64, grads64 = _attention_grads64(params64, tok_w, y_w, w32.double())
    _, grads_bf16 = _attention_grads64(params64, tok_w, y_w, w32.double(), control="bf16_qkv")

    def grad_err(grads):
        return max(float((grads[n].double() - grads64[n]).abs().max() / grads64[n].abs().max()) for n in grads64)

    step1_err, step1_bf16 = grad_err(grads32), grad_err(grads_bf16)
    del grads32, grads64, grads_bf16, params32
    torch.cuda.empty_cache()

    # the loss history against a float64 fit of the same schedule
    losses64 = np.asarray(_reference_attention_fit(init, torch.from_numpy(tok).to(dev).long(),
                                                   torch.from_numpy(y_idx).to(dev)))
    losses_bf16 = np.asarray(_reference_attention_fit(init, torch.from_numpy(tok).to(dev).long(),
                                                      torch.from_numpy(y_idx).to(dev), control="bf16_qkv"))
    loss_err = float(np.max(np.abs(losses - losses64) / np.abs(losses64)))
    loss_bf16 = float(np.max(np.abs(losses_bf16 - losses64) / np.abs(losses64)))
    torch.cuda.empty_cache()

    # steady ms per step from two iteration counts, and one traced step
    walls = {}
    for iters in FIT_ATTN_STEP_ITERS + FIT_ATTN_STEP_ITERS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        estimator(iters).fit(df)
        walls.setdefault(iters, []).append(time.perf_counter() - t0)
    lo_it, hi_it = FIT_ATTN_STEP_ITERS
    step_ms = (min(walls[hi_it]) - min(walls[lo_it])) / (hi_it - lo_it) * 1e3
    params = {n: torch.from_numpy(a).to(dev) for n, a in init.items()}
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    profile = _profile_steps(lambda: attn._train_step(params, zeros, zeros, 1, tok_w, y_w, w32, FIT_ATTN_T,
                                                      ATTN_H, FIT_ATTN_LR),
                             expect=("flash_fold_kernel", "fold_bwd_dq_kernel", "fold_bwd_dkv_kernel"))
    profile["iterations"] = 1

    def share(tag):
        ms = sum(e["ms"] for e in profile["top"] if tag in e["name"])
        return ms / profile["device_busy_ms"] if profile["device_busy_ms"] else None

    # the fitted model serves held-out documents, against float64
    held, held_y = _attention_documents(FIT_ATTN_HELD, FIT_ATTN_TOKEN_SEED + 1)
    out = model.transform(DataFrame.from_dict({"features": held.astype(np.float64)}))
    probs = np.asarray(out.column("rawPrediction"))
    if probs.shape != (FIT_ATTN_HELD, ATTN_CLASSES) or not np.all(np.isfinite(probs)):
        raise AssertionError(f"rawPrediction has shape {probs.shape} or a non-finite value")
    fitted64 = {n: torch.from_numpy(np.asarray(a, np.float64)).to(dev) for n, a in model.params.items()}
    prob_err, prob_bf16, prob_uniform = 0.0, 0.0, 0.0
    with torch.no_grad():
        for i in range(FIT_ATTN_HELD):
            t = torch.from_numpy(held[i]).to(dev)
            want = torch.softmax(_attention_float64(fitted64, t, ATTN_H)[0], dim=-1).cpu().numpy()
            prob_err = max(prob_err, float(np.abs(probs[i] - want).max()))
            for control in ("bf16_qkv", "uniform"):
                c = torch.softmax(_attention_float64(fitted64, t, ATTN_H, control=control)[0], dim=-1).cpu().numpy()
                if control == "bf16_qkv":
                    prob_bf16 = max(prob_bf16, float(np.abs(c - want).max()))
                else:
                    prob_uniform = max(prob_uniform, float(np.abs(c - want).max()))
    accuracy = float(np.mean(np.asarray(out.column("prediction")) == held_y))
    result = {
        "config": {"E": ATTN_E, "H": ATTN_H, "head_dim": ATTN_E // ATTN_H, "vocab": ATTN_VOCAB,
                   "classes": ATTN_CLASSES, "T": FIT_ATTN_T, "docs": FIT_ATTN_DOCS, "globalBatchSize": FIT_ATTN_BATCH,
                   "maxIter": FIT_ATTN_ITERS, "learningRate": FIT_ATTN_LR, "param_seed": ATTN_PARAM_SEED,
                   "token_seed": FIT_ATTN_TOKEN_SEED, "signal_share": FIT_ATTN_SIGNAL},
        "launches": launches, "plain_calls": len(plain_calls), "fit_wall_s": fit_wall,
        "fold_max_abs_err_vs_plain": fold_err, "bwd_max_abs_err_vs_plain": bwd_errs, "bwd_rtol": FLASH_BWD_RTOL,
        "loss_history": losses.tolist(), "loss_history_float64": losses64.tolist(),
        "loss_max_rel_err": loss_err, "loss_rtol": FIT_ATTN_LOSS_RTOL, "bf16_control_loss_max_rel_err": loss_bf16,
        "step1_loss": float(loss32), "step1_loss_float64": loss64, "step1_grad_max_rel_err": step1_err,
        "grad_rtol": FIT_ATTN_GRAD_RTOL, "bf16_control_step1_grad_max_rel_err": step1_bf16,
        "ms_per_step": step_ms, "fit_walls_s": {str(k): v for k, v in walls.items()},
        "tokens_per_s": FIT_ATTN_BATCH * FIT_ATTN_T / (step_ms * 1e-3),
        "device_idle_share": profile["idle_share"],
        "fold_share_of_device_time": share("flash_fold_kernel"),
        "dq_share_of_device_time": share("fold_bwd_dq_kernel"),
        "dkv_share_of_device_time": share("fold_bwd_dkv_kernel"),
        "profile": profile,
        "served": {"docs": FIT_ATTN_HELD, "max_prob_err": prob_err, "prob_atol": FIT_ATTN_PROB_ATOL,
                   "bf16_control_max_prob_err": prob_bf16, "uniform_control_max_prob_err": prob_uniform,
                   "uniform_control_outside_prob_atol": prob_uniform > FIT_ATTN_PROB_ATOL,
                   "accuracy": accuracy},
    }
    emit("fit_attention", card=card, **result)
    # the checks of the readings above (emitted first, so a failing run
    # still shows every reading)
    if not step1_err <= FIT_ATTN_GRAD_RTOL:
        raise AssertionError(f"step-1 gradients {step1_err} from float64 (relative to each one's largest) > "
                             f"{FIT_ATTN_GRAD_RTOL}")
    if not step1_bf16 > FIT_ATTN_GRAD_RTOL:
        raise AssertionError(f"the bf16 q/k/v control's gradients ({step1_bf16}) are inside {FIT_ATTN_GRAD_RTOL}")
    if not loss_err <= FIT_ATTN_LOSS_RTOL:
        raise AssertionError(f"loss history {losses} vs float64 {losses64}: {loss_err} > {FIT_ATTN_LOSS_RTOL}")
    if not loss_bf16 > FIT_ATTN_LOSS_RTOL:
        raise AssertionError(f"the bf16 q/k/v fit's losses ({loss_bf16}) are inside {FIT_ATTN_LOSS_RTOL}")
    if not prob_err <= FIT_ATTN_PROB_ATOL:
        raise AssertionError(f"the fitted model's probabilities {prob_err} from float64 > {FIT_ATTN_PROB_ATOL}")
    if not prob_bf16 > FIT_ATTN_PROB_ATOL:
        raise AssertionError(f"the bf16 q/k/v control ({prob_bf16}) is inside {FIT_ATTN_PROB_ATOL}")
    return {FLASH_FOLD_BWD_DQ.name: launches[FLASH_FOLD_BWD_DQ.name],
            FLASH_FOLD_BWD_DKV.name: launches[FLASH_FOLD_BWD_DKV.name]}


def _chain_kmeans_case(name, rows, d, k, measure, dev, rng):
    """``(inputs, ops)`` of ("normalize", "kmeans") or ("scale", "normalize",
    "kmeans") on the kmeans grid's inputs: from 5 rows on a zero row and a
    NaN feature, from k 2 on a duplicate centroid; the centroids normalized
    rows, as a fitted model's are after a Normalizer."""
    import torch

    from flink_ml_tpu_torch.servable.megakernels import RowLocalOp

    x, mean, inv_std, C = _kmeans_inputs(rng, rows, d, k, dev)
    if rows >= 5:
        x[1] = 0.0
        x[2, d // 2] = float("nan")
    C = C / C.norm(dim=1, keepdim=True).clamp_min(1e-12)
    if k >= 2:
        C[-1] = C[0]
    norm = RowLocalOp("normalize", 0, params={"p": 2.0})
    head = RowLocalOp("kmeans", 1, C.contiguous(), params={"measure": measure})
    if name == "normalize_kmeans":
        return [x], [norm, head]
    scale = RowLocalOp("scale", 0, mean, inv_std, {"with_mean": True, "with_std": True})
    return [x], [scale, norm._replace(src=1), head._replace(src=2)]


def _check_chain_kmeans(inputs, ops, got, want, measure, where):
    """The table's outputs before the head as ``_check_rowlocal`` holds them;
    the index equal to the plain version's where the float64 top-two
    distance gap (of the plain version's head input) exceeds KMEANS_MARGIN.
    Returns ``(rows inside the margin, max |kernel - plain| of the float
    outputs)``."""
    import torch

    head = ops[-1]
    _in, err, _ulps = _check_rowlocal(inputs, ops[:-1], got[:-1], want[:-1], where)
    x = (list(inputs) + list(want))[head.src]
    decided = _kmeans_decided(_kmeans_distances64(measure, x, head.a))
    g, w = got[-1], want[-1]
    if g.dtype != torch.int32 or not torch.equal(g[decided], w[decided]):
        raise AssertionError(f"kmeans index differs outside the margin: {where}")
    return int((~decided).sum()), err


def _chain_mlp_case(name, rows, widths, dev, rng):
    """``(inputs, ops, head slot, layers, labels)`` of ("normalize", "mlp")
    or ("elementwise_product", "scale", "mlp") on the MLP grid's inputs."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.servable.megakernels import RowLocalOp

    x, mean, inv_std, layers, labels = _mlp_inputs(rng, rows, widths, dev)
    if name == "normalize_mlp":
        return [x], [RowLocalOp("normalize", 0, params={"p": 2.0})], 1, layers, labels
    scaling = torch.from_numpy((np.abs(rng.normal(size=widths[0])) + 0.1).astype(np.float32)).to(dev)
    ops = [RowLocalOp("elementwise_product", 0, scaling),
           RowLocalOp("scale", 1, mean, inv_std, {"with_mean": True, "with_std": True})]
    return [x], ops, 2, layers, labels


def _residue_case(name, rows, width, cap, d, dev, rng, sparse_models):
    """``(inputs, ops, kernel)`` of a chain of the table's last four classes
    (RESIDUE_CHAINS): a dense column ``x`` [rows, width] (from 5 rows on a
    zero row and a NaN, and, outside the kmeans chains, ±inf), and, for the
    sparse chains, a sparse column of dimension ``d`` packed at ``cap``
    (rows of 0 … cap sorted ids, padding id 0 / value 0, a NaN and ±inf
    among the values) with ``sparse_models[d]`` = (idf, idf2, coef)."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.servable.megakernels import ROWLOCAL, ROWLOCAL_MLP, RowLocalOp

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    if name.startswith("mlp") or "_mlp" in name:
        x, mean, inv_std, layers, labels = _mlp_inputs(rng, rows, list(width), dev)
        if rows >= 5:
            x[1] = 0.0
        scale = RowLocalOp("scale", 0, mean, inv_std, {"with_mean": True, "with_std": True})

        def mlp(src):
            return RowLocalOp("mlp", src, labels, layers=layers)

        if name == "mlp_scale":
            ops = [mlp(0), scale]
        elif name == "normalize_mlp_binarize":
            ops = [RowLocalOp("normalize", 0, params={"p": 2.0}), mlp(1),
                   RowLocalOp("binarize", 3, params={"threshold": RESIDUE_MLP_THRESHOLD})]
        elif name == "mlp_kmeans":
            C = t(rng.normal(size=(RESIDUE_K, width[0])))
            ops = [mlp(0), RowLocalOp("kmeans", 0, C, params={"measure": "euclidean"})]
        else:
            ops = [mlp(0), mlp(0)]
        return [x], ops, ROWLOCAL_MLP
    x = rng.normal(size=(rows, width)).astype(np.float32)
    kmeans = "kmeans" in name
    if rows >= 5:
        x[1] = 0.0
        x[2, width // 2] = np.nan
        if not kmeans:
            x[3, 0], x[4, -1] = np.inf, -np.inf
    mean, inv_std = t(rng.normal(size=width)), t(np.abs(rng.normal(size=width)))
    scale = RowLocalOp("scale", 0, mean, inv_std, {"with_mean": True, "with_std": True})
    if kmeans:
        C = t(rng.normal(size=(RESIDUE_K, width)))
        measure = ("euclidean", "manhattan", "cosine")[int(rng.integers(3))]
        head = RowLocalOp("kmeans", 0, C, params={"measure": measure})
        ops = {
            "kmeans_binarize": [head, RowLocalOp("binarize", 1, params={"threshold": 0.5})],
            "kmeans_impute": [head, RowLocalOp("impute", 1, t([7.5]), params={
                "missing_is_nan": False, "missing_value": 1.0, "column": 0})],
            "scale_kmeans_binarize": [scale, head._replace(src=1), RowLocalOp("binarize", 2, params={
                "threshold": 4.5})],
        }[name]
        return [t(x)], ops, ROWLOCAL
    nnz = rng.integers(0, cap + 1, rows)
    ids = np.zeros((rows, cap), np.int32)
    vals = np.zeros((rows, cap), np.float32)
    for r in range(rows):
        ids[r, :nnz[r]] = np.sort(rng.choice(d, size=int(nnz[r]), replace=False))
        vals[r, :nnz[r]] = rng.random(int(nnz[r])) + 0.5
    for r, v in ((1, np.nan), (2, np.inf), (3, -np.inf)):
        if r < rows and nnz[r]:
            vals[r, 0] = v
    idf, idf2, coef = sparse_models[d]
    inputs = [t(vals), t(ids, np.int32), t(nnz, np.int32), t(x)]
    scale = scale._replace(src=3)

    def sidf(src, a):
        return RowLocalOp("sparse_idf", src, a, params={"ids": 1})

    def slr(src):
        return RowLocalOp("sparse_logistic", src, coef, params={"ids": 1})

    ops = {
        "idf_lr_scale": [sidf(0, idf), slr(4), scale],
        "scale_idf_lr": [scale, sidf(0, idf), slr(5)],
        "idf_normalize": [sidf(0, idf), RowLocalOp("normalize", 3, params={"p": 2.0})],
        "idf_idf": [sidf(0, idf), sidf(4, idf2)],
        "idf_idf_lr": [sidf(0, idf), sidf(4, idf2), slr(5)],
        "two_sparse_heads": [slr(0), sidf(0, idf), slr(6)],
    }[name]
    return inputs, ops, ROWLOCAL


def _check_table(inputs, ops, got, want, where):
    """Each output of a table kernel against the plain table's, by the rules
    of ``_check_rowlocal`` extended to every op: elementwise ops bit-equal
    until a normalize or a head's rounding, then within
    ULP_ENVELOPE["feature6"]; a sparse IDF bit-equal; a sparse head's
    prediction equal and its rawPrediction bit-equal (its margin is the
    plain version's sequential fold, its sigmoid torch's formula); an MLP
    head's probabilities within ULP_ENVELOPE["scale_mlp"] and its prediction
    equal past a PREDICTION_MARGIN logit gap; a kmeans index equal past a
    KMEANS_MARGIN distance gap; a binarize of a rounded column equal outside
    BIN_MARGIN; binarize and impute of an index exactly equal on the rows
    whose index is. Later ops are compared on the rows whose inputs are.
    Returns ``(entries or rows inside a margin, max |kernel - plain|)``."""
    import torch

    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff

    def fail(what):
        raise AssertionError(f"{what}: {where}")

    plain = list(inputs) + list(want)
    rows = int(inputs[0].shape[0])
    rounded = [False] * len(inputs)
    decided = [torch.ones(rows, dtype=torch.bool, device=inputs[0].device)] * len(inputs)
    inside, max_abs_err, k = 0, 0.0, 0

    def err(g, w):
        diff = torch.nan_to_num(g.float() - w.float(), nan=0.0, posinf=0.0, neginf=0.0)
        return float(diff.abs().max()) if diff.numel() else 0.0

    for op in ops:
        dec = decided[op.src]
        if op.op in ("logistic", "sparse_logistic", "mlp"):
            pred, second = got[k], got[k + 1]
            if (pred.shape, second.shape, pred.dtype) != (want[k].shape, want[k + 1].shape, want[k].dtype):
                fail(f"head {op.op} outputs {tuple(pred.shape)} {tuple(second.shape)} {pred.dtype}")
            if op.op == "mlp":
                if ulp_diff(second[dec].cpu().numpy(), want[k + 1][dec].cpu().numpy()) > ULP_ENVELOPE["scale_mlp"]:
                    fail("MLP probabilities outside the scale_mlp envelope")
                sure = dec & (_top_two_gap(op.layers, plain[op.src]) > PREDICTION_MARGIN)
            else:
                if op.op == "sparse_logistic":
                    if not _same_bits(second[dec], want[k + 1][dec]):
                        fail("sparse_logistic rawPrediction not bit-equal")
                elif ulp_diff(second[dec, 1].cpu().numpy(), want[k + 1][dec, 1].cpu().numpy()) > \
                        ULP_ENVELOPE["scale_logistic"]:
                    fail(f"{op.op} probability outside its envelope")
                if not (_same_bits(second[:, 0], 1.0 - second[:, 1])
                        and _same_bits(want[k + 1][:, 0], 1.0 - want[k + 1][:, 1])):
                    fail("rawPrediction[:, 0] is not 1 - rawPrediction[:, 1]")
                if op.op == "logistic":
                    margin = plain[op.src].double() @ op.a.double()
                    sure = dec & (margin.abs() > PREDICTION_MARGIN)
                else:
                    sure = dec
            if not torch.equal(pred[sure], want[k][sure]):
                fail(f"{op.op} prediction differs")
            inside += int((dec & ~sure).sum())
            max_abs_err = max(max_abs_err, err(second[dec], want[k + 1][dec]))
            rounded += [False, True]
            decided += [sure, dec]
            k += 2
            continue
        g, w = got[k], want[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"output {k} {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        row_mask = dec if g.dim() == 1 else dec[:, None].expand_as(g)
        if op.op == "kmeans":
            sure = dec & _kmeans_decided(_kmeans_distances64(op.params["measure"], plain[op.src], op.a))
            if g.dtype != torch.int32 or not torch.equal(g[sure], w[sure]):
                fail("kmeans index differs outside the margin")
            inside += int((dec & ~sure).sum())
            rounded.append(False)
            decided.append(sure)
            k += 1
            continue
        if op.op == "binarize" and rounded[op.src]:
            near = (plain[op.src] - op.params["threshold"]).abs() <= BIN_MARGIN
            if not torch.equal(g[row_mask & ~near], w[row_mask & ~near]):
                fail(f"binarize output {k} differs outside the margin")
            inside += int((row_mask & near).sum())
            dec = dec & ~(near if near.dim() == 1 else near.any(dim=1))
            rounded.append(False)
        elif plain[op.src].dtype == torch.int32:  # binarize or impute of an index
            if not torch.equal(g[row_mask], w[row_mask]):
                fail(f"output {k} of the index differs")
            rounded.append(False)
        elif rounded[op.src] or op.op == "normalize":
            if ulp_diff(g[row_mask].cpu().numpy(), w[row_mask].cpu().numpy()) > ULP_ENVELOPE["feature6"]:
                fail(f"output {k} outside the feature6 envelope")
            rounded.append(True)
        else:
            if not _same_bits(g[row_mask], w[row_mask]):
                fail(f"output {k} not bit-equal to the plain version")
            rounded.append(False)
        max_abs_err = max(max_abs_err, err(g[row_mask], w[row_mask]))
        decided.append(dec)
        k += 1
    return inside, max_abs_err


def _seeded_mlp(widths, features_col, rng):
    """An MLPClassifier servable of ``widths`` reading ``features_col``:
    He-initialised weights, small biases, class values 1 … classes."""
    import numpy as np

    from flink_ml_tpu_torch.servable import MLPClassifierModelServable

    arrays = {"labels": np.arange(widths[-1], dtype=np.float64) + 1.0}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        arrays[f"W{i}"] = (rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
        arrays[f"b{i}"] = (rng.normal(size=b) * 0.1).astype(np.float32)
    return MLPClassifierModelServable().set_features_col(features_col)._apply_model_arrays(arrays)


def _residue_specs(d_sparse, d_dense, mlp_widths, kmeans_d, rng):
    """The three timed chains of the table's last classes as the port's
    servables' kernel specs, from seeded model data: IDF → LR on a sparse
    column of dimension ``d_sparse`` beside a StandardScaler on a dense
    column of ``d_dense``; Normalizer → MLP (``mlp_widths``) → Binarizer on
    rawPrediction; KMeans (k RESIDUE_K, ``kmeans_d``) → Binarizer on
    prediction."""
    import numpy as np

    from flink_ml_tpu_torch.models.feature.binarizer import Binarizer
    from flink_ml_tpu_torch.models.feature.idf import IDFModel
    from flink_ml_tpu_torch.models.feature.normalizer import Normalizer
    from flink_ml_tpu_torch.servable import (
        KMeansModelServable,
        LogisticRegressionModelServable,
        StandardScalerModelServable,
    )

    idf = IDFModel().set_input_col("tf").set_output_col("tfidf")
    idf.idf, idf.doc_freq, idf.num_docs = (np.abs(rng.normal(size=d_sparse)) + 0.1, np.ones(d_sparse),
                                           np.asarray(9.0))
    lr = LogisticRegressionModelServable().set_features_col("tfidf")
    lr.coefficient = rng.normal(size=d_sparse) * 0.3
    sc = StandardScalerModelServable().set_input_col("dense").set_output_col("scaled").set_with_mean(True)
    sc.mean, sc.std = rng.normal(size=d_dense), np.abs(rng.normal(size=d_dense)) + 0.5
    mlp = _seeded_mlp(mlp_widths, "norm", rng)
    km = KMeansModelServable().set_features_col("features").set_k(RESIDUE_K)
    km.centroids, km.weights = rng.random((RESIDUE_K, kmeans_d)).astype(np.float32), np.ones(RESIDUE_K)
    return {
        "idf_lr_scale": [idf.sparse_kernel_spec({"tf": d_sparse}), lr.sparse_kernel_spec({"tfidf": d_sparse}),
                         sc.kernel_spec()],
        "normalize_mlp_binarize": [
            Normalizer().set_input_col("features").set_output_col("norm").set_p(2.0).kernel_spec(),
            mlp.kernel_spec(),
            Binarizer().set_input_cols("rawPrediction").set_output_cols("rb")
            .set_thresholds(RESIDUE_MLP_THRESHOLD).kernel_spec()],
        "kmeans_binarize": [km.kernel_spec(), Binarizer().set_input_cols("prediction").set_output_cols("pb")
                            .set_thresholds(4.5).kernel_spec()],
    }


def _chain_bound(x_bytes, out_bytes, model_bytes, ops, tf32_products=0):
    """``{bytes, ops, bytes_ms, ops_ms, bound_ms, bound_by}`` of one call:
    each input, output and model byte once; ``ops`` as counted by the
    caller, of which ``tf32_products`` run on the tensor cores as 3×TF32
    (three TF32 operations each at the TF32 peak; ``bound_ms_f32`` counts
    them as float32 too)."""
    b = x_bytes + out_bytes + model_bytes
    f32_ops = ops - tf32_products
    bytes_ms = b / HBM_BYTES_PER_S * 1e3
    ops_ms = f32_ops / F32_OPS_PER_S * 1e3 + 3 * tf32_products / TF32_OPS_PER_S * 1e3
    out = {"bytes": b, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
           "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    if tf32_products:
        out["bound_ms_f32"] = max(bytes_ms, ops / F32_OPS_PER_S * 1e3)
    return out


def phase_kernels_chains(rng, card: str):
    """The chains of the Pipeline slice and the table's last four classes on
    the card against their plain versions, then cold and warm times (module
    docstring, phase 22). Returns the MLP kernel's readings, the row-local
    kernel's largest error and its timed chains."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
    from flink_ml_tpu_torch.servable.megakernels import (
        ROWLOCAL,
        ROWLOCAL_MLP,
        SPARSE_IDF_LOGISTIC,
        rowlocal_chain,
        rowlocal_chain_plain,
        rowlocal_mlp,
        rowlocal_mlp_plain,
        sparse_idf,
        sparse_idf_plain,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain products in full float32

    # 1. a row-local prefix before kmeans: the row-local kernel's kmeans op
    km = {"configurations": 0, "rows_inside_margin": 0, "max_abs_err": 0.0}
    for name in CHAIN_KMEANS_NAMES:
        for measure in KMEANS_MEASURES:
            for d in CHAIN_KMEANS_DIMS:
                for k in CHAIN_KMEANS_KS:
                    for rows in CHECK_ROWS:
                        inputs, ops = _chain_kmeans_case(name, rows, d, k, measure, dev, rng)
                        before = ROWLOCAL.launches
                        got = rowlocal_chain(inputs, ops)
                        want = rowlocal_chain_plain(inputs, ops)
                        torch.cuda.synchronize()
                        if ROWLOCAL.launches != before + 1:
                            raise AssertionError("the row-local kernel did not launch once")
                        n_in, err = _check_chain_kmeans(inputs, ops, got, want, measure,
                                                        f"{name} {measure} d={d} k={k} rows={rows}")
                        km["configurations"] += 1
                        km["rows_inside_margin"] += n_in
                        km["max_abs_err"] = max(km["max_abs_err"], err)
    emit("kernels_chains", kernel=ROWLOCAL.name, chains=list(CHAIN_KMEANS_NAMES), **km,
         grid={"measures": list(KMEANS_MEASURES), "d": list(CHAIN_KMEANS_DIMS), "k": list(CHAIN_KMEANS_KS),
               "rows": list(CHECK_ROWS)},
         rule=("scaled bit-equal; normalized within ULP_ENVELOPE['feature6']; the index equal where the "
               f"float64 top-two distance gap exceeds {KMEANS_MARGIN}"))

    # 2. a row-local prefix before mlp: the MLP kernel's table prologue
    networks = dict(MLP_CHECK_NETWORKS)
    networks["limits"] = (512,) * 8 + (32,)
    mlp = {"configurations": 0, "rows_inside_margin": 0, "max_abs_err": 0.0, "max_prob_ulps": 0}
    for name in CHAIN_MLP_NAMES:
        for net, widths in networks.items():
            for rows in MLP_CHECK_ROWS:
                inputs, ops, head_src, layers, labels = _chain_mlp_case(name, rows, list(widths), dev, rng)
                before = ROWLOCAL_MLP.launches
                outs, pred, probs = _mlp_head(rowlocal_mlp, inputs, ops, head_src, layers, labels)
                p_outs, p_pred, p_probs = _mlp_head(rowlocal_mlp_plain, inputs, ops, head_src, layers, labels)
                torch.cuda.synchronize()
                where = f"{name} {net} rows={rows}"
                if ROWLOCAL_MLP.launches != before + 1:
                    raise AssertionError(f"the MLP prologue kernel did not launch once: {where}")
                _n, err, _u = _check_rowlocal(inputs, ops, outs, p_outs, where)
                ulps = ulp_diff(probs.cpu().numpy(), p_probs.cpu().numpy())
                if ulps > ULP_ENVELOPE["scale_mlp"]:
                    raise AssertionError(f"probabilities {ulps} ulps from the plain version: {where}")
                sure = _top_two_gap(layers, (list(inputs) + p_outs)[head_src]) > PREDICTION_MARGIN
                if not torch.equal(pred[sure], p_pred[sure]):
                    raise AssertionError(f"prediction differs outside the margin: {where}")
                mlp["configurations"] += 1
                mlp["rows_inside_margin"] += int((~sure).sum())
                mlp["max_abs_err"] = max(mlp["max_abs_err"], err, float((probs - p_probs).abs().max()))
                mlp["max_prob_ulps"] = max(mlp["max_prob_ulps"], ulps)
    emit("kernels_chains", kernel=ROWLOCAL_MLP.name, chains=list(CHAIN_MLP_NAMES), **mlp,
         grid={"networks": {k: list(v) for k, v in networks.items()}, "rows": list(MLP_CHECK_ROWS)},
         rule=("the table's outputs bit-equal until a normalize, then within ULP_ENVELOPE['feature6']; "
               "probabilities within ULP_ENVELOPE['scale_mlp']; prediction equal where the plain "
               f"top-two logit gap exceeds {PREDICTION_MARGIN}"))

    # 3. sparse_idf alone: the sparse kernel's head-less mode
    sp = {"configurations": 0}
    for d in SPARSE_DIMS:
        idf = torch.from_numpy(np.abs(rng.normal(size=d)).astype(np.float32) + np.float32(0.1)).to(dev)
        for rows in SPARSE_ROWS:
            for cap in SPARSE_CAPS:
                nnz = rng.integers(0, cap + 1, rows)
                ids = np.sort(rng.integers(0, d, (rows, cap)), axis=1).astype(np.int32)
                vals = rng.normal(size=(rows, cap)).astype(np.float32)
                dead = np.arange(cap)[None, :] >= nnz[:, None]
                ids[dead], vals[dead] = 0, 0.0
                v_t, i_t = torch.from_numpy(vals).to(dev), torch.from_numpy(ids).to(dev)
                before = SPARSE_IDF_LOGISTIC.launches
                got = sparse_idf(v_t, i_t, idf)
                torch.cuda.synchronize()
                where = f"rows={rows} cap={cap} d={d}"
                if SPARSE_IDF_LOGISTIC.launches != before + 1:
                    raise AssertionError(f"the sparse kernel did not launch once: {where}")
                for want in (sparse_idf_plain(v_t, i_t, idf), v_t * idf[i_t.long()]):
                    if not _same_bits(got, want):
                        raise AssertionError(f"tfidf not bit-equal to float32 values * idf[ids]: {where}")
                sp["configurations"] += 1
    emit("kernels_chains", kernel=SPARSE_IDF_LOGISTIC.name, chains=["sparse_idf"], **sp,
         grid={"d": list(SPARSE_DIMS), "rows": list(SPARSE_ROWS), "caps": list(SPARSE_CAPS)},
         rule="tfidf bit-equal to the plain version and to float32 values * idf[ids]")

    # 4. the table's last four classes against the plain table
    sparse_models = {}
    for d in RESIDUE_DIMS:
        idf = torch.from_numpy(np.abs(rng.normal(size=d)).astype(np.float32) + np.float32(0.1)).to(dev)
        sparse_models[d] = (idf, (idf * 0.5 + 0.25).contiguous(),
                            torch.from_numpy((rng.normal(size=d) * 0.3).astype(np.float32)).to(dev))
    residue = {}
    for cls, names in RESIDUE_CHAINS.items():
        seen = {"configurations": 0, "inside_margin": 0, "max_abs_err": 0.0, "launches": 0}
        sparse = cls in ("sparse_with_dense", "other_sparse_run")
        widths = list(MLP_CHECK_NETWORKS.values()) if cls == "mlp_not_last" else RESIDUE_WIDTHS
        grid = [(w, cap, d) for w in widths for cap in (RESIDUE_CAPS if sparse else (0,))
                for d in (RESIDUE_DIMS if sparse else (0,))]
        for name in names:
            for rows in RESIDUE_ROWS:
                for width, cap, d in grid:
                    inputs, ops, kernel = _residue_case(name, rows, width, cap, d, dev, rng, sparse_models)
                    run, run_plain = ((rowlocal_mlp, rowlocal_mlp_plain) if kernel is ROWLOCAL_MLP
                                      else (rowlocal_chain, rowlocal_chain_plain))
                    before = kernel.launches
                    got = run(inputs, ops)
                    want = run_plain(inputs, ops)
                    torch.cuda.synchronize()
                    where = f"{cls} {name} rows={rows} width={width} cap={cap} d={d}"
                    if kernel.launches != before + 1:
                        raise AssertionError(f"{kernel.name} did not launch once: {where}")
                    n_in, err = _check_table(inputs, ops, got, want, where)
                    seen["configurations"] += 1
                    seen["launches"] += 1
                    seen["inside_margin"] += n_in
                    seen["max_abs_err"] = max(seen["max_abs_err"], err)
        residue[cls] = {"chains": list(names), **seen}
    emit("kernels_chains", classes=residue,
         grid={"rows": list(RESIDUE_ROWS), "widths": list(RESIDUE_WIDTHS), "caps": list(RESIDUE_CAPS),
               "d": list(RESIDUE_DIMS), "networks": {k: list(v) for k, v in MLP_CHECK_NETWORKS.items()}},
         rule=("elementwise ops and tf-idf bit-equal until a normalize or a head, then within "
               "ULP_ENVELOPE['feature6']; sparse heads' prediction and rawPrediction bit-equal; "
               "MLP probabilities within ULP_ENVELOPE['scale_mlp'], "
               f"prediction equal past a {PREDICTION_MARGIN} logit gap; kmeans index equal past a "
               f"{KMEANS_MARGIN} distance gap; binarize of a rounded column equal outside {BIN_MARGIN}; "
               "binarize (int32) and impute (float32) of the index exact"))

    # 5. cold and warm times at the slice's shapes
    timing, merged_first = _time_chains(dev)
    emit("kernels_chains", card=card, timing=timing, merged_program_first=merged_first,
         library="none: no single PyTorch call computes normalize -> kmeans, normalize -> mlp, "
                 "values * idf[ids], IDF -> LR -> scale, normalize -> mlp -> binarize or "
                 "kmeans -> binarize")
    table = ("idf_lr_scale", "kmeans_binarize")
    return ({"max_abs_err": max(mlp["max_abs_err"], residue["mlp_not_last"]["max_abs_err"]),
             **timing["normalize_mlp"], "chains": {k: v for k, v in timing.items() if k not in table}},
            max(km["max_abs_err"], *(residue[c]["max_abs_err"] for c in residue if c != "mlp_not_last")),
            {k: timing[k] for k in table})


def _time_chains(dev):
    """Cold and warm CUDA-event times of the table chains at the slice's
    shapes, each held against its plain version first, beside the plain
    version, the merged program of the chains the table's last classes
    added (the fast tier's program without a megakernel: the specs'
    ``kernel_fn`` bodies) and the bound. The merged program of IDF → LR →
    scale is timed first, before any kernel of this phase's timing ran.
    Returns ``(timing, the merged program's first reading)``."""
    import numpy as np
    import torch

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
    from flink_ml_tpu_torch.servable.megakernels import (
        RowLocalOp,
        rowlocal_chain,
        rowlocal_chain_plain,
        rowlocal_mlp,
        rowlocal_mlp_plain,
        sparse_idf,
        sparse_idf_plain,
    )
    from flink_ml_tpu_torch.servable.planner import PLAN_FUSED, _Program

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    rows, cap = MAX_BATCH, 64  # serve_sparse's hot key (4096, 64): 39 features a row
    hashed = _hashed_rows(np.random.default_rng(SPARSE_SERVE_SEED), rows, TRAIN_NNZ)
    sp_ids = torch.from_numpy(np.pad(hashed, ((0, 0), (0, cap - TRAIN_NNZ))).astype(np.int32)).to(dev)
    sp_vals = torch.zeros((rows, cap), dtype=torch.float32, device=dev)
    sp_vals[:, :TRAIN_NNZ] = 1.0
    sp_nnz = torch.full((rows,), TRAIN_NNZ, dtype=torch.int32, device=dev)

    # the new chains through the planner's calling convention: the kernel as
    # the main path launches it, the plain table and the merged program
    spec_rng = np.random.default_rng(MIXED_DENSE_SEED)
    chains = _residue_specs(TRAIN_DIM, MIXED_DENSE_D, list(MLP_WIDTHS), KMEANS_D, spec_rng)
    x_dense = torch.from_numpy(spec_rng.normal(size=(rows, MIXED_DENSE_D)).astype(np.float32)).to(dev)
    x_mlp = torch.from_numpy(spec_rng.normal(size=(rows, MLP_WIDTHS[0])).astype(np.float32)).to(dev)
    x_km = torch.from_numpy(spec_rng.random((rows, KMEANS_D)).astype(np.float32)).to(dev)
    cols = {
        "idf_lr_scale": {"tf!values": sp_vals, "tf!ids": sp_ids, "tf!nnz": sp_nnz, "dense": x_dense},
        "normalize_mlp_binarize": {"features": x_mlp},
        "kmeans_binarize": {"features": x_km},
    }
    new = {}
    for name, specs in chains.items():
        models = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in spec.model_arrays.items()}
                  for spec in specs]
        merged = _Program(specs, [models], PLAN_FUSED)
        program = mk._rowlocal_program(specs)
        if program is None or not mk.chain_eligible(specs):
            raise AssertionError(f"{name}: not a table chain")
        inputs, ops = program.bind(models, cols[name])
        run_plain = rowlocal_mlp_plain if program.mlp_heads else rowlocal_chain_plain
        new[name] = (mk.build_megakernel_fn(specs), models, merged, inputs, ops, run_plain)

    # the yardstick first: the merged program of IDF -> LR -> scale, before any kernel of it ran
    mega, models, merged, inputs, ops, run_plain = new["idf_lr_scale"]
    for _ in range(10):
        merged(cols["idf_lr_scale"])
    torch.cuda.synchronize()
    merged_first = {"cold_ms": _median(_cold_times(lambda: merged(cols["idf_lr_scale"]), 25, flush,
                                                   hold_cycles=4_000_000)),
                    "warm_ms": _warm_time(lambda: merged(cols["idf_lr_scale"]), 25)}

    # the timed shapes held against the plain versions first, and the main
    # path's call against the merged program on the outputs no near tie moves
    for name, (mega, models, merged, inputs, ops, run_plain) in new.items():
        run = rowlocal_mlp if run_plain is rowlocal_mlp_plain else rowlocal_chain
        _check_table(inputs, ops, run(inputs, ops), run_plain(inputs, ops), f"timed {name}")
        got, ref = mega(models, cols[name]), merged(cols[name])
        for n in ("tfidf!values", "scaled", "rawPrediction"):
            if n in ref and ulp_diff(got[n].cpu().numpy(), ref[n].cpu().numpy()) > ULP_ENVELOPE["scale_mlp"]:
                raise AssertionError(f"timed {name}: {n} outside the envelope of the merged program")

    timed_rng = np.random.default_rng(KMEANS_SERVE_SEED)
    x, _mean, _inv, C = _kmeans_inputs(timed_rng, MAX_BATCH, KMEANS_D, KMEANS_K, dev)
    km_in = [x]
    km_ops = [RowLocalOp("normalize", 0, params={"p": 2.0}),
              RowLocalOp("kmeans", 1, (C / C.norm(dim=1, keepdim=True)).contiguous(),
                         params={"measure": "euclidean"})]
    mlp_in, mlp_ops, mlp_src, layers, labels = _chain_mlp_case(
        "normalize_mlp", MAX_BATCH, list(MLP_WIDTHS), dev, np.random.default_rng(MLP_SERVE_SEED))
    sp_idf = torch.from_numpy(np.abs(np.random.default_rng(5).normal(size=TRAIN_DIM)).astype(np.float32)
                              + np.float32(0.1)).to(dev)
    _check_chain_kmeans(km_in, km_ops, rowlocal_chain(km_in, km_ops), rowlocal_chain_plain(km_in, km_ops),
                        "euclidean", "timed normalize -> kmeans")
    outs, pred, probs = _mlp_head(rowlocal_mlp, mlp_in, mlp_ops, mlp_src, layers, labels)
    p_outs, p_pred, p_probs = _mlp_head(rowlocal_mlp_plain, mlp_in, mlp_ops, mlp_src, layers, labels)
    if ulp_diff(probs.cpu().numpy(), p_probs.cpu().numpy()) > ULP_ENVELOPE["scale_mlp"]:
        raise AssertionError("timed normalize -> mlp outside the envelope")
    if not _same_bits(sparse_idf(sp_vals, sp_ids, sp_idf), sparse_idf_plain(sp_vals, sp_ids, sp_idf)):
        raise AssertionError("timed sparse_idf not bit-equal")
    fns = {
        "normalize_kmeans": lambda: rowlocal_chain(km_in, km_ops),
        "normalize_kmeans_plain": lambda: rowlocal_chain_plain(km_in, km_ops),
        "normalize_mlp": lambda: _mlp_head(rowlocal_mlp, mlp_in, mlp_ops, mlp_src, layers, labels),
        "normalize_mlp_plain": lambda: _mlp_head(rowlocal_mlp_plain, mlp_in, mlp_ops, mlp_src, layers, labels),
        "sparse_idf": lambda: sparse_idf(sp_vals, sp_ids, sp_idf),
        "sparse_idf_plain": lambda: sparse_idf_plain(sp_vals, sp_ids, sp_idf),
    }
    for name, (mega, models, merged, inputs, ops, run_plain) in new.items():
        fns[name] = lambda m=mega, mo=models, c=cols[name]: m(mo, c)
        fns[name + "_plain"] = lambda r=run_plain, i=inputs, o=ops: r(i, o)
        fns[name + "_merged"] = lambda p=merged, c=cols[name]: p(c)
    for fn in fns.values():  # warm-up
        for _ in range(10):
            fn()
    torch.cuda.synchronize()
    times = {n: {"cold": [], "warm": []} for n in fns}
    order = list(fns)
    for name in order + order[::-1]:  # each side twice, in turns
        times[name]["cold"] += _cold_times(fns[name], 25, flush, hold_cycles=4_000_000)
        times[name]["warm"].append(_warm_time(fns[name], 25))
    cold = {n: _median(v["cold"]) for n, v in times.items()}
    warm = {n: _median(v["warm"]) for n, v in times.items()}
    widths = list(MLP_WIDTHS)
    mlp_products = 2 * rows * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    mlp_weights = 4 * sum(a * b + b for a, b in zip(widths[:-1], widths[1:])) + 4 * widths[-1]
    # each distinct 32-byte sector of a gathered model vector once (a repeat
    # hits L2), as kernels_sparse counts them: padding slots gather id 0
    sectors = int(torch.unique(sp_ids // 8).numel())
    bounds = {
        # x in, normalized out, index out, centroids; normalize 3 an element + a root a row,
        # the head 2·k·d (the dots) + 4·k (distance and search) a row
        "normalize_kmeans": _chain_bound(4 * rows * KMEANS_D, 4 * rows * KMEANS_D + 4 * rows,
                                         4 * KMEANS_K * KMEANS_D,
                                         rows * (3 * KMEANS_D + 1 + 2 * KMEANS_K * KMEANS_D + 4 * KMEANS_K)),
        # x in, normalized, prediction and probabilities out, the weights; the products dominate
        "normalize_mlp": _chain_bound(4 * rows * widths[0], 4 * rows * (widths[0] + 1 + widths[-1]),
                                      mlp_weights, mlp_products + rows * (3 * widths[0] + 1), mlp_products),
        # values and ids in, tfidf out, idf's sectors at the batch's ids; one multiply a slot
        "sparse_idf": _chain_bound(8 * rows * cap, 4 * rows * cap, 32 * sectors, rows * cap),
        # values and ids of every slot, the dense column in; tf-idf of every slot, prediction,
        # rawPrediction and the scaled column out; idf's and coef's sectors at the batch's ids,
        # mean and inv_std; per entry a multiply for tf-idf, a multiply and an add for the
        # margin, the sigmoid's 4 a row, 2 an element of the scale
        "idf_lr_scale": _chain_bound(8 * rows * cap + 4 * rows * MIXED_DENSE_D,
                                     4 * rows * cap + 12 * rows + 4 * rows * MIXED_DENSE_D,
                                     2 * 32 * sectors + 2 * 4 * MIXED_DENSE_D,
                                     rows * (3 * TRAIN_NNZ + 4 + 2 * MIXED_DENSE_D)),
        # normalize_mlp's, and the binarized probabilities out (one compare an element)
        "normalize_mlp_binarize": _chain_bound(4 * rows * widths[0],
                                               4 * rows * (widths[0] + 1 + 2 * widths[-1]), mlp_weights,
                                               mlp_products + rows * (3 * widths[0] + 1 + widths[-1]),
                                               mlp_products),
        # x in, the index and its binarize out, the centroids; the head's 3·k·d (|h|^2 aside, the
        # dots and norms) + 4·k a row, one compare
        "kmeans_binarize": _chain_bound(4 * rows * KMEANS_D, 8 * rows, 4 * KMEANS_K * KMEANS_D,
                                        rows * (2 * KMEANS_D + 2 * KMEANS_K * KMEANS_D + 4 * KMEANS_K + 1)),
    }
    shapes = {
        "normalize_kmeans": {"rows": rows, "d": KMEANS_D, "k": KMEANS_K, "measure": "euclidean"},
        "normalize_mlp": {"rows": rows, "widths": widths},
        "sparse_idf": {"rows": rows, "cap": cap, "nnz": TRAIN_NNZ, "d": TRAIN_DIM, "distinct_sectors": sectors},
        "idf_lr_scale": {"rows": rows, "cap": cap, "nnz": TRAIN_NNZ, "d": TRAIN_DIM, "dense": MIXED_DENSE_D,
                         "distinct_sectors": sectors},
        "normalize_mlp_binarize": {"rows": rows, "widths": widths},
        "kmeans_binarize": {"rows": rows, "d": KMEANS_D, "k": RESIDUE_K, "measure": "euclidean"},
    }
    timing = {}
    for name in shapes:
        timing[name] = {
            "ms": cold[name], "ms_l2_warm": warm[name],
            "plain_ms": cold[name + "_plain"], "plain_ms_l2_warm": warm[name + "_plain"],
            "library_ms": None, **bounds[name], "shape": shapes[name],
        }
        if name in new:
            timing[name].update(merged_ms=cold[name + "_merged"], merged_ms_l2_warm=warm[name + "_merged"])
    return timing, merged_first


def _published_kmeans_pipeline():
    """Pipeline([StandardScaler, Normalizer(p 2), KMeans(k 10, maxIter 10)])
    at kmeans-benchmark.json's paramMap."""
    from flink_ml_tpu_torch.builder import Pipeline
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
    from flink_ml_tpu_torch.models.feature.normalizer import Normalizer
    from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScaler

    return Pipeline([
        StandardScaler().set_input_col("features").set_output_col("scaled").set_with_mean(True).set_with_std(True),
        Normalizer().set_input_col("scaled").set_output_col("norm").set_p(2.0),
        KMeans().set_features_col("norm").set_k(KMEANS_K).set_max_iter(KMEANS_ITERS),
    ])


def _kmeans_pipeline_float64(model, x):
    """Float64 numpy of the fitted pipeline on rows ``x`` (read as float32, as
    the path reads them): scaled, normalized, distances to the centroids."""
    import numpy as np

    scaler, _norm, km = model.stages
    mean = np.asarray(scaler.mean, np.float32).astype(np.float64)
    std = np.asarray(scaler.std, np.float32).astype(np.float64)
    inv_std = np.where(std == 0.0, 0.0, 1.0 / np.where(std == 0.0, 1.0, std))
    inv_std = inv_std.astype(np.float32).astype(np.float64)
    scaled = (np.asarray(x, np.float32).astype(np.float64) - mean) * inv_std
    n = np.linalg.norm(scaled, axis=1, keepdims=True)
    norm = scaled / np.where(n == 0.0, 1.0, n)
    C = np.asarray(km.centroids, np.float32).astype(np.float64)
    dist = np.sqrt(np.maximum((norm ** 2).sum(1)[:, None] + (C ** 2).sum(1)[None, :] - 2.0 * norm @ C.T, 0.0))
    return scaled, norm, dist


def _decided_rows(dist):
    import numpy as np

    top = np.sort(dist, axis=1)
    return top[:, 1] - top[:, 0] > KMEANS_MARGIN


def _serve_pipeline(pipeline, name, payloads, column, check, hot_from, kernel, template):
    """Serve ``pipeline`` with ``InferenceServer`` (fusion.mode=fast) to the
    payloads from N_CLIENTS clients, every response checked; counts every
    kernel's launches over the traffic alone and the plain versions' calls.
    Returns the readings; fails unless ``kernel`` launched once per batch of
    bucket ≥ ``hot_from``, the plain versions were never called, no batch
    fell back and no chain was built after warmup."""
    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    config = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
    t0 = time.perf_counter()
    server = InferenceServer(pipeline, name=name, serving_config=config,
                             warmup_template=DataFrame.from_dict({column: template}), device="cuda")
    warmup_s = time.perf_counter() - t0
    scope = server.scope
    with server:
        plan = pipeline._fastpath_plan
        kinds = chain_kinds(plan)
        ingest = plan._ingest
        # The path's run starts here: counts to 0, then traffic.
        for k in KERNELS:
            k.reset_launches()
        plain_calls, restore = _count_calls(mk, _PLAIN_MEGAKERNELS)
        batches_before = len(server.executed_batch_sizes)
        fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
        try:
            latencies, wall, failures = _serve_and_check(server, payloads, column, check)
        finally:
            restore()
        launches = kernel.launches
        other = {k.name: k.launches for k in KERNELS if k is not kernel}
        batches = server.executed_batch_sizes[batches_before:]
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    sizes = [len(p) for p in payloads]
    breakdown = _dense_batch_breakdown(
        plan, DataFrame.from_dict({column: payloads[sizes.index(MAX_BATCH)]}), ingest, col=column)
    hot = sorted(b for b, kind in kinds.items() if "megakernel" in kind)
    if hot != [b for b in kinds if b >= hot_from]:
        raise AssertionError(f"hot buckets {hot}: the cost model should mark every bucket from {hot_from}")
    hot_batches = sum(1 for _, bucket in batches if bucket >= hot_from)
    fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
    compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    if not launches > 0 or launches != hot_batches:
        raise AssertionError(f"{kernel.name} launches {launches} != batches of bucket >= {hot_from} {hot_batches}")
    if fallback != 0:
        raise AssertionError(f"{fallback} batches fell back to the per-stage path")
    if compiles != 0:
        raise AssertionError(f"{compiles} chains were built after warmup")
    if plain_calls:
        raise AssertionError(f"plain megakernel versions were called: {sorted(set(plain_calls))}")
    if any(other.values()):
        raise AssertionError(f"other kernels launched while serving: {other}")
    lat = sorted(latencies)
    return {
        "warmup_s": warmup_s, "warmed_buckets": len(kinds), "chain": [list(v) for v in set(kinds.values())],
        "requests": len(payloads), "rows": sum(sizes), "batches": len(batches),
        "hot_buckets": hot, "hot_batches": hot_batches, "megakernel_launches": launches,
        "fallback_batches": fallback, "post_warmup_builds": compiles, "plain_calls": len(plain_calls),
        "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(sizes) / wall, "wall_s": wall, "hot_batch_breakdown_ms": breakdown,
    }


def _traffic_sizes(rng):
    """64 request sizes of 1–4096 rows, every 16th on a large bucket."""
    n_req = N_CLIENTS * REQUESTS_PER_CLIENT
    sizes = [int(min(MAX_BATCH, max(1, round(2 ** rng.uniform(0, 12))))) for _ in range(n_req)]
    sizes[::16] = [MAX_BATCH, MAX_BATCH * 1500 // 4096, MAX_BATCH // 2,
                   MAX_BATCH * 600 // 4096][: len(sizes[::16])]  # hot buckets on every run
    return sizes


def _batch_transform(model, df, scope="ml.batch[plan]"):
    """``model.transform(df)`` through the batch plan on the card with the
    path's counters read around it: ``(output, seconds, {kernel: launches},
    chains built, chunks)``."""
    import torch

    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.native import KERNELS

    for k in KERNELS:
        k.reset_launches()
    builds = metrics.get(scope, MLMetrics.BATCH_COMPILES, 0)
    chunks = metrics.get(scope, MLMetrics.BATCH_FUSED_CHUNKS, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.transform(df)
    seconds = time.perf_counter() - t0
    return (out, seconds, {k.name: k.launches for k in KERNELS if k.launches},
            metrics.get(scope, MLMetrics.BATCH_COMPILES, 0) - builds,
            metrics.get(scope, MLMetrics.BATCH_FUSED_CHUNKS, 0) - chunks)


def _batch_expectations(plan, rows):
    """What the batch plan's one fused segment must show for ``rows`` input
    rows at PIPELINE_CHUNK_ROWS: ``(chunks, distinct chunk signatures,
    chunks whose chain the cost model ran as the megakernel)``."""
    (segment,) = [s for s in plan.segments if hasattr(s, "plan_kinds")]
    sizes = [PIPELINE_CHUNK_ROWS] * (rows // PIPELINE_CHUNK_ROWS) + (
        [rows % PIPELINE_CHUNK_ROWS] if rows % PIPELINE_CHUNK_ROWS else [])
    hot_rows = {next(iter(key))[1][0] for key, kinds in segment.plan_kinds.items() if "megakernel" in kinds}
    return len(sizes), len(set(sizes)), sum(1 for n in sizes if n in hot_rows)


def phase_pipeline_kmeans(card: str):
    """StandardScaler → Normalizer → KMeans fitted through Pipeline.fit,
    transformed in the batch tier, saved, loaded and served (module
    docstring, phase 23)."""
    import tempfile

    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.builder import PipelineModel
    from flink_ml_tpu_torch.config import Options, config
    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff

    X = _kmeans_published_rows()
    df = DataFrame.from_dict({"features": X})
    t0 = time.perf_counter()
    model = _published_kmeans_pipeline().fit(df)
    fit_s = time.perf_counter() - t0
    if [type(s).__name__ for s in model.stages] != ["StandardScalerModel", "Normalizer", "KMeansModel"]:
        raise AssertionError(f"Pipeline.fit gave {model.stages}")

    config.set(Options.FUSION_MODE, "fast")
    config.set(Options.BATCH_CHUNK_ROWS, PIPELINE_CHUNK_ROWS)  # two chunks, the second ragged
    try:
        out, batch_s, batch_launches, builds, chunks = _batch_transform(model, df)
        again, batch_s2, launches2, builds2, _ = _batch_transform(model, df)
        plan = model._plan_cache[1]
        config.set(Options.BATCH_FASTPATH, False)
        t0 = time.perf_counter()
        per_stage = model.transform(df)
        per_stage_s = time.perf_counter() - t0
    finally:
        for option in (Options.FUSION_MODE, Options.BATCH_CHUNK_ROWS, Options.BATCH_FASTPATH):
            config.unset(option)
    segment = plan.segments[0]
    labels = sorted({segment.plan_label(key) for key in segment.compiled})
    want_chunks, want_builds, hot_chunks = _batch_expectations(plan, len(X))
    if (builds, builds2, chunks) != (want_builds, 0, want_chunks) or not hot_chunks:
        raise AssertionError(f"batch plan: {builds} then {builds2} builds, {chunks} chunks "
                             f"({hot_chunks} hot), tiers {labels}")
    if batch_launches != {mk.ROWLOCAL.name: hot_chunks} or launches2 != batch_launches:
        raise AssertionError(f"batch launches {batch_launches}, then {launches2}: expected {hot_chunks} "
                             "of the row-local kernel")
    scaled64, norm64, dist = _kmeans_pipeline_float64(model, X)
    decided = _decided_rows(dist)
    for name in ("scaled", "norm", "prediction"):
        if not np.array_equal(out.column(name), again.column(name)):
            raise AssertionError(f"two batch transforms differ in {name}")
    np.testing.assert_array_equal(out.column("scaled"), per_stage.column("scaled"))
    norm_ulps = ulp_diff(out.column("norm"), per_stage.column("norm"))
    if norm_ulps > ULP_ENVELOPE["feature6"]:
        raise AssertionError(f"batch norm {norm_ulps} ulps from the per-stage path")
    np.testing.assert_array_equal(out.column("prediction")[decided], per_stage.column("prediction")[decided])
    np.testing.assert_allclose(out.column("scaled"), scaled64, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.column("norm"), norm64, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out.column("prediction")[decided], np.argmin(dist, axis=1)[decided])
    batch = {"rows": len(X), "chunks": chunks, "hot_chunks": hot_chunks, "builds": builds,
             "builds_second_call": builds2, "tiers": labels, "launches": batch_launches, "seconds": batch_s, "seconds_second_call": batch_s2,
             "per_stage_seconds": per_stage_s, "rows_inside_margin": int((~decided).sum()),
             "norm_ulps_from_per_stage": norm_ulps}

    with tempfile.TemporaryDirectory() as tmp:
        model.save(f"{tmp}/pipeline")
        loaded = PipelineModel.load(f"{tmp}/pipeline")
        pipeline = PipelineModel.load_servable(f"{tmp}/pipeline")
    if not np.array_equal(loaded.stages[2].centroids, model.stages[2].centroids):
        raise AssertionError("the loaded centroids differ from the fitted ones")
    specs = [s.kernel_spec() for s in pipeline.servables]
    if [s.fusion_op for s in specs] != ["scale", "normalize", "kmeans"] or not mk.chain_eligible(specs):
        raise AssertionError("the served chain is not (scale, normalize, kmeans) on a kernel")

    rng = np.random.default_rng(KMEANS_SERVE_SEED)
    payloads = [rng.random((n, KMEANS_D)) for n in _traffic_sizes(rng)]
    inside = [0] * len(payloads)

    def check(i, resp):
        scaled, norm, d64 = _kmeans_pipeline_float64(model, payloads[i])
        np.testing.assert_allclose(resp["scaled"], scaled, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(resp["norm"], norm, rtol=1e-5, atol=1e-6)
        dec = _decided_rows(d64)
        inside[i] = int((~dec).sum())
        np.testing.assert_array_equal(np.asarray(resp["prediction"])[dec], np.argmin(d64, axis=1)[dec])

    served = _serve_pipeline(pipeline, "chip-smoke-pipeline-kmeans", payloads, "features", check,
                             PIPELINE_KMEANS_HOT_FROM, mk.ROWLOCAL, payloads[0][:1])
    emit("pipeline_kmeans", card=card, fit_rows=len(X), d=KMEANS_D, k=KMEANS_K, fit_s=fit_s, batch=batch,
         serve={**served, "rows_inside_margin": sum(inside)})
    return {"pipeline_kmeans.batch": batch_launches[mk.ROWLOCAL.name],
            "pipeline_kmeans.serve": served["megakernel_launches"]}


def phase_pipeline_mlp(card: str):
    """Normalizer → MLPClassifier fitted through Pipeline.fit at the
    published network, saved, loaded and served (module docstring,
    phase 24)."""
    import tempfile

    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.builder import Pipeline, PipelineModel
    from flink_ml_tpu_torch.models.classification.mlp_classifier import MLPClassifier
    from flink_ml_tpu_torch.models.feature.normalizer import Normalizer

    population = _mlp_population()
    X, y = _mlp_rows(np.random.default_rng(MLP_SEED), population, MLP_ROWS)
    est = Pipeline([
        Normalizer().set_input_col("features").set_output_col("norm").set_p(2.0),
        MLPClassifier().set_features_col("norm").set_hidden_layers(*MLP_WIDTHS[1:-1])
        .set_max_iter(MLP_ITERS).set_global_batch_size(MLP_BATCH),
    ])
    t0 = time.perf_counter()
    model = est.fit(DataFrame.from_dict({"features": X, "label": y}))
    fit_s = time.perf_counter() - t0
    mlp = model.stages[1]
    layers64 = [(np.asarray(W, np.float32).astype(np.float64), np.asarray(b, np.float32).astype(np.float64))
                for W, b in mlp.params]
    if [W.shape for W, _ in layers64] != [(a, b) for a, b in zip(MLP_WIDTHS[:-1], MLP_WIDTHS[1:])]:
        raise AssertionError(f"the fitted network is {[W.shape for W, _ in layers64]}")
    labels = np.asarray(mlp.labels, np.float64)

    with tempfile.TemporaryDirectory() as tmp:
        model.save(f"{tmp}/pipeline")
        pipeline = PipelineModel.load_servable(f"{tmp}/pipeline")
    specs = [s.kernel_spec() for s in pipeline.servables]
    if [s.fusion_op for s in specs] != ["normalize", "mlp"] or not mk.chain_eligible(specs):
        raise AssertionError("the served chain is not (normalize, mlp) on a kernel")

    def forward64(x):
        x = np.asarray(x, np.float32).astype(np.float64)
        n = np.linalg.norm(x, axis=1, keepdims=True)
        h = x / np.where(n == 0.0, 1.0, n)
        norm = h
        for W, b in layers64[:-1]:
            h = np.maximum(h @ W + b, 0.0)
        logits = h @ layers64[-1][0] + layers64[-1][1]
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return norm, logits, e / e.sum(axis=1, keepdims=True)

    rng = np.random.default_rng(MLP_SERVE_SEED)
    payloads = [_mlp_rows(rng, population, n)[0] for n in _traffic_sizes(rng)]
    inside = [0] * len(payloads)
    max_prob_err = [0.0] * len(payloads)

    def check(i, resp):
        norm, logits, probs = forward64(payloads[i])
        np.testing.assert_allclose(resp["norm"], norm, rtol=1e-5, atol=1e-7)
        got = np.asarray(resp["rawPrediction"])
        max_prob_err[i] = float(np.abs(got - probs).max())
        np.testing.assert_allclose(got, probs, rtol=0, atol=PIPELINE_MLP_PROB_ATOL)
        top = np.sort(logits, axis=1)
        dec = top[:, -1] - top[:, -2] > PREDICTION_MARGIN
        inside[i] = int((~dec).sum())
        np.testing.assert_array_equal(np.asarray(resp["prediction"])[dec], labels[np.argmax(logits, axis=1)][dec])

    served = _serve_pipeline(pipeline, "chip-smoke-pipeline-mlp", payloads, "features", check,
                             PIPELINE_MLP_HOT_FROM, mk.ROWLOCAL_MLP, payloads[0][:1])
    emit("pipeline_mlp", card=card, fit_rows=MLP_ROWS, widths=list(MLP_WIDTHS), fit_s=fit_s,
         serve={**served, "rows_inside_margin": sum(inside), "max_prob_err_vs_float64": max(max_prob_err)})
    return {"pipeline_mlp.serve": served["megakernel_launches"]}


def phase_pipeline_sparse(card: str, headline, idf_model, lr_model):
    """PipelineModel([IDF, LogisticRegression]) in the batch tier over the
    headline rows, and a one-stage PipelineModel([IDFModel]) served as a
    TF-IDF featurization service (module docstring, phase 25)."""
    import tempfile

    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.builder import PipelineModel
    from flink_ml_tpu_torch.config import Options, config
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    idx, _y = headline
    df = _sparse_frame(idx)
    model = PipelineModel([idf_model, lr_model])
    idf32 = np.asarray(idf_model.idf, np.float32)
    coef32 = np.asarray(lr_model.coefficient, np.float32).astype(np.float64)
    config.set(Options.FUSION_MODE, "fast")
    config.set(Options.BATCH_CHUNK_ROWS, PIPELINE_CHUNK_ROWS)  # 4 chunks, the last ragged
    try:
        out, batch_s, batch_launches, builds, chunks = _batch_transform(model, df)
        plan = model._plan_cache[1]
        config.set(Options.BATCH_FASTPATH, False)
        t0 = time.perf_counter()
        per_stage = model.transform(df)
        per_stage_s = time.perf_counter() - t0
    finally:
        for option in (Options.FUSION_MODE, Options.BATCH_CHUNK_ROWS, Options.BATCH_FASTPATH):
            config.unset(option)
    (segment,) = plan.segments
    if [s.fusion_op for s in segment.specs] != ["sparse_idf", "sparse_logistic"]:
        raise AssertionError(f"the batch chain is {[s.fusion_op for s in segment.specs]}")
    labels = sorted({segment.plan_label(key) for key in segment.compiled})
    want_chunks, want_builds, hot_chunks = _batch_expectations(plan, len(idx))
    if (builds, chunks) != (want_builds, want_chunks) or not hot_chunks \
            or batch_launches != {mk.SPARSE_IDF_LOGISTIC.name: hot_chunks}:
        raise AssertionError(f"batch plan: {builds} builds, {chunks} chunks ({hot_chunks} hot), tiers {labels}, "
                             f"launches {batch_launches}")
    for r in range(0, len(idx), 997):
        got, ref = out.column("tfidf")[r], per_stage.column("tfidf")[r]
        if not (np.array_equal(got.indices, idx[r]) and np.array_equal(got.values, ref.values)
                and np.array_equal(got.values, idf32[idx[r]].astype(np.float64))):
            raise AssertionError(f"batch tfidf row {r} is not the f32 product")
    np.testing.assert_array_equal(out.column("prediction"), per_stage.column("prediction"))
    raw_ulps = ulp_diff(out.column("rawPrediction"), per_stage.column("rawPrediction"))
    if raw_ulps > ULP_ENVELOPE["sparse_idf_logistic"]:
        raise AssertionError(f"batch rawPrediction {raw_ulps} ulps from the per-stage path")
    margin = (idf32[idx].astype(np.float64) * coef32[idx]).sum(axis=1)
    p = 1.0 / (1.0 + np.exp(-margin))
    np.testing.assert_allclose(out.column("rawPrediction"), np.stack([1.0 - p, p], axis=1), rtol=0, atol=1e-5)
    batch = {"rows": len(idx), "chunks": chunks, "hot_chunks": hot_chunks, "builds": builds, "tiers": labels,
             "launches": batch_launches,
             "seconds": batch_s, "per_stage_seconds": per_stage_s, "raw_ulps_from_per_stage": raw_ulps}

    # the TF-IDF featurization service: ("sparse_idf",) on the head-less kernel
    with tempfile.TemporaryDirectory() as tmp:
        PipelineModel([idf_model]).save(f"{tmp}/idf-service")
        service = PipelineModel.load_servable(f"{tmp}/idf-service")
    rng = np.random.default_rng(SPARSE_SERVE_SEED + 1)
    sizes = _traffic_sizes(rng)
    payload_ids = [_hashed_rows(rng, n, TRAIN_NNZ if i % 4 else (1, 5, 17, 38)[i // 4 % 4])
                   for i, n in enumerate(sizes)]
    payloads = [_sparse_frame(ids) for ids in payload_ids]
    config_ = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
    t0 = time.perf_counter()
    server = InferenceServer(service, name="chip-smoke-idf-service", serving_config=config_,
                             warmup_template=payloads[0].take([0]), device="cuda")
    warmup_s = time.perf_counter() - t0
    scope = server.scope
    failures, latencies = [], [None] * len(payloads)
    with server:
        plan = service._fastpath_plan
        kinds = chain_kinds(plan)
        keys = []
        ingest = plan._ingest

        def recording_ingest(seg, frame, bucket, cap=None, warm=False):
            got = ingest(seg, frame, bucket, cap=cap, warm=warm)
            keys.append(got[1])
            return got

        plan._ingest = recording_ingest
        for k in KERNELS:
            k.reset_launches()
        plain_calls, restore = _count_calls(mk, _PLAIN_MEGAKERNELS)
        fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)

        def client(c):
            for i in range(c, len(payloads), N_CLIENTS):
                t_req = time.perf_counter()
                try:
                    resp = server.predict(payloads[i]).dataframe
                    latencies[i] = (time.perf_counter() - t_req) * 1000.0
                    ids = payload_ids[i]
                    got = resp["tfidf"]
                    for r in range(len(ids)):
                        if not (np.array_equal(got[r].indices, ids[r])
                                and np.array_equal(got[r].values, idf32[ids[r]].astype(np.float64))):
                            raise AssertionError(f"row {r}: tfidf is not float32 values * idf[ids]")
                except BaseException as e:  # noqa: BLE001 — reported below, fails the run
                    failures.append(f"request {i}: {type(e).__name__}: {e}")

        try:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            restore()
            plan._ingest = ingest
        launches = mk.SPARSE_IDF_LOGISTIC.launches
        other = {k.name: k.launches for k in KERNELS if k is not mk.SPARSE_IDF_LOGISTIC}
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    chains = {tuple(s.fusion_op for s in seg.specs) for seg in plan.segments}
    hot = sorted(k for k, kind in kinds.items() if "megakernel" in kind)
    hot_batches = sum(1 for k in keys if k in hot)
    fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
    compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    if chains != {("sparse_idf",)}:
        raise AssertionError(f"the service's chains are {chains}")
    if not launches > 0 or launches != hot_batches:
        raise AssertionError(f"head-less sparse launches {launches} != batches with hot keys {hot_batches}")
    if fallback or compiles or plain_calls or any(other.values()):
        raise AssertionError(f"fallbacks {fallback}, post-warmup builds {compiles}, plain calls "
                             f"{sorted(set(plain_calls))}, other kernels {other}")
    lat = sorted(latencies)
    service_readings = {
        "warmup_s": warmup_s, "warmed_keys": len(kinds), "requests": len(payloads), "rows": sum(sizes),
        "batches": len(keys), "hot_keys": hot, "hot_batches": hot_batches, "megakernel_launches": launches,
        "fallback_batches": fallback, "post_warmup_builds": compiles, "plain_calls": len(plain_calls),
        "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(sizes) / wall, "wall_s": wall,
    }
    emit("pipeline_sparse", card=card, batch=batch, idf_service=service_readings)
    return {"pipeline_sparse.batch": batch_launches[mk.SPARSE_IDF_LOGISTIC.name],
            "pipeline_sparse.idf_service": launches}


def _mixed_batch_breakdown(plan, df, ingest, reps=5):
    """Where one full-bucket batch of the mixed pipeline goes on the plan's
    path (host clock, the device synchronised after each step; median of
    ``reps``): packing the SparseVectors and gathering the dense column on
    the host, their upload, the chain on the card, and the readback with
    the tf-idf SparseVectors rebuilt."""
    import torch

    from flink_ml_tpu_torch.servable.planner import PlanExecution, run_segment, to_device
    from flink_ml_tpu_torch.servable.sparse import resolve_nnz_cap_max

    (segment,) = plan.segments
    _inputs, key = ingest(segment, df, len(df))
    steps = {"pack_and_gather": [], "upload": [], "chain": [], "readback": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        arrays, _cap = segment.gather_sparse(df, "features", cap_max=resolve_nnz_cap_max())
        arrays["dense"] = segment.gather(df, "dense")
        t1 = time.perf_counter()
        inputs = {name: to_device(arr, plan.device) for name, arr in arrays.items()}
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        outputs = run_segment(segment, key, inputs)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        PlanExecution(df, segment.pending(outputs)).finalize()
        t4 = time.perf_counter()
        for name, dt in zip(steps, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            steps[name].append(dt * 1e3)
    medians = {name: _median(v) for name, v in steps.items()}
    return {"rows": len(df), "key": list(key), "kinds": list(segment.plan_kinds[key]), **medians,
            "chain_share": medians["chain"] / sum(medians.values())}


def _batch_against_per_stage(model, df, kernel, where):
    """``model.transform(df)`` through the batch plan (fusion.mode=fast,
    65,536-row chunks) and through the per-stage path on the card: the
    plan's readings, both frames; fails unless ``kernel`` launched once a
    chunk and nothing else did."""
    from flink_ml_tpu_torch.config import Options, config

    config.set(Options.FUSION_MODE, "fast")
    config.set(Options.BATCH_CHUNK_ROWS, PIPELINE_CHUNK_ROWS)
    try:
        out, seconds, launches, builds, chunks = _batch_transform(model, df)
        plan = model._plan_cache[1]
        config.set(Options.BATCH_FASTPATH, False)
        t0 = time.perf_counter()
        per_stage = model.transform(df)
        per_stage_s = time.perf_counter() - t0
    finally:
        for option in (Options.FUSION_MODE, Options.BATCH_CHUNK_ROWS, Options.BATCH_FASTPATH):
            config.unset(option)
    want_chunks, want_builds, hot_chunks = _batch_expectations(plan, len(df))
    chains = sorted({tuple(s.fusion_op for s in seg.specs) for seg in plan.segments if hasattr(seg, "specs")})
    if (builds, chunks) != (want_builds, want_chunks) or hot_chunks != chunks \
            or launches != {kernel.name: chunks}:
        raise AssertionError(f"{where}: {builds} builds, {chunks} chunks ({hot_chunks} hot), chains {chains}, "
                             f"launches {launches}")
    readings = {"rows": len(df), "chunks": chunks, "builds": builds, "chains": [list(c) for c in chains],
                "launches": launches, "seconds": seconds, "per_stage_seconds": per_stage_s}
    return readings, out, per_stage


def phase_pipeline_mixed(card: str, headline, idf_model, lr_model):
    """The slice's path: IDF → LR beside a StandardScaler served and in the
    batch tier, and the other three classes in the batch tier (module
    docstring, phase 26)."""
    import tempfile

    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.builder import PipelineModel
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.feature.binarizer import Binarizer
    from flink_ml_tpu_torch.models.feature.idf import IDFModel
    from flink_ml_tpu_torch.models.feature.normalizer import Normalizer
    from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScaler, StandardScalerModel
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.servable import KMeansModelServable
    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    idx, _y = headline
    rng = np.random.default_rng(MIXED_DENSE_SEED)
    dense = rng.normal(loc=0.5, scale=2.0, size=(len(idx), MIXED_DENSE_D))
    df = _sparse_frame(idx, dense=dense)
    scaler = (StandardScaler().set_input_col("dense").set_output_col("scaled").set_with_mean(True)
              .set_with_std(True).fit(DataFrame.from_dict({"dense": dense})))
    model = PipelineModel([idf_model, lr_model, scaler])
    idf32 = np.asarray(idf_model.idf, np.float32)
    coef64 = np.asarray(lr_model.coefficient, np.float32).astype(np.float64)
    mean32 = np.asarray(scaler.mean, np.float32)
    std32 = np.asarray(scaler.std, np.float32)
    inv_std64 = np.where(std32 == 0.0, 0.0, 1.0 / np.where(std32 == 0.0, 1.0, std32)).astype(np.float32) \
        .astype(np.float64)

    def expected(ids, x):
        """float64 numpy of the chain on rows of ids (value 1.0) and dense rows ``x``."""
        margin = (idf32[ids].astype(np.float64) * coef64[ids]).sum(axis=1)
        p = 1.0 / (1.0 + np.exp(-margin))
        scaled = (np.asarray(x, np.float32).astype(np.float64) - mean32.astype(np.float64)) * inv_std64
        return margin, np.stack([1.0 - p, p], axis=1), scaled

    # 1. served: save, load_servable, InferenceServer
    with tempfile.TemporaryDirectory() as tmp:
        model.save(f"{tmp}/mixed")
        servable = PipelineModel.load_servable(f"{tmp}/mixed")
    sizes = _traffic_sizes(np.random.default_rng(SPARSE_SERVE_SEED + 2))
    payload_ids = [_hashed_rows(rng, n, TRAIN_NNZ if i % 4 else (1, 5, 17, 38)[i // 4 % 4])
                   for i, n in enumerate(sizes)]
    payload_dense = [rng.normal(loc=0.5, scale=2.0, size=(n, MIXED_DENSE_D)) for n in sizes]
    payloads = [{"features": _sparse_frame(ids).column("features"), "dense": x}
                for ids, x in zip(payload_ids, payload_dense)]
    max_err = [0.0] * len(payloads)

    def check(i, resp):
        ids, x = payload_ids[i], payload_dense[i]
        margin, raw, scaled = expected(ids, x)
        for r, v in enumerate(resp["tfidf"]):
            if not (np.array_equal(v.indices, ids[r]) and np.array_equal(v.values, idf32[ids[r]].astype(np.float64))):
                raise AssertionError(f"row {r}: tfidf is not float32 values * idf[ids]")
        got_raw = np.asarray(resp["rawPrediction"])
        np.testing.assert_allclose(got_raw, raw, rtol=0, atol=1e-5)
        sure = np.abs(margin) > PREDICTION_MARGIN
        np.testing.assert_array_equal(np.asarray(resp["prediction"])[sure], (margin >= 0)[sure].astype(np.float64))
        np.testing.assert_allclose(resp["scaled"], scaled, rtol=1e-6, atol=1e-6)
        max_err[i] = max(float(np.abs(got_raw - raw).max()), float(np.abs(resp["scaled"] - scaled).max()))

    config_ = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
    template = DataFrame.from_dict({"features": payloads[0]["features"][:1], "dense": payload_dense[0][:1]})
    t0 = time.perf_counter()
    server = InferenceServer(servable, name="chip-smoke-pipeline-mixed", serving_config=config_,
                             warmup_template=template, device="cuda")
    warmup_s = time.perf_counter() - t0
    scope = server.scope
    with server:
        plan = servable._fastpath_plan
        kinds = chain_kinds(plan)
        chains = {tuple(s.fusion_op for s in seg.specs) for seg in plan.segments}
        keys = []
        ingest = plan._ingest

        def recording_ingest(seg, frame, bucket, cap=None, warm=False):
            got = ingest(seg, frame, bucket, cap=cap, warm=warm)
            keys.append(got[1])
            return got

        plan._ingest = recording_ingest
        # The path's run starts here: counts to 0, then traffic.
        for k in KERNELS:
            k.reset_launches()
        plain_calls, restore = _count_calls(mk, _PLAIN_MEGAKERNELS)
        fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
        try:
            latencies, wall, failures = _serve_and_check(server, payloads, None, check)
        finally:
            restore()
            plan._ingest = ingest
        launches = mk.ROWLOCAL.launches
        other = {k.name: k.launches for k in KERNELS if k is not mk.ROWLOCAL}
        hot_ids = _hashed_rows(rng, MAX_BATCH, TRAIN_NNZ)  # the headline key: (4096, cap 64)
        breakdown = _mixed_batch_breakdown(plan, DataFrame.from_dict({
            "features": _sparse_frame(hot_ids).column("features"),
            "dense": rng.normal(loc=0.5, scale=2.0, size=(MAX_BATCH, MIXED_DENSE_D))}), ingest)
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    hot = sorted(k for k, kind in kinds.items() if "megakernel" in kind)
    hot_batches = sum(1 for k in keys if k in hot)
    fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
    compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    if chains != {("sparse_idf", "sparse_logistic", "scale")}:
        raise AssertionError(f"the served chains are {chains}")
    if not launches > 0 or launches != hot_batches:
        raise AssertionError(f"table launches {launches} != batches with hot keys {hot_batches}")
    if fallback or compiles or plain_calls or any(other.values()):
        raise AssertionError(f"fallbacks {fallback}, post-warmup builds {compiles}, plain calls "
                             f"{sorted(set(plain_calls))}, other kernels {other}")
    lat = sorted(latencies)
    served = {
        "warmup_s": warmup_s, "warmed_keys": len(kinds), "requests": len(payloads), "rows": sum(sizes),
        "batches": len(keys), "hot_keys": [list(k) for k in hot], "hot_batches": hot_batches,
        "megakernel_launches": launches, "fallback_batches": fallback, "post_warmup_builds": compiles,
        "plain_calls": len(plain_calls), "max_err_vs_float64": max(max_err),
        "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(sizes) / wall, "wall_s": wall, "hot_batch_breakdown_ms": breakdown,
    }

    # 2. the batch tier over the headline rows
    mixed, out, ref = _batch_against_per_stage(model, df, mk.ROWLOCAL, "mixed pipeline")
    for r in range(0, len(idx), 997):
        got, want = out.column("tfidf")[r], ref.column("tfidf")[r]
        if not (np.array_equal(got.indices, idx[r]) and np.array_equal(got.values, want.values)):
            raise AssertionError(f"batch tfidf row {r} differs from the per-stage path")
    np.testing.assert_array_equal(out.column("prediction"), ref.column("prediction"))
    np.testing.assert_array_equal(out.column("scaled"), ref.column("scaled"))
    mixed["raw_ulps_from_per_stage"] = ulp_diff(out.column("rawPrediction"), ref.column("rawPrediction"))
    if mixed["raw_ulps_from_per_stage"] > ULP_ENVELOPE["sparse_idf_logistic"]:
        raise AssertionError(f"batch rawPrediction {mixed['raw_ulps_from_per_stage']} ulps from the per-stage path")
    del df, out, ref

    # 3. the other classes at their published widths, in the batch tier
    mlp_model = PipelineModel([
        Normalizer().set_input_col("features").set_output_col("norm").set_p(2.0),
        _seeded_mlp(list(MLP_WIDTHS), "norm", np.random.default_rng(13)),
        Binarizer().set_input_cols("rawPrediction").set_output_cols("rb").set_thresholds(RESIDUE_MLP_THRESHOLD)])
    X = np.random.default_rng(MLP_SERVE_SEED).normal(size=(MLP_ROWS, MLP_WIDTHS[0]))
    mlp_run, out, ref = _batch_against_per_stage(mlp_model, DataFrame.from_dict({"features": X}),
                                                 mk.ROWLOCAL_MLP, "normalize -> mlp -> binarize")
    mlp_run["prob_ulps_from_per_stage"] = ulp_diff(out.column("rawPrediction"), ref.column("rawPrediction"))
    if mlp_run["prob_ulps_from_per_stage"] > ULP_ENVELOPE["scale_mlp"]:
        raise AssertionError("batch MLP probabilities outside the envelope of the per-stage path")
    probs = np.asarray(ref.column("rawPrediction"))
    top = np.sort(probs, axis=1)
    far = np.abs(probs - RESIDUE_MLP_THRESHOLD) > BIN_MARGIN
    np.testing.assert_array_equal(np.asarray(out.column("rb"))[far], np.asarray(ref.column("rb"))[far])
    sure = top[:, -1] - top[:, -2] > PREDICTION_MARGIN
    np.testing.assert_array_equal(out.column("prediction")[sure], ref.column("prediction")[sure])
    mlp_run["rows_inside_margin"] = int((~sure).sum())
    del X, out, ref

    sc = StandardScalerModel().set_input_col("features").set_output_col("scaled").set_with_mean(True)
    km_rng = np.random.default_rng(KMEANS_SERVE_SEED + 1)
    sc.mean, sc.std = km_rng.random(KMEANS_D) * 0.5, km_rng.random(KMEANS_D) * 0.3 + 0.2
    C = km_rng.random((KMEANS_K, KMEANS_D))
    km = KMeansModelServable().set_features_col("norm").set_k(KMEANS_K)
    km.centroids, km.weights = (C / np.linalg.norm(C, axis=1, keepdims=True)).astype(np.float32), np.ones(KMEANS_K)
    km_model = PipelineModel([sc, Normalizer().set_input_col("scaled").set_output_col("norm").set_p(2.0), km,
                              Binarizer().set_input_cols("prediction").set_output_cols("pb").set_thresholds(4.5)])
    X = _kmeans_published_rows()
    km_run, out, ref = _batch_against_per_stage(km_model, DataFrame.from_dict({"features": X}), mk.ROWLOCAL,
                                                "kmeans pipeline -> binarize")
    np.testing.assert_array_equal(out.column("scaled"), ref.column("scaled"))
    if ulp_diff(out.column("norm"), ref.column("norm")) > ULP_ENVELOPE["feature6"]:
        raise AssertionError("batch normalized rows outside the feature6 envelope")
    norm = np.asarray(ref.column("norm"))
    dist = np.sqrt(np.maximum((norm ** 2).sum(1)[:, None] + (km.centroids.astype(np.float64) ** 2).sum(1)[None, :]
                              - 2.0 * norm @ km.centroids.astype(np.float64).T, 0.0))
    decided = _decided_rows(dist)
    for col in ("prediction", "pb"):
        np.testing.assert_array_equal(np.asarray(out.column(col))[decided], np.asarray(ref.column(col))[decided])
    km_run["rows_inside_margin"] = int((~decided).sum())
    del X, out, ref

    idf2 = IDFModel().set_input_col("tfidf").set_output_col("tfidf2")
    idf2.idf = np.abs(np.random.default_rng(14).normal(size=TRAIN_DIM)) + 0.1
    idf2.doc_freq, idf2.num_docs = np.ones(TRAIN_DIM), np.asarray(9.0)
    idf_idf = PipelineModel([idf_model, idf2])
    df = _sparse_frame(idx)
    idf_run, out, ref = _batch_against_per_stage(idf_idf, df, mk.ROWLOCAL, "idf -> idf")
    idf2_32 = np.asarray(idf2.idf, np.float32)
    for r in range(0, len(idx), 997):
        got = out.column("tfidf2")[r]
        want = (idf32[idx[r]] * idf2_32[idx[r]]).astype(np.float64)  # float32 products, rounded twice
        if not (np.array_equal(got.indices, idx[r]) and np.array_equal(got.values, want)
                and np.array_equal(got.values, ref.column("tfidf2")[r].values)):
            raise AssertionError(f"batch tfidf2 row {r} is not the float32 products")
    emit("pipeline_mixed", card=card, serve=served, batch=mixed, mlp_binarize=mlp_run, kmeans_binarize=km_run,
         idf_idf=idf_run)
    return {"pipeline_mixed.serve": {mk.ROWLOCAL.name: launches},
            "pipeline_mixed.batch": mixed["launches"],
            "pipeline_mixed.mlp_binarize": mlp_run["launches"],
            "pipeline_mixed.kmeans_binarize": km_run["launches"],
            "pipeline_mixed.idf_idf": idf_run["launches"]}


def _fail_at(epoch):
    from flink_ml_tpu_torch.iteration import IterationListener

    class FailAt(IterationListener):
        def on_epoch_watermark_incremented(self, e, context):
            if e == epoch:
                raise RuntimeError(f"killed at epoch {e}")

    return FailAt()


def _dense_ckpt_rows():
    """fit_checkpoint's dense rows: CKPT_DENSE_ROWS × 100 standard normal
    features and real labels of a seeded linear model plus noise."""
    import numpy as np

    rng = np.random.default_rng(CKPT_SEED)
    X = rng.standard_normal((CKPT_DENSE_ROWS, CKPT_DENSE_D)).astype(np.float32)
    w = rng.standard_normal(CKPT_DENSE_D) / np.sqrt(CKPT_DENSE_D)
    y = (X.astype(np.float64) @ w + 0.1 * rng.standard_normal(CKPT_DENSE_ROWS)).astype(np.float32)
    return X, y


def _reference_least_squares(X, y, iters):
    """Float64 numpy SGD of SGD's schedule and update under LeastSquareLoss
    (no regularization) on dense rows."""
    import numpy as np

    from flink_ml_tpu_torch.ops.schedule import offset_schedule

    n = y.shape[0]
    batch = min(CKPT_DENSE_BATCH, n)
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    coef = np.zeros(X.shape[1])
    for start, offset in zip(*offset_schedule(n, batch, iters)):
        rows = slice(start, start + batch)
        wb = (start + np.arange(batch) >= offset).astype(np.float64)
        mult = wb * (X64[rows] @ coef - y64[rows])
        coef -= CKPT_DENSE_LR / wb.sum() * (X64[rows].T @ mult)
    return coef


def _sync_seconds(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_fit_checkpoint(card: str, headline):
    """Checkpointed SGD killed by a listener and resumed, dense and on the
    headline rows' host loop; a corrupt newest snapshot and a foreign
    config (module docstring, phase 27). Returns the resumed sparse
    coefficient (hot_swap's v2) and the dense rows."""
    t_phase = time.perf_counter()
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from flink_ml_tpu_torch.checkpoint import CheckpointManager, FingerprintMismatchError
    from flink_ml_tpu_torch.iteration import DeviceDataCache, IterationListener
    from flink_ml_tpu_torch.linalg import onehot_sparse as O
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss, LeastSquareLoss
    from flink_ml_tpu_torch.ops.optimizer import SGD

    crossings = (O.DOT_CROSSING, O.MULT_CROSSING, O.DOT_CROSSING_PREMAT, O.MULT_CROSSING_PREMAT)
    for k in crossings:
        k.reset_launches()
    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        # -- dense leg ---------------------------------------------------------
        X, y = _dense_ckpt_rows()
        dense = DeviceDataCache({"features": X, "labels": y, "weights": np.ones(len(y), np.float32)})
        loss = LeastSquareLoss.INSTANCE

        def dense_sgd(**kw):
            return SGD(max_iter=CKPT_DENSE_ITERS, learning_rate=CKPT_DENSE_LR,
                       global_batch_size=CKPT_DENSE_BATCH, tol=0.0, **kw)

        fused_coef = dense_sgd().optimize(np.zeros(CKPT_DENSE_D, np.float32), dense, loss)
        mgr = CheckpointManager(os.path.join(root, "dense"), max_to_keep=2)
        try:
            dense_sgd(checkpoint_manager=mgr, checkpoint_interval=CKPT_INTERVAL,
                      listeners=[_fail_at(CKPT_DENSE_KILL)]).optimize(np.zeros(CKPT_DENSE_D, np.float32), dense, loss)
            raise AssertionError("the dense fit was not killed")
        except RuntimeError as e:
            if "killed at epoch" not in str(e):
                raise
        steps_at_kill = mgr.all_steps()
        if steps_at_kill != [10, 15]:
            raise AssertionError(f"dense snapshots at the kill: {steps_at_kill}, expected [10, 15]")
        corrupt_dir = os.path.join(root, "dense-corrupt")
        shutil.copytree(mgr.directory, corrupt_dir)
        resumed = dense_sgd(checkpoint_manager=CheckpointManager(mgr.directory, max_to_keep=2),
                            checkpoint_interval=CKPT_INTERVAL)
        dense_resumed = resumed.optimize(np.zeros(CKPT_DENSE_D, np.float32), dense, loss)
        dense_bit_equal = bool(np.array_equal(dense_resumed.view(np.int32), fused_coef.view(np.int32)))
        dense_err = float(np.abs(dense_resumed - fused_coef).max())
        if not dense_err <= CKPT_DENSE_ATOL:
            raise AssertionError(f"the resumed dense coefficient is {dense_err} off the fused fit")
        if len(resumed.loss_history) != CKPT_DENSE_ITERS - 15:
            raise AssertionError(f"{len(resumed.loss_history)} epochs after resuming from 15")

        # corruption: the newest snapshot truncated → quarantined, resumed from the one before
        npz = os.path.join(corrupt_dir, "ckpt-15", "arrays.npz")
        with open(npz, "r+b") as f:
            f.truncate(os.path.getsize(npz) // 2)
        q0 = metrics.get(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_QUARANTINED, 0)
        f0 = metrics.get(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_FALLBACKS, 0)
        fallback = dense_sgd(checkpoint_manager=CheckpointManager(corrupt_dir, max_to_keep=2),
                             checkpoint_interval=CKPT_INTERVAL)
        fallback_coef = fallback.optimize(np.zeros(CKPT_DENSE_D, np.float32), dense, loss)
        if not os.path.isdir(os.path.join(corrupt_dir, "ckpt-15.corrupt")):
            raise AssertionError("the truncated snapshot was not quarantined")
        if len(fallback.loss_history) != CKPT_DENSE_ITERS - 10:
            raise AssertionError(f"{len(fallback.loss_history)} epochs after falling back to 10")
        quarantined = metrics.get(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_QUARANTINED) - q0
        fallbacks = metrics.get(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_FALLBACKS) - f0
        if (quarantined, fallbacks) != (1, 1):
            raise AssertionError(f"quarantined {quarantined}, fallbacks {fallbacks}; expected 1 and 1")
        fallback_err = float(np.abs(fallback_coef - fused_coef).max())
        if not fallback_err <= CKPT_DENSE_ATOL:
            raise AssertionError(f"the fallen-back dense coefficient is {fallback_err} off the fused fit")
        try:
            SGD(max_iter=CKPT_DENSE_ITERS, learning_rate=CKPT_DENSE_LR / 2, global_batch_size=CKPT_DENSE_BATCH,
                tol=0.0, checkpoint_manager=CheckpointManager(mgr.directory), checkpoint_interval=CKPT_INTERVAL,
                ).optimize(np.zeros(CKPT_DENSE_D, np.float32), dense, loss)
            raise AssertionError("a different config resumed another run's snapshots")
        except FingerprintMismatchError as e:
            mismatch = str(e)[:120]
        ref = _reference_least_squares(X, y, CKPT_DENSE_ITERS)
        dense_scale = float(np.abs(ref).max())
        dense_ref_err = float(np.abs(fused_coef.astype(np.float64) - ref).max())
        if not dense_ref_err <= COEF_TOL * dense_scale:
            raise AssertionError(f"the dense fit is {dense_ref_err} off the float64 SGD (scale {dense_scale})")
        del dense

        # -- sparse leg: the headline rows on the host loop ---------------------
        idx, labels = headline
        cache = DeviceDataCache({
            "indices": idx.astype(np.int32), "values": np.ones(idx.shape, np.float32),
            "labels": labels.astype(np.float32), "weights": np.ones(len(labels), np.float32),
        })
        logistic = BinaryLogisticLoss.INSTANCE

        def sparse_sgd(iters=TRAIN_ITERS, **kw):
            return SGD(max_iter=iters, learning_rate=TRAIN_LR, global_batch_size=TRAIN_BATCH, tol=0.0, **kw)

        zeros = np.zeros(TRAIN_DIM, np.float32)
        fused_sparse = sparse_sgd(sparse_kernel="scatter").optimize(zeros, cache, logistic)
        smgr = CheckpointManager(os.path.join(root, "sparse"), max_to_keep=2)
        try:
            sparse_sgd(checkpoint_manager=smgr, checkpoint_interval=CKPT_INTERVAL,
                       listeners=[_fail_at(CKPT_SPARSE_KILL)]).optimize(zeros, cache, logistic)
            raise AssertionError("the sparse fit was not killed")
        except RuntimeError as e:
            if "killed at epoch" not in str(e):
                raise
        sparse_steps = smgr.all_steps()
        resumed_sparse = sparse_sgd(checkpoint_manager=CheckpointManager(smgr.directory, max_to_keep=2),
                                    checkpoint_interval=CKPT_INTERVAL)
        sparse_coef = resumed_sparse.optimize(zeros, cache, logistic)
        if len(resumed_sparse.loss_history) != TRAIN_ITERS - sparse_steps[-1]:
            raise AssertionError(f"{len(resumed_sparse.loss_history)} epochs after resuming from {sparse_steps}")
        sref, _ = _reference_sgd(idx, np.ones(idx.shape), labels, TRAIN_DIM)
        sparse_scale = float(np.abs(sref).max())
        errs = {name: float(np.abs(c.astype(np.float64) - sref).max())
                for name, c in (("resumed", sparse_coef), ("uninterrupted", fused_sparse))}
        for name, err in errs.items():
            if not err <= COEF_TOL * sparse_scale:
                raise AssertionError(f"the {name} sparse coefficient is {err} off the float64 SGD "
                                     f"(scale {sparse_scale})")
        launched = {k.name: k.launches for k in crossings if k.launches}
        if launched:
            raise AssertionError(f"the host loop launched one-hot crossings: {launched}")

        # ms/epoch: the host loop (a listener, no manager) against the fused
        # scatter path on the same cache, two epoch counts differenced
        class Quiet(IterationListener):
            pass

        ms = {}
        for form in ("host_loop", "fused", "fused", "host_loop"):
            kw = {"listeners": [Quiet()]} if form == "host_loop" else {"sparse_kernel": "scatter"}
            t = [_sync_seconds(lambda: sparse_sgd(iters, **kw).optimize(zeros, cache, logistic))[1]
                 for iters in CKPT_EPOCH_ITERS]
            ms.setdefault(form, []).append((t[1] - t[0]) / (CKPT_EPOCH_ITERS[1] - CKPT_EPOCH_ITERS[0]) * 1e3)

        # save and restore of the 16 MB coefficient, restored onto the card
        coef_dev = torch.from_numpy(sparse_coef).cuda()
        io_mgr = CheckpointManager(os.path.join(root, "io"), max_to_keep=1)
        save_ms, restore_ms = [], []
        for rep in range(CKPT_IO_REPS):
            _, t = _sync_seconds(lambda: io_mgr.save(rep + 1, [coef_dev, np.asarray(rep, np.int32)]))
            save_ms.append(t * 1e3)
            (step, state), t = _sync_seconds(lambda: io_mgr.restore_latest(device=coef_dev.device))
            restore_ms.append(t * 1e3)
            if step != rep + 1 or state[0].device != coef_dev.device or not torch.equal(state[0], coef_dev):
                raise AssertionError("the restored coefficient is not the saved one on the card")
        del cache, coef_dev
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("fit_checkpoint", card=card, seconds=time.perf_counter() - t_phase, dense={
        "rows": CKPT_DENSE_ROWS, "d": CKPT_DENSE_D, "batch": CKPT_DENSE_BATCH, "iterations": CKPT_DENSE_ITERS,
        "killed_at": CKPT_DENSE_KILL, "snapshots_at_kill": steps_at_kill,
        "resumed_bit_equal_to_fused": dense_bit_equal, "resumed_max_abs_diff": dense_err,
        "epochs_after_resume": len(resumed.loss_history),
        "corrupt_newest": {"quarantined": quarantined, "fallbacks": fallbacks,
                           "epochs_after_resume": len(fallback.loss_history), "max_abs_diff": fallback_err},
        "fingerprint_mismatch": mismatch,
        "fused_vs_f64_max_abs_err": dense_ref_err, "f64_scale": dense_scale,
    }, sparse={
        "rows": len(labels), "dim": TRAIN_DIM, "batch": TRAIN_BATCH, "iterations": TRAIN_ITERS,
        "killed_at": CKPT_SPARSE_KILL, "snapshots_at_kill": sparse_steps,
        "epochs_after_resume": len(resumed_sparse.loss_history),
        "max_abs_err_vs_f64": errs, "f64_scale": sparse_scale, "coef_tol": COEF_TOL,
        "ms_per_epoch": {k: _median(v) for k, v in ms.items()}, "ms_per_epoch_runs": ms,
        "checkpoint_bytes": int(sparse_coef.nbytes), "save_ms": _median(save_ms), "restore_ms": _median(restore_ms),
        "save_ms_runs": save_ms, "restore_ms_runs": restore_ms,
    })
    return sparse_coef, (X, y, fused_coef)


def phase_fit_linear_family(card: str, headline, dense_rows):
    """LinearSVC on the headline rows through the estimator (the one-hot
    path) and LinearRegression on fit_checkpoint's dense rows, each held
    against float64 (module docstring, phase 28). Returns the crossing
    launches of the form the LinearSVC fit ran."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch

    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.linalg import onehot_sparse as O
    from flink_ml_tpu_torch.models.classification.linearsvc import LinearSVC
    from flink_ml_tpu_torch.models.regression.linear_regression import LinearRegression

    premat_k = (O.DOT_CROSSING_PREMAT, O.MULT_CROSSING_PREMAT)
    build_k = (O.DOT_CROSSING, O.MULT_CROSSING)
    idx, y = headline
    df = _sparse_frame(idx, label=y)
    est = (LinearSVC().set_max_iter(TRAIN_ITERS).set_global_batch_size(TRAIN_BATCH)
           .set_learning_rate(TRAIN_LR).set_tol(0.0))
    calls, restore = _count_plain_calls()
    try:
        for k in premat_k + build_k:
            k.reset_launches()
        svc, fit_s = _sync_seconds(lambda: est.fit(df))
        launches = {k.name: k.launches for k in premat_k + build_k}
    finally:
        restore()
    if calls:
        raise AssertionError(f"plain crossings were called on the card: {sorted(set(calls))}")
    ran, idle = (premat_k, build_k) if est.onehot_premat_active else (build_k, premat_k)
    if any(launches[k.name] != TRAIN_ITERS for k in ran) or any(launches[k.name] for k in idle):
        raise AssertionError(f"the LinearSVC fit's crossing launches are {launches}")
    ref, ref_losses = _reference_sgd(idx, np.ones(idx.shape), y, TRAIN_DIM, hinge=True)
    scale = float(np.abs(ref).max())
    svc_err = float(np.abs(svc.coefficient.astype(np.float64) - ref).max())
    if not svc_err <= COEF_TOL * scale:
        raise AssertionError(f"the LinearSVC coefficient is {svc_err} off the float64 hinge SGD (scale {scale})")
    loss_err = float(np.max(np.abs(np.asarray(est.loss_history) - ref_losses) / np.abs(ref_losses)))
    if not loss_err <= 1e-5:
        raise AssertionError(f"the LinearSVC loss history is {loss_err} off the float64 one (relative)")
    rows = TRAIN_BATCH
    out, transform_s = _sync_seconds(lambda: svc.transform(df.take(np.arange(rows))))
    coef64 = np.asarray(svc.coefficient, np.float32).astype(np.float64)
    margin = coef64[idx[:rows]].sum(axis=1)
    raw = np.asarray(out.column("rawPrediction"))
    raw_err = float(np.abs(raw - np.stack([margin, -margin], axis=1)).max())
    if not raw_err <= 1e-6 * max(1.0, float(np.abs(margin).max())):
        raise AssertionError(f"LinearSVC rawPrediction is {raw_err} off float64")
    decided = np.abs(margin) > SVC_MARGIN
    np.testing.assert_array_equal(np.asarray(out.column("prediction"))[decided], (margin >= 0)[decided])
    del df

    X, yd, fused_coef = dense_rows
    dense_df = DataFrame.from_dict({"features": X, "label": yd})
    lin = (LinearRegression().set_max_iter(CKPT_DENSE_ITERS).set_global_batch_size(CKPT_DENSE_BATCH)
           .set_learning_rate(CKPT_DENSE_LR).set_tol(0.0))
    lin_model, lin_fit_s = _sync_seconds(lambda: lin.fit(dense_df))
    lin_vs_sgd = float(np.abs(lin_model.coefficient - fused_coef).max())
    if not lin_vs_sgd <= CKPT_DENSE_ATOL:
        raise AssertionError(f"LinearRegression.fit is {lin_vs_sgd} off fit_checkpoint's fused SGD")
    lref = _reference_least_squares(X, yd, CKPT_DENSE_ITERS)
    lscale = float(np.abs(lref).max())
    lin_err = float(np.abs(lin_model.coefficient.astype(np.float64) - lref).max())
    if not lin_err <= COEF_TOL * lscale:
        raise AssertionError(f"the LinearRegression coefficient is {lin_err} off float64 (scale {lscale})")
    pred, lin_transform_s = _sync_seconds(lambda: lin_model.transform(dense_df))
    want = X.astype(np.float64) @ np.asarray(lin_model.coefficient, np.float32).astype(np.float64)
    pred_err = float(np.abs(np.asarray(pred.column("prediction")) - want).max())
    if not pred_err <= 1e-5 * float(np.abs(want).max()):
        raise AssertionError(f"LinearRegression predictions are {pred_err} off float64")
    torch.cuda.empty_cache()
    form = "premat" if est.onehot_premat_active else "build"
    emit("fit_linear_family", card=card, seconds=time.perf_counter() - t_phase, linearsvc={
        "rows": len(idx), "dim": TRAIN_DIM, "batch": TRAIN_BATCH, "iterations": TRAIN_ITERS, "form": form,
        "crossing_launches": launches, "fit_s": fit_s, "coef_max_abs_err_vs_f64": svc_err, "f64_scale": scale,
        "loss_max_rel_err_vs_f64": loss_err, "loss_first": est.loss_history[0], "loss_last": est.loss_history[-1],
        "transform_rows": rows, "transform_s": transform_s, "raw_max_abs_err_vs_f64": raw_err,
        "decided_share": float(decided.mean()),
    }, linear_regression={
        "rows": len(yd), "d": CKPT_DENSE_D, "fit_s": lin_fit_s, "max_abs_diff_vs_fused_sgd": lin_vs_sgd,
        "coef_max_abs_err_vs_f64": lin_err, "f64_scale": lscale, "transform_s": lin_transform_s,
        "pred_max_abs_err_vs_f64": pred_err,
    })
    return {k.name: launches[k.name] for k in ran}


class _CorruptPublish:
    """A stage whose saved LogisticRegression model data is truncated:
    published through the atomic path, so the poller meets a complete but
    unloadable version."""

    def __init__(self, model):
        self.model = model

    def save(self, path):
        import os

        self.model.save(path)
        npz = os.path.join(path, "stages", f"{1:08d}", "data", "model_data.npz")
        with open(npz, "r+b") as f:
            f.truncate(os.path.getsize(npz) // 2)


def phase_hot_swap(card: str, idf_model, lr_model, v2_coef):
    """serve_sparse's IDF → LR published as v1 and served through the
    poller; v2 (fit_checkpoint's resumed coefficient) and a corrupt v3
    published under traffic (module docstring, phase 29). Returns the
    sparse kernel's launches."""
    t_phase = time.perf_counter()
    import tempfile

    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.builder import PipelineModel
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegressionModel
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.params.param import update_existing_params
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig, publish_servable
    from flink_ml_tpu_torch.serving.plan import CompiledServingPlan, chain_kinds

    lr2 = LogisticRegressionModel()
    update_existing_params(lr2, lr_model)
    lr2.coefficient = np.asarray(v2_coef, np.float32)
    versions = {1: PipelineModel([idf_model, lr_model]), 2: PipelineModel([idf_model, lr2])}
    idf32 = np.asarray(idf_model.idf, np.float32)
    coef64 = {v: np.asarray(m.stages[1].coefficient, np.float32).astype(np.float64) for v, m in versions.items()}
    if np.array_equal(coef64[1], coef64[2]):
        raise AssertionError("v1 and v2 carry the same coefficient: the swap would be invisible")

    rng = np.random.default_rng(HOT_SWAP_SEED)
    n_req = N_CLIENTS * REQUESTS_PER_CLIENT + HOT_SWAP_POST
    sizes = [int(min(MAX_BATCH, max(1, round(2 ** rng.uniform(0, 12))))) for _ in range(n_req)]
    for j, i in enumerate(range(0, n_req, 8)):  # hot keys on every run
        sizes[i] = (MAX_BATCH, MAX_BATCH // 2, MAX_BATCH // 4)[j % 3]
    nnz = [TRAIN_NNZ if i % 4 else (1, 3, 9, 24)[(i // 4) % 4] for i in range(n_req)]
    payload_ids = [_hashed_rows(rng, n, k) for n, k in zip(sizes, nnz)]
    payloads = [_sparse_frame(ids) for ids in payload_ids]

    def check(i, out, version):
        ids = payload_ids[i]
        want = idf32[ids]
        got = out["tfidf"]
        if len(got) != len(ids):
            raise AssertionError(f"{len(got)} rows back for {len(ids)}")
        for r in range(0, len(ids), 7):
            if not (np.array_equal(got[r].indices, ids[r]) and np.array_equal(got[r].values, want[r])):
                raise AssertionError(f"row {r}: tfidf is not the f32 product")
        margin = (want.astype(np.float64) * coef64[version][ids]).sum(axis=1)
        p = 1.0 / (1.0 + np.exp(-margin))
        np.testing.assert_allclose(out["rawPrediction"], np.stack([1.0 - p, p], axis=1), rtol=0, atol=1e-5)
        decided = np.abs(margin) > PREDICTION_MARGIN
        np.testing.assert_array_equal(np.asarray(out["prediction"])[decided],
                                      (margin >= 0).astype(np.float64)[decided])

    # every ingest of every version's plan, warm or not, in order
    lock = threading.Lock()
    ingests = []
    ingest = CompiledServingPlan._ingest

    def recording_ingest(self, segment, df, bucket, cap=None, warm=False):
        got = ingest(self, segment, df, bucket, cap=cap, warm=warm)
        with lock:
            ingests.append((warm, got[1]))
        return got

    config = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
    CompiledServingPlan._ingest = recording_ingest
    tmp = tempfile.TemporaryDirectory()
    try:
        d = tmp.name
        publish_servable(versions[1], d)
        server = InferenceServer(name="chip-smoke-hot-swap", serving_config=config,
                                 warmup_template=payloads[0].take([0]), device="cuda")
        scope = server.scope
        with server:
            poller = server.attach_poller(d, interval_ms=HOT_SWAP_POLL_MS)
            stage_ms = {"load": [], "warmup": []}  # each version's load and warmup on the poller's thread

            def timed(name, fn):
                def run(arg):
                    t = time.perf_counter()
                    try:
                        return fn(arg)
                    finally:
                        stage_ms[name].append((time.perf_counter() - t) * 1e3)
                return run

            poller.loader, poller.warmup = timed("load", poller.loader), timed("warmup", poller.warmup)
            deadline = time.perf_counter() + 300
            while server.model_version != 1 and time.perf_counter() < deadline:
                time.sleep(0.01)
            if server.model_version != 1:
                raise AssertionError(f"v1 was not swapped in: {dict(poller.failed)}")
            # per-batch version snapshots, in dispatch order
            batch_versions = []
            current = server.registry.current

            def recording_current():
                pair = current()
                batch_versions.append(pair[0])
                return pair

            server.registry.current = recording_current
            kinds = chain_kinds(server.registry._current[1]._fastpath_plan)
            hot = {k for k, kind in kinds.items() if "megakernel" in kind}
            # The main path's run starts here: counts to 0, then traffic.
            with lock:
                del ingests[:]
            for k in KERNELS:
                k.reset_launches()
            plain_calls, restore = _count_calls(mk, ("sparse_idf_logistic_plain", "scale_logistic_plain"))
            swaps0 = metrics.get(scope, MLMetrics.SERVING_SWAPS, 0)
            fail0 = metrics.get(scope, MLMetrics.SERVING_SWAP_FAILURES, 0)
            fallback0 = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
            compiles0 = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
            done = []  # (request, version, completion time), in completion order
            failures = []
            first = N_CLIENTS * REQUESTS_PER_CLIENT
            flipped = threading.Event()

            def serve(i):
                try:
                    resp = server.predict(payloads[i])
                    done.append((i, resp.model_version, time.perf_counter()))
                    check(i, resp.dataframe, resp.model_version)
                except BaseException as e:  # noqa: BLE001 — reported below, fails the run
                    failures.append(f"request {i} ({sizes[i]} rows): {type(e).__name__}: {e}")

            def client(c):
                # its own requests, then again in turn, paced, until the flip:
                # traffic flows through v2's load, warmup and swap without
                # starving the poller's thread of the interpreter
                mine = list(range(c, first, N_CLIENTS))
                for i in mine:
                    serve(i)
                for n in range(10_000):
                    if flipped.wait(HOT_SWAP_RESEND_S) or failures:
                        break
                    serve(mine[n % len(mine)])

            try:
                threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
                for th in threads:
                    th.start()
                while len(done) < HOT_SWAP_AFTER and any(th.is_alive() for th in threads):
                    time.sleep(0.001)
                t_publish = time.perf_counter()
                publish_servable(versions[2], d)
                t_published = time.perf_counter()
                publish_servable(_CorruptPublish(versions[2]), d)
                deadline = time.perf_counter() + 300
                while (server.model_version != 2 or 3 not in poller.failed) and time.perf_counter() < deadline:
                    time.sleep(0.005)
                t_swapped = time.perf_counter()
                flipped.set()
                for i in range(first, n_req):  # strictly after the flip
                    serve(i)
                for th in threads:
                    th.join(timeout=600)
            finally:
                restore()
                server.registry.current = current
            if any(th.is_alive() for th in threads):
                raise AssertionError("hot_swap clients did not finish within 600 s")
            launches = mk.SPARSE_IDF_LOGISTIC.launches
            other = {k.name: k.launches for k in KERNELS if k is not mk.SPARSE_IDF_LOGISTIC}
            failed = {v: f"{type(e).__name__}: {str(e)[:80]}" for v, e in poller.failed.items()}
            swaps = metrics.get(scope, MLMetrics.SERVING_SWAPS, 0) - swaps0
            swap_failures = metrics.get(scope, MLMetrics.SERVING_SWAP_FAILURES, 0) - fail0
            fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback0
            compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles0
            final_version = server.model_version
    finally:
        CompiledServingPlan._ingest = ingest
        tmp.cleanup()
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    served = {i: v for i, v, _ in done}
    if set(failed) != {3} or final_version != 2:
        raise AssertionError(f"poller.failed {failed}, serving v{final_version}: expected v3 failed, v2 serving")
    if (swaps, swap_failures) != (1, 1):
        raise AssertionError(f"swaps rose by {swaps} and swap failures by {swap_failures}, expected 1 and 1")
    if batch_versions != sorted(batch_versions) or set(batch_versions) != {1, 2}:
        raise AssertionError(f"batches took versions out of order: {batch_versions}")
    if any(served[i] != 2 for i in range(first, n_req)):
        raise AssertionError(f"v1 served after the flip: {[served[i] for i in range(first, n_req)]}")
    first_v2 = min(t for _, v, t in done if v == 2)
    traffic = [key for warm, key in ingests if not warm]
    warm_hot = sum(1 for warm, key in ingests if warm and key in hot)
    hot_batches = sum(1 for key in traffic if key in hot)
    if len(traffic) != len(batch_versions):
        raise AssertionError(f"{len(traffic)} batches ingested, {len(batch_versions)} dispatched")
    if not hot_batches or launches != hot_batches + warm_hot:
        raise AssertionError(f"sparse kernel launches {launches} != hot batches {hot_batches} "
                             f"+ v2's hot warmup batches {warm_hot}")
    if fallback or compiles:
        raise AssertionError(f"{fallback} fallback batches, {compiles} chains built after warmup")
    if plain_calls or any(other.values()):
        raise AssertionError(f"plain versions {sorted(set(plain_calls))} or other kernels {other} ran")
    emit("hot_swap", card=card, seconds=time.perf_counter() - t_phase, requests=n_req, rows=sum(sizes), batches=len(batch_versions),
         batches_per_version={v: batch_versions.count(v) for v in (1, 2)},
         responses=len(done), responses_per_version={v: sum(u == v for _, u, _ in done) for v in (1, 2)},
         v2_publish_ms=(t_published - t_publish) * 1e3,
         published_to_first_v2_response_ms=(first_v2 - t_published) * 1e3,
         published_to_v3_rejected_ms=(t_swapped - t_published) * 1e3,
         poller_load_ms=stage_ms["load"], poller_warmup_ms=stage_ms["warmup"],
         poller_failed=failed, swaps=swaps, swap_failures=swap_failures,
         hot_keys=sorted(hot), hot_batches=hot_batches, v2_warmup_hot_batches=warm_hot,
         megakernel_launches=launches, fallback_batches=fallback, post_warmup_builds=compiles)
    return launches


def _online_batches():
    """The online stream's ONLINE_VERSIONS batches from ONLINE_SEED: float32
    standard-normal features, the last three quarters scaled by 1e-2, and
    labels of a teacher plus noise, float32. The teacher weighs each of the
    first quarter by 1 to 2 in magnitude, so under leg B's L1 term every
    dimension's |z| stays clear of l1 from the first version on: far above
    it, or (the faint features) far below."""
    import numpy as np

    rng = np.random.default_rng(ONLINE_SEED)
    d, faint = ONLINE_D, ONLINE_D // 4
    w_true = np.concatenate([np.sign(rng.normal(size=faint)) * rng.uniform(1.0, 2.0, faint), np.zeros(d - faint)])
    scale = np.where(np.arange(d) >= faint, 1e-2, 1.0).astype(np.float32)
    batches = []
    for _ in range(ONLINE_VERSIONS):
        X = rng.standard_normal((ONLINE_BATCH, d), dtype=np.float32) * scale
        y = (X.astype(np.float64) @ w_true + 0.3 * rng.standard_normal(ONLINE_BATCH) > 0).astype(np.float32)
        batches.append({"features": X, "label": y})
    return batches


def _ftrl64(batches, reg, elastic_net, control=None):
    """Float64 FTRL of ``batches`` (features through ``control`` first, if
    given) from a zero coefficient: each version's coefficient, and the
    least | |z| - l1 | over every version and dimension."""
    import numpy as np

    l1, l2 = elastic_net * reg, (1.0 - elastic_net) * reg
    coef = np.zeros(ONLINE_D)
    n, z = np.zeros(ONLINE_D), np.zeros(ONLINE_D)
    coefs, margin = [], math.inf
    for b in batches:
        X = np.asarray(b["features"], np.float64) if control is None else control(b["features"])
        y = np.asarray(b["label"], np.float64)
        p = 1.0 / (1.0 + np.exp(-(X @ coef)))
        g = X.T @ (p - y) / len(y)
        sigma = (np.sqrt(n + g * g) - np.sqrt(n)) / ONLINE_ALPHA
        z = z + g - sigma * coef
        n = n + g * g
        margin = min(margin, float(np.min(np.abs(np.abs(z) - l1))))
        coef = np.where(np.abs(z) <= l1, 0.0, (np.sign(z) * l1 - z) / ((ONLINE_BETA + np.sqrt(n)) / ONLINE_ALPHA + l2))
        coefs.append(coef)
    return coefs, margin


def _online_lr(reg, elastic_net):
    """An OnlineLogisticRegression from a zero coefficient at the phase's shape."""
    import numpy as np

    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.linalg.vectors import DenseVector
    from flink_ml_tpu_torch.models.classification.online_logistic_regression import OnlineLogisticRegression

    return (OnlineLogisticRegression()
            .set_initial_model_data(DataFrame(["coefficient"], None, [[DenseVector(np.zeros(ONLINE_D))]]))
            .set_alpha(ONLINE_ALPHA).set_beta(ONLINE_BETA).set_reg(reg).set_elastic_net(elastic_net)
            .set_global_batch_size(ONLINE_BATCH))


def _queue(batches, close=True):
    """A QueueBatchStream holding ``batches``, closed unless asked not to be."""
    from flink_ml_tpu_torch.models.online import QueueBatchStream

    stream = QueueBatchStream()
    for b in batches:
        stream.add(b)
    return stream.close() if close else stream


def _ftrl_versus(got, ref):
    """Each version's largest excess of |got - ref| over the tolerance
    (≤ 0: inside), the largest absolute error and whether each version's
    zero pattern equals float64's."""
    import numpy as np

    excess, err, zeros_equal = [], 0.0, True
    for g, r in zip(got, ref):
        g = np.asarray(g, np.float64)
        excess.append(float(np.max(np.abs(g - r) - (ONLINE_COEF_ATOL + ONLINE_COEF_RTOL * np.abs(r)))))
        err = max(err, float(np.max(np.abs(g - r))))
        zeros_equal = zeros_equal and bool(np.array_equal(g == 0, r == 0))
    return excess, err, zeros_equal


def _online_lr_leg(batches, leg, reg, elastic_net, dev):
    """One leg's 64 versions on the card: versions 1–16 warm, 17–32 traced
    by torch.profiler, 33–64 timed on the host clock; every version held
    against float64 FTRL."""
    model = _online_lr(reg, elastic_net).fit(_queue(batches), device=dev)
    got, stamps = [], []

    def hook(version, coef):
        stamps.append(time.perf_counter())
        got.append(coef)

    profile = _profile_steps(lambda: model.advance(ONLINE_PROFILE_VERSIONS, on_snapshot=hook),
                             expect=("Memcpy HtoD", "Memcpy DtoH"))
    model.advance(on_snapshot=hook)
    if model.version_history != list(range(1, ONLINE_VERSIONS + 1)) or len(got) != ONLINE_VERSIONS:
        raise AssertionError(f"leg {leg}: versions {model.version_history}")
    ref, margin = _ftrl64(batches, reg, elastic_net)
    excess, err, zeros_equal = _ftrl_versus(got, ref)
    first = 2 * ONLINE_PROFILE_VERSIONS  # stamps[first] is version 2P + 1
    traced = ONLINE_PROFILE_VERSIONS
    reading = {
        "reg": reg, "elastic_net": elastic_net, "versions": len(got),
        "ms_per_version": (stamps[-1] - stamps[first]) / (len(stamps) - 1 - first) * 1e3,
        "versions_differenced": [first + 1, len(stamps)],
        "traced_versions": traced,
        "upload_ms_per_version": profile["copy_ms"]["HtoD"] / traced,
        "readback_ms_per_version": profile["copy_ms"]["DtoH"] / traced,
        "device_busy_ms_per_version": profile["device_busy_ms"] / traced,
        "wall_ms_per_traced_version": profile["wall_ms"] / traced,
        "idle_share": profile["idle_share"], "top": profile["top"][:6],
        "max_abs_err_vs_float64": err, "worst_excess_over_tol": max(excess),
        "zero_pattern_equal": zeros_equal, "zeros_last_version": int((got[-1] == 0).sum()),
        "float64_least_l1_margin": margin,
        "state_dtypes": sorted({str(t.dtype) for t in model._snapshots.state}),
    }
    if max(excess) > 0 or not zeros_equal:
        raise AssertionError(f"leg {leg}: a version lies outside rtol {ONLINE_COEF_RTOL} / atol "
                             f"{ONLINE_COEF_ATOL} of float64 FTRL or its zeros differ: {reading}")
    if reg * elastic_net > 0 and margin <= ONLINE_L1_MARGIN:  # at l1 0 only an exact 0 flips
        raise AssertionError(f"leg {leg}: the float64 run comes within {margin} of the L1 threshold")
    if (reading["zeros_last_version"] > 0) != (reg * elastic_net > 0):
        raise AssertionError(f"leg {leg}: {reading['zeros_last_version']} zeros at reg {reg}, en {elastic_net}")
    if reading["state_dtypes"] != ["torch.float32"]:
        raise AssertionError(f"leg {leg}: FTRL state in {reading['state_dtypes']}")
    return got, ref, reading


def _online_serve_leg(batches, coefs_a, ref_a, dev):
    """Leg A trained again under traffic, every ONLINE_PUBLISH_EVERY-th
    version published and flipped in by the poller; returns the readings,
    the kernel's launches on the path and the published coefficients."""
    import tempfile

    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig, publish_servable
    from flink_ml_tpu_torch.serving.plan import CompiledServingPlan, chain_kinds

    rng = np.random.default_rng(ONLINE_SEED + 1)
    sizes = [int(min(MAX_BATCH, max(1, round(2 ** rng.uniform(0, 12))))) for _ in range(ONLINE_REQUESTS)]
    sizes[::16] = [4096, 1500, 2048, 1024][: len(sizes[::16])]  # hot buckets on every run
    payloads = [rng.standard_normal((n, ONLINE_D), dtype=np.float32) for n in sizes]
    frames = [DataFrame.from_dict({"features": x}) for x in payloads]
    payloads64 = [x.astype(np.float64) for x in payloads]
    published = {}  # version -> float64 of the published float32 coefficient

    def check(i, out, version):
        margin = payloads64[i] @ published[version]
        p = 1.0 / (1.0 + np.exp(-margin))
        np.testing.assert_allclose(out["rawPrediction"], np.stack([1.0 - p, p], axis=1), rtol=0, atol=1e-5)
        decided = np.abs(margin) > PREDICTION_MARGIN
        np.testing.assert_array_equal(np.asarray(out["prediction"])[decided],
                                      (margin >= 0).astype(np.float64)[decided])

    lock = threading.Lock()
    ingests = []
    ingest = CompiledServingPlan._ingest

    def recording_ingest(self, segment, df, bucket, cap=None, warm=False):
        got = ingest(self, segment, df, bucket, cap=cap, warm=warm)
        with lock:
            ingests.append((warm, got[1]))
        return got

    config = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
    stream = _queue([], close=False)
    model = _online_lr(*ONLINE_LEGS[0][1:]).fit(stream, device=dev)
    got, step_ms = [], []

    def train_one(v):
        stream.add(batches[v - 1])
        t0 = time.perf_counter()
        if model.advance(1) != 1 or model.model_version != v:
            raise AssertionError(f"the served leg did not reach version {v}")
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got.append(model.coefficient)

    def publish(v):
        published[v] = np.asarray(model.coefficient, np.float32).astype(np.float64)
        t = time.perf_counter()
        publish_servable(model, d, version=v)
        return t, time.perf_counter()

    CompiledServingPlan._ingest = recording_ingest
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    try:
        server = InferenceServer(name="chip-smoke-online", serving_config=config,
                                 warmup_template=frames[0].take([0]), device="cuda")
        scope = server.scope
        with server:
            poller = server.attach_poller(d, interval_ms=HOT_SWAP_POLL_MS)
            stage_ms = {"load": [], "warmup": []}

            def timed(name, fn):
                def run(arg):
                    t = time.perf_counter()
                    try:
                        return fn(arg)
                    finally:
                        stage_ms[name].append((time.perf_counter() - t) * 1e3)
                return run

            poller.loader, poller.warmup = timed("load", poller.loader), timed("warmup", poller.warmup)
            for v in range(1, ONLINE_PUBLISH_EVERY + 1):
                train_one(v)
            publish(ONLINE_PUBLISH_EVERY)
            deadline = time.perf_counter() + 300
            while server.model_version != ONLINE_PUBLISH_EVERY and time.perf_counter() < deadline:
                time.sleep(0.005)
            if server.model_version != ONLINE_PUBLISH_EVERY:
                raise AssertionError(f"version {ONLINE_PUBLISH_EVERY} was not swapped in: {dict(poller.failed)}")
            kinds = chain_kinds(server.registry._current[1]._fastpath_plan)
            hot = {k for k, kind in kinds.items() if "megakernel" in kind}
            batch_versions = []
            current = server.registry.current

            def recording_current():
                pair = current()
                batch_versions.append(pair[0])
                return pair

            server.registry.current = recording_current
            # The main path's run starts here: counts to 0, then traffic.
            with lock:
                del ingests[:]
            for k in KERNELS:
                k.reset_launches()
            plain_calls, restore = _count_calls(mk, ("scale_logistic_plain",))
            base = {name: metrics.get(scope, name, 0) for name in (
                MLMetrics.SERVING_SWAPS, MLMetrics.SERVING_SWAP_FAILURES, MLMetrics.SERVING_FALLBACK_BATCHES,
                MLMetrics.SERVING_FASTPATH_COMPILES)}
            done, latencies, failures = [], [], []
            stop = threading.Event()

            def client(c):
                i = c
                while not stop.is_set() and not failures:
                    t0 = time.perf_counter()
                    try:
                        resp = server.predict(frames[i])
                        t1 = time.perf_counter()
                        done.append((i, resp.model_version, t1))
                        latencies.append((t1 - t0) * 1e3)
                        check(i, resp.dataframe, resp.model_version)
                    except BaseException as e:  # noqa: BLE001 — reported below, fails the run
                        failures.append(f"request {i} ({sizes[i]} rows): {type(e).__name__}: {e}")
                    i = (i + N_CLIENTS) % len(frames)

            flips = {}
            threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
            try:
                for th in threads:
                    th.start()
                for v in range(ONLINE_PUBLISH_EVERY + 1, ONLINE_VERSIONS + 1):
                    train_one(v)
                    if v % ONLINE_PUBLISH_EVERY:
                        continue
                    t_publish, t_published = publish(v)
                    deadline = time.perf_counter() + 300
                    first = None
                    while first is None and time.perf_counter() < deadline and not failures:
                        first = next((t for _, u, t in list(done) if u == v), None)
                        time.sleep(0.001)
                    if first is None:
                        raise AssertionError(f"no response of version {v}: {dict(poller.failed)} {failures[:3]}")
                    flips[v] = {"publish_ms": (t_published - t_publish) * 1e3,
                                "published_to_first_response_ms": (first - t_published) * 1e3}
            finally:
                stop.set()
                for th in threads:
                    th.join(timeout=600)
                restore()
                server.registry.current = current
            if any(th.is_alive() for th in threads):
                raise AssertionError("online clients did not finish within 600 s")
            launches = mk.SCALE_LOGISTIC.launches
            other = {k.name: k.launches for k in KERNELS if k is not mk.SCALE_LOGISTIC}
            deltas = {name: metrics.get(scope, name, 0) - b for name, b in base.items()}
            failed = dict(poller.failed)
    finally:
        CompiledServingPlan._ingest = ingest
        tmp.cleanup()
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    versions = sorted(published)
    if failed or deltas[MLMetrics.SERVING_SWAPS] != len(versions) - 1 or deltas[MLMetrics.SERVING_SWAP_FAILURES]:
        raise AssertionError(f"poller failed {failed}, swaps {deltas}")
    if batch_versions != sorted(batch_versions) or set(batch_versions) != set(versions):
        raise AssertionError(f"batches took versions out of order or missed some: {sorted(set(batch_versions))}")
    traffic = [key for warm, key in ingests if not warm]
    warm_hot = sum(1 for warm, key in ingests if warm and key in hot)
    hot_batches = sum(1 for key in traffic if key in hot)
    if len(traffic) != len(batch_versions):
        raise AssertionError(f"{len(traffic)} batches ingested, {len(batch_versions)} dispatched")
    if not hot_batches or launches != hot_batches + warm_hot:
        raise AssertionError(f"scale -> logistic launches {launches} != hot batches {hot_batches} "
                             f"+ the new versions' hot warmup batches {warm_hot}")
    if deltas[MLMetrics.SERVING_FALLBACK_BATCHES] or deltas[MLMetrics.SERVING_FASTPATH_COMPILES]:
        raise AssertionError(f"fallbacks or chains built after warmup: {deltas}")
    if plain_calls or any(other.values()):
        raise AssertionError(f"plain versions {sorted(set(plain_calls))} or other kernels {other} ran")
    lat = sorted(latencies)
    bit_equal_a = all(np.array_equal(g, a) for g, a in zip(got, coefs_a))
    excess, err, _ = _ftrl_versus(got, ref_a)
    if max(excess) > 0:
        raise AssertionError(f"the served leg's coefficients leave float64 FTRL's tolerance: {max(excess)}")
    reading = {
        "published_versions": versions, "flips": flips,
        "poller_load_ms": stage_ms["load"], "poller_warmup_ms": stage_ms["warmup"],
        "requests": len(done), "rows": sum(sizes[i] for i, _, _ in done),
        "responses_per_version": {v: sum(u == v for _, u, _ in done) for v in versions},
        "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "batches": len(batch_versions), "hot_keys": sorted(hot), "hot_batches": hot_batches,
        "warmup_hot_batches": warm_hot, "megakernel_launches": launches,
        "fallback_batches": deltas[MLMetrics.SERVING_FALLBACK_BATCHES],
        "post_warmup_builds": deltas[MLMetrics.SERVING_FASTPATH_COMPILES],
        "ms_per_version_under_traffic": float(np.mean(step_ms[ONLINE_PUBLISH_EVERY:])),
        "bit_equal_to_leg_A": bit_equal_a, "max_abs_err_vs_float64": err,
    }
    return reading, launches, {v: published[v] for v in versions}, payloads[sizes.index(MAX_BATCH)]


def _online_kernel_check(published, x_host, dev):
    """One 4096-row batch of each published version through the scale ->
    logistic kernel and its plain version on the card: raw's largest ulp
    distance and absolute difference, prediction equal past the margin."""
    import numpy as np
    import torch

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff

    x = torch.from_numpy(x_host).to(dev)
    out = {}
    for v, coef64 in published.items():
        coef = torch.from_numpy(coef64.astype(np.float32)).to(dev)
        _, pred_k, raw_k = mk.scale_logistic(x, None, None, coef, with_mean=False, with_std=False,
                                             write_scaled=False)
        _, pred_p, raw_p = mk.scale_logistic_plain(x, None, None, coef, with_mean=False, with_std=False)
        raw_k, raw_p = raw_k.cpu().numpy(), raw_p.cpu().numpy()
        margin = x_host.astype(np.float64) @ coef64
        decided = np.abs(margin) > PREDICTION_MARGIN
        if not np.array_equal(pred_k.cpu().numpy()[decided], pred_p.cpu().numpy()[decided]):
            raise AssertionError(f"version {v}: the kernel's prediction differs from the plain version's")
        ulps = ulp_diff(raw_k, raw_p)
        if ulps > ULP_ENVELOPE["scale_logistic"]:
            raise AssertionError(f"version {v}: raw {ulps} ulps from the plain version")
        out[v] = {"max_ulps": ulps, "max_abs_err": float(np.max(np.abs(raw_k - raw_p)))}
    return out


def _online_kill_and_resume(batches, coefs_a, dev):
    """Leg A with a CheckpointManager every ONLINE_CKPT_INTERVAL versions,
    dropped after ONLINE_KILL_AT versions and resumed from a source that
    replays the stream: every later version bit-equal to leg A's."""
    import tempfile

    import numpy as np

    from flink_ml_tpu_torch.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory() as ck:
        est = _online_lr(*ONLINE_LEGS[0][1:])
        crashed = est.set_checkpoint(CheckpointManager(ck), ONLINE_CKPT_INTERVAL).fit(
            _queue(batches[:ONLINE_KILL_AT]), device=dev)
        if crashed.advance() != ONLINE_KILL_AT:
            raise AssertionError("the killed run did not train its versions")
        steps = CheckpointManager(ck).all_steps()
        del crashed
        t0 = time.perf_counter()
        resumed = _online_lr(*ONLINE_LEGS[0][1:]).set_checkpoint(CheckpointManager(ck), ONLINE_CKPT_INTERVAL).fit(
            _queue(batches), device=dev)
        restore_ms = (time.perf_counter() - t0) * 1e3
        start = resumed.model_version
        got = {}
        resumed.advance(on_snapshot=lambda v, coef: got.__setitem__(v, coef))
    expected = list(range(ONLINE_KILL_AT + 1, ONLINE_VERSIONS + 1))
    if start != ONLINE_KILL_AT or resumed.version_history != expected:
        raise AssertionError(f"resumed at {start} with versions {resumed.version_history}")
    unequal = [v for v in expected if not np.array_equal(got[v], coefs_a[v - 1])]
    if unequal:
        raise AssertionError(f"resumed versions {unequal[:5]} are not bit-equal to the uninterrupted run")
    return {"killed_at": ONLINE_KILL_AT, "snapshots_kept": steps, "resumed_at": start,
            "versions": [expected[0], expected[-1]], "bit_equal": True, "fit_with_restore_ms": restore_ms}


def _online_kmeans_batches(seed=KMEANS_DATA_SEED + 36):
    """ONLINE_KMEANS_VERSIONS batches of uniform rows at kmeans-benchmark.json's width."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"features": rng.random((ONLINE_BATCH, KMEANS_D), dtype=np.float32)}
            for _ in range(ONLINE_KMEANS_VERSIONS)]


def _online_kmeans_leg(dev):
    """OnlineKMeans on the card, every version against float64 from its own
    starting model: the step's assignment equal to the float64 argmin past
    the margin, the weights exactly the decayed weights plus the counts, and
    the centroids within KMEANS_CENTROID_ATOL of the float64 blend over the
    same assignment."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.models.clustering.online_kmeans import OnlineKMeans
    from flink_ml_tpu_torch.ops.distance import DistanceMeasure

    batches = _online_kmeans_batches()
    est = (OnlineKMeans().set_k(KMEANS_K).set_seed(KMEANS_DATA_SEED).set_decay_factor(ONLINE_KMEANS_DECAY)
           .set_random_initial_model_data(dim=KMEANS_D))
    model = est.fit(_queue(batches), device=dev)
    prev = [(np.asarray(model.centroids, np.float32), np.asarray(model.weights, np.float32))]
    stamps = []

    def hook(version, payload):
        stamps.append(time.perf_counter())
        prev.append(payload)

    model.advance(on_snapshot=hook)
    measure = DistanceMeasure.get_instance("euclidean")
    worst = {"mismatched": 0, "inside_margin": 0, "centroid_err": 0.0, "weights_rel_err": 0.0}
    for v, b in enumerate(batches):
        (c0, w0), (c1, w1) = prev[v], prev[v + 1]
        X = torch.from_numpy(b["features"]).to(dev)
        c0_t = torch.from_numpy(np.ascontiguousarray(c0, np.float32)).to(dev)
        with torch.no_grad():
            assign = measure.find_closest(X, c0_t)  # the step's own assignment: same inputs, same bits
        dist = _kmeans_distances64("euclidean", X.double(), c0_t)
        decided = _kmeans_decided(dist)
        worst["mismatched"] += int(((assign != torch.argmin(dist, dim=1)) & decided).sum())
        worst["inside_margin"] += int((~decided).sum())
        hot = (assign[:, None] == torch.arange(KMEANS_K, device=dev)).double()
        counts = hot.sum(dim=0).cpu().numpy()
        sums = (hot.T @ X.double()).cpu().numpy()
        w_ref = w0.astype(np.float64) * ONLINE_KMEANS_DECAY + counts
        lam = np.where(w_ref > 0, counts / np.maximum(w_ref, 1e-16), 0.0)
        means = sums / np.maximum(counts, 1.0)[:, None]
        c_ref = np.where(counts[:, None] > 0, (1 - lam[:, None]) * c0.astype(np.float64) + lam[:, None] * means,
                         c0.astype(np.float64))
        worst["centroid_err"] = max(worst["centroid_err"], float(np.max(np.abs(c1 - c_ref))))
        worst["weights_rel_err"] = max(worst["weights_rel_err"], float(np.max(
            np.abs(w1 - w_ref) / np.maximum(w_ref, 1.0))))
    # a weight is one float32 rounding of decayed weight + count away from float64
    if worst["mismatched"] or worst["centroid_err"] > KMEANS_CENTROID_ATOL or worst["weights_rel_err"] > 2.0 ** -23:
        raise AssertionError(f"OnlineKMeans against float64: {worst}")
    first = ONLINE_KMEANS_VERSIONS // 4
    return {"versions": len(stamps), "ms_per_version": (stamps[-1] - stamps[first]) / (len(stamps) - 1 - first) * 1e3,
            "versions_differenced": [first + 1, len(stamps)], **worst}


def _online_scaler_leg():
    """OnlineStandardScaler over ONLINE_SCALER_WINDOWS event-time windows of
    ONLINE_BATCH rows: ms a window; at each delay the gated transform's rows
    each served by the earliest fresh enough version (scaled on the card,
    against float64 of that version's statistics), the rest buffered and
    served once their version arrives."""
    import numpy as np

    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.models.feature.standard_scaler import TIMESTAMP_COL, OnlineStandardScaler
    from flink_ml_tpu_torch.ops.windows import EventTimeTumblingWindows

    rng = np.random.default_rng(ONLINE_SEED + 2)
    n_win, size = ONLINE_SCALER_WINDOWS, ONLINE_SCALER_WINDOW_MS
    windows = [{"input": rng.normal(3.0, 2.0, (ONLINE_BATCH, ONLINE_SCALER_D)),
                TIMESTAMP_COL: np.sort(rng.uniform(w * size, (w + 1) * size, ONLINE_BATCH))} for w in range(n_win)]
    # float64 statistics of each version, and its timestamp
    X = np.concatenate([w["input"] for w in windows])
    stats = []
    for v in range(n_win):
        rows = X[: (v + 1) * ONLINE_BATCH]
        stats.append((rows.mean(axis=0), rows.std(axis=0, ddof=1), float(windows[v][TIMESTAMP_COL].max())))
    query = {"input": rng.normal(3.0, 2.0, (512, ONLINE_SCALER_D)),
             TIMESTAMP_COL: rng.uniform(0, (n_win - 0.5) * size, 512)}  # every row has a fresh enough window
    times = np.asarray([t for _, _, t in stats])

    def scaler(delay=0):
        return (OnlineStandardScaler().set_windows(EventTimeTumblingWindows.of(size)).set_with_mean(True)
                .set_max_allowed_model_delay_ms(delay))

    stamps = []
    scaler().fit(_queue([DataFrame.from_dict(w) for w in windows])).advance(
        on_snapshot=lambda v, p: stamps.append(time.perf_counter()))
    first = n_win // 4
    out = {"windows": len(stamps), "ms_per_window": (stamps[-1] - stamps[first]) / (len(stamps) - 1 - first) * 1e3,
           "versions_differenced": [first, len(stamps) - 1]}
    half = n_win // 2
    for delay in ONLINE_SCALER_DELAYS:
        stream = _queue([DataFrame.from_dict(w) for w in windows[:half]], close=False)
        model = scaler(delay).fit(stream)
        model.advance()
        served = model.transform(DataFrame.from_dict(query), device="cuda")
        pending = model.pending_rows
        for w in windows[half:]:
            stream.add(DataFrame.from_dict(w))
        later = model.serve_pending(device="cuda")
        parts = [f for f in (served, later) if f is not None]
        ts = np.concatenate([f.scalars(TIMESTAMP_COL) for f in parts])
        vers = np.concatenate([np.asarray(f["version"]) for f in parts])
        inputs = np.concatenate([f.vectors("input") for f in parts])
        outputs = np.concatenate([f.vectors("output") for f in parts])
        # a row is served by the version installed when it came, or by the
        # earliest later one fresh enough for it
        want = np.asarray([max(half - 1, int(np.argmax(times >= t - delay))) for t in ts])
        err = 0.0
        for v in np.unique(vers):
            sel = vers == v
            mean, std, _ = stats[v]
            err = max(err, float(np.max(np.abs(outputs[sel] - (inputs[sel] - mean) / std))))
        reading = {"served_first": len(served), "pending": pending,
                   "served_later": 0 if later is None else len(later), "pending_after": model.pending_rows,
                   "versions_used": sorted(set(vers.tolist())), "max_abs_err_vs_float64": err,
                   "model_version": model.model_version}
        if (len(ts) != len(query[TIMESTAMP_COL]) or model.pending_rows or not pending
                or not np.array_equal(vers, want) or err > ONLINE_SCALER_ATOL):
            raise AssertionError(f"gated transform at delay {delay}: {reading}")
        out[f"delay_{delay}"] = reading
    return out


def phase_online(card: str):
    """Online training and its published versions served (module docstring,
    phase 36). Returns the scale -> logistic kernel's launches on the path
    and the largest difference of its per-version checks."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    batches = _online_batches()
    gen_s = time.perf_counter() - t0
    legs, coefs, refs = {}, {}, {}
    for leg, reg, en in ONLINE_LEGS:
        coefs[leg], refs[leg], legs[leg] = _online_lr_leg(batches, leg, reg, en, dev)
    # the bf16-feature control must land outside the tolerance
    control_batches = [{"features": _bf16(b["features"]).astype(np.float32), "label": b["label"]}
                       for b in batches[:ONLINE_CONTROL_VERSIONS]]
    control = _online_lr(*ONLINE_LEGS[0][1:]).fit(_queue(control_batches), device=dev)
    control_got = []
    control.advance(on_snapshot=lambda v, c: control_got.append(c))
    control_excess, control_err, _ = _ftrl_versus(control_got, refs["A"][:ONLINE_CONTROL_VERSIONS])
    if max(control_excess) <= 0:
        raise AssertionError(f"the bf16 control stays inside the tolerance ({control_err})")
    kill = _online_kill_and_resume(batches, coefs["A"], dev)
    torch.cuda.synchronize()
    served, launches, published, x4096 = _online_serve_leg(batches, coefs["A"], refs["A"], dev)
    kernel = _online_kernel_check(published, x4096, dev)
    kmeans = _online_kmeans_leg(dev)
    scaler = _online_scaler_leg()
    emit("online", card=card, seconds=time.perf_counter() - t_phase, batch_generation_s=gen_s,
         shape={"d": ONLINE_D, "batch": ONLINE_BATCH, "versions": ONLINE_VERSIONS, "alpha": ONLINE_ALPHA,
                "beta": ONLINE_BETA},
         legs=legs, bf16_control={"versions": len(control_got), "max_abs_err_vs_float64": control_err,
                                  "worst_excess_over_tol": max(control_excess)},
         kill_and_resume=kill, serve=served, kernel_vs_plain=kernel, kmeans=kmeans, scaler=scaler)
    return launches, max(k["max_abs_err"] for k in kernel.values())


def _random_string_arrays(seed, rows, array_size, distinct):
    """RandomStringArrayGenerator (flink_ml_tpu/benchmark/datagenerator.py)
    for one column: ``rows`` arrays of ``array_size`` strings, each the
    decimal of a uniform integer below ``distinct``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [[str(v) for v in row] for row in rng.integers(0, distinct, (rows, array_size)).tolist()]


def _double_columns(seed, names, rows):
    """DoubleGenerator (flink_ml_tpu/benchmark/datagenerator.py) at arity 0:
    per column, ``rows`` uniform doubles in [0, 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {name: rng.random(rows) for name in names}


def _murmur3_index(term: str, dim: int) -> int:
    """The reference's HashingTF index of a string, computed here for the
    float64 reference: guava murmur3_32(0) over the UTF-16LE code units
    (``hashUnencodedChars``), then nonNegativeMod."""
    data = term.encode("utf-16-le")
    mask = 0xFFFFFFFF

    def mix_k(k):
        k = (k * 0xCC9E2D51) & mask
        k = ((k << 15) | (k >> 17)) & mask
        return (k * 0x1B873593) & mask

    h = 0
    body = len(data) - len(data) % 4
    for i in range(0, body, 4):
        h ^= mix_k(int.from_bytes(data[i:i + 4], "little"))
        h = ((h << 13) | (h >> 19)) & mask
        h = (h * 5 + 0xE6546B64) & mask
    if len(data) > body:
        h ^= mix_k(int.from_bytes(data[body:], "little"))
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & mask
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & mask
    h ^= h >> 16
    signed = h - (1 << 32) if h >= 1 << 31 else h
    return signed % dim  # Python's % is nonNegativeMod for a positive dim


def _text_rows(seed, rows):
    """Documents of the text phase's generator, and each one's term counts
    over the distinct strings ([rows, TEXT_DISTINCT], by string value)."""
    import numpy as np

    arrays = _random_string_arrays(seed, rows, TEXT_ARRAY, TEXT_DISTINCT)
    counts = np.zeros((rows, TEXT_DISTINCT), np.int64)
    for r, row in enumerate(arrays):
        for t in row:
            counts[r, int(t)] += 1
    return [" ".join(row) for row in arrays], counts


def _text_ids():
    """The hashed index of each distinct string in ascending order, and the
    order (string values by index) that sorts them; fails on a collision."""
    import numpy as np

    index = np.asarray([_murmur3_index(str(v), TEXT_DIM) for v in range(TEXT_DISTINCT)])
    order = np.argsort(index)
    if len(np.unique(index)) != TEXT_DISTINCT:
        raise AssertionError(f"two of the strings hash to one index: {index}")
    return index[order], order


def _text_reference(counts, idf32, coef32):
    """The float64 numpy reference of a batch: per document the hashed ids
    (sorted), their term counts, tf-idf as the float32 product of count and
    float32 idf (exact in float64, then rounded once), and the probability
    of the float64 margin over the float32 tf-idf and coefficient."""
    import numpy as np

    ids, order = _text_ids()
    cnt = counts[:, order]
    tfidf = (cnt * idf32.astype(np.float64)[ids][None, :]).astype(np.float32).astype(np.float64)
    margin = (tfidf * coef32.astype(np.float64)[ids][None, :]).sum(axis=1)
    return ids, cnt, tfidf, 1.0 / (1.0 + np.exp(-margin)), margin


def _text_check_tf(column, ids, counts, tfidf, where, values=False):
    """A tf (or, with ``values``, tf-idf) SparseVector column exactly equal
    to the reference rows: the ids a row holds and their counts (tf-idf)."""
    import numpy as np

    for r, v in enumerate(column):
        held = counts[r] > 0
        want = tfidf[r][held] if values else counts[r][held].astype(np.float64)
        if v.size() != TEXT_DIM or not np.array_equal(v.indices, ids[held]) or not np.array_equal(v.values, want):
            raise AssertionError(f"{where}: row {r} is {v} against ids {ids[held]} values {want}")


def _same_frames(a, b, where):
    """Two DataFrames bit for bit: names, dense columns by their bits,
    SparseVector columns by size, indices and value bits, others by value."""
    import numpy as np

    if a.get_column_names() != b.get_column_names():
        raise AssertionError(f"{where}: columns {a.get_column_names()} != {b.get_column_names()}")
    for name in a.get_column_names():
        ca, cb = a.column(name), b.column(name)
        if isinstance(ca, np.ndarray):
            cb = np.asarray(cb)
            if ca.dtype != cb.dtype or ca.shape != cb.shape or ca.tobytes() != cb.tobytes():
                raise AssertionError(f"{where}: column {name} differs")
        elif len(ca) and hasattr(ca[0], "indices"):
            for r, (u, v) in enumerate(zip(ca, cb)):
                if not (u.size() == v.size() and np.array_equal(u.indices, v.indices)
                        and u.values.tobytes() == v.values.tobytes()):
                    raise AssertionError(f"{where}: column {name} row {r} differs")
        elif list(ca) != list(cb):
            raise AssertionError(f"{where}: column {name} differs")


def _fused_and_per_stage(model, df, where):
    """``model.transform(df)`` in the batch tier (exact, 65,536-row chunks)
    and per stage: ``(fused, per-stage, readings)``, failing unless the
    fused segment took every row and the two frames agree bit for bit."""
    from flink_ml_tpu_torch.config import Options, config
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics

    scope = "ml.batch[plan]"
    config.set(Options.FUSION_MODE, "exact")
    config.set(Options.BATCH_CHUNK_ROWS, PIPELINE_CHUNK_ROWS)
    try:
        rows0 = metrics.get(scope, MLMetrics.BATCH_FUSED_ROWS, 0)
        out, seconds, launches, builds, chunks = _batch_transform(model, df)
        fused_rows = metrics.get(scope, MLMetrics.BATCH_FUSED_ROWS, 0) - rows0
        config.set(Options.BATCH_FASTPATH, False)
        per_stage, per_stage_s = _sync_seconds(lambda: model.transform(df))
    finally:
        for option in (Options.FUSION_MODE, Options.BATCH_CHUNK_ROWS, Options.BATCH_FASTPATH):
            config.unset(option)
    if fused_rows != len(df) or launches:
        raise AssertionError(f"{where}: {fused_rows} of {len(df)} rows fused, kernels {launches}")
    _same_frames(out, per_stage, where)
    return out, per_stage, {"rows": len(df), "chunks": chunks, "builds": builds, "seconds": seconds,
                            "per_stage_seconds": per_stage_s}


def phase_text(card: str):
    """Tokenizer → HashingTF → IDF → LogisticRegression fitted on the card at
    hashingtf-benchmark.json's rows, batch-transformed and served (module
    docstring, phase 30). Returns the launches of the crossings the fit ran."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch

    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.builder import Pipeline, PipelineModel
    from flink_ml_tpu_torch.iteration import DeviceDataCache
    from flink_ml_tpu_torch.linalg import onehot_sparse as O
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegression
    from flink_ml_tpu_torch.models.common import extract_labeled_data
    from flink_ml_tpu_torch.models.feature import IDF, HashingTF, Tokenizer
    from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss
    from flink_ml_tpu_torch.ops.optimizer import SGD
    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
    from flink_ml_tpu_torch.servable.planner import FusedSegment, PlanExecution, run_segment, to_device
    from flink_ml_tpu_torch.servable.sparse import resolve_nnz_cap_max
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    t0 = time.perf_counter()
    docs, counts = _text_rows(TEXT_SEED, TEXT_ROWS)
    w = np.random.default_rng(TEXT_LABEL_SEED).normal(size=TEXT_DISTINCT)
    y = (counts @ (w - w.mean()) > 0).astype(np.float64)  # the label rule over the tokens
    df = DataFrame.from_dict({"text": docs, "label": y})
    data_s = time.perf_counter() - t0

    # The fit: the pipeline's transforms and IDF on the way, the one-hot path at the end.
    premat_k = (O.DOT_CROSSING_PREMAT, O.MULT_CROSSING_PREMAT)
    build_k = (O.DOT_CROSSING, O.MULT_CROSSING)
    est = (LogisticRegression().set_features_col("tfidf").set_max_iter(TEXT_ITERS)
           .set_global_batch_size(TEXT_BATCH).set_learning_rate(TEXT_LR).set_tol(0.0))
    pipeline = Pipeline([Tokenizer().set_input_col("text").set_output_col("tokens"),
                         HashingTF().set_input_col("tokens").set_output_col("tf"),
                         IDF().set_input_col("tf").set_output_col("tfidf"), est])
    calls, restore = _count_plain_calls()
    try:
        for k in premat_k + build_k:
            k.reset_launches()
        model, fit_s = _sync_seconds(lambda: pipeline.fit(df))
        launches = {k.name: k.launches for k in premat_k + build_k}
    finally:
        restore()
    if model.stages[1].get_num_features() != TEXT_DIM:
        raise AssertionError("HashingTF's default numFeatures is not 2^18")
    ran, idle = (premat_k, build_k) if est.onehot_premat_active else (build_k, premat_k)
    if calls:
        raise AssertionError(f"plain crossings were called on the card: {sorted(set(calls))}")
    if any(launches[k.name] != TEXT_ITERS for k in ran) or any(launches[k.name] for k in idle):
        raise AssertionError(f"the text fit's crossing launches are {launches}: no one-hot path ran")
    idf_model, lr_model = model.stages[2], model.stages[3]
    ids, order = _text_ids()
    doc_freq = (counts > 0).sum(axis=0)[order]
    idf_ref = np.log((TEXT_ROWS + 1.0) / (doc_freq + 1.0))
    if not (np.array_equal(idf_model.doc_freq[ids], doc_freq)
            and np.allclose(idf_model.idf[ids], idf_ref, rtol=1e-15, atol=0)
            and np.count_nonzero(idf_model.doc_freq) == len(ids)):
        raise AssertionError("the fitted IDF is not the float64 document-frequency reference")

    # The coefficient against float64 SGD on the fit's own float32 tf-idf rows.
    idf32 = np.asarray(idf_model.idf, np.float32)
    _ids, cnt, tfidf, _p, _m = _text_reference(counts, idf32, np.zeros(TEXT_DIM, np.float32))
    rows_idx = np.broadcast_to(ids, cnt.shape)
    ref, ref_losses = _reference_sgd(rows_idx, tfidf, y, TEXT_DIM, batch=TEXT_BATCH, iters=TEXT_ITERS,
                                     lr=TEXT_LR)
    control, _ = _reference_sgd(rows_idx, tfidf, y, TEXT_DIM, hi_only=True, batch=TEXT_BATCH,
                                iters=TEXT_ITERS, lr=TEXT_LR)
    coef = np.asarray(lr_model.coefficient)
    scale = float(np.abs(ref).max())
    coef_err = float(np.abs(coef.astype(np.float64) - ref).max())
    control_err = float(np.abs(control - ref).max())
    loss_err = float(np.max(np.abs(np.asarray(est.loss_history) - ref_losses) / np.abs(ref_losses)))
    if not coef_err <= COEF_TOL * scale:
        raise AssertionError(f"the text coefficient is {coef_err} off the float64 SGD (scale {scale})")
    if not control_err > COEF_TOL * scale:
        raise AssertionError(f"the hi-half-only control is within the tolerance ({control_err}, scale {scale})")
    if not loss_err <= 1e-5:
        raise AssertionError(f"the text loss history is {loss_err} off the float64 one (relative)")

    # ms/step: SGD on the fit's tf-idf rows, the form the fit ran, two iteration counts on one cache.
    tfidf_df = PipelineModel(model.stages[:3]).transform(df)
    cols = extract_labeled_data(tfidf_df, "tfidf", "label", None, allow_sparse=True)
    dim = cols.pop("dim")
    cache = DeviceDataCache(cols)
    del tfidf_df, cols
    form = "on" if est.onehot_premat_active else "off"

    def sgd_seconds(iters):
        opt = SGD(max_iter=iters, global_batch_size=TEXT_BATCH, tol=0.0, learning_rate=TEXT_LR,
                  onehot_premat=form)
        return _sync_seconds(lambda: opt.optimize(np.zeros(dim, np.float32), cache,
                                                  BinaryLogisticLoss.INSTANCE))[1]

    sgd_seconds(TEXT_STEP_ITERS[0])  # the cache's one-hot layout, built once
    step_ms = []
    for _ in range(3):
        t = [sgd_seconds(iters) for iters in TEXT_STEP_ITERS]
        step_ms.append((t[1] - t[0]) / (TEXT_STEP_ITERS[1] - TEXT_STEP_ITERS[0]) * 1e3)
    del cache
    torch.cuda.empty_cache()

    # The batch tier, exact: every row on the chain, fused equal to per-stage bit for bit.
    out, _, batch = _fused_and_per_stage(model, df, "text batch tier")
    (segment,) = [s for s in model._plan_cache[1].segments if isinstance(s, FusedSegment)]
    batch["programs"] = [p.kind for p in segment.programs]
    if batch["chunks"] != -(-TEXT_ROWS // PIPELINE_CHUNK_ROWS) or segment.external_inputs != ("tokens",):
        raise AssertionError(f"text batch tier: {batch}, inputs {segment.external_inputs}")
    _text_check_tf(out.column("tf")[:4096], ids, cnt[:4096], tfidf[:4096], "batch tf")
    _text_check_tf(out.column("tfidf")[:4096], ids, cnt[:4096], tfidf[:4096], "batch tfidf", values=True)

    # Serving: the fitted model saved, loaded and served with the sparse fast path.
    import tempfile

    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig

    rng = np.random.default_rng(TEXT_SERVE_SEED)
    sizes = _traffic_sizes(rng)
    pool, pool_counts = _text_rows(TEXT_SERVE_SEED, sum(sizes))
    starts = np.cumsum([0] + sizes[:-1])
    payloads = [{"text": pool[s:s + n]} for s, n in zip(starts, sizes)]
    coef32 = np.asarray(lr_model.coefficient, np.float32)
    want = [_text_reference(pool_counts[s:s + n], idf32, coef32) for s, n in zip(starts, sizes)]
    expected = [model.transform(DataFrame.from_dict(p)) for p in payloads]  # the per-stage path's answers

    def check(i, frame):
        ids_i, cnt_i, tfidf_i, p, margin = want[i]
        _text_check_tf(frame.column("tf"), ids_i, cnt_i, tfidf_i, f"request {i} tf")
        _text_check_tf(frame.column("tfidf"), ids_i, cnt_i, tfidf_i, f"request {i} tfidf", values=True)
        raw = np.asarray(frame.column("rawPrediction"))
        np.testing.assert_allclose(raw, np.stack([1.0 - p, p], axis=1), rtol=0, atol=TEXT_PROB_ATOL)
        ulps = ulp_diff(raw, expected[i].column("rawPrediction"))
        if ulps > ULP_ENVELOPE["sparse_idf_logistic"]:
            raise AssertionError(f"request {i}: rawPrediction {ulps} ulps off the per-stage path")
        if not np.array_equal(frame.column("prediction"), expected[i].column("prediction")):
            raise AssertionError(f"request {i}: predictions differ from the per-stage path")

    tmp = tempfile.TemporaryDirectory()
    try:
        model.save(f"{tmp.name}/text")
        servable = PipelineModel.load_servable(f"{tmp.name}/text")
    finally:
        tmp.cleanup()
    cfg = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
    t0 = time.perf_counter()
    server = InferenceServer(servable, name="chip-smoke-text", serving_config=cfg,
                             warmup_template=DataFrame.from_dict({"text": docs[:1]}), device="cuda")
    warmup_s = time.perf_counter() - t0
    sscope = server.scope
    with server:
        plan = servable._fastpath_plan
        kinds = chain_kinds(plan)
        for k in KERNELS:
            k.reset_launches()
        batches_before = len(server.executed_batch_sizes)
        fallback0 = metrics.get(sscope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles0 = metrics.get(sscope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
        latencies, wall, failures = _serve_and_check(server, payloads, "text", check)
        served_launches = {k.name: k.launches for k in KERNELS if k.launches}
        batches = server.executed_batch_sizes[batches_before:]
        fallback = metrics.get(sscope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback0
        compiles = metrics.get(sscope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles0
    if failures:
        raise AssertionError(f"{len(failures)} text responses failed: {failures[:5]}")
    if fallback or compiles:
        raise AssertionError(f"text serving: {fallback} fallback batches, {compiles} chains built after warmup")
    if any(not (isinstance(k, tuple) and len(k) == 2) for k in kinds) or served_launches:
        raise AssertionError(f"text serving keys {sorted(kinds)}, kernels launched {served_launches}")
    (segment,) = [s for s in plan.segments if isinstance(s, FusedSegment)]

    # Where a 4096-document batch's time goes on the served path (host clock,
    # the device synchronised after each step; the chain's device time by
    # CUDA events), median of 5.
    batch_df = DataFrame.from_dict(payloads[sizes.index(MAX_BATCH)])
    tokenizer = servable.servables[0]
    steps = {"tokenize": [], "featurize": [], "upload": [], "chain": [], "chain_device": [], "readback": []}
    for _ in range(6):
        t0 = time.perf_counter()
        tokens = tokenizer.transform(batch_df)
        t1 = time.perf_counter()
        arrays, cap = segment.gather_sparse(tokens, "tokens", cap_max=resolve_nnz_cap_max())
        t2 = time.perf_counter()
        inputs = {n: to_device(a, segment.device) for n, a in arrays.items()}
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outputs = run_segment(segment, (MAX_BATCH, cap), inputs)
        end.record()
        end.synchronize()
        t4 = time.perf_counter()
        PlanExecution(tokens, segment.pending(outputs)).finalize()
        t5 = time.perf_counter()
        for name, ms in zip(steps, ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3, (t4 - t3) * 1e3,
                                    start.elapsed_time(end), (t5 - t4) * 1e3)):
            steps[name].append(ms)
    breakdown = {name: _median(v[1:]) for name, v in steps.items()}  # the first warms the host caches
    lat = sorted(latencies)
    form_name = "premat" if est.onehot_premat_active else "build"
    emit("text", card=card, seconds=time.perf_counter() - t_phase, rows=TEXT_ROWS, dim=TEXT_DIM,
         data_s=data_s, fit={
             "form": form_name, "crossing_launches": launches, "iterations": TEXT_ITERS,
             "batch": TEXT_BATCH, "windows": -(-TEXT_ROWS // TEXT_BATCH), "fit_s": fit_s,
             "ms_per_step": _median(step_ms), "ms_per_step_runs": step_ms,
             "coef_max_abs_err_vs_f64": coef_err, "coef_scale": scale,
             "hi_only_control_max_abs_err_vs_f64": control_err, "loss_max_rel_err_vs_f64": loss_err,
             "loss_first": est.loss_history[0], "loss_last": est.loss_history[-1],
             "label_share": float(y.mean())},
         batch={**batch, "fused_equals_per_stage": "bit for bit"},
         serve={"warmup_s": warmup_s, "keys": len(kinds), "caps": sorted({c for _, c in kinds}),
                "requests": len(payloads), "documents": sum(sizes), "batches": len(batches),
                "fallback_batches": fallback, "post_warmup_builds": compiles,
                "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
                "docs_per_s": sum(sizes) / wall, "wall_s": wall,
                "featurize_ms_per_4096_docs": breakdown["tokenize"] + breakdown["featurize"],
                "chain_ms_per_4096_docs": breakdown["chain_device"], "chain_nnz_cap": cap,
                "hot_batch_breakdown_ms": breakdown, "hot_batch_runs_ms": steps,
                "device_busy_share_of_batch": breakdown["chain_device"] / sum(
                    breakdown[k] for k in ("tokenize", "featurize", "upload", "chain", "readback"))})
    return {k.name: launches[k.name] for k in ran}


def phase_featurize(card: str):
    """CountVectorizer and FeatureHasher at their published configurations,
    batch-transformed fused against per-stage (module docstring, phase 31)."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch

    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.builder import PipelineModel
    from flink_ml_tpu_torch.config import Options, config
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.feature import CountVectorizer, FeatureHasher

    # CountVectorizer: 100 raw entries a row, so the leg sets the cap ladder to 128.
    docs = _random_string_arrays(CV_SEED, CV_ROWS, CV_ARRAY, CV_DISTINCT)
    cv_df = DataFrame.from_dict({"input": docs})
    cv_model, cv_fit_s = _sync_seconds(lambda: CountVectorizer().fit(cv_df))
    vocab = cv_model.vocabulary
    if sorted(vocab) != sorted(str(v) for v in range(CV_DISTINCT)):
        raise AssertionError(f"the vocabulary holds {len(vocab)} terms, not the {CV_DISTINCT} drawn")
    cv_pipe = PipelineModel([cv_model])
    config.set(Options.SPARSE_NNZ_CAP_MAX, CV_CAP_MAX)
    try:
        cv_out, _, cv_readings = _fused_and_per_stage(cv_pipe, cv_df, "CountVectorizer")
    finally:
        config.unset(Options.SPARSE_NNZ_CAP_MAX)
    position = {t: i for i, t in enumerate(vocab)}
    for r in range(0, CV_ROWS, 97):  # counts against numpy
        want = np.bincount([position[t] for t in docs[r]], minlength=len(vocab)).astype(np.float64)
        v = cv_out.column("output")[r]
        if not np.array_equal(v.to_array(), want):
            raise AssertionError(f"CountVectorizer row {r} is not the token counts")
    # At the default cap of 64 the batch is off the ladder: per stage, labelled, the same bits.
    scope = "ml.batch[plan]"
    reason = MLMetrics.fallback_reason("batch", "off_ladder")
    off0 = metrics.get(scope, reason, 0)
    config.set(Options.FUSION_MODE, "exact")
    try:
        cv_pipe.invalidate_batch_plan()
        off_out, off_s = _sync_seconds(lambda: cv_pipe.transform(cv_df))
    finally:
        config.unset(Options.FUSION_MODE)
    off_ladder = metrics.get(scope, reason, 0) - off0
    if off_ladder != 1:
        raise AssertionError(f"the cap-64 transform fell back {off_ladder} times under off_ladder, not once")
    _same_frames(off_out, cv_out, "CountVectorizer at cap 64")
    del cv_df, cv_out, off_out, docs

    # FeatureHasher: three categorical columns and two numeric ones.
    columns = _double_columns(FH_SEED, FH_COLS, FH_ROWS)
    fh_df = DataFrame.from_dict(columns)
    hasher = (FeatureHasher().set_input_cols(*FH_COLS).set_categorical_cols(*FH_CATEGORICAL)
              .set_num_features(FH_DIM))
    fh_out, _, fh_readings = _fused_and_per_stage(PipelineModel([hasher]), fh_df, "FeatureHasher")
    numeric = columns["f3"] + columns["f4"]
    for r in range(0, FH_ROWS, 97):
        v = fh_out.column("output")[r]
        if v.size() != FH_DIM or not abs(v.values.sum() - (len(FH_CATEGORICAL) + numeric[r])) <= 1e-6:
            raise AssertionError(f"FeatureHasher row {r}: {v} does not sum to 3 + f3 + f4")
    torch.cuda.empty_cache()
    emit("featurize", card=card, seconds=time.perf_counter() - t_phase,
         count_vectorizer={"rows": CV_ROWS, "tokens_per_row": CV_ARRAY, "vocabulary": len(vocab),
                           "nnz_cap_max": CV_CAP_MAX, "fit_s": cv_fit_s, **cv_readings,
                           "cap64_off_ladder_fallbacks": off_ladder, "cap64_seconds": off_s,
                           "fused_equals_per_stage": "bit for bit"},
         feature_hasher={"rows": FH_ROWS, "columns": list(FH_COLS), "categorical": list(FH_CATEGORICAL),
                         "num_features": FH_DIM, **fh_readings, "fused_equals_per_stage": "bit for bit"})


def _lr_published_rows():
    """logisticregression-benchmark.json's rows: LabeledPointWithWeightGenerator
    at seed LR_SEED — features U[0, 1) [100,000 × 100], labels of arity 2,
    weights U[0, 1)."""
    import numpy as np

    rng = np.random.default_rng(LR_SEED)
    X = rng.random((LR_ROWS, LR_D))
    y = rng.integers(0, 2, LR_ROWS).astype(np.float64)
    return X, y, rng.random(LR_ROWS)


def _reference_dense_logistic(X, y, w, iters, lr):
    """Float64 full-batch gradient descent of the deterministic tier's
    schedule at globalBatchSize == rows (every epoch's window is every row):
    BinaryLogisticLoss, weighted rows, no regularization."""
    import numpy as np

    X64, ys, w64 = X.astype(np.float32).astype(np.float64), 2.0 * y - 1.0, w.astype(np.float32).astype(np.float64)
    coef = np.zeros(X.shape[1])
    for _ in range(iters):
        z = (X64 @ coef) * ys
        mult = w64 * (-ys / (1.0 + np.exp(z)))
        coef -= lr / w64.sum() * (X64.T @ mult)
    return coef


def _mlp_sharded_rows():
    """serve_mlp's rows, standardised on the host (float64 moments,
    float32 features): the sharded MLP fit's input."""
    import numpy as np

    X, y = _mlp_rows(np.random.default_rng(MLP_SEED + 10), _mlp_population(), MLP_ROWS)
    X = (X - X.mean(axis=0)) / X.std(axis=0, ddof=1)
    return X.astype(np.float32), y


def _sharded_rank(rank, world, init, backend, out_dir):
    """One rank of a sharded world: joins the process group on the card,
    sets train.mesh to the world size and runs the world's fits through the
    entry points a user calls, each rank on the same whole input. Writes its
    readings (JSON) and arrays (npz) to ``out_dir``."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            device_id=torch.device("cuda", 0) if backend == "nccl" else None)
    try:
        import flink_ml_tpu_torch.linalg.onehot_sparse as O
        from flink_ml_tpu_torch.api.dataframe import DataFrame
        from flink_ml_tpu_torch.checkpoint import ShardedCheckpointManager
        from flink_ml_tpu_torch.config import Options, config
        from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegression
        from flink_ml_tpu_torch.models.classification.mlp_classifier import MLPClassifier
        from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
        from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss, LeastSquareLoss
        from flink_ml_tpu_torch.ops.optimizer import SGD
        from flink_ml_tpu_torch.parallel.collectives import all_gather_blocks
        from flink_ml_tpu_torch.parallel.train_sharding import resolve_train_sharding

        config.set(Options.TRAIN_MESH, world)
        ts = resolve_train_sharding()
        ctx = ts.ctx
        readings = {"rank": rank, "backend": ctx.backend, "device": str(ctx.device),
                    "host_staged": ctx.host_staged, "card_bytes": torch.cuda.mem_get_info()[1]}
        arrays = {}

        def timed(fn):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        def peak(name):
            readings[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

        # dense LogisticRegression at the published config
        X, y, w = _lr_published_rows()
        df = DataFrame.from_dict({"features": X, "label": y, "weight": w})

        def lr(iters):
            return (LogisticRegression().set_weight_col("weight").set_max_iter(iters)
                    .set_global_batch_size(LR_BATCH).set_learning_rate(LR_LR).set_tol(LR_TOL))

        torch.cuda.reset_peak_memory_stats()
        model, fit_s = timed(lambda: lr(LR_ITERS).fit(df))
        arrays["lr_coef"] = model.coefficient
        peak("lr")
        spans = [timed(lambda: lr(iters).fit(df))[1] for iters in SHARDED_EPOCH_ITERS]
        readings["lr"] = {"fit_s": fit_s, "ms_per_epoch": (spans[1] - spans[0])
                          / (SHARDED_EPOCH_ITERS[1] - SHARDED_EPOCH_ITERS[0]) * 1e3}

        # KMeans at the published config
        pts = _kmeans_published_rows()
        kdf = DataFrame.from_dict({"features": pts})

        def km(iters):
            return KMeans().set_k(KMEANS_K).set_max_iter(iters)

        model, fit_s = timed(lambda: km(KMEANS_ITERS).fit(kdf))
        arrays["kmeans_centroids"], arrays["kmeans_weights"] = model.centroids, model.weights
        peak("kmeans")
        spans = [timed(lambda: km(iters).fit(kdf))[1] for iters in (KMEANS_ITERS, 2 * KMEANS_ITERS)]
        readings["kmeans"] = {"fit_s": fit_s, "ms_per_epoch": (spans[1] - spans[0]) / KMEANS_ITERS * 1e3}

        # OnlineKMeans (phase 36's stream) on the deterministic tier: every
        # version bit-equal across the ranks and the widths
        from flink_ml_tpu_torch.models.clustering.online_kmeans import OnlineKMeans

        stream = _queue([], close=False)
        model = (OnlineKMeans().set_k(KMEANS_K).set_seed(KMEANS_DATA_SEED).set_decay_factor(ONLINE_KMEANS_DECAY)
                 .set_random_initial_model_data(dim=KMEANS_D).fit(stream))
        cs, ws, stamps = [], [], []
        torch.cuda.synchronize()
        dist.barrier()
        for batch in _online_kmeans_batches():
            stream.add(batch)
            if model.advance(1) != 1:
                raise AssertionError("OnlineKMeans did not take its batch")
            stamps.append(time.perf_counter())
            cs.append(model.centroids)
            ws.append(model.weights)
        arrays["online_kmeans_centroids"], arrays["online_kmeans_weights"] = np.stack(cs), np.stack(ws)
        first = ONLINE_KMEANS_VERSIONS // 4
        readings["online_kmeans"] = {"versions": len(stamps), "ms_per_version": (stamps[-1] - stamps[first])
                                     / (len(stamps) - 1 - first) * 1e3}

        # the mapreduce all_gather at each fit's partial shape
        gathers = {}
        for name, shape in (("lr", (LR_BATCH // 8 // world, LR_D + 2)),
                            ("kmeans", (-(-KMEANS_ROWS // (8 * world)), KMEANS_K, KMEANS_D + 1))):
            part = torch.ones(shape, device=ctx.device)
            if world > 1:
                all_gather_blocks(part, ctx)  # warm
                gathers[name] = timed(lambda: [all_gather_blocks(part, ctx)
                                               for _ in range(SHARDED_GATHER_REPS)])[1] / SHARDED_GATHER_REPS * 1e3
        readings["all_gather_ms"] = gathers

        # the headline wide-sparse fit: each crossing of the form taken
        # launched once a step on every rank, no plain crossing
        idx, ys = _headline_data()
        cols = {"indices": idx.astype(np.int32), "values": np.ones(idx.shape, np.float32), "labels": ys}
        kernels = (O.DOT_CROSSING, O.MULT_CROSSING, O.DOT_CROSSING_PREMAT, O.MULT_CROSSING_PREMAT)
        calls, restore = _count_plain_calls()
        try:
            for k in kernels:
                k.reset_launches()
            opt = SGD(max_iter=TRAIN_ITERS, learning_rate=TRAIN_LR, global_batch_size=TRAIN_BATCH, tol=0.0)
            coef, fit_s = timed(lambda: opt.optimize(np.zeros(TRAIN_DIM, np.float32), cols,
                                                     BinaryLogisticLoss.INSTANCE))
            launches = {k.name: k.launches for k in kernels}
        finally:
            restore()
        arrays["sparse_coef"] = coef
        peak("sparse")
        readings["sparse"] = {"fit_s": fit_s, "launches": launches, "plain_calls": len(calls),
                              "premat": opt.onehot_premat_active, "layout_s": opt.layout_seconds,
                              "losses": opt.loss_history}

        if world == SHARDED_MLP_WIDTH:
            Xm, ym = _mlp_sharded_rows()
            est = (MLPClassifier().set_hidden_layers(*MLP_WIDTHS[1:-1]).set_max_iter(MLP_ITERS)
                   .set_global_batch_size(MLP_BATCH))
            model, fit_s = timed(lambda: est.fit(DataFrame.from_dict({"features": Xm, "label": ym})))
            peak("mlp")
            readings["mlp"] = {"fit_s": fit_s, "losses": est.loss_history, "seed": est.get_seed(),
                               "lr": est.get_learning_rate()}

        ckpt_dir = os.path.join(out_dir, "ckpt")
        if world == SHARDED_CKPT_WIDTH:
            Xc, yc = _dense_ckpt_rows()
            data = {"features": Xc, "labels": yc}
            kw = dict(max_iter=SHARDED_CKPT_ITERS, learning_rate=CKPT_DENSE_LR,
                      global_batch_size=SHARDED_CKPT_BATCH, tol=0.0, checkpoint_interval=CKPT_INTERVAL)
            clean = SGD(checkpoint_manager=ShardedCheckpointManager(os.path.join(ckpt_dir, "clean"), sharding=ts),
                        **kw).optimize(np.zeros(CKPT_DENSE_D, np.float32), data, LeastSquareLoss.INSTANCE)
            mgr = ShardedCheckpointManager(os.path.join(ckpt_dir, "killed"), sharding=ts)
            try:
                SGD(checkpoint_manager=mgr, listeners=[_fail_at(SHARDED_CKPT_KILL)], **kw).optimize(
                    np.zeros(CKPT_DENSE_D, np.float32), data, LeastSquareLoss.INSTANCE)
                raise AssertionError("the listener did not stop the checkpointed fit")
            except RuntimeError as e:
                if "killed at epoch" not in str(e):
                    raise
            killed_steps = mgr.all_steps()
            resumed = SGD(checkpoint_manager=mgr, **kw).optimize(
                np.zeros(CKPT_DENSE_D, np.float32), data, LeastSquareLoss.INSTANCE)
            arrays["ckpt_clean"], arrays["ckpt_resumed"] = clean, resumed
            readings["ckpt"] = {"killed_steps": killed_steps, "steps": mgr.all_steps()}
        if world == SHARDED_RESTORE_WIDTH:
            step, state = ShardedCheckpointManager(os.path.join(ckpt_dir, "killed"), sharding=ts).restore_latest()
            arrays["restored_coef"] = state[0].cpu().numpy()
            readings["restored"] = {"step": step, "offset": int(state[1]), "device": str(state[0].device)}
        np.savez(os.path.join(out_dir, f"w{world}_r{rank}.npz"), **arrays)
        with open(os.path.join(out_dir, f"w{world}_r{rank}.json"), "w") as f:
            json.dump(readings, f)
    finally:
        dist.destroy_process_group()


def phase_sharded(card: str):
    """Data-parallel training on train.mesh (module docstring, phase 32).
    Returns the crossing kernels' launches over every rank of every world,
    and rank 0's headline sparse coefficient by width."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import flink_ml_tpu_torch.linalg.onehot_sparse as O
    from flink_ml_tpu_torch.checkpoint import ShardedCheckpointManager
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
    from flink_ml_tpu_torch.parallel.train_sharding import pick_backend

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="sharded-")
    worlds = {}
    for world in SHARDED_WIDTHS:
        backend = pick_backend(world)
        t0 = time.perf_counter()
        mp.start_processes(_sharded_rank, args=(world, f"file://{out_dir}/init_w{world}", backend, out_dir),
                           nprocs=world, join=True, start_method="spawn")
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"w{world}_r{r}.json")) as f:
                got = json.load(f)
            with np.load(os.path.join(out_dir, f"w{world}_r{r}.npz")) as z:
                got["arrays"] = {k: z[k] for k in z.files}
            ranks.append(got)
        worlds[world] = ranks
        emit("sharded", card=card, world=world, backend=backend, seconds=time.perf_counter() - t0,
             ranks=[{k: v for k, v in got.items() if k != "arrays" and k != "sparse"}
                    | {"sparse": {k: v for k, v in got["sparse"].items() if k != "losses"}} for got in ranks])

    def check(ok, what):
        if not ok:
            raise AssertionError(what)

    # every rank returns the same model, and each width the same as width 1
    for world, ranks in worlds.items():
        check(all(r["backend"] == ("nccl" if world == 1 else "gloo") for r in ranks),
              f"world {world} took {[r['backend'] for r in ranks]}")
        for got in ranks[1:]:
            for name, a in ranks[0]["arrays"].items():
                check(np.array_equal(a, got["arrays"][name]), f"world {world}: rank {got['rank']}'s {name} differs")
    base = worlds[1][0]["arrays"]
    for world in SHARDED_WIDTHS[1:]:
        for name in ("lr_coef", "kmeans_centroids", "kmeans_weights", "online_kmeans_centroids",
                     "online_kmeans_weights"):
            check(np.array_equal(worlds[world][0]["arrays"][name], base[name]),
                  f"{name} at width {world} is not bit-equal to width 1")

    # dense: float64 of the schedule (globalBatchSize is every row)
    X, y, w = _lr_published_rows()
    ref = _reference_dense_logistic(X, y, w, LR_ITERS, LR_LR)
    lr_err = float(np.abs(base["lr_coef"] - ref).max())
    # KMeans: every epoch of the width-1 deterministic program against float64
    dev = torch.device("cuda", 0)
    pts = _kmeans_published_rows()
    X32 = torch.from_numpy(pts.astype(np.float32)).to(dev)
    pick = np.random.default_rng(KMeans().get_seed()).choice(KMEANS_ROWS, size=KMEANS_K, replace=False)
    final, km_readings, km_ok = _kmeans_epoch_check(X32, X32[torch.from_numpy(pick).to(dev)], "euclidean",
                                                    KMEANS_ITERS, sharded=True)
    km_replayed = np.array_equal(final.cpu().numpy().astype(np.float64), base["kmeans_centroids"])
    del X32
    # sparse: each width against float64 of its own schedule
    idx, ys = _headline_data()
    sparse = {}
    for world in SHARDED_WIDTHS:
        ref_coef, ref_losses = _reference_sgd(idx, np.ones(idx.shape), ys, TRAIN_DIM, n_data=world)
        sparse[world] = {"max_abs_err": float(np.abs(worlds[world][0]["arrays"]["sparse_coef"] - ref_coef).max()),
                         "loss_max_rel": float(np.max(np.abs(np.asarray(worlds[world][0]["sparse"]["losses"])
                                                             - ref_losses) / np.abs(ref_losses)))}
    # MLP at width 2 against float64 of the width-2 schedule
    mlp = worlds[SHARDED_MLP_WIDTH][0]["mlp"]
    Xm, ym = _mlp_sharded_rows()
    ref_losses, _ = _reference_mlp_fit(Xm, np.searchsorted(np.unique(ym), ym), list(MLP_WIDTHS), mlp["seed"],
                                       mlp["lr"], MLP_BATCH, MLP_ITERS, torch.float64, dev,
                                       n_data=SHARDED_MLP_WIDTH)
    mlp_rel = np.abs(np.asarray(mlp["losses"]) - ref_losses) / np.abs(ref_losses)
    # the checkpointed fit and its snapshot at width 4
    ck = worlds[SHARDED_CKPT_WIDTH][0]
    step, state = ShardedCheckpointManager(os.path.join(out_dir, "ckpt", "killed")).restore_latest()
    restored = worlds[SHARDED_RESTORE_WIDTH]

    # the per-row products the deterministic tier does not take: do cuBLAS's
    # bits for a row change with the row count? (a reading)
    Xd = torch.from_numpy(X.astype(np.float32)).to(dev)
    coef = torch.from_numpy(base["lr_coef"]).to(dev)
    C = torch.from_numpy(base["kmeans_centroids"].astype(np.float32)).to(dev)
    full, full_c = Xd @ coef, Xd @ C.T
    product_rows_differing = {
        str(rows): {"gemv": int((Xd[:rows] @ coef != full[:rows]).sum()),
                    "gemm_centroids": int((Xd[:rows] @ C.T != full_c[:rows]).any(dim=1).sum())}
        for rows in (LR_ROWS // 2, LR_ROWS // 4, 8)
    }
    del Xd, full, full_c

    launches = {}
    for world, ranks in worlds.items():
        for r in ranks:
            for name, n in r["sparse"]["launches"].items():
                launches[name] = launches.get(name, 0) + n
    result = {
        "widths": list(SHARDED_WIDTHS),
        "backends": {w: worlds[w][0]["backend"] for w in SHARDED_WIDTHS},
        "lr": {"max_abs_err_vs_float64": lr_err, "tolerance": SHARDED_COEF_TOL,
               "ms_per_epoch": {w: [r["lr"]["ms_per_epoch"] for r in worlds[w]] for w in SHARDED_WIDTHS}},
        "kmeans": {"epochs": km_readings, "replay_equals_fit": km_replayed,
                   "ms_per_epoch": {w: [r["kmeans"]["ms_per_epoch"] for r in worlds[w]] for w in SHARDED_WIDTHS}},
        "all_gather_ms": {w: worlds[w][0]["all_gather_ms"] for w in SHARDED_WIDTHS},
        "sparse": {w: dict(sparse[w], premat=worlds[w][0]["sparse"]["premat"],
                           launches_per_rank=[r["sparse"]["launches"] for r in worlds[w]],
                           plain_calls=[r["sparse"]["plain_calls"] for r in worlds[w]],
                           fit_s=[r["sparse"]["fit_s"] for r in worlds[w]],
                           layout_s=[r["sparse"]["layout_s"] for r in worlds[w]]) for w in SHARDED_WIDTHS},
        "mlp": {"width": SHARDED_MLP_WIDTH, "first_loss_rel": float(mlp_rel[0]), "loss_max_rel": float(mlp_rel.max()),
                "fit_s": [r["mlp"]["fit_s"] for r in worlds[SHARDED_MLP_WIDTH]]},
        "ckpt": dict(ck["ckpt"], resumed_equals_clean=bool(np.array_equal(ck["arrays"]["ckpt_resumed"],
                                                                           ck["arrays"]["ckpt_clean"])),
                     restored_at_4=[r["restored"] for r in restored]),
        "peak_bytes": {w: [{k: v for k, v in r.items() if k.endswith("_peak_bytes")} for r in worlds[w]]
                       for w in SHARDED_WIDTHS},
        "card_bytes": worlds[1][0]["card_bytes"],
        "product_rows_differing_from_the_full_batch": product_rows_differing,
        "seconds": time.perf_counter() - t_phase,
    }
    emit("sharded", card=card, **result)  # before the gates, so a failure shows its numbers
    check(lr_err <= SHARDED_COEF_TOL, f"dense LR off float64 by {lr_err}")
    check(km_ok and km_replayed, f"KMeans epochs off float64 or not the fit: {km_readings}")
    for world in SHARDED_WIDTHS:
        got = sparse[world]
        check(got["max_abs_err"] <= SHARDED_COEF_TOL, f"sparse fit at width {world} off float64: {got}")
        for r in worlds[world]:
            got = r["sparse"]["launches"]
            taken = sorted(n for n, c in got.items() if c)
            form = [O.DOT_CROSSING_PREMAT.name, O.MULT_CROSSING_PREMAT.name] if r["sparse"]["premat"] \
                else [O.DOT_CROSSING.name, O.MULT_CROSSING.name]
            check(taken == sorted(form) and all(got[n] == TRAIN_ITERS for n in taken)
                  and r["sparse"]["plain_calls"] == 0,
                  f"width {world} rank {r['rank']}: crossing launches {got}, plain calls {r['sparse']['plain_calls']}")
    check(mlp_rel[0] <= FIT_FIRST_LOSS_RTOL and mlp_rel.max() <= FIT_LOSS_RTOL,
          f"MLP at width {SHARDED_MLP_WIDTH} off float64: {mlp_rel.tolist()}")
    check(result["ckpt"]["resumed_equals_clean"], "the resumed fit differs from the clean one")
    for r in restored:
        check(r["restored"]["step"] == step and np.array_equal(r["arrays"]["restored_coef"], state[0].numpy())
              and r["restored"]["offset"] == int(state[1]), f"width-4 restore of the snapshot differs: {r['restored']}")
    return launches, {w: worlds[w][0]["arrays"]["sparse_coef"] for w in SHARDED_WIDTHS}


def _model_parallel_rank(rank, world, init, out_dir, ckpt_dir):
    """One rank of a model_parallel world (gloo, the ranks sharing the one
    card): train.mesh world / MP_MODEL × MP_MODEL, then the headline
    wide-sparse fit in both one-hot forms on model-local stacks, the dense
    and scatter fits (1 × 2) or a checkpointed dense fit (2 × 2), the
    sequence-sharded SelfAttentionClassifier and expert-parallel MoE. Writes
    its readings (JSON) and arrays (npz) to ``out_dir``; rank 0 keeps the
    inputs and outputs of its kernels' launches for the parent's checks."""
    import datetime
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        import flink_ml_tpu_torch.linalg.onehot_sparse as O
        import flink_ml_tpu_torch.parallel.flash as flash_mod
        import flink_ml_tpu_torch.parallel.ring as ring_mod
        from flink_ml_tpu_torch.api.dataframe import DataFrame
        from flink_ml_tpu_torch.checkpoint import ShardedCheckpointManager
        from flink_ml_tpu_torch.config import Options, config
        from flink_ml_tpu_torch.iteration.datacache import DeviceDataCache
        from flink_ml_tpu_torch.models.classification import attention_classifier as attn
        from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegression
        from flink_ml_tpu_torch.native import KERNELS
        from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss, LeastSquareLoss
        from flink_ml_tpu_torch.ops.optimizer import SGD
        from flink_ml_tpu_torch.parallel.mesh import MeshContext
        from flink_ml_tpu_torch.parallel.moe import moe_ffn_sharded, route_top1
        from flink_ml_tpu_torch.parallel.train_sharding import resolve_train_sharding

        torch.backends.cuda.matmul.allow_tf32 = False
        n_data = world // MP_MODEL
        config.set(Options.TRAIN_MESH, n_data)
        config.set(Options.TRAIN_MESH_MODEL, MP_MODEL)
        ts = resolve_train_sharding()
        ctx = ts.ctx
        readings = {"rank": rank, "data_index": ctx.data_index, "model_index": ctx.model_index,
                    "backend": ctx.backend, "host_staged": ctx.host_staged}
        arrays = {}
        keep = {}  # rank 0: the first launch of each wrapper, (args, out)

        def timed(fn):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        def launches():
            return {k.name: k.launches for k in KERNELS if k.launches}

        def first_launch(module, name):
            """Keep rank 0's first call of ``module.name`` (``_first_launch``)."""
            return _first_launch(module, name, keep, rank == 0)

        # --- tensor parallelism, sparse: the headline fit on model-local stacks
        idx, ys = _headline_data()
        cols = {"indices": idx.astype(np.int32), "values": np.ones(idx.shape, np.float32),
                "labels": ys.astype(np.float32), "weights": np.ones(ys.shape[0], np.float32)}
        cache = DeviceDataCache(cols, ctx=ctx)
        sparse = {}
        for form in ("on", "off"):
            torch.cuda.reset_peak_memory_stats()
            undo = [first_launch(O, n) for n in ("dot_crossing", "mult_crossing", "dot_crossing_premat",
                                                  "mult_crossing_premat")]
            calls, restore = _count_plain_calls()
            try:
                for k in KERNELS:
                    k.reset_launches()
                opt = SGD(max_iter=TRAIN_ITERS, learning_rate=TRAIN_LR, global_batch_size=TRAIN_BATCH, tol=0.0,
                          sparse_kernel="onehot", onehot_premat=form, sharding=ts)
                coef, fit_s = timed(lambda: opt.optimize(np.zeros(TRAIN_DIM, np.float32), cache,
                                                         BinaryLogisticLoss.INSTANCE))
                got = launches()
            finally:
                restore()
                for u in undo:
                    u()
            _, again_s = timed(lambda: SGD(max_iter=TRAIN_ITERS, learning_rate=TRAIN_LR,
                                           global_batch_size=TRAIN_BATCH, tol=0.0, sparse_kernel="onehot",
                                           onehot_premat=form,
                                           sharding=ts).optimize(np.zeros(TRAIN_DIM, np.float32), cache,
                                                                 BinaryLogisticLoss.INSTANCE))
            lay = cache._onehot_memo[1]
            arrays[f"sparse_{form}"] = coef
            sparse[form] = {"launches": got, "plain_calls": len(calls), "premat": opt.onehot_premat_active,
                            "fit_s": fit_s, "layout_s": opt.layout_seconds,
                            "ms_per_step": again_s / TRAIN_ITERS * 1e3,
                            "peak_bytes": torch.cuda.max_memory_allocated(),
                            "nblk": lay.nblk, "nblk_local": lay.nblk_local, "n_flat": lay.n_flat,
                            "losses": opt.loss_history}
        readings["sparse"] = sparse
        if rank == 0:
            readings["sparse_first_launch"] = _mp_check_crossings(keep)
        keep.clear()
        del cache
        torch.cuda.empty_cache()

        if n_data == 1:
            # --- dense TP at logisticregression-benchmark.json's config, 1 × 2
            X, y, w = _lr_published_rows()
            df = DataFrame.from_dict({"features": X, "label": y, "weight": w})
            model, fit_s = timed(lambda: LogisticRegression().set_weight_col("weight").set_max_iter(LR_ITERS)
                                 .set_global_batch_size(LR_BATCH).set_learning_rate(LR_LR).set_tol(LR_TOL).fit(df))
            arrays["lr_coef"] = model.coefficient
            readings["lr"] = {"fit_s": fit_s, "ms_per_epoch": fit_s / LR_ITERS * 1e3}
            # --- sparse scatter TP, 1 × 2
            for k in KERNELS:
                k.reset_launches()
            opt = SGD(max_iter=TRAIN_ITERS, learning_rate=TRAIN_LR, global_batch_size=TRAIN_BATCH, tol=0.0,
                      sparse_kernel="scatter", sharding=ts)
            arrays["scatter_coef"], fit_s = timed(lambda: opt.optimize(np.zeros(TRAIN_DIM, np.float32), cols,
                                                                       BinaryLogisticLoss.INSTANCE))
            readings["scatter"] = {"fit_s": fit_s, "launches": launches()}
            # --- the 2 × 2 world's snapshot, restored on this 1 × 2 mesh
            step, state = ShardedCheckpointManager(os.path.join(ckpt_dir, "tp")).restore_latest()
            arrays["restored_coef"] = np.asarray(state[0].cpu() if isinstance(state[0], torch.Tensor) else state[0])
            readings["restored"] = {"step": step}
        else:
            # --- a checkpointed dense TP fit, 2 × 2: the model-sharded coefficient snapshotted
            Xc, yc = _dense_ckpt_rows()
            mgr = ShardedCheckpointManager(os.path.join(ckpt_dir, "tp"), sharding=ts)
            coef, fit_s = timed(lambda: SGD(max_iter=SHARDED_CKPT_ITERS, learning_rate=CKPT_DENSE_LR,
                                            global_batch_size=SHARDED_CKPT_BATCH, tol=0.0, sharding=ts,
                                            checkpoint_manager=mgr, checkpoint_interval=CKPT_INTERVAL).optimize(
                np.zeros(CKPT_DENSE_D, np.float32), {"features": Xc, "labels": yc}, LeastSquareLoss.INSTANCE))
            arrays["ckpt_coef"] = coef
            readings["ckpt"] = {"steps": mgr.all_steps(), "fit_s": fit_s}
        del cols, idx, ys
        torch.cuda.empty_cache()

        # --- sequence parallelism: the classifier with its sequence split over the world
        seq = MeshContext(device="cuda")
        tok, y = _attention_documents(FIT_ATTN_DOCS, FIT_ATTN_TOKEN_SEED)
        df = DataFrame.from_dict({"features": tok.astype(np.float64), "label": y})

        def estimator(iters):
            return (attn.SelfAttentionClassifier().set_embedding_dim(ATTN_E).set_num_heads(ATTN_H)
                    .set_vocab_size(ATTN_VOCAB).set_global_batch_size(FIT_ATTN_BATCH)
                    .set_learning_rate(FIT_ATTN_LR).set_max_iter(iters).set_seed(ATTN_PARAM_SEED))

        estimator(1).fit(df)  # warm
        real = {"fold": ring_mod.fused_fold, "dq": flash_mod.fold_bwd_dq, "dkv": flash_mod.fold_bwd_dkv,
                "exchange": ring_mod._exchange}
        captured = {"fold": [], "dq": [], "dkv": []}
        exchange_s = [0.0, 0]

        def kept(kind):
            def run(*args):
                out = real[kind](*args)
                if rank == 0:
                    captured[kind].append(([a.detach() if isinstance(a, torch.Tensor) else a for a in args],
                                           tuple(o.detach() for o in out)))
                return out
            return run

        def exchange(*args):
            t0 = time.perf_counter()
            out = real["exchange"](*args)
            exchange_s[0] += time.perf_counter() - t0
            exchange_s[1] += 1
            return out

        for k in KERNELS:
            k.reset_launches()
        plain_calls, restore = _count_calls(flash_mod, ("reference_fold", "reference_fold_bwd"))
        ring_mod.fused_fold, flash_mod.fold_bwd_dq, flash_mod.fold_bwd_dkv = kept("fold"), kept("dq"), kept("dkv")
        ring_mod._exchange = exchange
        try:
            est = estimator(FIT_ATTN_ITERS)
            model, fit_s = timed(lambda: est.fit(df))
            attn_launches = launches()
        finally:
            ring_mod.fused_fold, flash_mod.fold_bwd_dq, flash_mod.fold_bwd_dkv = real["fold"], real["dq"], real["dkv"]
            ring_mod._exchange = real["exchange"]
            restore()
        if rank == 0:
            readings["attention_checks"] = _mp_check_flash(captured, world)
        captured.clear()
        torch.cuda.empty_cache()
        walls = {it: timed(lambda: estimator(it).fit(df))[1] for it in MP_ATTN_STEP_ITERS}
        lo_it, hi_it = MP_ATTN_STEP_ITERS
        # step 1's loss and gradients, summed over the world
        y_idx = np.searchsorted(model.labels, y)
        init = attn._init_params(np.random.default_rng(ATTN_PARAM_SEED), ATTN_VOCAB, ATTN_E, ATTN_CLASSES)
        params32 = {n: torch.from_numpy(a).to(seq.device) for n, a in init.items()}
        t_loc = FIT_ATTN_T // world
        tok_w = torch.from_numpy(tok[:FIT_ATTN_BATCH, seq.rank * t_loc:(seq.rank + 1) * t_loc]).to(seq.device).long()
        loss1, grads1 = attn._loss_and_grads(params32, tok_w, torch.from_numpy(y_idx[:FIT_ATTN_BATCH]).to(seq.device),
                                             torch.ones(FIT_ATTN_BATCH, device=seq.device), FIT_ATTN_T, ATTN_H, seq)
        arrays.update({f"attn_grad_{n}": g.cpu().numpy() for n, g in grads1.items()})
        held, _held_y = _attention_documents(FIT_ATTN_HELD, FIT_ATTN_TOKEN_SEED + 1)
        out = model.transform(DataFrame.from_dict({"features": held.astype(np.float64)}))
        arrays["attn_probs"] = np.asarray(out.column("rawPrediction"))
        arrays.update({f"attn_param_{n}": a for n, a in model.params.items()})
        readings["attention"] = {
            "launches": attn_launches, "plain_calls": len(plain_calls), "fit_s": fit_s,
            "losses": est.loss_history, "step1_loss": float(loss1),
            "ms_per_step": (walls[hi_it] - walls[lo_it]) / (hi_it - lo_it) * 1e3,
            "rotations": exchange_s[1], "rotation_ms_per_step": exchange_s[0] / FIT_ATTN_ITERS * 1e3,
            "peak_bytes": torch.cuda.max_memory_allocated()}
        del params32, grads1
        torch.cuda.empty_cache()

        # --- expert parallelism: moe_ffn_sharded over two all-to-alls
        rng = np.random.default_rng(MOE_SEED)
        x = rng.standard_normal((MOE_T, MOE_D)).astype(np.float32)
        router = rng.standard_normal((MOE_D, MOE_E)).astype(np.float32)
        w1 = (rng.standard_normal((MOE_E, MOE_D, MOE_H)) / np.sqrt(MOE_D)).astype(np.float32)
        w2 = (rng.standard_normal((MOE_E, MOE_H, MOE_D)) / np.sqrt(MOE_H)).astype(np.float32)
        moe = {}
        t = MOE_T // world
        for cap in (int(MOE_CAPACITY_FACTOR * MOE_T / MOE_E), MOE_SMALL_CAPACITY):
            got, moe_s = timed(lambda: moe_ffn_sharded(x, router, w1, w2, cap, ctx=seq))
            _, moe_again = timed(lambda: moe_ffn_sharded(x, router, w1, w2, cap, ctx=seq))
            xs = torch.from_numpy(x[seq.rank * t:(seq.rank + 1) * t]).to(seq.device)
            expert = route_top1(xs, torch.from_numpy(router).to(seq.device), cap)[0]
            out = got.cpu().numpy()
            kept_mask = np.any(out != 0, axis=1)  # the timed call's own: a dropped token's row is exactly 0
            arrays[f"moe_out_{cap}"] = out
            arrays[f"moe_expert_{cap}"] = expert.cpu().numpy()
            arrays[f"moe_keep_{cap}"] = kept_mask
            moe[cap] = {"first_s": moe_s, "ms": moe_again * 1e3, "dropped": int((~kept_mask).sum())}
        readings["moe"] = moe

        np.savez(os.path.join(out_dir, f"mp_w{world}_r{rank}.npz"), **arrays)
        with open(os.path.join(out_dir, f"mp_w{world}_r{rank}.json"), "w") as f:
            json.dump(readings, f)
    finally:
        dist.destroy_process_group()


def _first_launch(module, name, keep, take=True):
    """Keep the first call of ``module.name`` in ``keep`` (when ``take``):
    its arguments (the premat one-hot stacks left out: the build form's row
    ids rebuild a unit's) and its output. Returns the undo."""
    import torch

    real = getattr(module, name)

    def kept(*args):
        out = real(*args)
        if take and name not in keep:
            small = args[:1] + args[3:] if "premat" in name else args
            keep[name] = ([a.clone() if isinstance(a, torch.Tensor) else
                           tuple(x.clone() for x in a) if isinstance(a, tuple) else a for a in small],
                          out.clone())
        return out
    setattr(module, name, kept)
    return lambda: setattr(module, name, real)


def _mp_check_crossings(keep, where="model_parallel"):
    """The first launch of each crossing (``keep``: name -> (args, output);
    rank 0's, on model-local stacks in ``model_parallel``): the premat forms
    bit-equal to the build forms on the same q and multiplier, and the four
    kernels held against their plain versions on the build form's unit
    (``_check_crossings``)."""
    import torch

    import flink_ml_tpu_torch.linalg.onehot_sparse as O

    (q, rowid, row_hi, order), dot_b = keep["dot_crossing"]
    (m3, _rowid), mult_b = keep["mult_crossing"]
    (q_p, _wi), dot_p = keep["dot_crossing_premat"]
    (m3_p, _wi), mult_p = keep["mult_crossing_premat"]
    if not (torch.equal(q, q_p) and torch.equal(dot_b, dot_p)):
        raise AssertionError(f"{where}: the first premat and build-form dots differ")
    if not (torch.equal(m3, m3_p) and torch.equal(mult_p[:, :q.shape[1]], mult_b)):
        raise AssertionError(f"{where}: the first premat and build-form mults differ")
    if not torch.equal(dot_b, O.dot_crossing(q, rowid, row_hi, order)):
        raise AssertionError(f"{where}: the build-form dot is not repeatable")
    errs = _check_crossings(q, rowid, m3, row_hi, order, O.premat_row_onehots(rowid, row_hi),
                            f"{where} first launch")
    return {"max_abs_err": errs, "n_sub": int(q.shape[0]), "n_flat_local": int(q.shape[1]), "row_hi": int(row_hi)}


def _mp_check_flash(captured, world):
    """Every fold, dq and dkv launch rank 0 made in the sequence-sharded fit
    against ``reference_fold`` / ``reference_fold_bwd``, a document at a
    time (``_check_flash``, ``_check_flash_bwd``)."""
    import torch

    from flink_ml_tpu_torch.parallel import reference_fold, reference_fold_bwd

    dev = torch.device("cuda", 0)
    n_calls = {k: len(v) for k, v in captured.items()}
    if n_calls != {k: FIT_ATTN_ITERS * world for k in captured}:
        raise AssertionError(f"rank 0 launched {n_calls}, expected {world} of each a step")
    fold_err, bwd_errs = 0.0, {n: 0.0 for n in FLASH_BWD_NAMES}
    with torch.no_grad():
        for f_args, f_out in captured["fold"]:
            tensors, (q_pos0, k_pos0, causal, n_valid, scale) = f_args[:6], f_args[6:]
            Tq, Tk = tensors[0].shape[2], tensors[1].shape[2]
            if Tq != FIT_ATTN_T // world:
                raise AssertionError(f"the fold ran at {tuple(tensors[0].shape)}")
            for i in range(FIT_ATTN_BATCH):
                ins = [x[i:i + 1] for x in tensors]
                want = reference_fold(*ins, q_pos0, k_pos0, causal, n_valid, scale)
                idle = _idle_rows(ATTN_H, Tq, Tk, q_pos0, k_pos0, causal, n_valid, dev)
                s_mag = scale * torch.einsum("bhqd,bhkd->bhqk", ins[0].abs(), ins[1].abs()).amax(-1)
                fold_err = max(fold_err, _check_flash([x[i:i + 1] for x in f_out], want, ins[3:], idle, s_mag,
                                                      f"model_parallel fold {q_pos0}/{k_pos0} doc {i}")[0])
        for (dq_args, dq_out), (dkv_args, dkv_out) in zip(captured["dq"], captured["dkv"]):
            if not (dkv_args[0] is dq_args[0] or torch.equal(dkv_args[0], dq_args[0])):
                raise AssertionError("the dkv kernel did not take the dq kernel's inputs")
            Tq, Tk = dq_args[0].shape[2], dq_args[1].shape[2]
            for i in range(FIT_ATTN_BATCH):
                doc_in = [x[i:i + 1] for x in dq_args[:6]]
                doc_cot = [x[i:i + 1] for x in dq_args[11:]]
                want = reference_fold_bwd(*doc_in, *dq_args[6:11], *doc_cot)
                got = (dq_out[0][i:i + 1], dkv_out[0][i:i + 1], dkv_out[1][i:i + 1],
                       *(x[i:i + 1] for x in dq_out[1:4]))
                idle = _idle_rows(ATTN_H, Tq, Tk, *dq_args[6:10], dev)
                unattended = _unattended_keys(ATTN_H, Tq, Tk, *dq_args[6:10], dev)
                errs, _, _ = _check_flash_bwd(got, want, doc_in[3], idle, unattended,
                                              f"model_parallel bwd {dq_args[6]}/{dq_args[7]} doc {i}")
                for n, e in errs.items():
                    bwd_errs[n] = max(bwd_errs[n], e)
    # from the second fold of a step on, the incoming state carries gradient
    nonzero = sum(int(bool(out[1].abs().max() > 0 or out[2].abs().max() > 0)) for _a, out in captured["dq"])
    return {"fold_max_abs_err_vs_plain": fold_err, "bwd_max_abs_err_vs_plain": bwd_errs,
            "bwd_rtol": FLASH_BWD_RTOL, "dq_calls_with_nonzero_dm_dl_in": nonzero, "launches_held": n_calls}


def _moe_dense(x, router, w1, w2, capacity, world, dev):
    """The dense one-rank computation of top-1 routing on ``world`` ranks,
    written apart from the port's ``route_top1``: each rank's tokens go to
    their argmax expert with its softmax gate, each expert keeps the first
    ``capacity`` of a rank's tokens in token order, and its kept tokens go
    through its FFN as one product pair, scaled by the gate. Returns (out,
    expert, keep) over every token."""
    import torch

    X = torch.from_numpy(x).to(dev)
    R, W1, W2 = (torch.from_numpy(a).to(dev) for a in (router, w1, w2))
    t = X.shape[0] // world
    out, experts, keeps = torch.zeros_like(X), [], []
    for r in range(world):
        xs = X[r * t:(r + 1) * t]
        probs = torch.softmax(xs @ R, dim=-1)
        expert = torch.argmax(probs, dim=-1)
        gate = probs[torch.arange(t, device=dev), expert]
        keep = torch.zeros(t, dtype=torch.bool, device=dev)
        for e in range(W1.shape[0]):
            sel = torch.nonzero(expert == e)[:capacity, 0]
            keep[sel] = True
            if sel.numel():
                h = torch.relu(xs[sel] @ W1[e])
                out[r * t + sel] = (h @ W2[e]) * gate[sel, None]
        experts.append(expert)
        keeps.append(keep)
    return out.cpu().numpy(), torch.cat(experts).cpu().numpy(), torch.cat(keeps).cpu().numpy()


def phase_model_parallel(card: str, sparse_dp):
    """Tensor, sequence and expert parallelism on gloo worlds sharing the
    card (module docstring, phase 33). ``sparse_dp``: phase_sharded's
    headline sparse coefficients by width (n_model 1). Returns the
    launches of every kernel over every rank of both worlds."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import flink_ml_tpu_torch.linalg.onehot_sparse as O
    from flink_ml_tpu_torch.checkpoint import ShardedCheckpointManager
    from flink_ml_tpu_torch.models.classification import attention_classifier as attn
    from flink_ml_tpu_torch.parallel import FLASH_FOLD, FLASH_FOLD_BWD_DKV, FLASH_FOLD_BWD_DQ, reference_fold, \
        reference_fold_bwd

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="model-parallel-")
    ckpt_dir = os.path.join(out_dir, "ckpt")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    worlds = {}
    for world in MP_WORLDS:  # the 2 × 2 world first: it writes the snapshot the 1 × 2 world restores
        t0 = time.perf_counter()
        mp.start_processes(_model_parallel_rank, args=(world, f"file://{out_dir}/init_w{world}", out_dir, ckpt_dir),
                           nprocs=world, join=True, start_method="spawn")
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"mp_w{world}_r{r}.json")) as f:
                got = json.load(f)
            with np.load(os.path.join(out_dir, f"mp_w{world}_r{r}.npz")) as z:
                got["arrays"] = {k: z[k] for k in z.files}
            ranks.append(got)
        worlds[world] = ranks
        emit("model_parallel", card=card, world=world, mesh=[world // MP_MODEL, MP_MODEL],
             seconds=time.perf_counter() - t0,
             ranks=[{k: v for k, v in got.items() if k not in ("arrays", "sparse", "attention")}
                    | {"sparse": {f: {k: v for k, v in s.items() if k != "losses"} for f, s in got["sparse"].items()},
                       "attention": {k: v for k, v in got["attention"].items() if k != "losses"}} for got in ranks])

    def check(ok, what):
        if not ok:
            raise AssertionError(what)

    idx, ys = _headline_data()
    result = {"worlds": list(MP_WORLDS), "model_axis": MP_MODEL, "sparse": {}, "attention": {}, "moe": {}}
    for world, ranks in worlds.items():
        n_data = world // MP_MODEL
        for got in ranks[1:]:
            for name, a in ranks[0]["arrays"].items():
                if not name.startswith(("moe_", "attn_grad_")):  # a rank's own tokens, or summed already
                    check(np.array_equal(a, got["arrays"][name]), f"world {world}: rank {got['rank']}'s {name} differs")
        # TP sparse: float64 of the n_data schedule, the n_model 1 fit, launches on model-local stacks
        ref, _ = _reference_sgd(idx, np.ones(idx.shape), ys, TRAIN_DIM, n_data=n_data)
        a0 = ranks[0]["arrays"]
        forms = {}
        for form in ("on", "off"):
            coef = a0[f"sparse_{form}"]
            dp = sparse_dp[n_data]
            forms[form] = {"max_abs_err_vs_float64": float(np.abs(coef - ref).max()),
                           "max_abs_diff_vs_n_model_1": float(np.abs(coef - dp).max()),
                           "within_jax_invariance_bound": bool(np.allclose(coef, dp, rtol=MP_INV_RTOL,
                                                                           atol=MP_INV_ATOL)),
                           "per_rank": [r["sparse"][form] | {"losses": None} for r in ranks]}
        check(np.array_equal(a0["sparse_on"], a0["sparse_off"]), f"world {world}: premat and build fits differ")
        result["sparse"][world] = forms
        result["sparse"][world]["first_launch"] = ranks[0]["sparse_first_launch"]
        for r in ranks:
            for form, want in (("on", (O.DOT_CROSSING_PREMAT.name, O.MULT_CROSSING_PREMAT.name)),
                               ("off", (O.DOT_CROSSING.name, O.MULT_CROSSING.name))):
                got = r["sparse"][form]
                check(got["launches"] == {n: TRAIN_ITERS for n in want} and got["plain_calls"] == 0,
                      f"world {world} rank {r['rank']} {form}: launches {got['launches']}, plain {got['plain_calls']}")
                check(got["nblk_local"] < got["nblk"], f"world {world}: the stacks are not model-local: {got}")
        for r in ranks:
            got = r["attention"]
            check(got["launches"] == {FLASH_FOLD.name: FIT_ATTN_ITERS * world,
                                      FLASH_FOLD_BWD_DQ.name: FIT_ATTN_ITERS * world,
                                      FLASH_FOLD_BWD_DKV.name: FIT_ATTN_ITERS * world}
                  and got["plain_calls"] == 0, f"world {world} rank {r['rank']}: attention launches {got}")
            check(got["rotations"] == 2 * (world - 1) * FIT_ATTN_ITERS,
                  f"world {world}: {got['rotations']} rotations in {FIT_ATTN_ITERS} steps")
        result["attention"][world] = {**ranks[0]["attention_checks"],
                                      "ms_per_step": [r["attention"]["ms_per_step"] for r in ranks],
                                      "rotation_ms_per_step": [r["attention"]["rotation_ms_per_step"] for r in ranks],
                                      "fit_s": [r["attention"]["fit_s"] for r in ranks],
                                      "peak_bytes": [r["attention"]["peak_bytes"] for r in ranks],
                                      "losses": ranks[0]["attention"]["losses"]}
        # MoE against the dense computation of the same routing
        rng = np.random.default_rng(MOE_SEED)
        x = rng.standard_normal((MOE_T, MOE_D)).astype(np.float32)
        router = rng.standard_normal((MOE_D, MOE_E)).astype(np.float32)
        w1 = (rng.standard_normal((MOE_E, MOE_D, MOE_H)) / np.sqrt(MOE_D)).astype(np.float32)
        w2 = (rng.standard_normal((MOE_E, MOE_H, MOE_D)) / np.sqrt(MOE_H)).astype(np.float32)
        for cap in (int(MOE_CAPACITY_FACTOR * MOE_T / MOE_E), MOE_SMALL_CAPACITY):
            want, expert, keep = _moe_dense(x, router, w1, w2, cap, world, dev)
            got = np.concatenate([r["arrays"][f"moe_out_{cap}"] for r in ranks])
            check(np.array_equal(np.concatenate([r["arrays"][f"moe_expert_{cap}"] for r in ranks]), expert)
                  and np.array_equal(np.concatenate([r["arrays"][f"moe_keep_{cap}"] for r in ranks]), keep),
                  f"world {world} capacity {cap}: the routing differs")
            err = float(np.abs(got - want).max())
            dropped = ~keep
            result["moe"].setdefault(world, {})[cap] = {
                "max_abs_err": err, "dropped": int(dropped.sum()), "dropped_rows_zero": bool(np.all(got[dropped] == 0)),
                "ms": [r["moe"][str(cap)]["ms"] for r in ranks]}
            check(err <= MOE_ATOL, f"world {world} capacity {cap}: moe off the dense computation by {err}")
            check(np.all(got[dropped] == 0), f"world {world} capacity {cap}: a dropped token's row is not 0")
        check(result["moe"][world][MOE_SMALL_CAPACITY]["dropped"] > 0, "the small capacity dropped no token")

    # the classifier: step 1 and the fitted model, against world 1 and float64
    tok, y = _attention_documents(FIT_ATTN_DOCS, FIT_ATTN_TOKEN_SEED)
    y_idx = np.searchsorted(np.unique(y), y)
    init = attn._init_params(np.random.default_rng(ATTN_PARAM_SEED), ATTN_VOCAB, ATTN_E, ATTN_CLASSES)
    params32 = {n: torch.from_numpy(a).to(dev) for n, a in init.items()}
    loss1, grads1 = attn._loss_and_grads(params32, torch.from_numpy(tok[:FIT_ATTN_BATCH]).to(dev).long(),
                                         torch.from_numpy(y_idx[:FIT_ATTN_BATCH]).to(dev),
                                         torch.ones(FIT_ATTN_BATCH, device=dev), FIT_ATTN_T, ATTN_H)
    held, _ = _attention_documents(FIT_ATTN_HELD, FIT_ATTN_TOKEN_SEED + 1)
    for world, ranks in worlds.items():
        a0 = ranks[0]["arrays"]
        loss_rel = abs(ranks[0]["attention"]["step1_loss"] - float(loss1)) / abs(float(loss1))
        grad_rel = max(float(np.abs(a0[f"attn_grad_{n}"] - g.cpu().numpy()).max() / g.abs().max()) for n, g in grads1.items())
        fitted64 = {n[len("attn_param_"):]: torch.from_numpy(a.astype(np.float64)).to(dev)
                    for n, a in a0.items() if n.startswith("attn_param_")}
        prob_err = 0.0
        with torch.no_grad():
            for i in range(FIT_ATTN_HELD):
                want = torch.softmax(_attention_float64(fitted64, torch.from_numpy(held[i]).to(dev), ATTN_H)[0],
                                     dim=-1).cpu().numpy()
                prob_err = max(prob_err, float(np.abs(a0["attn_probs"][i] - want).max()))
        result["attention"][world].update({"step1_loss_rel_vs_world_1": loss_rel, "loss_rtol": FIT_ATTN_LOSS_RTOL,
                                           "step1_grad_rel_vs_world_1": grad_rel, "grad_rtol": FIT_ATTN_GRAD_RTOL,
                                           "served_max_prob_err_vs_float64": prob_err,
                                           "prob_atol": FIT_ATTN_PROB_ATOL})
    # dense TP, scatter TP and the snapshot
    one = next(r for w, r in worlds.items() if w // MP_MODEL == 1)
    X, y_lr, w_lr = _lr_published_rows()
    lr_err = float(np.abs(one[0]["arrays"]["lr_coef"] - _reference_dense_logistic(X, y_lr, w_lr, LR_ITERS, LR_LR)).max())
    ref1, _ = _reference_sgd(idx, np.ones(idx.shape), ys, TRAIN_DIM, n_data=1)
    scatter_err = float(np.abs(one[0]["arrays"]["scatter_coef"] - ref1).max())
    two = next(r for w, r in worlds.items() if w // MP_MODEL == 2)
    step, state = ShardedCheckpointManager(os.path.join(ckpt_dir, "tp")).restore_latest()
    snap = np.asarray(state[0])
    result.update({
        "dense_lr": {"mesh": [1, MP_MODEL], "max_abs_err_vs_float64": lr_err, "tolerance": SHARDED_COEF_TOL,
                     "ms_per_epoch": [r["lr"]["ms_per_epoch"] for r in one]},
        "scatter": {"mesh": [1, MP_MODEL], "max_abs_err_vs_float64": scatter_err,
                    "fit_s": [r["scatter"]["fit_s"] for r in one], "launches": one[0]["scatter"]["launches"]},
        "snapshot": {"saved_on": [2, MP_MODEL], "restored_on": [1, MP_MODEL], "step": step,
                     "steps": two[0]["ckpt"]["steps"], "padded_len": int(snap.shape[0]),
                     "restored_equal": bool(np.array_equal(one[0]["arrays"]["restored_coef"], snap))},
        "seconds": time.perf_counter() - t_phase,
    })
    emit("model_parallel", card=card, **result)  # before the gates, so a failure shows its numbers
    for world in MP_WORLDS:
        for form, got in result["sparse"][world].items():
            if form not in ("on", "off"):
                continue
            check(got["max_abs_err_vs_float64"] <= SHARDED_COEF_TOL, f"TP sparse {form} at world {world}: {got}")
            check(got["within_jax_invariance_bound"], f"TP sparse {form} at world {world} off the n_model 1 fit")
        att = result["attention"][world]
        check(att["step1_loss_rel_vs_world_1"] <= FIT_ATTN_LOSS_RTOL, f"world {world} step-1 loss: {att}")
        check(att["step1_grad_rel_vs_world_1"] <= FIT_ATTN_GRAD_RTOL, f"world {world} step-1 gradients: {att}")
        check(att["served_max_prob_err_vs_float64"] <= FIT_ATTN_PROB_ATOL, f"world {world} probabilities: {att}")
        check(att["dq_calls_with_nonzero_dm_dl_in"] >= (world - 1) * FIT_ATTN_ITERS,
              f"world {world}: the chained folds carried no gradient back: {att}")
    check(lr_err <= SHARDED_COEF_TOL, f"dense TP LR off float64 by {lr_err}")
    check(scatter_err <= SHARDED_COEF_TOL, f"scatter TP off float64 by {scatter_err}")
    check(result["snapshot"]["restored_equal"] and snap.shape[0] % MP_MODEL == 0, "the TP snapshot did not restore")
    launches = {}
    for ranks in worlds.values():
        for r in ranks:
            for got in list(r["sparse"].values()) + [r["attention"]]:
                for name, n in got["launches"].items():
                    launches[name] = launches.get(name, 0) + n
    return launches


def _stream_cache(cache, idx, y, chunk_rows=STREAM_CHUNK_ROWS):
    """``cache`` filled with the headline rows ``idx``/``y`` (value 1.0) in
    ``chunk_rows``-row chunks, then finished."""
    import numpy as np

    ones = np.ones((chunk_rows, idx.shape[1]), np.float32)
    for a in range(0, len(y), chunk_rows):
        b = min(a + chunk_rows, len(y))
        cache.append({"indices": idx[a:b], "values": ones[:b - a], "labels": y[a:b].astype(np.float32)})
    cache.finish()
    return cache


def _kmeans_cache(X32, budget=None, spill_dir=None):
    """A ``HostDataCache`` of the KMeans rows in STREAM_KMEANS_CHUNK-row chunks."""
    from flink_ml_tpu_torch.iteration import HostDataCache

    cache = HostDataCache(budget, spill_dir)
    for a in range(0, len(X32), STREAM_KMEANS_CHUNK):
        cache.append({"features": X32[a:a + STREAM_KMEANS_CHUNK]})
    cache.finish()
    return cache


def _stream_readings(opt, seconds, peak):
    """A streamed fit's readings: ms per epoch of its window loop, each
    window load's host ms and its parts' (the cache's ``rows``, the host
    fill, the upload call), each run's device ms (CUDA events), the device's
    idle share over the loop, and the peak device memory beside two
    windows' forecast."""
    st = opt.stream_stats
    loop_ms = st["loop_s"] * 1e3
    busy = sum(st["run_ms"])
    out = {"fit_s": seconds, "plan_s": st["plan_s"], "loop_s": st["loop_s"], "runs": st["runs"],
           "ms_per_epoch": loop_ms / max(1, len(opt.loss_history)),
           "window_load_ms": [x * 1e3 for x in st["load_s"]],
           **{f"window_{part}_ms": [p[f"{part}_s"] * 1e3 for p in st["load_parts"]]
              for part in ("rows", "fill", "upload")},
           "run_device_ms": st["run_ms"],
           "idle_share": 1.0 - busy / loop_ms if loop_ms > 0 else None, "peak_bytes": peak}
    if "window_bytes" in st:
        out["two_windows_forecast_bytes"] = 2 * st["window_bytes"]
    return out


def _streamed_rank(rank, world, init, out_dir):
    """One rank of the streamed phase's gloo world on the card: train.mesh
    set to the world, the streamed one-hot fit and the resident fit of the
    same rows on the psum path, and KMeans.fit_stream on the deterministic
    tier; writes its readings (JSON) and arrays (npz) to ``out_dir``."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        import flink_ml_tpu_torch.linalg.onehot_sparse as O
        from flink_ml_tpu_torch.config import Options, config
        from flink_ml_tpu_torch.iteration import HostDataCache
        from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
        from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss
        from flink_ml_tpu_torch.ops.optimizer import SGD

        config.set(Options.TRAIN_MESH, world)
        crossings = (O.DOT_CROSSING, O.MULT_CROSSING, O.DOT_CROSSING_PREMAT, O.MULT_CROSSING_PREMAT)
        idx, y = _headline_data(STREAM_WORLD_ROWS)
        idx = idx.astype(np.int32)

        def sgd(**kw):
            return SGD(max_iter=TRAIN_ITERS, global_batch_size=TRAIN_BATCH, tol=0.0, learning_rate=TRAIN_LR,
                       sparse_kernel="onehot", **kw)

        for k in crossings:
            k.reset_launches()
        t0 = time.perf_counter()
        opt = sgd(stream_window_rows=STREAM_WORLD_WINDOW)
        coef = opt.optimize(np.zeros(TRAIN_DIM, np.float32), _stream_cache(HostDataCache(), idx, y),
                            BinaryLogisticLoss.INSTANCE)
        stream_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in crossings}
        resident = sgd().optimize(np.zeros(TRAIN_DIM, np.float32),
                                  {"indices": idx, "values": np.ones(idx.shape, np.float32),
                                   "labels": y.astype(np.float32)}, BinaryLogisticLoss.INSTANCE)
        kcache = _kmeans_cache(_kmeans_published_rows().astype(np.float32))
        t0 = time.perf_counter()
        km = KMeans().set_k(KMEANS_K).set_max_iter(KMEANS_ITERS).fit_stream(kcache, chunk_rows=STREAM_KMEANS_CHUNK)
        kmeans_s = time.perf_counter() - t0
        np.savez(os.path.join(out_dir, f"r{rank}.npz"), coef=coef, resident=resident,
                 losses=np.asarray(opt.loss_history), centroids=km.centroids, weights=km.weights)
        with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
            json.dump({"rank": rank, "launches": launches, "premat": opt.onehot_premat_active,
                       "stream_s": stream_s, "kmeans_s": kmeans_s,
                       "window_load_ms": [x * 1e3 for x in opt.stream_stats["load_s"]]}, f)
    finally:
        dist.destroy_process_group()


def phase_streamed(card: str):
    """Streamed fits out of a host-tier cache (module docstring, phase 34).
    Returns the crossing kernels' launches on the streamed path: the premat
    leg's premat pair and the build leg's build pair."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import flink_ml_tpu_torch.linalg.onehot_sparse as O
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.checkpoint import CheckpointManager
    from flink_ml_tpu_torch.config import Options, config
    from flink_ml_tpu_torch.device import resolve_device
    from flink_ml_tpu_torch.iteration import HostDataCache, create_capacity_cache
    from flink_ml_tpu_torch.models.classification.mlp_classifier import MLPClassifier
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans, _epoch_update
    from flink_ml_tpu_torch.native.cache import NativeDataCache
    from flink_ml_tpu_torch.ops.distance import DistanceMeasure
    from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss
    from flink_ml_tpu_torch.ops.optimizer import SGD

    def check(ok, what):
        if not ok:
            raise AssertionError(f"streamed: {what}")

    t_phase = time.perf_counter()
    dev = resolve_device()
    premat_k = (O.DOT_CROSSING_PREMAT, O.MULT_CROSSING_PREMAT)
    build_k = (O.DOT_CROSSING, O.MULT_CROSSING)
    tmp = tempfile.mkdtemp(prefix="streamed-")
    try:
        t0 = time.perf_counter()
        idx, y = _headline_data(STREAM_ROWS)
        idx = idx.astype(np.int32)
        data_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        native = _stream_cache(create_capacity_cache(STREAM_BUDGET, os.path.join(tmp, "native")), idx, y)
        check(isinstance(native, NativeDataCache), f"create_capacity_cache gave a {type(native).__name__}: "
              "the C++ chunk store did not build")
        host = _stream_cache(HostDataCache(STREAM_BUDGET, os.path.join(tmp, "host")), idx, y)
        fill_s = time.perf_counter() - t0
        check(native.spilled_chunks > 0 and any("files" in e for e in host._log), "no chunk spilled")

        keep = {}

        def sgd_fit(cache, form="auto", kernel="onehot", mgr=None):
            opt = SGD(max_iter=TRAIN_ITERS, global_batch_size=TRAIN_BATCH, tol=0.0, learning_rate=TRAIN_LR,
                      sparse_kernel=kernel, onehot_premat=form, stream_window_rows=STREAM_WINDOW_ROWS,
                      checkpoint_manager=mgr, checkpoint_interval=STREAM_CKPT_INTERVAL if mgr else 0)
            undo = [_first_launch(O, n, keep) for n in ("dot_crossing", "mult_crossing", "dot_crossing_premat",
                                                         "mult_crossing_premat")]
            calls, restore = _count_plain_calls()
            try:
                for k in premat_k + build_k:
                    k.reset_launches()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                coef = opt.optimize(np.zeros(TRAIN_DIM, np.float32), cache, BinaryLogisticLoss.INSTANCE)
                seconds = time.perf_counter() - t0
                launches = {k.name: k.launches for k in premat_k + build_k}
            finally:
                restore()
                for u in undo:
                    u()
            check(not calls, f"plain crossings were called on the card: {sorted(set(calls))}")
            return opt, coef, launches, _stream_readings(opt, seconds, torch.cuda.max_memory_allocated())

        legs = {}
        for name, cache, form, kernel, used in (("premat", native, "auto", "onehot", premat_k),
                                                ("build", native, "off", "onehot", build_k),
                                                ("scatter", host, "auto", "scatter", ())):
            opt, coef, launches, readings = sgd_fit(cache, form, kernel)
            check(opt.onehot_premat_active == (name == "premat"), f"{name} leg ran premat={opt.onehot_premat_active}")
            for k in premat_k + build_k:
                want = TRAIN_ITERS if k in used else 0
                check(launches[k.name] == want, f"{k.name} launched {launches[k.name]} times in the {name} leg, "
                      f"not {want}")
            legs[name] = {"coef": coef, "losses": opt.loss_history, "launches": launches, **readings}
            torch.cuda.empty_cache()
        path_launches = {**{k.name: legs["premat"]["launches"][k.name] for k in premat_k},
                         **{k.name: legs["build"]["launches"][k.name] for k in build_k}}
        first_launch = _mp_check_crossings(keep, "streamed")
        keep.clear()
        check(np.array_equal(legs["premat"]["coef"].view(np.int32), legs["build"]["coef"].view(np.int32)),
              "the premat and build coefficients are not bit-identical")

        ones = np.ones(idx.shape, np.float32)
        ref, ref_losses = _reference_sgd(idx, ones, y, TRAIN_DIM)
        control, _ = _reference_sgd(idx, ones, y, TRAIN_DIM, hi_only=True)
        scale = float(np.abs(ref).max())
        control_err = float(np.abs(control - ref).max())
        errs = {}
        for name, leg in legs.items():
            errs[name] = {"coef": float(np.abs(leg["coef"].astype(np.float64) - ref).max()),
                          "loss_rel": float(np.max(np.abs(np.asarray(leg["losses"]) - ref_losses)
                                                   / np.abs(ref_losses)))}
        emit("streamed", card=card, part="sgd", rows=STREAM_ROWS, chunk_rows=STREAM_CHUNK_ROWS,
             budget_bytes=STREAM_BUDGET, window_rows=STREAM_WINDOW_ROWS, data_s=data_s, fill_s=fill_s,
             spilled_chunks={"native": native.spilled_chunks, "host": sum("files" in e for e in host._log)},
             chunks=len(native._chunk_rows), legs={k: {kk: v for kk, v in leg.items() if kk not in ("coef", "losses")}
                                                    for k, leg in legs.items()},
             coef_scale=scale, coef_tol=COEF_TOL, max_abs_err_vs_f64=errs,
             hi_only_control_max_abs_err_vs_f64=control_err, first_launch=first_launch)
        for name, e in errs.items():
            check(e["coef"] <= COEF_TOL * scale, f"the {name} coefficient is off float64 by {e['coef']}")
            check(e["loss_rel"] <= 1e-5, f"the {name} losses are off float64 by {e['loss_rel']} (relative)")
        check(control_err > COEF_TOL * scale, f"the hi-half-only control is within the tolerance ({control_err})")

        # one window's rows out of each cache: the first window (chunks in
        # RAM and spilled) and the last (all spilled; the page cache warm)
        rows_ms = {}
        for name, cache in (("native", native), ("host", host)):
            for j in (0, STREAM_ROWS // STREAM_WINDOW_ROWS - 1):
                times = []
                for _ in range(STREAM_ROWS_REPS):
                    t0 = time.perf_counter()
                    got = cache.rows(j * STREAM_WINDOW_ROWS, (j + 1) * STREAM_WINDOW_ROWS)
                    times.append((time.perf_counter() - t0) * 1e3)
                check(np.array_equal(got["indices"], idx[j * STREAM_WINDOW_ROWS:(j + 1) * STREAM_WINDOW_ROWS]),
                      f"the {name} cache's window {j} rows differ from the appended ones")
                rows_ms[f"{name}_window{j}"] = times
        del got
        emit("streamed", card=card, part="rows", window_rows=STREAM_WINDOW_ROWS, reps=STREAM_ROWS_REPS,
             rows_ms=rows_ms, page_cache="warm")

        # a streamed one-hot fit killed after its newest snapshot and resumed
        ckpt = os.path.join(tmp, "ckpt")
        mgr = CheckpointManager(ckpt)
        clean_opt, clean, _, _ = sgd_fit(native, mgr=mgr)
        steps = mgr.all_steps()
        shutil.rmtree(os.path.join(ckpt, f"ckpt-{steps[-1]}"))
        opt, resumed, resumed_launches, resumed_readings = sgd_fit(native, mgr=CheckpointManager(ckpt))
        keep.clear()
        check(np.array_equal(clean.view(np.int32), legs["premat"]["coef"].view(np.int32)),
              "the checkpointed fit differs from the clean one")
        check(np.array_equal(resumed.view(np.int32), clean.view(np.int32)), "the resumed fit differs from the clean one")
        check(opt.loss_history == clean_opt.loss_history, "the resumed loss history differs from the clean one")
        emit("streamed", card=card, part="resume", steps=steps, resumed_from=steps[-2],
             resumed_runs=resumed_readings["runs"], resumed_launches=resumed_launches,
             resumed_fit_s=resumed_readings["fit_s"], resumed="bit-equal to the clean fit")
        del native, host, idx, y, ones, legs, ref, control
        torch.cuda.empty_cache()

        # KMeans.fit_stream at kmeans-benchmark.json from a spilled cache
        X = _kmeans_published_rows()
        X32 = X.astype(np.float32)
        kcache = _kmeans_cache(X32, STREAM_KMEANS_BUDGET, os.path.join(tmp, "kmeans"))
        check(any("files" in e for e in kcache._log), "no KMeans chunk spilled")

        def estimator():
            return KMeans().set_k(KMEANS_K).set_max_iter(KMEANS_ITERS)

        t0 = time.perf_counter()
        streamed = estimator().fit_stream(kcache, chunk_rows=STREAM_KMEANS_CHUNK)
        kmeans_s = time.perf_counter() - t0
        kdir = os.path.join(tmp, "kmeans_ckpt")
        kmgr = CheckpointManager(kdir, max_to_keep=0)  # every epoch's centroids
        again = estimator().fit_stream(kcache, chunk_rows=STREAM_KMEANS_CHUNK, checkpoint_manager=kmgr,
                                       checkpoint_interval=1)
        check(np.array_equal(again.centroids, streamed.centroids) and np.array_equal(again.weights, streamed.weights),
              "two streamed KMeans fits differ")
        check(streamed.weights.sum() == KMEANS_ROWS, f"weights sum {streamed.weights.sum()}")
        est = estimator()
        resident = est.fit(DataFrame.from_dict({"features": X}))
        m = DistanceMeasure.get_instance(est.get_distance_measure())
        Xd = torch.from_numpy(X32).to(dev)
        X64 = Xd.double()
        pick = np.random.default_rng(est.get_seed()).choice(KMEANS_ROWS, size=KMEANS_K, replace=False)
        path = [X32[pick]] + [np.asarray(kmgr.restore(s)[0], np.float32) for s in kmgr.all_steps()]
        epochs, ok, control_ok = [], True, True
        with torch.no_grad():
            for c_np, new_np in zip(path[:-1], path[1:]):
                c, new = torch.from_numpy(c_np).to(dev), torch.from_numpy(new_np).to(dev)
                assign = torch.cat([m.find_closest(Xd[a:a + STREAM_KMEANS_CHUNK], c)
                                    for a in range(0, KMEANS_ROWS, STREAM_KMEANS_CHUNK)])
                reading, epoch_ok = _kmeans_epoch_reading(X64, est.get_distance_measure(), c, assign, new)
                _, c_ok = _kmeans_epoch_reading(X64, est.get_distance_measure(), c, assign,
                                                new.to(torch.bfloat16).to(torch.float32))
                r_new, _ = _epoch_update(m, KMEANS_K, c, Xd, torch.ones_like(Xd[:, 0]))
                r_assign = m.find_closest(Xd, c)
                reading["assign_differs_from_fit"] = int((r_assign != assign).sum())
                reading["centroid_diff_from_fit"] = float((r_new - new).abs().max())
                ok = ok and epoch_ok and (reading["assign_differs_from_fit"] > 0
                                          or reading["centroid_diff_from_fit"] <= KMEANS_CENTROID_ATOL)
                control_ok = control_ok and c_ok
                epochs.append(reading)
        emit("streamed", card=card, part="kmeans", rows=KMEANS_ROWS, d=KMEANS_D, k=KMEANS_K,
             chunk_rows=STREAM_KMEANS_CHUNK, spilled_chunks=sum("files" in e for e in kcache._log),
             fit_s=kmeans_s, ms_per_epoch=kmeans_s / KMEANS_ITERS * 1e3, epochs=epochs,
             final_centroid_diff_from_fit=float(np.abs(streamed.centroids - resident.centroids).max()),
             weights_equal_fit=bool(np.array_equal(streamed.weights, resident.weights)),
             control="each epoch's centroids rounded to bfloat16")
        check(len(path) == KMEANS_ITERS + 1 and np.array_equal(path[-1].astype(np.float64), streamed.centroids),
              "the snapshots do not end on the fitted centroids")
        check(ok, "a streamed KMeans epoch is off float64 or off the resident epoch")
        check(not control_ok, "the bfloat16 centroid control passes the float64 check")
        del Xd, X64, kcache
        torch.cuda.empty_cache()

        # MLPClassifier.fit_stream at mlpclassifier-benchmark.json
        Xm, ym = _mlp_sharded_rows()

        def mlp_est():
            return (MLPClassifier().set_hidden_layers(*MLP_WIDTHS[1:-1]).set_max_iter(MLP_ITERS)
                    .set_global_batch_size(MLP_BATCH))

        est_r, est_s = mlp_est(), mlp_est()
        m_res = est_r.fit(DataFrame.from_dict({"features": Xm, "label": ym}))
        mcache = HostDataCache(STREAM_BUDGET, os.path.join(tmp, "mlp"))
        for a in range(0, len(ym), STREAM_MLP_WINDOW):
            mcache.append({"features": Xm[a:a + STREAM_MLP_WINDOW], "labels": ym[a:a + STREAM_MLP_WINDOW]})
        mcache.finish()
        t0 = time.perf_counter()
        m_st = est_s.fit_stream(mcache, window_rows=STREAM_MLP_WINDOW)
        mlp_s = time.perf_counter() - t0
        held = DataFrame.from_dict({"features": Xm[:MLP_HOLDOUT_ROWS]})
        p_res = np.asarray(m_res.transform(held).column("rawPrediction"))
        p_st = np.asarray(m_st.transform(held).column("rawPrediction"))
        rel = np.abs(np.asarray(est_s.loss_history) - est_r.loss_history) / np.abs(est_r.loss_history)
        bit_equal = all(np.array_equal(a, b) for la, lb in zip(m_st.params, m_res.params) for a, b in zip(la, lb))
        emit("streamed", card=card, part="mlp", rows=len(ym), widths=list(MLP_WIDTHS), batch=MLP_BATCH,
             window_rows=STREAM_MLP_WINDOW, fit_s=mlp_s, ms_per_epoch=mlp_s / MLP_ITERS * 1e3,
             first_loss_rel=float(rel[0]), loss_max_rel=float(rel.max()),
             prob_mean_abs=float(np.abs(p_st - p_res).mean()), params_bit_equal_to_fit=bit_equal)
        check(rel[0] <= FIT_FIRST_LOSS_RTOL and rel.max() <= FIT_LOSS_RTOL, f"MLP losses off the fit by {rel.max()}")
        check(float(np.abs(p_st - p_res).mean()) <= FIT_PROB_MEAN_ATOL, "MLP probabilities off the fit")

        # a gloo world of 2 on the card, at 2^18 rows
        config.set(Options.TRAIN_MESH, 1)
        try:
            width1 = estimator().fit_stream(_kmeans_cache(X32), chunk_rows=STREAM_KMEANS_CHUNK)
        finally:
            config.unset(Options.TRAIN_MESH)
        out_dir = os.path.join(tmp, "world")
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        mp.start_processes(_streamed_rank, args=(STREAM_WORLD, f"file://{out_dir}/init", out_dir),
                           nprocs=STREAM_WORLD, join=True, start_method="spawn")
        world_s = time.perf_counter() - t0
        ranks = []
        for r in range(STREAM_WORLD):
            with open(os.path.join(out_dir, f"r{r}.json")) as f:
                got = json.load(f)
            with np.load(os.path.join(out_dir, f"r{r}.npz")) as z:
                got["arrays"] = {k: z[k] for k in z.files}
            ranks.append(got)
        base = ranks[0]["arrays"]
        for got in ranks[1:]:
            for name, a in base.items():
                check(np.array_equal(a, got["arrays"][name]), f"rank {got['rank']}'s {name} differs from rank 0's")
        idx, y = _headline_data(STREAM_WORLD_ROWS)
        wref, _ = _reference_sgd(idx, np.ones(idx.shape), y, TRAIN_DIM, n_data=STREAM_WORLD)
        world_err = float(np.abs(base["coef"].astype(np.float64) - wref).max())
        emit("streamed", card=card, part="world", world=STREAM_WORLD, rows=STREAM_WORLD_ROWS,
             window_rows=STREAM_WORLD_WINDOW, seconds=world_s,
             ranks=[{k: v for k, v in got.items() if k != "arrays"} for got in ranks],
             coef_max_abs_err_vs_f64=world_err, coef_scale=float(np.abs(wref).max()),
             streamed_bit_equal_to_resident=bool(np.array_equal(base["coef"], base["resident"])),
             kmeans_bit_equal_to_width_1=bool(np.array_equal(base["centroids"], width1.centroids)
                                              and np.array_equal(base["weights"], width1.weights)))
        check(np.array_equal(base["coef"], base["resident"]),
              "the world's streamed fit is not bit-equal to its resident fit")
        check(world_err <= COEF_TOL * float(np.abs(wref).max()), f"the world's coefficient is off float64 by {world_err}")
        check(np.array_equal(base["centroids"], width1.centroids) and np.array_equal(base["weights"], width1.weights),
              "KMeans.fit_stream at width 2 is not bit-equal to width 1")
        for got in ranks:
            for k in premat_k + build_k:
                want = TRAIN_ITERS if (k in premat_k) == got["premat"] else 0
                check(got["launches"][k.name] == want, f"rank {got['rank']} launched {k.name} "
                      f"{got['launches'][k.name]} times, not {want}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("streamed", card=card, part="done", seconds=time.perf_counter() - t_phase)
    return path_launches


# ---------------------------------------------------------------------------
# 35. sharded_serving — the plan tiers on a shard grid (servable/sharding.py)
# ---------------------------------------------------------------------------


def _sharded_responses(server, payloads, column, n_clients=N_CLIENTS):
    """Closed-loop clients as ``_serve_and_check``, keeping each response:
    ``(responses, latencies ms, wall s, failures)``."""
    from flink_ml_tpu_torch.api.dataframe import DataFrame

    responses, latencies, failures = [None] * len(payloads), [None] * len(payloads), []

    def client(c):
        for i in range(c, len(payloads), n_clients):
            t_req = time.perf_counter()
            try:
                frame = payloads[i] if isinstance(payloads[i], dict) else {column: payloads[i]}
                responses[i] = server.predict(DataFrame.from_dict(frame))
                latencies[i] = (time.perf_counter() - t_req) * 1000.0
            except BaseException as e:  # noqa: BLE001 — reported by the caller, fails the run
                failures.append(f"request {i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if any(th.is_alive() for th in threads):
        raise AssertionError("clients did not finish within 600 s")
    return responses, latencies, time.perf_counter() - t0, failures


def _fold_drift(a, b, into):
    """How far a frame ``a`` computed in the row-stable forms lies from the
    default (cuBLAS) one ``b``, added into ``into``: per dense float column,
    the rows that differ and their largest ulp distance."""
    import numpy as np

    from flink_ml_tpu_torch.servable.fusion import ulp_diff

    for name in a.get_column_names():
        ca = a.column(name)
        if not isinstance(ca, np.ndarray) or ca.dtype.kind != "f":
            continue
        cb = np.asarray(b.column(name))
        got = into.setdefault(name, {"rows_differing": 0, "max_ulps": 0})
        got["rows_differing"] += int((ca.reshape(len(ca), -1) != cb.reshape(len(cb), -1)).any(axis=1).sum())
        got["max_ulps"] = max(got["max_ulps"], ulp_diff(ca, cb))
    return into


def _mesh1_reference(servable, tier, template):
    """The mesh-1 plan of ``servable`` at ``tier`` on the card, built apart
    from any server: ``execute(df)`` at the caller's bucket. A sharded plan
    is held against it run inside ``rowstable.required()``: the mesh-1 plan
    in the row-stable forms the sharded one takes on the card."""
    from flink_ml_tpu_torch.servable.fusion import resolve_fusion_tier
    from flink_ml_tpu_torch.servable.sparse import resolve_sparse_hints
    from flink_ml_tpu_torch.serving.plan import CompiledServingPlan

    return CompiledServingPlan.build(servable, scope=f"ml.serving[chip-smoke-mesh1-{tier}]",
                                     fusion=resolve_fusion_tier(tier), device="cuda",
                                     sparse=resolve_sparse_hints(template))


def _sharded_serve(servable, name, payloads, column, template, tier, mesh, kernel, reference,
                   mesh_model=1):
    """Serve ``servable`` at ``serving.mesh`` × ``serving.mesh.model`` and
    ``tier`` to the payloads from N_CLIENTS clients. Counts every kernel's
    launches over the traffic alone, then holds every response bit-equal
    per row to ``reference`` (the mesh-1 plan, inside
    ``rowstable.required()`` at mesh > 1) at the response's bucket, and
    records how far the default mesh-1 plan (cuBLAS) lies from it.
    Fails unless, in the fast tier, ``kernel`` launched once per data shard
    of every batch whose key is hot (none in the exact tier), no plain
    version was called, no batch fell back, and no chain was built and no
    model array uploaded after warmup. Returns the readings."""
    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.ops import rowstable
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig, pad_to
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    config = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode=tier,
                           mesh=mesh, mesh_model=mesh_model)
    t0 = time.perf_counter()
    server = InferenceServer(servable, name=name, serving_config=config, warmup_template=template, device="cuda")
    warmup_s = time.perf_counter() - t0
    scope = server.scope
    with server:
        plan = servable._fastpath_plan
        sharding = plan.sharding
        n_data = sharding.n_data if sharding is not None else 1
        if n_data != mesh or (sharding is not None) != (mesh * mesh_model > 1):
            raise AssertionError(f"{name}: plan built on {sharding!r} for mesh {mesh} x {mesh_model}")
        kinds = chain_kinds(plan)
        keys, lock, ingest = [], threading.Lock(), plan._ingest

        def recording_ingest(segment, df, bucket, cap=None, warm=False):
            got = ingest(segment, df, bucket, cap=cap, warm=warm)
            if not warm:
                with lock:
                    keys.append(got[1])
            return got

        plan._ingest = recording_ingest
        uploads = sharding.model_uploads if sharding is not None else None
        aligned = None
        if sharding is not None:  # each shard its own allocation: 16-byte aligned, as mesh 1's bucket
            parts = sharding.put_batch(np.zeros((MAX_BATCH, 4), np.float32))
            aligned = [p.data_ptr() % 16 == 0 for p in parts]
        # The path's run starts here: counts to 0, then traffic.
        for k in KERNELS:
            k.reset_launches()
        plain_calls, restore = _count_calls(mk, _PLAIN_MEGAKERNELS)
        batches_before = len(server.executed_batch_sizes)
        fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
        try:
            responses, latencies, wall, failures = _sharded_responses(server, payloads, column)
        finally:
            restore()
        launches = {k.name: k.launches for k in KERNELS}
        batches = server.executed_batch_sizes[batches_before:]
        fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
        compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
        del plan._ingest
    if failures:
        raise AssertionError(f"{name}: {len(failures)} requests failed: {failures[:5]}")
    hot = {key for key, kind in kinds.items() if "megakernel" in kind}
    hot_batches = sum(1 for key in keys if key in hot)
    want = {k.name: (n_data * hot_batches if k is kernel and tier == "fast" else 0) for k in KERNELS}
    if launches != want or (tier == "fast" and not hot_batches):
        raise AssertionError(f"{name}: launches {launches}, expected {want} ({hot_batches} hot batches "
                             f"x {n_data} shards)")
    if fallback or compiles or plain_calls:
        raise AssertionError(f"{name}: {fallback} fallbacks, {compiles} chains built after warmup, "
                             f"plain versions called {sorted(set(plain_calls))}")
    if sharding is not None and sharding.model_uploads != uploads:
        raise AssertionError(f"{name}: {sharding.model_uploads - uploads} model uploads on the serving path")
    if sharding is not None and any(b % (8 * n_data) for _, b in batches):
        raise AssertionError(f"{name}: a bucket off the mesh ladder in {batches}")
    drift = {}
    for i, resp in enumerate(responses):
        frame = payloads[i] if isinstance(payloads[i], dict) else {column: payloads[i]}
        df = DataFrame.from_dict(frame)
        padded = pad_to(df, resp.bucket)
        with rowstable.required(n_data > 1):
            want_df = reference.execute(padded).take(np.arange(len(df)))
        _same_frames(resp.dataframe, want_df, f"{name} request {i} (bucket {resp.bucket}) against mesh 1")
        if n_data > 1:
            _fold_drift(want_df, reference.execute(padded).take(np.arange(len(df))), drift)
    lat = sorted(latencies)
    return responses, {
        "tier": tier, "mesh": mesh, "mesh_model": mesh_model, "warmup_s": warmup_s,
        "warmed_keys": len(kinds), "requests": len(payloads), "batches": len(batches),
        "hot_batches": hot_batches, "launches": launches[kernel.name], "fallback_batches": fallback,
        "post_warmup_builds": compiles, "post_warmup_model_uploads": 0 if uploads is not None else None,
        "model_uploads_at_build": uploads, "shards_16_byte_aligned": aligned,
        "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(len(r.dataframe) for r in responses) / wall, "bit_equal_to_mesh1": True,
        "reference": "mesh-1 plan in the row-stable forms" if n_data > 1 else "mesh-1 plan",
        "row_stable_vs_default_mesh1": drift or None,
    }


def _sharded_swap(servables, payloads, template):
    """Serve ``servables[1]`` at mesh 4 (fast tier) and, under traffic from
    N_CLIENTS clients, swap to v2, roll back to v1 and swap on to v3 (v2's
    servable). Every response bit-equal per row to the mesh-1 plan of the
    version it names, and that version flipped in only after its warmup
    (every bucket on every shard); no chain built after warmup and no model
    array uploaded on the batcher's thread."""
    import numpy as np

    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.ops import rowstable
    from flink_ml_tpu_torch.servable import sharding as sharding_mod
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig, pad_to

    config = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast", mesh=4)
    put_model = sharding_mod.PlanSharding.put_model
    upload_threads = []

    def recording_put_model(self, array):
        upload_threads.append(threading.current_thread().name)
        return put_model(self, array)

    sharding_mod.PlanSharding.put_model = recording_put_model
    refs = {v: _mesh1_reference(s, "fast", template) for v, s in servables.items()}
    flips, warmed = [], set()
    try:
        server = InferenceServer(servables[1], name="chip-smoke-sharded-swap", serving_config=config,
                                 warmup_template=template, device="cuda")
        warmed.add(1)
        with server:
            done, lock = [], threading.Lock()
            compiles_before = metrics.get(server.scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)

            def flipper():
                for after, version, how in ((len(payloads) // 4, 2, "swap"), (len(payloads) // 2, 1, "rollback"),
                                            (3 * len(payloads) // 4, 3, "swap")):
                    while len(done) < after:
                        time.sleep(0.005)
                    t0 = time.perf_counter()
                    (server.rollback if how == "rollback" else server.swap)(version, servables[version])
                    plan = servables[version]._fastpath_plan
                    warmed_keys = set(k for s in plan.segments if hasattr(s, "compiled") for k in s.compiled)
                    if not set(server._batcher.buckets) <= warmed_keys:
                        raise AssertionError(f"v{version} flipped in with buckets {sorted(warmed_keys)} warmed")
                    warmed.add(version)
                    flips.append({"version": version, "how": how, "after_responses": len(done),
                                  "warm_and_flip_s": time.perf_counter() - t0})

            flip_errors = []

            def run_flips():
                try:
                    flipper()
                except BaseException as e:  # noqa: BLE001 — reported below
                    flip_errors.append(e)

            th = threading.Thread(target=run_flips)
            th.start()
            responses, failures, last = [], [], [None] * N_CLIENTS

            def client(c):
                # this client's share of the payloads, then round again until
                # the last flip is done, then SHARDED_SWAP_POST more
                i, post = c, 0
                while i < len(payloads) or len(flips) < 3 or post < SHARDED_SWAP_POST:
                    j = i % len(payloads)
                    try:
                        resp = server.predict(DataFrame.from_dict({"features": payloads[j]}))
                        with lock:
                            responses.append((j, resp))
                            last[c] = resp.model_version
                    except BaseException as e:  # noqa: BLE001 — reported below
                        failures.append(f"request {j}: {type(e).__name__}: {e}")
                    with lock:
                        done.append(j)
                    post += i >= len(payloads) and len(flips) == 3 and not flip_errors
                    if flip_errors:
                        break
                    i += N_CLIENTS

            clients = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
            for t in clients:
                t.start()
            for t in clients:
                t.join(timeout=600)
            th.join(timeout=600)
            if th.is_alive() or any(t.is_alive() for t in clients):
                raise AssertionError("swap under traffic did not finish within 600 s")
            compiles = metrics.get(server.scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    finally:
        sharding_mod.PlanSharding.put_model = put_model
    if failures or flip_errors:
        raise AssertionError(f"swap under traffic: {failures[:5]} {flip_errors}")
    if [f["version"] for f in flips] != [2, 1, 3]:
        raise AssertionError(f"flips {flips}")
    versions = [r.model_version for _, r in responses]
    if not set(versions) <= warmed or compiles or last != [3] * N_CLIENTS:
        raise AssertionError(f"versions served {versions}, warmed {sorted(warmed)}, {compiles} builds")
    batcher_uploads = [t for t in upload_threads if t.startswith("micro-batcher")]
    if batcher_uploads:
        raise AssertionError(f"{len(batcher_uploads)} model uploads on the batcher's thread")
    for i, resp in responses:
        df = DataFrame.from_dict({"features": payloads[i]})
        with rowstable.required():
            want = refs[resp.model_version].execute(pad_to(df, resp.bucket)).take(np.arange(len(df)))
        _same_frames(resp.dataframe, want, f"swap request {i} (v{resp.model_version}, bucket {resp.bucket})")
    return {"flips": flips, "responses": len(responses),
            "responses_by_version": {v: versions.count(v) for v in sorted(set(versions))},
            "post_warmup_builds": compiles, "model_uploads": len(upload_threads),
            "model_uploads_on_batcher_thread": 0, "bit_equal_to_mesh1": True}


def _chunk_launches(plan, rows, mesh):
    """The megakernel launches a fast-tier batch transform of ``rows`` rows
    makes at ``batch.mesh`` ``mesh``: per hot chunk, one a data shard, or one
    for a replicated tail (one card: one distinct device)."""
    (segment,) = [s for s in plan.segments if hasattr(s, "plan_kinds")]
    want = 0
    for lo in range(0, rows, PIPELINE_CHUNK_ROWS):
        n = min(PIPELINE_CHUNK_ROWS, rows - lo)
        replicated = mesh > 1 and n % 8 != 0
        padded = n if mesh == 1 or replicated else n + (-n) % (8 * mesh)
        (key,) = [k for k in segment.plan_kinds
                  if k[0][1][0] == padded and (k[-1] == "replicated") == replicated]
        if "megakernel" in segment.plan_kinds[key]:
            want += 1 if replicated else mesh
    return want


def _sharded_batch(model, X, tier, mesh, scope="ml.batch[plan]"):
    """``model.transform`` of the rows ``X`` at ``batch.mesh`` ``mesh`` and
    ``tier`` in PIPELINE_CHUNK_ROWS chunks: ``(output, plan, readings)``."""
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.config import Options, config
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics

    counters = (MLMetrics.BATCH_SHARD_PAD_ROWS, MLMetrics.BATCH_SHARD_REPLICATED_CHUNKS, MLMetrics.BATCH_SHARD_ROWS)
    df = X if isinstance(X, DataFrame) else DataFrame.from_dict({"features": X})
    config.set(Options.FUSION_MODE, tier)
    config.set(Options.BATCH_CHUNK_ROWS, PIPELINE_CHUNK_ROWS)
    config.set(Options.BATCH_MESH, mesh)
    try:
        before = [metrics.get(scope, c, 0) for c in counters]
        out, seconds, launches, builds, chunks = _batch_transform(model, df, scope)
        pad, repl, shard_rows = (metrics.get(scope, c, 0) - b for c, b in zip(counters, before))
        plan = model._plan_cache[1]
    finally:
        for option in (Options.FUSION_MODE, Options.BATCH_CHUNK_ROWS, Options.BATCH_MESH):
            config.unset(option)
    if (plan.sharding.n_data if plan.sharding is not None else 1) != mesh:
        raise AssertionError(f"batch plan on {plan.sharding!r} for batch.mesh {mesh}")
    return out, plan, {"tier": tier, "mesh": mesh, "rows": len(df), "seconds": seconds, "chunks": chunks,
                       "pad_rows": pad, "replicated_chunks": repl, "shard_rows": shard_rows,
                       "launches": launches, "builds": builds}


def phase_sharded_serving(card: str):
    """The serving and batch plans on a shard grid on the one card (module
    docstring, phase 35). Returns the megakernels' launches on the sharded
    serving path."""
    import tempfile

    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.builder import PipelineModel
    from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegressionModel
    from flink_ml_tpu_torch.models.feature.idf import IDFModel
    from flink_ml_tpu_torch.ops import rowstable
    from flink_ml_tpu_torch.ops.tensor_parallel import ColumnShards
    from flink_ml_tpu_torch.servable import PipelineModelServable
    from flink_ml_tpu_torch.serving import pad_to

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SHARDED_SERVING_SEED)

    # the three models: the published KMeans pipeline (fitted), the published
    # MLP (seeded weights), IDF -> LR on the sparse convention (seeded)
    X = _kmeans_published_rows()
    t0 = time.perf_counter()
    kmeans_model = _published_kmeans_pipeline().fit(DataFrame.from_dict({"features": X}))
    kmeans_fit_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        kmeans_model.save(f"{tmp}/pipeline")
        kmeans_servable = PipelineModel.load_servable(f"{tmp}/pipeline")
    mlp = {v: _seeded_mlp(MLP_WIDTHS, "features", np.random.default_rng(SHARDED_SERVING_SEED + v)) for v in (1, 2)}
    mlp[3] = mlp[2]
    idf = IDFModel().set_input_col("features").set_output_col("tfidf")
    idf.idf = rng.random(TRAIN_DIM) * 4.0
    lr = LogisticRegressionModel().set_features_col("tfidf")
    lr.coefficient = (rng.standard_normal(TRAIN_DIM) * 0.05).astype(np.float32)
    sparse_servable = PipelineModelServable([idf, lr])

    sizes = _traffic_sizes(rng)
    kmeans_payloads = [rng.random((n, KMEANS_D)) for n in sizes]
    mlp_payloads = [rng.standard_normal((n, MLP_WIDTHS[0])) for n in sizes]
    sparse_ids = [_hashed_rows(rng, n, TRAIN_NNZ if i % 4 else (1, 3, 9, 24)[(i // 4) % 4])
                  for i, n in enumerate(sizes)]
    sparse_payloads = [{"features": _sparse_frame(ids).column("features")} for ids in sparse_ids]
    models = (
        ("kmeans", kmeans_servable, kmeans_payloads, DataFrame.from_dict({"features": kmeans_payloads[0][:1]}),
         mk.ROWLOCAL),
        ("mlp", mlp[1], mlp_payloads, DataFrame.from_dict({"features": mlp_payloads[0][:1]}), mk.ROWLOCAL_MLP),
        ("sparse", sparse_servable, sparse_payloads, _sparse_frame(sparse_ids[0][:1]), mk.SPARSE_IDF_LOGISTIC),
    )

    launches = {}
    served = []
    scaler, _norm, km = kmeans_model.stages
    layers64 = [(W.astype(np.float64), b.astype(np.float64)) for W, b in mlp[1].layers]
    for label, servable, payloads, template, kernel in models:
        for tier in ("exact", "fast"):
            reference = _mesh1_reference(servable, tier, template)
            for mesh in SHARDED_SERVING_MESHES:
                responses, reading = _sharded_serve(servable, f"chip-smoke-sharded-{label}-{tier}-{mesh}", payloads,
                                                    "features", template, tier, mesh, kernel, reference)
                if mesh == 1:  # mesh N is bit-equal to it: mesh 1 against float64
                    for i, resp in enumerate(responses):
                        out = resp.dataframe
                        if label == "kmeans":
                            scaled64, norm64, dist = _kmeans_pipeline_float64(kmeans_model, payloads[i])
                            dec = _decided_rows(dist)
                            np.testing.assert_allclose(out.column("scaled"), scaled64, rtol=1e-6, atol=1e-6)
                            np.testing.assert_allclose(out.column("norm"), norm64, rtol=1e-5, atol=1e-6)
                            np.testing.assert_array_equal(np.asarray(out.column("prediction"))[dec],
                                                          np.argmin(dist, axis=1)[dec])
                        elif label == "mlp":
                            h = np.asarray(payloads[i], np.float32).astype(np.float64)
                            for W, b in layers64[:-1]:
                                h = np.maximum(h @ W + b, 0.0)
                            logits = h @ layers64[-1][0] + layers64[-1][1]
                            p = np.exp(logits - logits.max(1, keepdims=True))
                            p /= p.sum(1, keepdims=True)
                            np.testing.assert_allclose(out.column("rawPrediction"), p, rtol=0,
                                                       atol=PIPELINE_MLP_PROB_ATOL)
                if tier == "fast" and mesh > 1:
                    launches[kernel.name] = launches.get(kernel.name, 0) + reading["launches"]
                served.append({"model": label, **reading})
                emit("sharded_serving", card=card, part="serve", model=label, **reading)
            del reference

    swap = _sharded_swap(mlp, mlp_payloads, models[1][3])
    emit("sharded_serving", card=card, part="swap_rollback", mesh=4, tier="fast", **swap)

    # tensor parallelism: the MLP at serving.mesh 2 x serving.mesh.model 2
    tp_payloads = mlp_payloads[:16]
    tp_ref = _mesh1_reference(mlp[1], "exact", models[1][3])
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig

    config = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="exact",
                           mesh=SHARDED_TP_MESH[0], mesh_model=SHARDED_TP_MESH[1])
    tp_servable = _seeded_mlp(MLP_WIDTHS, "features", np.random.default_rng(SHARDED_SERVING_SEED + 1))
    with InferenceServer(tp_servable, name="chip-smoke-sharded-tp", serving_config=config,
                         warmup_template=models[1][3], device="cuda") as server:
        (segment,) = tp_servable._fastpath_plan.segments
        split = sorted(k for k, v in segment.shard_models[0][0].items() if isinstance(v, ColumnShards))
        if split != ["W0", "W1"]:
            raise AssertionError(f"tensor-parallel split arrays {split}, expected W0 and W1 (W2 is 8 wide)")
        tp_resp, tp_lat, tp_wall, tp_fail = _sharded_responses(server, tp_payloads, "features")
    if tp_fail:
        raise AssertionError(f"tensor-parallel requests failed: {tp_fail[:5]}")
    tp_err, tp_err64 = 0.0, 0.0
    for i, resp in enumerate(tp_resp):
        df = DataFrame.from_dict({"features": tp_payloads[i]})
        want = tp_ref.execute(pad_to(df, resp.bucket)).take(np.arange(len(df)))
        got = np.asarray(resp.dataframe.column("rawPrediction"))
        np.testing.assert_allclose(got, want.column("rawPrediction"), rtol=1e-5, atol=1e-6)
        tp_err = max(tp_err, float(np.abs(got - want.column("rawPrediction")).max()))
        h = np.asarray(tp_payloads[i], np.float32).astype(np.float64)
        for W, b in layers64[:-1]:
            h = np.maximum(h @ W + b, 0.0)
        logits = h @ layers64[-1][0] + layers64[-1][1]
        p = np.exp(logits - logits.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        np.testing.assert_allclose(got, p, rtol=0, atol=PIPELINE_MLP_PROB_ATOL)
        tp_err64 = max(tp_err64, float(np.abs(got - p).max()))
    emit("sharded_serving", card=card, part="tensor_parallel", mesh=list(SHARDED_TP_MESH), split_arrays=split,
         requests=len(tp_payloads), max_abs_diff_vs_mesh1=tp_err, envelope={"rtol": 1e-5, "atol": 1e-6},
         max_abs_err_vs_float64=tp_err64, p50_ms=sorted(tp_lat)[len(tp_lat) // 2])

    # the batch tier: the KMeans pipeline at 100,000 / 100,008 / 100,003 rows
    batch = []
    for rows in SHARDED_BATCH_ROWS:
        Xb = np.random.default_rng(KMEANS_DATA_SEED).random((rows, KMEANS_D))
        tail = rows % PIPELINE_CHUNK_ROWS
        for tier in ("exact", "fast"):
            default, _plan, reading = _sharded_batch(kmeans_model, Xb, tier, 1)
            with rowstable.required():
                base, _plan, _ = _sharded_batch(kmeans_model, Xb, tier, 1)
            reading["row_stable_vs_default"] = _fold_drift(base, default, {})
            batch.append(reading)
            for mesh in SHARDED_SERVING_MESHES[1:]:
                out, plan, reading = _sharded_batch(kmeans_model, Xb, tier, mesh)
                _same_frames(out, base, f"batch {rows} rows {tier} mesh {mesh}")
                want_pad = (-tail) % (8 * mesh) if tail % 8 == 0 else 0
                want_repl = 0 if tail % 8 == 0 else 1
                if (reading["pad_rows"], reading["replicated_chunks"]) != (want_pad, want_repl):
                    raise AssertionError(f"batch {rows} rows mesh {mesh}: pad {reading['pad_rows']}, replicated "
                                         f"{reading['replicated_chunks']}; the rule gives {want_pad}, {want_repl}")
                if tier == "fast":
                    want = _chunk_launches(plan, rows, mesh)
                    if not want or reading["launches"] != {mk.ROWLOCAL.name: want}:
                        raise AssertionError(f"batch {rows} rows mesh {mesh}: launches {reading['launches']}, "
                                             f"expected {want} of {mk.ROWLOCAL.name}")
                    launches[mk.ROWLOCAL.name] = launches.get(mk.ROWLOCAL.name, 0) + want
                reading["bit_equal_to_mesh1"] = True
                batch.append(reading)
    emit("sharded_serving", card=card, part="batch", model="kmeans", chunk_rows=PIPELINE_CHUNK_ROWS, runs=batch)

    # IDF -> LR in the batch tier at batch.mesh 2
    sparse_rows = _hashed_rows(np.random.default_rng(SHARDED_SERVING_SEED + 7), KMEANS_ROWS + 8, TRAIN_NNZ)
    sparse_df = _sparse_frame(sparse_rows)
    sparse_model = PipelineModel([idf, lr])
    sparse_batch = []
    for tier in ("exact", "fast"):
        default, _plan, r1 = _sharded_batch(sparse_model, sparse_df, tier, 1)
        with rowstable.required():
            base, _plan, _ = _sharded_batch(sparse_model, sparse_df, tier, 1)
        r1["row_stable_vs_default"] = _fold_drift(base, default, {})
        out, plan, r2 = _sharded_batch(sparse_model, sparse_df, tier, 2)
        _same_frames(out, base, f"sparse batch {tier} mesh 2")
        if tier == "fast":
            want = _chunk_launches(plan, len(sparse_rows), 2)
            if r2["launches"] != {mk.SPARSE_IDF_LOGISTIC.name: want} or not want:
                raise AssertionError(f"sparse batch mesh 2: launches {r2['launches']}, expected {want}")
            launches[mk.SPARSE_IDF_LOGISTIC.name] = launches.get(mk.SPARSE_IDF_LOGISTIC.name, 0) + want
        r2["bit_equal_to_mesh1"] = True
        sparse_batch += [r1, r2]
    emit("sharded_serving", card=card, part="batch", model="idf_lr", chunk_rows=PIPELINE_CHUNK_ROWS,
         runs=sparse_batch)
    emit("sharded_serving", card=card, part="done", kmeans_fit_s=kmeans_fit_s, launches=launches,
         note="every shard runs on the one card: shards time-share it, so no gain over mesh 1 is expected",
         seconds=time.perf_counter() - t_phase)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import numpy as np

    from flink_ml_tpu_torch.native import KERNELS
    import flink_ml_tpu_torch.linalg.onehot_sparse  # noqa: F401 — defines the crossing kernels
    import flink_ml_tpu_torch.servable.megakernels  # noqa: F401 — defines the serving megakernels
    from flink_ml_tpu_torch.parallel import FLASH_FOLD  # defines the ring-attention fold and its backward
    from flink_ml_tpu_torch.servable.megakernels import (
        ROWLOCAL,
        ROWLOCAL_MLP,
        SCALE_KMEANS,
        SCALE_LOGISTIC,
        SPARSE_IDF_LOGISTIC,
    )

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    kernels = list(KERNELS)
    phase_build(kernels)
    rng = np.random.default_rng(SEED)
    # paths[kernel][phase]: the kernel's launches on each path that runs it
    paths = {k.name: {} for k in kernels}

    def record(phase, got):
        for kernel_name, n in got.items():
            paths[kernel_name][phase] = n

    measured = {SCALE_LOGISTIC.name: phase_kernels(rng, smi)}
    record("serve", {SCALE_LOGISTIC.name: phase_serve(rng, smi)})
    grid_errs = phase_crossings_grid(rng, smi)
    headline = _headline_data()
    cache, train_launches = phase_train(smi, headline)
    record("train", train_launches)
    measured.update(phase_crossings_headline(cache, smi))
    del cache
    torch.cuda.empty_cache()
    record("streamed", phase_streamed(smi))
    torch.cuda.empty_cache()
    record("sharded_serving", phase_sharded_serving(smi))
    torch.cuda.empty_cache()
    measured[SPARSE_IDF_LOGISTIC.name] = phase_kernels_sparse(rng, smi, headline[0])
    sparse_launches, idf_model, lr_model = phase_serve_sparse(smi, headline)
    record("serve_sparse", {SPARSE_IDF_LOGISTIC.name: sparse_launches})
    for phase, n in phase_pipeline_sparse(smi, headline, idf_model, lr_model).items():
        record(phase, {SPARSE_IDF_LOGISTIC.name: n})
    for phase, got in phase_pipeline_mixed(smi, headline, idf_model, lr_model).items():
        record(phase, got)
    v2_coef, dense_rows = phase_fit_checkpoint(smi, headline)
    torch.cuda.empty_cache()
    record("fit_linearsvc", phase_fit_linear_family(smi, headline, dense_rows))
    record("hot_swap", {SPARSE_IDF_LOGISTIC.name: phase_hot_swap(smi, idf_model, lr_model, v2_coef)})
    del headline, idf_model, lr_model, v2_coef, dense_rows
    online_launches, online_err = phase_online(smi)
    record("online", {SCALE_LOGISTIC.name: online_launches})
    measured[SCALE_LOGISTIC.name]["max_abs_err"] = max(measured[SCALE_LOGISTIC.name]["max_abs_err"], online_err)
    torch.cuda.empty_cache()
    record("text", phase_text(smi))
    phase_featurize(smi)
    torch.cuda.empty_cache()
    sharded_launches, sparse_dp = phase_sharded(smi)
    record("sharded", {k: n for k, n in sharded_launches.items() if n})
    torch.cuda.empty_cache()
    record("model_parallel", {k: n for k, n in phase_model_parallel(smi, sparse_dp).items() if n})
    del sparse_dp
    mlp_alone = phase_kernels_mlp(rng, smi)
    record("serve_mlp", {ROWLOCAL_MLP.name: phase_serve_mlp(smi)})
    torch.cuda.empty_cache()
    measured[SCALE_KMEANS.name] = phase_kernels_kmeans(rng, smi)
    phase_fit_kmeans(smi)
    record("serve_kmeans", {SCALE_KMEANS.name: phase_serve_kmeans(smi)})
    measured[ROWLOCAL.name] = phase_kernels_rowlocal(rng, smi)
    record("serve_feature6", {ROWLOCAL.name: phase_serve_feature6(smi)})
    record("serve_imputer", {ROWLOCAL.name: phase_serve_imputer(smi)})
    # The MLP kernel's line times its prologue on normalize -> mlp; its error
    # is the largest over both phases that hold it against the plain version.
    chains, rowlocal_chain_err, rowlocal_chains = phase_kernels_chains(rng, smi)
    measured[ROWLOCAL_MLP.name] = dict(chains, max_abs_err=max(chains["max_abs_err"],
                                                               mlp_alone["max_abs_err"]))
    measured[ROWLOCAL.name]["max_abs_err"] = max(measured[ROWLOCAL.name]["max_abs_err"], rowlocal_chain_err)
    measured[ROWLOCAL.name]["chains"] = rowlocal_chains
    for phase, n in phase_pipeline_kmeans(smi).items():
        record(phase, {ROWLOCAL.name: n})
    for phase, n in phase_pipeline_mlp(smi).items():
        record(phase, {ROWLOCAL_MLP.name: n})
    torch.cuda.empty_cache()
    measured[FLASH_FOLD.name] = phase_kernels_flash(rng, smi)
    record("serve_attention", {FLASH_FOLD.name: phase_serve_attention(smi)})
    torch.cuda.empty_cache()
    measured.update(phase_kernels_flash_bwd(rng, smi))
    record("fit_attention", phase_fit_attention(smi))
    lines = []
    for kernel in kernels:
        m = measured[kernel.name]
        launches = sum(paths[kernel.name].values())
        lines.append({
            "name": kernel.name,
            "route": "cuda",
            "source": kernel.source_path,
            "replaces": kernel.replaces,
            "launches": launches,
            "paths": paths[kernel.name],
            "max_abs_err": max(m["max_abs_err"], grid_errs.get(kernel.name, 0.0)),
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
        })
        if not launches > 0 or not all(n > 0 for n in paths[kernel.name].values()):
            raise AssertionError(f"{kernel.name} was never launched on a path of it: {paths[kernel.name]}")
    if len(lines) != 12:
        raise AssertionError(f"{len(lines)} kernels registered, expected 12")
    emit("done", seconds=time.perf_counter() - t_start, power_limit_line=smi)
    print(json.dumps({"kernels": lines}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:  # noqa: BLE001 — any failure: traceback, nonzero exit, no result line
        traceback.print_exc()
        code = 1
    sys.exit(code)
