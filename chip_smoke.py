#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``torchmetrics_tpu_torch``) on one GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. device: require CUDA, print ``nvidia-smi`` name and power limit;
2. build: compile the kernels in ``torchmetrics_tpu_torch/csrc`` (nvcc, sm_90a) and the
   host C++ in ``torchmetrics_tpu_torch/native`` (g++);
3. kernels: hold each kernel against its plain PyTorch version on the card, on the
   main paths' shapes and on edge shapes (K2 also on peaked, all-equal and
   on-threshold scores and on NaN thresholds; at the binary path's ``(2^20, 1, 200)``
   on random and peaked scores, and at the multilabel path's ``(8192, 80, 200)`` with a
   per-element mask), with exact (integer) equality;
4. main path: ``MulticlassAccuracy(num_classes=1000)`` over 16 batches of 8192x1000
   logits and ``MulticlassAUROC(num_classes=10, thresholds=200)`` over 16 batches of
   8192x10 logits, ``forward`` on every batch then ``compute``, each held against the
   same port run on the CPU; each kernel's launch count over its path must equal the
   number of updates;
5. collection path (``BASELINE.json`` config #2 at CIFAR-10 width): a
   ``MetricCollection`` of stat scores, macro and weighted accuracy, binned AUROC and
   two confusion matrices over 16 updates of 8192x10 scores, then ``compute``. Its
   compute groups, one launch each of K1 and K2 per update, every state against the
   same collection on the CPU and every value against the member run alone on the
   card; the confusion matrix on edge rows against the CPU and its update under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
6. binary path (a click-through-rate eval step): a collection of binned AUROC and AP
   (T=200), accuracy, F1, precision, recall, a confusion matrix and an exact AUROC over
   16 updates of 2^20 float32 logits and int64 clicks, beside a confusion matrix's
   ``forward`` per batch, then ``compute``. Its groups, K2 once per update and K1
   never, every state and value against the same run on the CPU; the stat-scores and
   confusion-matrix updates under ``set_sync_debug_mode("error")``;
7. multilabel path (MS-COCO's 80 categories): a collection of binned macro mAP and
   AUROC (T=200), F1 macro and micro, accuracy and a multilabel confusion matrix, with
   ``ignore_index=-1`` on ~5 % of the target elements, over 16 updates of 8192x80
   logits beside an F1's ``forward`` per batch; checked as the binary path;
8. task routers: each of the twenty routers once per task it has, on the card, against the CPU;
   and a multiclass F1 update on integer labels (the staged per-class count) under
   ``set_sync_debug_mode("error")``;
9. sync, two ranks on the one card (gloo, CUDA tensors, spawned processes, a join
   timeout): ragged batches and an exact-mode AUROC; ``compute`` must take the packed
   route with one collective per buffer plus the metadata gather and equal the
   ``merge_state`` fold of the two ranks' states; an empty-versus-nonempty ``cat``
   state must raise on both ranks on the eager route. Also times the 2-rank
   ``compute``, packed against eager;
10. times (CUDA events, medians; device time and operations per call from
   torch.profiler): each kernel and its plain version at the paths' shapes beside the
   least time the card could take (K2 also on peaked scores, at 8192x1000, at the
   binary and at the multilabel shape), each metric's ``update``, the collection's
   ``update`` against its six members updated one by one, and the binary and
   multilabel collections' ``update`` with and without ``validate_args`` (with the host
   syncs per update that ``set_sync_debug_mode("warn")`` reports);
11. engine: the compiled update engine (``engine/compiled.py``, ``engine/fusion.py``),
   on by default for a CUDA metric, over the same batches with ``validate_args=False``:
   accuracy's 16 ``forward``s and one ragged update of 5000 rows (bucket 8192), the
   config #2, binary and multilabel collections' 16 updates. Every state exactly equal
   to the eager run on the card and to the run on the CPU; replays equal to engine
   steps minus captures; the fused owners with 0 fallbacks and the binned curves
   falling back on every update, as in the JAX package; K1's launches (one per replay,
   plus the warm-up's and the pad-row unit's once per signature) against the
   profiler's kernel events (which must be more than none); reset, clone, a
   ``compute`` value that is a state, a retained member handle, ragged batches of
   logits through a binary pair at threshold 0.3 (exact-shape graphs) and 0.5
   (bucketed) against eager, and an accuracy replay and a fused binary replay under
   ``set_sync_debug_mode("error")``. Then engine on against eager per update (and per
   accuracy ``forward``, three rounds), in turns in this call: host µs, device busy and
   operations, idle share, and the batch copy into the static inputs;
12. the rest of the stat-scores family, on the batches of phases 4-7, each path 16
   updates eagerly, then again with the engine on, then ``compute``: ImageNet-1k logits
   into accuracy, specificity and Hamming distance (one stat-scores group, K1 once per
   update) and Jaccard, MCC and quadratic kappa (one 1000 x 1000 confusion-matrix
   group); CIFAR-10 scores into AUROC and the three fixed-point metrics (one binned
   group, K2 once per update); the 2^20 binary logits into specificity, Hamming, IoU,
   MCC, kappa and recall at 90 % precision beside a binned AUROC; the MS-COCO
   multilabel logits into exact match, Hamming, specificity, IoU, MCC and precision at
   50 % recall beside the binned macro mAP. Groups, launches per update, every state
   against the CPU run, the engine run bit-equal to eager, values within the CPU tests'
   tolerances, the fixed-point curves falling back on every engine update, the
   stat-scores and confusion-matrix updates under ``set_sync_debug_mode("error")``.
   Also the ImageNet top-5 accuracy on the stable-sort path (eager and engine, against
   the CPU, no host sync) with the top-5 selection timed alone, the sigmoid check (the
   same logits sliced from a 2^20 batch and as 7 rows give bit-identical probabilities;
   card against CPU mismatches counted) and each path's update µs, engine on against
   eager, in turns.

13. the eval loop: aggregators, wrappers and checkpoints at full width, each member
   over its batches eagerly, then with the engine on, then on the CPU. On ImageNet-1k
   (phase 4's 16 batches of 8192 x 1000 logits) and their per-sample cross-entropy:
   ``MeanMetric`` with a float NaN strategy and with the default ``"warn"``, ``Sum`` /
   ``Max`` / ``Min`` / ``Cat`` of the per-batch loss, a float64 ``SumMetric``,
   ``RunningMean(window=5)`` against the mean of the last <= 5 batch losses after each
   update, ``ClasswiseWrapper`` over 1000 labels, ``MinMaxMetric`` computed after every
   update, ``1 - accuracy``, ``BootStrapper`` with 10 copies (multinomial on 16
   batches, Poisson on 4; each copy held to a CPU copy on the same drawn rows), the
   ``MetricTracker`` of accuracy and F1 over 2 epochs of 8 batches with
   ``best_metric``; on MS-COCO (phase 7's 8192 x 80 logits) ``MultioutputWrapper`` of
   80 binned ``BinaryAUROC`` (and, with ~1 % NaN rows, ``remove_nans=True`` on 4
   batches); ``MultitaskWrapper`` of the ImageNet accuracy and the COCO binned mAP.
   States against the CPU (counts exactly, float sums relative 1e-6, AUROC / AP 1e-5),
   the engine run bit-equal to eager, K1 / K2 launches per member, the float-strategy
   aggregators replaying with no fallback and the host-reading ones falling back
   counted; a resume (the mean, the classwise inner metric and the tracker's
   collection saved to ``.npz`` after batch 8, restored on the card, run to the end)
   equal to the uninterrupted run; then each member's update µs, host syncs, device
   busy and idle share, engine replays / captures / fallbacks, in turns.

14. the engine tier, on phase 4's and phase 5's batches with ``validate_args=False`` and
   ``update()`` driven: accuracy (16 updates of 8192 x 1000 and one of 5000 rows) with
   ``scan_steps=8`` (two kb=8 drains and a kb=1 tail), then with ``async_dispatch=2``;
   the config #2 collection with ``scan_steps=8`` (the stat-scores and confusion-matrix
   owners queued, AUROC running K2 eagerly on every update); quarantine ``1`` with a NaN
   batch at update 5 of the accuracy path (the state equals the run without it, the
   counter reads 1); a compensated ``SumMetric`` and ``MeanMetric`` over 1024 updates of
   8192 float32 losses with ``scan_steps=16`` (within 2 ulp of the float64 sum, the naive
   run's drift beside it); the cached compute on each path. Every state bit-equal to the
   eager run on the card and to the CPU run (the compensated float states within relative
   1e-6 of the CPU's); K1's launches equal to Σ kb over the drains plus the probe's
   warm-ups, and against the profiler's kernel events over one kb=8 drain; K2's equal to
   the updates; one enqueue, one drain and one join under ``set_sync_debug_mode("error")``.
   Then, in turns in this call, per-update host µs for eager, the one-step engine, scan
   K=8 and scan K=8 + async with device busy and idle share; the host time of one engine
   step by part (signature key, shield, batch copy, replay) and of a scan enqueue (its own
   ``host_breakdown`` line); whether ``CUDAGraph.replay`` releases the GIL, read over the
   replay calls alone; accuracy's ``forward``, engine against eager, in five interleaved
   pairs. Last, an operation a CUDA graph cannot hold raises out of the engine's capture.

15. the rest of classification and regression's sum-state metrics, each path 16 updates
   eagerly, then with the engine on, then ``compute``, and the same on the CPU: an
   ImageNet-1k collection (8192 x 1000 logits of a confident model) of accuracy (K1), l1
   and l2 calibration errors (15 bins), crammer-singer and one-vs-all hinge losses and
   macro Dice; phase 7's MS-COCO logits into coverage error, label-ranking AP and loss
   beside the binned mAP (K2); phase 6's 2^20 click-through logits into calibration
   error, hinge loss and binned AUROC (K2), with ``BinaryFairness`` over UCI Adult's sex
   shares and ``BinaryGroupStatRates`` over its five race shares (seeded group ids); 2^20
   log-normal regression rows into MSE, RMSE, MAE, MSLE, MAPE, SMAPE, WMAPE, Minkowski
   (p=3), log-cosh, R², RSE, explained variance and Tweedie at powers 0 and 1.5, then
   MSE and raw R² at 131072 x 8. Groups, K1 / K2 launches per update, the engine's split
   (the rankings, fairness, Dice and regression replay; calibration, hinge and the curves
   fall back, as in the JAX package), states against the CPU (counts and the
   calibration streams exactly, float sums relative 2e-6), the engine run bit-equal to
   eager, values within the stated tolerances (the calibration errors within six
   standard deviations of a float32 sum's rounding walk), host syncs per update, the
   updates the JAX package runs without a host read under ``set_sync_debug_mode("error")``
   (and a Tweedie 1.5 replay), the debiased l2 calibration error, and each path's update
   µs, engine on against eager, in turns.

16. regression's moments and ``cat`` states and the retrieval domain, each path 16
   updates eagerly, then with the engine on, then ``compute``, and the same on the CPU:
   ``distill``, ImageNet-1k student logits (as phase 15 makes them) into accuracy (K1)
   beside ``KLDivergence()`` and ``KLDivergence(reduction="none")`` of the teacher's
   softmax against the student's; ``regression``, phase 15's 2^20 rows into Pearson and
   concordance (one group) beside an MSE (one fused graph carries the moments) and
   Spearman, and 131072 x 8 into both at eight outputs;
   ``kendall``, 16 x 4096 ranker scores rounded to 0.01 against 1-5 human labels into
   Kendall's tau a / b / c and b with its test, the CPU side an independent O(n log n)
   count (a Fenwick tree) in place of the port's O(n²) scan; ``embeddings``, 16 x
   (8192, 768) pairs into ``CosineSimilarity("mean")``; ``msmarco``, MS MARCO passage dev
   (small): 6,980 queries x 1,000 BM25 candidates, whole queries per update, into the
   nine binary retrieval metrics (top 10, a curve to 100, one ``skip``), nDCG@10 on TREC
   DL style grades and a binned ``BinaryAUROC`` (K2), the CPU side over the JAX
   package's numpy pack (checked bit-equal to the card's pack, which reads the host
   once). Groups, launches, the engine's split (Pearson, concordance, KL ``mean`` and
   accuracy replay; the lists fall back), states and values against the CPU, the
   engine bit-equal to eager, host syncs per update and per ``compute`` (a retrieval
   compute reads the host once), each ``compute``'s ms (Kendall's pairs per second
   beside its bound) and each path's update µs, engine on against eager, in turns.
   Phase 9 also syncs a ``PearsonCorrCoef`` (stacked moments) and a ``RetrievalMAP``
   (``None``-reduced lists of equal counts) over its two ranks, each held to the
   ``merge_state`` fold.

17. nominal association and pairwise distances, each metric path 16 updates eagerly,
   then with the engine on, then ``compute``, and the same on the CPU: ``imagenet``, phase
   15's ImageNet-1k logits against labels into a collection of accuracy (K1) and Cramér's
   V, Tschuprow's T, Pearson's contingency coefficient and Theil's U at 1000 classes (one
   table group, a count into 10^6 bins per update); ``adult``, UCI Adult's education x
   occupation (16 x 14 values, 5.8 % missing occupation as NaN) in updates of 2^20 rows
   into Cramér's V and Theil's U with ``nan_strategy="drop"`` (the few-bin count: 256
   bins); ``crowd``, CIFAR-10H-shaped ratings (10,000 images x 10 classes, 51 labels
   each) into Fleiss' kappa in counts mode and in probs mode on (625, 10, 51) scores per
   update. Groups, K1's launches, the engine's split (the tables replay, the drop path
   included; Fleiss' lists fall back), tables equal to the CPU's, the engine bit-equal
   to eager, values within the stated tolerances, 0 host syncs per update, one host read
   per table ``compute``. Then the four ``*_matrix`` functionals over a seeded 48,842 x 9
   matrix with Adult's nine cardinalities (36 pairs), and the five pairwise functionals
   over BERT-base-sized embeddings (linear, cosine and euclidean over 8192 x 768 against
   itself, Manhattan and Minkowski p=3 of 2048 queries against the 8192), each with
   ``reduction=None`` and ``"mean"``, the leading rows against the CPU: host ms, device
   busy and idle share, host syncs and the largest device items per call, beside the
   bound. Each metric path's update µs, engine on against eager, in turns.

18. the tensor half of the image domain, each path eagerly, then with the engine on, then
   ``compute``, and the same on the CPU: ``ssim`` (``BASELINE.json`` config #3's SSIM: the
   evaluation of a 256 x 256 generator or super-resolution model), 16 updates of 32 x 3 x
   256 x 256 float32 in [0, 1] (seeded smooth targets; blurred, noised predictions) into a
   collection of SSIM and MS-SSIM (``data_range=1.0``) and PSNR (``data_range=None``: the
   min / max states on the card), beside PSNR-B on the luma (32 x 1 x 256 x 256 with an 8 x 8
   blocking artifact, block 8) and TV on the predictions; ``pansharpening``, 16 updates of
   8 x 4 x 256 x 256 four-band scenes and their ratio-4 pansharpened estimates into ERGAS,
   SAM, D-lambda, RASE and UQI (``cat`` lists: one compute group that falls back, the cost
   at the epoch end) and RMSE-SW; ``volume``, 4 updates of 2 x 1 x 64 x 128 x 128 into 3-D
   SSIM with sigma (1.5, 1.0, 1.0). Groups, no K1 / K2 launch, the engine's split (the sum
   states replay, the lists fall back), states and values against the CPU (SSIM, MS-SSIM,
   UQI and D-lambda absolute 1e-5; PSNR, PSNR-B, ERGAS, RASE, RMSE-SW, SAM and the float
   sums relative 1e-5; TV relative 1e-6), the engine bit-equal to eager; on the ssim path 0
   host syncs and no host-to-device copy per update after the first, eagerly and with the
   engine, the collection's members replaying in one fused graph; ``image_gradients``
   bit-equal to the CPU's; the band products of SSIM's five-map stack (5 x 32 x 3 planes of
   266 x 266) against the band design's bound (its MACs over 67 TFLOP/s) and the
   separable filter's (11 taps per axis, or its bytes), beside one depthwise
   ``F.conv2d`` of the same stack (used nowhere in the port), and their share of the
   SSIM update's device time; each pansharpening ``compute``'s ms and host reads; each
   path's update µs, engine on against eager, in turns.

19. the model half of the image domain, on the port's seeded random trunks (no weights
   are bundled): ``fid`` (``BASELINE.json`` config #3's FID: a 256 x 256 generator
   evaluated against its training set), 32 updates per side of 32 x 3 x 256 x 256 uint8
   images (seeded smooth scenes as the real side, coarser and noisier ones as the fake)
   into ``FrechetInceptionDistance(2048)`` with a 0-d tensor flag on the card and
   ``KernelInceptionDistance`` at its defaults (100 subsets of 1000), the fake side also
   into ``InceptionScore`` (10 splits; the ``logits`` tap of the seeded trunk with its fc
   re-centred and scaled so that IS is well above 1), eagerly and with the engine,
   then each ``compute``. Checks: the trunk's weights equal on the card and the CPU, its
   six taps on 2 images against the CPU's, TF32 off inside its forward; the three
   metrics' states and values over the first 2 updates per side against the CPU run
   (a KID of 10 subsets of 50 there; log IS relative); the full run's FID against
   scipy's float64 ``sqrtm`` Fréchet distance of its states; the FID engine bit-equal to
   eager on full batches, replaying every update in an exact-shape graph, KID and IS
   falling back on their lists; one ragged
   update of 20 images (12 zero pad images in bucket 32) within its tolerance; 0 host
   syncs per FID update, eagerly and with the engine. Times: the trunk's forward alone
   and its share of an update's device time, FID update µs eager against engine in
   turns, FID ``compute`` ms and its ``eigh`` / ``eigvalsh`` ms, host reads per
   ``compute``, KID ``compute`` ms and its peak memory, IS ``compute`` ms. ``lpips``
   (super-resolution and image-translation evaluation), for each of ``alex``, ``vgg`` and
   ``squeeze`` (bundled heads, seeded backbones): 16 updates of 32 pairs of 3 x 256 x 256
   float32 in [-1, 1], eagerly and with the engine (every update falls back: the range
   check reads the host, as in the JAX engine), then ``compute``; the first batch's first
   4 pairs and a gradient through ``img1`` (at full float32; relative L2, beside the CPU's
   float64 gradient) against the CPU; host syncs per update; update µs
   and the backbone's share of the device time. No K1 / K2 launch. Every number stands
   beside the card's ``nvidia-smi`` name and power limit (the result's ``card``).

20. the text domain (``BASELINE.json`` config #4, BERTScore / ROUGE on WMT16 en-de pairs),
   on 512 seeded pairs shaped like newstest2016 en-de (5-80 words, mean ~22, from a seeded
   4000-word vocabulary; each reference an edit of its prediction; a third of the pairs
   with two or three sentences) in 8 updates of 64, and 512 seeded SQuAD answers: ``mt``,
   a collection of BLEU, SacreBLEU (``13a``), chrF, TER, EED and ROUGE (four keys) with
   one-element reference lists; ``asr``, a collection of WER, CER, MER, WIL and WIP on flat
   strings; ``squad``. Each eagerly and with the engine (every update falls back:
   ``non-tensor-input`` or ``list-state``, as in the JAX engine), the engine run equal to
   the eager one, the first 2 updates against the CPU (counts exactly, float sums
   relative 1e-6); host µs per member and per collection, host-to-device copies and host
   syncs per update, host reads per member ``compute``, device operations and idle share,
   and the collection's fallback cost by part. BERTScore at roberta-large's width (24 x 1024, 16 heads, FFN 4096,
   vocabulary 50265, 514 positions; a seeded encoder and a word tokenizer written here,
   injected, every row at ``max_length=512``) over the 512 pairs, ``compute`` with
   ``idf`` off and on (ms, the encoder's share, peak memory over what was live, host
   reads), the greedy-cosine ``bmm`` against its float32 bound, the padding's share; each
   ``compute`` at 8 pairs (one in each update) against a CPU ``BERTScore`` that took the
   same updates, and the functional's first 2 pairs, against the CPU (absolute 1e-4). Perplexity at GPT-2's shapes: 4
   updates of (8, 1024, 50257) logits with ~5 % ``ignore_index``, float32 then bfloat16,
   eagerly and with the engine (which replays, with 0 host syncs), device ms per update
   against the bytes bound, two rows against the CPU (relative 1e-5). InfoLM's nine
   measures over injected (512, 50265) distributions, eagerly and with the engine (each
   ``compute`` against a CPU ``InfoLM`` that took the same updates, and the functional's
   first 16 pairs, relative 1e-5). The HF route: ``BERTScore`` and ``InfoLM`` with ``model_name_or_path``
   on a seeded ``BertForMaskedLM`` at bert-base width (12 x 768, vocabulary 30522) and a
   ``BertTokenizer`` the script saves with ``save_pretrained`` (BERTScore on the 512 pairs,
   InfoLM on 16), BERTScore's ``compute`` at the same 8 pairs and the functionals' first 2
   pairs against the CPU; the model the loader caches stays on the CPU and the card runs
   a copy. No K1 / K2 launch.

21. the detection domain (``BASELINE.json`` config #5, ``MeanAveragePrecision`` on COCO val2017)
   on 5000 seeded images shaped like COCO val (640 x 480, 80 classes, ~7.3 ground truths
   per image capped at 63, 41 / 34 / 25 % small / medium / large, 100 post-NMS detections
   per image): ``coco_list``, ``MeanAveragePrecision()`` at the defaults with class
   metrics over per-image dicts in updates of 16 (host µs per update; ``compute`` ms, the
   C++ evaluator's share, device reads per ``compute`` (at most 9), values equal to the
   same run on the CPU; the C++ evaluator against the numpy route on the first 500
   images to 1e-12); ``coco_packed``, ``PackedMeanAveragePrecision(80)`` over the same
   images as widened (16, 128, 6) / (16, 64, 5) batches, eagerly and with the engine
   (histograms equal both ways and to a CPU run over the first 1024 images; ``map``
   within 1e-3 of ``coco_list``'s; µs per update, device busy and idle, device
   operations, replays and captures, 0 host syncs per update); ``segm``, dense 480 x 640
   masks (64 images, 20 detections each) and RLE dicts of the same masks, equal to each
   other and to the CPU run; ``iou_family``, IoU / GIoU / DIoU / CIoU over 512 images
   (within 1e-6 of the CPU run, 3 reads per ``compute``); ``panoptic``, ``PanopticQuality``
   and ``ModifiedPanopticQuality`` on 8 COCO-panoptic-shaped (480, 640, 2) maps, equal to
   the CPU run; ``sync2``, the packed-dict and packed routes over 2 gloo ranks of 2500
   images each, equal to one process over all 5000, and ragged per-image lists raising on
   both ranks. The C++ builds with ``g++`` at first use. No K1 / K2 launch.

22. the audio and multimodal domains: ``dns``, a ``MetricCollection`` of SNR, SI-SNR and
   SI-SDR over 16 clips of 160,000 samples (10 s at 16 kHz, the DNS Challenge test
   clips); ``sdr``, ``SignalDistortionRatio(filter_length=512)`` over 16 x 32,000 (4 s at
   8 kHz, WSJ0-2mix's ``min``); ``pit2`` / ``pit3`` / ``pit4``, speaker-wise
   ``PermutationInvariantTraining`` of SI-SDR over 8 x S x 32,000 (S = 2 and 3 search the
   permutations on the card, S = 4 runs the Hungarian solver on the host); ``pit_sdr``,
   permutation-wise PIT of SDR over 4 x 2 x 32,000; ``csisnr``,
   ``ComplexScaleInvariantSignalNoiseRatio`` over 16 x 257 x 251 complex64 spectra. Each
   runs 16 updates eagerly and with the engine, then ``compute``, held against the same
   port run on the CPU (relative 1e-5; PIT's best permutations equal update by update),
   the engine against eager bit for bit, and the engine split against
   ``AUDIO_REPLAYING`` / ``AUDIO_FALLBACK_REASONS``; host µs per update, device busy,
   operations, idle share, the largest device items and host syncs per update
   (``AUDIO_SYNCS``: 0, and 1 on ``pit4``, the Hungarian read; SDR's printed). ``clip``,
   ``CLIPScore`` on a seeded checkpoint at openai/clip-vit-large-patch14's widths written
   with ``save_pretrained``: 4 updates of 64 (3 x 480 x 640 uint8 image, 8-16 word
   caption) pairs, eagerly and with the engine; the processor's host ms and the towers'
   device ms per update beside their float32 bound; the towers asserted on the card; the
   first 4 pairs within 1e-3 of the CPU. No K1 / K2 launch.

23. fault-tolerant sync and elastic snapshots (``parallel/resilience.py``, ``faults.py``,
   ``elastic.py``, the degraded re-plan in ``engine/epoch.py``), after K1 and K2 against
   their plain versions as in phase 3. Part A, two gloo ranks on the one card: each
   runs config #2's collection (phase 5's members, eagerly) over 16 updates of its own
   8192 x 10 scores (K1 and K2 once per update), then ``compute`` from the same local
   states with no policy (phase 9's collectives, the ``merge_state`` fold), under a
   policy with no fault (deadline 2000 ms, retries 2, backoff 1 ms, ``verify_payload``:
   bit-equal values, its ms and host reads beside the no-policy ones, in turns), with
   ``CorruptPayload(rank=1)`` and ``CollectiveTimeout`` (one retry each, bit-equal),
   ``RankDrop(rank=1)`` (one degraded fold on both ranks, a ``sync.degraded`` event
   naming ``(0,)``, values bit-equal to rank 0's states computed alone) and the same with
   ``degraded=False`` (``RankUnreachableError`` on both ranks, the local states back);
   then a pair of its own where rank 1 sleeps three times a 500 ms deadline: rank 0
   escapes with an in-flight ``CollectiveTimeoutError`` within the deadline plus 500 ms,
   not retried, and both ranks leave without tearing the group down. Part B, on the
   card with the engine: two copies each of ``MulticlassAccuracy(1000)`` and the config #2
   collection over 8 of phase 4's and phase 5's batches each, saved as 2-rank shards
   (and a set half way), restored into worlds of 1 and 3 and folded with ``merge_state``
   against the 2-rank fold (counts exactly, floats relative 1e-6); a flipped byte raises
   ``SnapshotIntegrityError`` and ``last_good`` restores the half-way set; shard bytes,
   save and restore ms. Part C: a spawned child updates accuracy on the card under a
   ``ContinuousSnapshotter`` (every 4 updates) and gets SIGTERM after 10 updates;
   ``restore_latest`` on the card plus the remaining batches equals the uninterrupted run,
   again with ``scan_steps=8``; the signal-time flush ms. It prints a
   ``resilience_summary`` line with the card's ``nvidia-smi`` name and power limit.

24. the diagnostics plane (``torchmetrics_tpu_torch/diag/``), after K1 and K2 against their
   plain versions as in phase 3. Guarded: ``MulticlassAccuracy(1000)`` on phase 4's
   batches and config #2's members that the engine runs (all but the binned AUROC, whose
   [0, 1] range check reads the host on every update in both packages) on phase 5's, a
   cold build and 16 warm updates each under ``transfer_guard("strict")`` (both layers:
   ``torch.cuda.set_sync_debug_mode("error")`` and the Python hooks) with the recorder, the
   sentinel and ``profile_context(every_n=4)`` on: 0 readbacks, the sentinel 0, 4 probes per
   16 warm updates, values bit-equal to the same run with the diagnostics off; ``compute``
   under the log guard with its readbacks counted by layer; ``device_us`` / ``device_event_us``
   p50 / p99 beside the profiler's device time per update, K1 / K2 launches, the cost
   ledger's entries; the binned AUROC's readbacks under the log guard; then host µs per
   update with every knob off, each alone (recorder, sentinel, profile, guard, lineage) and
   all on, medians of 11 rounds of 64 updates in turns. Planted, on the card and equal to the CPU run: a
   NaN row under quarantine (``input_poisoned``, states equal to the run without the
   batch), a NaN into a float sum (``nan``, sticky), a compensated sum absorbing its
   increments (``precision_loss``), an int32 count past 2^30 (``overflow_suspect``). Two
   gloo ranks with config #2's collection and the profile on: a NaN on rank 1 alone read on
   both after the OR fold, a divergent rank-invariant state flagged on both, rank 1 late by
   20 ms (``DelayRank``) named the straggler on both, then rank 1 late past a 500 ms
   deadline: rank 0 escapes in flight and degrades with rank 1 as the culprit, its
   coverage members ``(0,)``; both ranks' events merged into one Perfetto trace. It prints a
   ``diag_summary`` line with the card's ``nvidia-smi`` name and power limit;
25. the serving plane (``serve/``, ``diag/slo.py``, ``diag/telemetry.py``), the engine on:
   K1 and K2 against their plain versions; config #1 in a ``WindowedMetric`` (8 x 4
   buckets, 48 updates) under the strict guard (0 readbacks, one capture, 48 K1
   launches), its ``compute`` against a fresh metric over the covered updates and its
   states against the CPU, its update µs against the bare metric's; config #2's binned
   AUROC in the same window under the log guard (its range check's readbacks, K2's
   launches); ``TenantSlices`` over config #1 (capacity 4096, 6000 updates of 512 x 1000
   from 5000 tenants: one capture, the global and 32 sampled tenants exact, an untracked
   tenant ``None``) and the sum sweep over 10^4 tenants; HLL, heavy hitters and KLL at
   serving sizes against their error bounds and the CPU; a scrape thread reading
   ``snapshot_compute`` and the sidecar's endpoints while the window updates; four pods'
   envelopes folded (against ``merge_state``, byte-stable, one pod stale: degraded); two
   sidecars' telemetry merged by ``FleetTelemetry`` with a planted degraded pull; two
   gloo ranks syncing the sketches. It prints a ``serve_summary`` line with the card's
   ``nvidia-smi`` name and power limit;
26. sharded state (``parallel/sharding.py``) on 4 gloo ranks sharing the card, one spawn.
   shard_vocab: a 1-D state mesh of 4 at Llama 3's vocabulary (128,256 classes, 32,064 per
   rank): macro accuracy, precision, recall and F1 in one compute group over 16 updates of
   2048 x 128,256 float32 logits (two seeded batches, cycled; every rank draws the same),
   eagerly and with the engine; each rank's ``(32064,)`` shards, its state bytes 1/4 of
   the whole, 0 collectives and 0 host reads in the update loop, K1 launched, the
   assembled states and ``compute`` exactly equal to a replicated run on the same rank;
   update µs against the replicated run's, ``compute`` ms with its collectives.
   shard_confmat: ``MulticlassConfusionMatrix(32768)`` on the same mesh, 16 updates of
   2^20 label pairs: (8192, 32768) int32 shards, the peak memory of 3 eager updates and of
   every engine update after the build (warm-up, static buffers and graph pool: reported
   apart) below one (C, C) matrix, 0 collectives and host reads, each rank's shard exactly
   equal to its rows of a replicated run (eager) made one rank at a time. shard_2x2: config #2's collection on a (data 2, state 2)
   mesh, 8 updates per data row of that row's own 8192 x 10 batches; the synced
   ``compute`` equal to a replicated run over both rows' batches, its collectives counted,
   K1 and K2 held against their plain versions. The degrade: ``MulticlassAccuracy(50257)``
   (GPT-2's vocabulary) replicated with 4 ``shard.fallback`` events. Then, in the parent, K1
   at 2048 x 128,256 against its plain version and its row of the kernels line. It prints a
   ``shard_summary`` line with the card's ``nvidia-smi`` name and power limit.

Phases 3-10 run under ``engine_context(False)``: the eager path the earlier slices
measured, so their numbers stay comparable.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA the script exits
with code 2 and prints no result. It imports nothing of JAX.

``python3 chip_smoke.py --out PATH`` also writes every result line, in full, to PATH as
one JSON object (the updates line runs to tens of kilobytes).

``python3 chip_smoke.py --eval-loop-only`` runs phases 1-2 and then phase 13 alone, on
batches made for it; ``--engine-tier-only`` runs phases 1-2 and then phase 14 alone;
``--tensor-metrics-only`` runs phases 1-2 and then phase 15 alone;
``--moments-retrieval-only`` runs phases 1-2 and then phase 16 alone;
``--nominal-pairwise-only`` runs phases 1-2 and then phase 17 alone;
``--image-only`` runs phases 1-2 and then phase 18 alone; ``--image-models-only`` runs
phases 1-2 and then phase 19 alone; ``--text-only`` runs phases 1-2 and then phase 20
alone; ``--detection-only`` runs phases 1-2 and then phase 21 alone; ``--audio-only``
runs phases 1-2 and then phase 22 alone; ``--resilience-only`` runs phases 1-2 and then
phase 23 alone, on batches made for it; ``--diag-only`` runs phases 1-2 and then phase 24
alone, on batches made for it; ``--serve-only`` runs phases 1-2 and then phase 25 alone,
on batches made for it; ``--shard-only`` runs phases 1-2 and then phase 26 alone.

``python3 chip_smoke.py --binned-update-only`` runs phases 1-2 and then only times
``_binned_multi_threshold_confmat`` (K2's step in the curve update) for the package
first on ``sys.path``, so two checkouts can be compared in turns in one call.
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import json
import math
import multiprocessing
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

ACC_BATCH, ACC_CLASSES = 8192, 1000
CIFAR_BATCH, CIFAR_CLASSES, N_THRESH = 8192, 10, 200
N_BATCHES = 16
SYNC_BATCHES = (3, 5)  # per rank: ragged cat lists across the two ranks
SYNC_JOIN_TIMEOUT_S = 300
ACC_ATOL = 1e-6  # both sides divide identical int32 counts in float32
AUROC_ATOL = 1e-5  # trapezoid sums taken in another order
IGNORE = -100
BIN_BATCH = 1 << 20  # a click-through-rate eval step
ML_BATCH, ML_LABELS, ML_IGNORE = 8192, 80, -1  # MS-COCO's 80 categories, multilabel

# HBM rate by card (bytes/s), from NVIDIA's data sheets
_HBM_RATE = (("H200", 4.8e12), ("NVL", 3.9e12), ("PCIe", 2.0e12), ("H100", 3.35e12))
_F32_RATE = 67e12  # H100 SXM float32 outside the tensor cores, op/s
_F64_RATE = 67e12  # H100 SXM float64 on the tensor cores, op/s
_NOTE = (
    "ms: CUDA-event time per wrapper call at the path's shape (output allocation included);"
    " kernel_device_ms: the kernel's own device time (torch.profiler); device_ms and"
    " device_ops_per_call: every device operation of one call (kernel and memset); library_ms is null:"
    " no single PyTorch call computes this function"
)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The port's sigmoid, the one its binary and multilabel metrics apply to logits."""
    from torchmetrics_tpu_torch.utilities.compute import _sigmoid as port_sigmoid

    return port_sigmoid(x)


_T0 = time.perf_counter()


def _log(msg: str) -> None:
    """One progress line, stamped with the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def _hbm_rate(name: str) -> float:
    for key, rate in _HBM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no HBM rate known for {name!r}")


def _equal(name: str, got, want) -> float:
    """Require exact equality of tensors (or tuples of them), dtypes included; return
    the largest absolute difference found (0.0 once it passes)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: output {i} is {g.dtype}{tuple(g.shape)}, plain {w.dtype}{tuple(w.shape)}")
        diff = (g.cpu().double() - w.cpu().double()).abs().max().item() if g.numel() else 0.0
        if diff != 0.0:
            raise AssertionError(f"{name}: output {i} differs from the plain version (max abs diff {diff})")
        worst = max(worst, diff)
    return worst


def _median_ms(fn, iters: int, repeats: int = 5, warmup: int = 3) -> float:
    """Median over ``repeats`` of the mean time per call of ``fn(i)`` (CUDA events)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _host_us_per_call(fn, iters: int, repeats: int = 5) -> float:
    """Median host time per call of work that ends in a device synchronize."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6 / iters)
    return statistics.median(times)


def _mean_measured(values) -> "float | None":
    """The mean of the runs that measured a value (None where the profiler saw no device
    activity), or None when none did."""
    measured = [v for v in values if v is not None]
    return statistics.mean(measured) if measured else None


def _mean_runs(rs: list) -> dict:
    """One mode's runs folded into one record: a float key's mean over the runs that
    measured it, another key's first value. ``empty_windows`` sums the profiler windows
    that saw no device activity and were tried again; ``profiled_runs`` counts the runs
    whose device figures entered the means."""
    out = {k: (_mean_measured(r[k] for r in rs) if any(isinstance(r[k], float) for r in rs) else rs[0][k]) for k in rs[0]}
    out["empty_windows"] = sum(r["empty_windows"] for r in rs)
    out["profiled_runs"] = f"{sum(r['device_busy_us'] is not None for r in rs)} of {len(rs)}"
    return out


#: every profiler window of the run: how many, how many recorded no device activity
#: (and were tried again), and how many calls gave up after ``attempts`` empty windows
PROFILE_WINDOWS = {"windows": 0, "empty": 0, "gave_up": 0}


def _device_profile(fn, iters: int, attempts: int = 3) -> dict:
    """Device time per call of ``fn(i)`` by kernel name (torch.profiler, CUPTI).

    Returns ``{"device_busy_us": ..., "device_ops": ..., "kernels_us": {name: us},
    "memcpy_us": ...}`` (``device_ops``: kernels, memsets and copies on the device per
    call; ``memcpy_us``: the copies alone; ``empty_windows``: the windows that recorded
    no device activity and were tried again), or ``None`` values when none of the
    ``attempts`` windows recorded any.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    per_kernel: dict = {}
    n_events = 0
    empty = 0
    for _ in range(attempts):  # a window now and then records no device activity: try again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        PROFILE_WINDOWS["windows"] += 1
        for event in prof.events():
            if event.device_type == DeviceType.CUDA:
                name = event.name[:80]
                per_kernel[name] = per_kernel.get(name, 0.0) + event.time_range.elapsed_us() / iters
                n_events += 1
        if per_kernel:
            break
        empty += 1
        PROFILE_WINDOWS["empty"] += 1
    if not per_kernel:
        PROFILE_WINDOWS["gave_up"] += 1
        return {"device_busy_us": None, "device_ops": None, "kernels_us": None, "memcpy_us": None, "empty_windows": empty}
    top = dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8])
    memcpy = sum(us for name, us in per_kernel.items() if "Memcpy" in name)
    return {
        "device_busy_us": sum(per_kernel.values()), "device_ops": n_events / iters, "kernels_us": top,
        "memcpy_us": memcpy, "empty_windows": empty,
    }


# ---------------------------------------------------------------- inputs


def _logits_with_edge_rows(n: int, c: int, gen: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    x = torch.randn(n, c, generator=gen)
    if n >= 8 and c >= 10:
        x[0] = 0.0  # all tied: index 0
        x[1, 3] = x[1, c - 2] = 50.0  # two maxima: the first wins
        x[2, 5] = x[2, 9] = float("nan")  # NaN is maximal, the first NaN wins
        x[3, c - 1] = float("nan")
        x[4] = float("-inf")  # all -inf: index 0
        x[5] = -1.0
        x[5, 7], x[5, 3] = -0.0, 0.0  # -0.0 == 0.0: index 3 wins
        x[6, 2], x[6, 4] = float("inf"), float("inf")
    return x.to(dtype)


def _targets_with_edge_rows(n: int, c: int, gen: torch.Generator) -> torch.Tensor:
    t = torch.randint(0, c, (n,), generator=gen)
    if n >= 16:
        t[8:10] = IGNORE
        t[10] = c  # out of range: the row counts nowhere
        t[11] = -3
        t[12:16] = torch.tensor([0, 3, 3, 2])[: min(4, c)].clamp(max=c - 1)
    return t


def check_stat_counts(gen: torch.Generator) -> float:
    """Every case must match exactly; returns the max abs error at the path's shape."""
    from torchmetrics_tpu_torch.ops import stat_counts as sc

    cases = [
        ("path 8192x1000 f32", ACC_BATCH, ACC_CLASSES, torch.float32),
        ("ragged 8229x1000", ACC_BATCH + 37, ACC_CLASSES, torch.float32),
        ("unaligned width 2048x1001", 2048, 1001, torch.float32),
        ("C=1", 777, 1, torch.float32),
        ("C=20000 global histogram", 4096, 20000, torch.float32),
        ("f16 2048x1000", 2048, ACC_CLASSES, torch.float16),
        ("bf16 2048x1000", 2048, ACC_CLASSES, torch.bfloat16),
        ("f64 2048x1000", 2048, ACC_CLASSES, torch.float64),
    ]
    path_err = 0.0
    for name, n, c, dtype in cases:
        preds = _logits_with_edge_rows(n, c, gen, dtype).cuda()
        target = _targets_with_edge_rows(n, c, gen).cuda()
        for ignore in (None, IGNORE):
            for tgt in (target, target.to(torch.int32)):
                got = sc.stat_counts(preds, tgt, c, ignore)
                want = sc._stat_counts_plain(preds, tgt, c, ignore)
                torch.cuda.synchronize()
                err = _equal(f"stat_counts {name} ignore={ignore} target={tgt.dtype}", got, want)
                if name.startswith("path"):
                    path_err = max(path_err, err)
        _log(f"  stat_counts {name}: equal")
    # a row-aligned view that is not 16-byte aligned takes the scalar loads
    flat = torch.randn(512 * 1000 + 1, generator=gen).cuda()
    preds = flat[1:].view(512, 1000)
    target = torch.randint(0, 1000, (512,), generator=gen).cuda()
    _equal("stat_counts unaligned base", sc.stat_counts(preds, target, 1000), sc._stat_counts_plain(preds, target, 1000))
    before = sc.LAUNCHES
    empty = sc.stat_counts(torch.zeros(0, 7, device="cuda"), torch.zeros(0, dtype=torch.long, device="cuda"), 7)
    if sc.LAUNCHES != before or any(int(x.abs().sum()) for x in empty):
        raise AssertionError("stat_counts N=0 must return zeros without a launch")
    _log("  stat_counts unaligned base, N=0: equal")
    return path_err


def _curve_inputs(n: int, c: int, t: int, gen: torch.Generator, kind: str = "random"):
    """K2's inputs as the curve update builds them (bool one-hot, broadcast row mask).

    ``kind``: "random" (softmax of unit-normal logits, 1 % NaN scores, a duplicated
    threshold, one score on a threshold), "peaked" (softmax of logits x 8, as a trained
    classifier gives: most scores in the lowest and highest bins), "all_equal" (every
    element in one bin), "on_threshold" (every score exactly on a threshold) or
    "nan_thresholds" (two NaN thresholds beside the random case).
    """
    from torchmetrics_tpu_torch.ops.multi_threshold import sort_thresholds

    logits = torch.randn(n, c, generator=gen)
    preds = (logits * 8 if kind == "peaked" else logits).softmax(dim=1)
    target = torch.randint(0, c, (n,), generator=gen)
    target[torch.rand(n, generator=gen) < 0.05] = -1
    thr = torch.linspace(0, 1, t)[torch.randperm(t, generator=gen)]
    thr[1] = thr[0]  # a duplicated threshold
    if kind in ("random", "nan_thresholds"):
        preds[torch.rand(n, c, generator=gen) < 0.01] = float("nan")
    if kind == "all_equal":
        preds.fill_(0.5)
    elif kind == "on_threshold":
        preds = thr[torch.randint(0, t, (n, c), generator=gen)]
    elif kind == "nan_thresholds" and t > 4:
        thr[2] = thr[4] = float("nan")
    if n and kind != "all_equal":
        preds[0, 0] = thr[3]  # a score exactly on a threshold
    preds, target, thr = preds.cuda(), target.cuda(), thr.cuda()
    valid = target >= 0
    positive = target[:, None] == torch.arange(c, device="cuda")
    return preds, positive, valid[:, None].expand(-1, c), sort_thresholds(thr), target


def check_multi_threshold(gen: torch.Generator) -> float:
    """Every case must match exactly; returns the max abs error at the path's shape."""
    from torchmetrics_tpu_torch.ops import multi_threshold as mt

    cases = [
        ("path 8192x10 T=200", CIFAR_BATCH, CIFAR_CLASSES, N_THRESH, "random"),
        ("class tiles 8192x1000 T=200", CIFAR_BATCH, 1000, N_THRESH, "random"),
        ("ragged 1000x3 T=17", 1000, 3, 17, "random"),
        ("global histogram 512x3 T=40000", 512, 3, 40000, "random"),
        ("peaked 8192x10 T=200", CIFAR_BATCH, CIFAR_CLASSES, N_THRESH, "peaked"),
        ("peaked 8192x1000 T=200", CIFAR_BATCH, 1000, N_THRESH, "peaked"),
        ("all-equal 8192x10 T=200", CIFAR_BATCH, CIFAR_CLASSES, N_THRESH, "all_equal"),
        ("on-threshold 8192x10 T=200", CIFAR_BATCH, CIFAR_CLASSES, N_THRESH, "on_threshold"),
        ("NaN thresholds 4096x10 T=200", 4096, CIFAR_CLASSES, N_THRESH, "nan_thresholds"),
    ]
    path_err = 0.0
    for name, n, c, t, kind in cases:
        preds, positive, valid, (thr_sorted, order), target = _curve_inputs(n, c, t, gen, kind)
        want = mt._multi_threshold_confmat_plain(preds, positive, valid, thr_sorted, order)
        want_counts = mt._multi_threshold_plain(preds, positive, valid, thr_sorted, order)
        got = mt.multi_threshold_confmat(preds, positive, valid, thr_sorted, order)
        torch.cuda.synchronize()
        err = _equal(f"multi_threshold {name}", got, want)
        if name.startswith("path"):
            path_err = max(path_err, err)
        counts = mt.multi_threshold_counts(preds, positive, valid, thr_sorted, order)
        torch.cuda.synchronize()
        _equal(f"multi_threshold {name} counts", tuple(x.contiguous() for x in counts), want_counts)
        # int64 one-hot and a contiguous int32 mask: other element sizes and strides
        pos64 = torch.nn.functional.one_hot(target.clamp(min=0), c)
        val32 = valid.to(torch.int32).contiguous()
        got = mt.multi_threshold_confmat(preds, pos64, val32, thr_sorted, order)
        torch.cuda.synchronize()
        _equal(f"multi_threshold {name} int64/int32 flags", got, want)
        _log(f"  multi_threshold {name}: equal")
    before = mt.LAUNCHES
    preds, positive, valid, sorted_thr, _ = _curve_inputs(0, 4, 9, gen)
    empty = mt.multi_threshold_confmat(preds, positive, valid, *sorted_thr)
    if mt.LAUNCHES != before or empty.shape != (9, 4, 2, 2) or int(empty.abs().sum()):
        raise AssertionError("multi_threshold N=0 must return zeros without a launch")
    _log("  multi_threshold N=0: equal")
    return path_err


def _binary_curve_inputs(n: int, t: int, gen: torch.Generator, kind: str = "random"):
    """K2's inputs as the binned binary update builds them: ``(N, 1)`` scores, positives
    and row mask. ``kind``: "random" (sigmoid of unit-normal logits, 1 % NaN, one score
    on a threshold) or "peaked" (sigmoid of logits x 8: most scores crowd the lowest and
    highest bins, as a trained classifier's do, and all N rows share one class)."""
    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
    from torchmetrics_tpu_torch.ops.multi_threshold import sort_thresholds

    logits = torch.randn(n, generator=gen)
    preds = torch.sigmoid(logits * 8 if kind == "peaked" else logits)
    target = (torch.rand(n, generator=gen) < 0.3).long()
    target[torch.rand(n, generator=gen) < 0.05] = -1
    thr = _adjust_threshold_arg(t, torch.device("cpu"))
    if kind == "random":
        preds[torch.rand(n, generator=gen) < 0.01] = float("nan")
        preds[0] = thr[3]
    preds, target, thr = preds.cuda(), target.cuda(), thr.cuda()
    return preds[:, None], (target > 0)[:, None], (target >= 0)[:, None], sort_thresholds(thr), target


def _multilabel_curve_inputs(n: int, labels: int, t: int, gen: torch.Generator, kind: str = "random"):
    """K2's inputs as the binned multilabel update builds them: ``(N, L)`` scores with the
    sentinel ``-4 * L * T`` on ignored elements, positives and a per-element ``(N, L)``
    bool mask. ``kind``: "random" or "peaked", as for the binary inputs."""
    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
    from torchmetrics_tpu_torch.ops.multi_threshold import sort_thresholds

    logits = torch.randn(n, labels, generator=gen)
    preds = torch.sigmoid(logits * 8 if kind == "peaked" else logits)
    target = (torch.rand(n, labels, generator=gen) < 0.1).long()
    ignored = torch.rand(n, labels, generator=gen) < 0.05
    target[ignored] = -4 * labels * t
    thr = _adjust_threshold_arg(t, torch.device("cpu"))
    if kind == "random":
        preds[torch.rand(n, labels, generator=gen) < 0.01] = float("nan")
        preds[0, 0] = thr[3]
    preds[ignored] = -4 * labels * t
    preds, target, thr = preds.cuda(), target.cuda(), thr.cuda()
    return preds, target > 0, target >= 0, sort_thresholds(thr), target


def check_multi_threshold_new_shapes(gen: torch.Generator) -> dict:
    """K2 at the binary path's ``(2^20, 1, 200)`` (random and peaked scores) and the
    multilabel path's ``(8192, 80, 200)`` with a per-element mask, against its plain
    version, integer-exact; returns the max abs error per path."""
    from torchmetrics_tpu_torch.ops import multi_threshold as mt

    cases = [
        ("binary", "binary 1048576x1 T=200 random", _binary_curve_inputs(BIN_BATCH, N_THRESH, gen, "random")),
        ("binary", "binary 1048576x1 T=200 peaked", _binary_curve_inputs(BIN_BATCH, N_THRESH, gen, "peaked")),
        ("multilabel", "multilabel 8192x80 T=200 per-element mask random",
         _multilabel_curve_inputs(ML_BATCH, ML_LABELS, N_THRESH, gen, "random")),
        ("multilabel", "multilabel 8192x80 T=200 per-element mask peaked",
         _multilabel_curve_inputs(ML_BATCH, ML_LABELS, N_THRESH, gen, "peaked")),
        ("edge", "binary ragged 1000x1 T=17", _binary_curve_inputs(1000, 17, gen, "random")),
    ]
    errors = {"binary": 0.0, "multilabel": 0.0}
    for path, name, (preds, positive, valid, (thr_sorted, order), _) in cases:
        got = mt.multi_threshold_confmat(preds, positive, valid, thr_sorted, order)
        want = mt._multi_threshold_confmat_plain(preds, positive, valid, thr_sorted, order)
        torch.cuda.synchronize()
        err = _equal(f"multi_threshold {name}", got, want)
        if path in errors:
            errors[path] = max(errors[path], err)
        if int(got[0].sum()) != int(valid.sum()):
            raise AssertionError(f"multi_threshold {name}: counts {int(got[0].sum())} elements, {int(valid.sum())} are valid")
        _log(f"  multi_threshold {name}: equal")
    return errors


# ---------------------------------------------------------------- main path


def _assert_close(name: str, got, want, atol: float) -> None:
    g, w = got.detach().cpu().double(), want.detach().cpu().double()
    if g.shape != w.shape or not torch.isfinite(g).all() or not torch.allclose(g, w, atol=atol, rtol=0):
        raise AssertionError(f"{name}: cuda {g.tolist()} vs cpu {w.tolist()} (atol {atol})")


def _assert_states_equal(name: str, gpu_metric, cpu_metric) -> None:
    for attr in gpu_metric._defaults:
        g, c = getattr(gpu_metric, attr), getattr(cpu_metric, attr)
        if isinstance(g, list):  # cat-list states: the same number of pieces, equal once joined
            if len(g) != len(c):
                raise AssertionError(f"{name}: state {attr} holds {len(g)} pieces on cuda, {len(c)} on cpu")
            g, c = (torch.cat(g), torch.cat(c)) if g else (torch.zeros(0), torch.zeros(0))
        if g.dtype != c.dtype or not torch.equal(g.cpu(), c):
            raise AssertionError(f"{name}: state {attr} differs between cuda and cpu")


def run_accuracy_path(gen: torch.Generator):
    from torchmetrics_tpu_torch import MulticlassAccuracy
    from torchmetrics_tpu_torch.ops import multi_threshold, stat_counts

    batches = [
        (torch.randn(ACC_BATCH, ACC_CLASSES, generator=gen), torch.randint(0, ACC_CLASSES, (ACC_BATCH,), generator=gen))
        for _ in range(N_BATCHES)
    ]
    gpu_batches = [(p.cuda(), t.cuda()) for p, t in batches]
    torch.cuda.synchronize()

    stat_counts.LAUNCHES = multi_threshold.LAUNCHES = 0
    metric = MulticlassAccuracy(num_classes=ACC_CLASSES)
    gpu_vals = [metric(p, t) for p, t in gpu_batches]
    gpu_final = metric.compute()
    torch.cuda.synchronize()
    launches = {"stat_counts": stat_counts.LAUNCHES, "multi_threshold": multi_threshold.LAUNCHES}

    ref = MulticlassAccuracy(num_classes=ACC_CLASSES, device="cpu")
    for i, (p, t) in enumerate(batches):
        _assert_close(f"accuracy forward {i}", gpu_vals[i], ref(p, t), ACC_ATOL)
    _assert_close("accuracy compute", gpu_final, ref.compute(), ACC_ATOL)
    _assert_states_equal("accuracy", metric, ref)
    if not 0.0 <= float(gpu_final) < 0.01:
        raise AssertionError(f"accuracy of random logits over 1000 classes should be near 0.001, got {float(gpu_final)}")
    if launches != {"stat_counts": N_BATCHES, "multi_threshold": 0}:
        raise AssertionError(f"accuracy path launches {launches}, expected {N_BATCHES} of stat_counts")
    _log(f"  MulticlassAccuracy: {N_BATCHES} forwards, compute {float(gpu_final):.6f}, launches {launches}")
    return launches["stat_counts"], gpu_batches


def run_auroc_path(gen: torch.Generator):
    from torchmetrics_tpu_torch import MulticlassAUROC
    from torchmetrics_tpu_torch.ops import multi_threshold, stat_counts

    gpu_batches = [
        (
            torch.randn(CIFAR_BATCH, CIFAR_CLASSES, generator=gen).cuda(),
            torch.randint(0, CIFAR_CLASSES, (CIFAR_BATCH,), generator=gen).cuda(),
        )
        for _ in range(N_BATCHES)
    ]
    torch.cuda.synchronize()

    stat_counts.LAUNCHES = multi_threshold.LAUNCHES = 0
    metric = MulticlassAUROC(num_classes=CIFAR_CLASSES, thresholds=N_THRESH)
    gpu_vals = [metric(p, t) for p, t in gpu_batches]
    gpu_final = metric.compute()
    torch.cuda.synchronize()
    launches = {"stat_counts": stat_counts.LAUNCHES, "multi_threshold": multi_threshold.LAUNCHES}

    # The metric softmaxes the logits on the card; the CPU run takes those very
    # probabilities (all in [0, 1], so it does not softmax again), which makes the
    # binning, and so the states, comparable bit for bit.
    ref = MulticlassAUROC(num_classes=CIFAR_CLASSES, thresholds=N_THRESH, device="cpu")
    for i, (p, t) in enumerate(gpu_batches):
        _assert_close(f"auroc forward {i}", gpu_vals[i], ref(p.softmax(dim=1).cpu(), t.cpu()), AUROC_ATOL)
    _assert_close("auroc compute", gpu_final, ref.compute(), AUROC_ATOL)
    _assert_states_equal("auroc", metric, ref)
    if not 0.45 < float(gpu_final) < 0.55:
        raise AssertionError(f"AUROC of random scores should be near 0.5, got {float(gpu_final)}")
    if launches != {"stat_counts": 0, "multi_threshold": N_BATCHES}:
        raise AssertionError(f"auroc path launches {launches}, expected {N_BATCHES} of multi_threshold")
    _log(f"  MulticlassAUROC: {N_BATCHES} forwards, compute {float(gpu_final):.6f}, launches {launches}")
    return launches["multi_threshold"], gpu_batches


# ---------------------------------------------------------------- collection path

# compute groups the collection must settle on (as sets: the owner is the first name)
_EXPECTED_GROUPS = {frozenset({"stats", "acc", "acc_w"}), frozenset({"auroc"}), frozenset({"confmat", "confmat_t"})}


def _collection_members(device=None, validate_args: bool = True, **kwargs) -> dict:
    """``BASELINE.json`` config #2 at CIFAR-10 width, as one collection's members."""
    from torchmetrics_tpu_torch import (
        MulticlassAccuracy,
        MulticlassAUROC,
        MulticlassConfusionMatrix,
        MulticlassStatScores,
    )

    common = dict(device=device, validate_args=validate_args, **kwargs)
    c = CIFAR_CLASSES
    return {
        "stats": MulticlassStatScores(c, **common),
        "acc": MulticlassAccuracy(c, average="macro", **common),
        "acc_w": MulticlassAccuracy(c, average="weighted", **common),
        "auroc": MulticlassAUROC(c, thresholds=N_THRESH, **common),
        "confmat": MulticlassConfusionMatrix(c, **common),
        "confmat_t": MulticlassConfusionMatrix(c, normalize="true", **common),
    }


def _scores_with_edge_rows(n: int, c: int, gen: torch.Generator) -> torch.Tensor:
    """Softmax scores computed on the card, with argmax edge rows that stay in [0, 1].

    Every member takes the same scores, and the CPU run takes these very values, so
    AUROC does not softmax on either side (its range check passes) and the binned
    states compare bit for bit. NaN and infinite logits would fail that check and
    softmax again on each device; they are held on the confusion matrix alone
    (``check_confmat_edges``).
    """
    x = torch.randn(n, c, generator=gen).cuda().softmax(dim=1)
    x[0] = 0.1  # all tied: index 0
    x[1, 3] = x[1, c - 2] = 0.45  # two maxima: the first wins
    x[2] = 0.0
    x[2, 0] = -0.0  # -0.0 == 0.0: index 0
    x[3, 2] = x[3, 4] = 1.0  # two exact ones
    x[4] = 0.0
    return x


def run_collection_path(gen: torch.Generator):
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.ops import multi_threshold, stat_counts

    batches = [
        (_scores_with_edge_rows(CIFAR_BATCH, CIFAR_CLASSES, gen), torch.randint(0, CIFAR_CLASSES, (CIFAR_BATCH,), generator=gen).cuda())
        for _ in range(N_BATCHES)
    ]
    torch.cuda.synchronize()

    mc = MetricCollection(_collection_members())
    stat_counts.LAUNCHES = multi_threshold.LAUNCHES = 0
    for p, t in batches:
        mc.update(p, t)
    torch.cuda.synchronize()
    launches = {"stat_counts": stat_counts.LAUNCHES, "multi_threshold": multi_threshold.LAUNCHES}
    values = mc.compute()
    torch.cuda.synchronize()

    groups = {frozenset(g) for g in mc.compute_groups.values()}
    if groups != _EXPECTED_GROUPS:
        raise AssertionError(f"collection compute groups {mc.compute_groups}, expected {_EXPECTED_GROUPS}")
    if launches != {"stat_counts": N_BATCHES, "multi_threshold": N_BATCHES}:
        raise AssertionError(f"collection path launches {launches}, expected {N_BATCHES} of each kernel")

    # every state against the same collection on the CPU, exactly; values within the tolerances
    ref = MetricCollection(_collection_members(device="cpu"))
    for p, t in batches:
        ref.update(p.cpu(), t.cpu())
    ref_values = ref.compute()
    for name, metric in mc.items(keep_base=True):
        _assert_states_equal(f"collection {name}", metric, ref[name])
        got, want = values[name], ref_values[name]
        if got.dtype == torch.int32:
            _equal(f"collection {name}", got.cpu(), want)
        else:
            _assert_close(f"collection {name}", got, want, AUROC_ATOL if name == "auroc" else ACC_ATOL)

    # every value against the member run alone on the card
    for name, alone in _collection_members().items():
        for p, t in batches:
            alone.update(p, t)
        want = alone.compute()
        if values[name].dtype != want.dtype or not torch.equal(values[name], want):
            raise AssertionError(f"collection {name}: {values[name].tolist()} vs alone {want.tolist()}")
    _log(f"  MetricCollection: groups {sorted(sorted(g) for g in groups)}, {N_BATCHES} updates, launches {launches};"
         f" acc {float(values['acc']):.6f}, auroc {float(values['auroc']):.6f}")
    check_confmat_edges(gen)
    return launches, batches


def check_confmat_edges(gen: torch.Generator) -> None:
    """The confusion matrix on ``_logits_with_edge_rows`` (ties, NaN, infinities) and
    out-of-range targets against the CPU, and its update with no host sync."""
    from torchmetrics_tpu_torch import MulticlassConfusionMatrix

    preds = _logits_with_edge_rows(CIFAR_BATCH, CIFAR_CLASSES, gen).cuda()
    target = _targets_with_edge_rows(CIFAR_BATCH, CIFAR_CLASSES, gen).cuda()
    for ignore in (None, IGNORE):
        card = MulticlassConfusionMatrix(CIFAR_CLASSES, ignore_index=ignore, validate_args=False)
        host = MulticlassConfusionMatrix(CIFAR_CLASSES, ignore_index=ignore, validate_args=False, device="cpu")
        card.update(preds, target)
        host.update(preds.cpu(), target.cpu())
        _equal(f"confusion matrix edge rows ignore={ignore}", card.confmat.cpu(), host.confmat)
    metric = MulticlassConfusionMatrix(CIFAR_CLASSES, validate_args=False)
    metric.update(preds, target)  # warm: first-use allocations are not the point
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metric.update(preds, target)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _log("  MulticlassConfusionMatrix: edge rows equal to the CPU; update ran under set_sync_debug_mode('error')")


# ---------------------------------------------------------------- binary and multilabel paths

_BINARY_GROUPS = {
    frozenset({"auroc", "ap"}), frozenset({"acc", "f1", "precision", "recall"}), frozenset({"cm"}),
    frozenset({"auroc_exact"}),
}
_MULTILABEL_GROUPS = {frozenset({"map", "auroc"}), frozenset({"f1_macro", "f1_micro", "acc"}), frozenset({"cm"})}


def _binary_members(device=None, validate_args: bool = True) -> dict:
    """The binary path's collection: a click-through-rate eval, binned and exact AUROC
    (the exact one is what MLPerf's DLRM reports) beside the threshold metrics."""
    import torchmetrics_tpu_torch as tm

    common = dict(device=device, validate_args=validate_args)
    return {
        "auroc": tm.BinaryAUROC(thresholds=N_THRESH, **common),
        "ap": tm.BinaryAveragePrecision(thresholds=N_THRESH, **common),
        "acc": tm.BinaryAccuracy(**common),
        "f1": tm.BinaryF1Score(**common),
        "precision": tm.BinaryPrecision(**common),
        "recall": tm.BinaryRecall(**common),
        "cm": tm.BinaryConfusionMatrix(**common),
        "auroc_exact": tm.BinaryAUROC(**common),
    }


def _multilabel_members(device=None, validate_args: bool = True) -> dict:
    """The multilabel path's collection: MS-COCO's 80 categories, macro mAP and AUROC
    binned over 200 thresholds, F1 macro and micro, accuracy, per-label matrices."""
    import torchmetrics_tpu_torch as tm

    common = dict(num_labels=ML_LABELS, ignore_index=ML_IGNORE, device=device, validate_args=validate_args)
    return {
        "map": tm.MultilabelAveragePrecision(thresholds=N_THRESH, **common),
        "auroc": tm.MultilabelAUROC(thresholds=N_THRESH, **common),
        "f1_macro": tm.MultilabelF1Score(average="macro", **common),
        "f1_micro": tm.MultilabelF1Score(average="micro", **common),
        "acc": tm.MultilabelAccuracy(**common),
        "cm": tm.MultilabelConfusionMatrix(**common),
    }


def _binary_batches(gen: torch.Generator, n_batches: int = N_BATCHES, n: int = BIN_BATCH) -> list:
    """float32 logits (so the auto-sigmoid fires) and int64 {0, 1} clicks drawn from the
    logits' own sigmoid: a calibrated model, AUROC near 0.8."""
    out = []
    for _ in range(n_batches):
        logits = torch.randn(n, generator=gen) * 2
        target = (torch.rand(n, generator=gen) < torch.sigmoid(logits)).long()
        out.append((logits.cuda(), target.cuda()))
    return out


def _multilabel_batches(gen: torch.Generator, n_batches: int = N_BATCHES, n: int = ML_BATCH) -> list:
    """float32 logits and int64 {0, 1} labels drawn from them (about one in eight
    positive), ``ML_IGNORE`` on about 5 % of the target elements."""
    out = []
    for _ in range(n_batches):
        logits = torch.randn(n, ML_LABELS, generator=gen) * 2 - 2.5
        target = (torch.rand(n, ML_LABELS, generator=gen) < torch.sigmoid(logits)).long()
        target[torch.rand(n, ML_LABELS, generator=gen) < 0.05] = ML_IGNORE
        out.append((logits.cuda(), target.cuda()))
    return out


def _run_task_path(name: str, members_fn, groups: set, batches: list, forward_member) -> tuple:
    """One collection over ``batches`` (``update``, then ``compute``) beside one member's
    ``forward`` per batch, launches counted over exactly that; then every state against
    the same run on the CPU, which takes the card's own sigmoid of the logits (the
    port's ``_sigmoid``, computed on the card)."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.ops import multi_threshold, stat_counts

    mc = MetricCollection(members_fn())
    forward_gpu = forward_member()
    stat_counts.LAUNCHES = multi_threshold.LAUNCHES = 0
    batch_values = []
    for p, t in batches:
        mc.update(p, t)
        batch_values.append(forward_gpu(p, t))
    values = mc.compute()
    forward_final = forward_gpu.compute()
    torch.cuda.synchronize()
    launches = {"stat_counts": stat_counts.LAUNCHES, "multi_threshold": multi_threshold.LAUNCHES}

    got_groups = {frozenset(g) for g in mc.compute_groups.values()}
    if got_groups != groups:
        raise AssertionError(f"{name} compute groups {mc.compute_groups}, expected {groups}")
    if launches != {"stat_counts": 0, "multi_threshold": len(batches)}:
        raise AssertionError(f"{name} path launches {launches}, expected {len(batches)} of multi_threshold and none of stat_counts")

    ref = MetricCollection(members_fn(device="cpu"))
    forward_cpu = forward_member(device="cpu")
    for i, (p, t) in enumerate(batches):
        probs, target = _sigmoid(p).cpu(), t.cpu()
        ref.update(probs, target)
        _assert_close_any(f"{name} forward {i}", batch_values[i], forward_cpu(probs, target), ACC_ATOL)
    _assert_close_any(f"{name} forward compute", forward_final, forward_cpu.compute(), ACC_ATOL)
    ref_values = ref.compute()
    for member, metric in mc.items(keep_base=True):
        _assert_states_equal(f"{name} {member}", metric, ref[member])
        atol = AUROC_ATOL if member in ("auroc", "ap", "map", "auroc_exact") else ACC_ATOL
        _assert_close_any(f"{name} {member}", values[member], ref_values[member], atol)
    sigmoid = batches[0][0]
    mismatched = int((_sigmoid(sigmoid).cpu() != _sigmoid(sigmoid.cpu())).sum())
    summary = {
        "groups": sorted(sorted(g) for g in got_groups),
        "launches": launches,
        "values": {k: v.tolist() if v.numel() < 8 else f"{tuple(v.shape)} tensor" for k, v in values.items()},
        "sigmoid_cuda_vs_cpu_mismatches": [mismatched, sigmoid.numel()],
    }
    _log(f"  {name}: groups {summary['groups']}, {len(batches)} updates + forwards, launches {launches};"
         f" sigmoid cuda vs cpu differs on {mismatched} of {sigmoid.numel()} logits")
    return launches, values, summary


def _assert_close_any(name: str, got, want, atol: float) -> None:
    """Integer tensors exactly, float ones within ``atol``."""
    if got.dtype in (torch.int32, torch.int64):
        _equal(name, got.cpu(), want)
    else:
        _assert_close(name, got, want, atol)


def _updates_without_sync(name: str, metrics: list, batch: tuple) -> None:
    """Each metric's ``validate_args=False`` update under ``set_sync_debug_mode("error")``."""
    for metric in metrics:
        metric.update(*batch)  # warm: first-use allocations are not the point
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for metric in metrics:
            metric.update(*batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _log(f"  {name}: {', '.join(type(m).__name__ for m in metrics)} updates ran under set_sync_debug_mode('error')")


def run_binary_path(gen: torch.Generator):
    import torchmetrics_tpu_torch as tm

    batches = _binary_batches(gen)
    torch.cuda.synchronize()
    launches, values, summary = _run_task_path(
        "binary", _binary_members, _BINARY_GROUPS, batches, lambda device=None: tm.BinaryConfusionMatrix(device=device)
    )
    auroc, exact = float(values["auroc"]), float(values["auroc_exact"])
    if not (0.7 < exact < 0.95 and abs(auroc - exact) < 2e-3):
        raise AssertionError(f"binary AUROC of calibrated scores: binned {auroc}, exact {exact}")
    _updates_without_sync(
        "binary", [tm.BinaryF1Score(validate_args=False), tm.BinaryConfusionMatrix(validate_args=False)], batches[0]
    )
    return launches, batches, summary


def run_multilabel_path(gen: torch.Generator):
    import torchmetrics_tpu_torch as tm

    batches = _multilabel_batches(gen)
    torch.cuda.synchronize()
    launches, values, summary = _run_task_path(
        "multilabel", _multilabel_members, _MULTILABEL_GROUPS, batches,
        lambda device=None: tm.MultilabelF1Score(ML_LABELS, ignore_index=ML_IGNORE, device=device),
    )
    if not (0.7 < float(values["auroc"]) < 0.95 and 0.2 < float(values["map"]) < 0.8):
        raise AssertionError(f"multilabel AUROC {float(values['auroc'])}, mAP {float(values['map'])}")
    common = dict(num_labels=ML_LABELS, ignore_index=ML_IGNORE, validate_args=False)
    _updates_without_sync(
        "multilabel", [tm.MultilabelF1Score(**common), tm.MultilabelConfusionMatrix(**common)], batches[0]
    )
    return launches, batches, summary


_ROUTERS = (
    "StatScores", "Accuracy", "Precision", "Recall", "FBetaScore", "F1Score", "ConfusionMatrix",
    "PrecisionRecallCurve", "ROC", "AUROC", "AveragePrecision",
)
_ALL_TASKS = ("binary", "multiclass", "multilabel")
# the rest of the stat-scores family: router -> (its tasks, extra keyword arguments)
_FAMILY_ROUTERS = {
    "Specificity": (_ALL_TASKS, {}),
    "HammingDistance": (_ALL_TASKS, {}),
    "ExactMatch": (("multiclass", "multilabel"), {}),
    "JaccardIndex": (_ALL_TASKS, {}),
    "MatthewsCorrCoef": (_ALL_TASKS, {}),
    "CohenKappa": (("binary", "multiclass"), {"weights": "quadratic"}),
    "RecallAtFixedPrecision": (_ALL_TASKS, {"min_precision": 0.5, "thresholds": N_THRESH}),
    "PrecisionAtFixedRecall": (_ALL_TASKS, {"min_recall": 0.5, "thresholds": N_THRESH}),
    "SpecificityAtSensitivity": (_ALL_TASKS, {"min_sensitivity": 0.5, "thresholds": N_THRESH}),
}


def run_routers(gen: torch.Generator) -> None:
    """Every task router once per task on the card, against the same router on the CPU
    (probability inputs, so neither side runs a sigmoid or softmax of its own)."""
    import torchmetrics_tpu_torch as tm

    n, c = 4096, 10
    inputs = {
        "binary": (torch.rand(n, generator=gen), torch.randint(0, 2, (n,), generator=gen)),
        "multiclass": (torch.randn(n, c, generator=gen).softmax(dim=1), torch.randint(0, c, (n,), generator=gen)),
        "multilabel": (torch.rand(n, c, generator=gen), torch.randint(0, 2, (n, c), generator=gen)),
    }
    curves = ("PrecisionRecallCurve", "ROC", "AUROC", "AveragePrecision")
    table = {**{r: (_ALL_TASKS, {"thresholds": N_THRESH} if r in curves else {}) for r in _ROUTERS}, **_FAMILY_ROUTERS}
    for router, (tasks, extra) in table.items():
        for task in tasks:
            preds, target = inputs[task]
            kwargs = dict(task=task, num_classes=c if task == "multiclass" else None, **extra)
            if router != "CohenKappa":  # the kappa router has no multilabel task and no num_labels
                kwargs["num_labels"] = c if task == "multilabel" else None
            card, host = getattr(tm, router)(**kwargs), getattr(tm, router)(**kwargs, device="cpu")
            got, want = card(preds.cuda(), target.cuda()), host(preds, target)
            for i, (g, w) in enumerate(zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,))):
                _assert_close_any(f"router {router} {task} {type(card).__name__} output {i}", g, w, AUROC_ATOL)
    _log(f"  {len(table)} routers, once per task: equal to the CPU")
    # integer label inputs take the staged per-class count, not K1
    preds, target = inputs["multiclass"]
    _updates_without_sync(
        "multiclass labels", [tm.MulticlassF1Score(c, ignore_index=-1, validate_args=False)],
        (preds.argmax(dim=1).cuda(), target.cuda()),
    )


# ---------------------------------------------------------------- sync, two ranks


def _sync_members(**kwargs) -> dict:
    """The collection members plus an exact-mode AUROC, whose cat lists are ragged."""
    from torchmetrics_tpu_torch import MulticlassAUROC

    members = _collection_members(**kwargs)
    members["auroc_exact"] = MulticlassAUROC(CIFAR_CLASSES, **{k: v for k, v in kwargs.items() if k != "validate_args"})
    return members


def _sync_batches(rank: int) -> list:
    gen = torch.Generator().manual_seed(1000 + rank)
    return [
        (torch.randn(CIFAR_BATCH, CIFAR_CLASSES, generator=gen).cuda(), torch.randint(0, CIFAR_CLASSES, (CIFAR_BATCH,), generator=gen).cuda())
        for _ in range(SYNC_BATCHES[rank])
    ]


def _timed_computes(mc, repeats: int) -> float:
    """Median ms of a 2-rank ``compute`` (barrier first; cached values dropped)."""
    import torch.distributed as dist

    times = []
    for _ in range(repeats):
        for m in mc.values(copy_state=False):
            m._computed = None
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mc.compute()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _same_state_dict(a: dict, b: dict) -> bool:
    def flat(v):
        return torch.cat(v) if isinstance(v, list) else torch.as_tensor(v)

    return a.keys() == b.keys() and all(torch.equal(flat(a[k]), flat(b[k])) for k in a)


SYNC2_ROWS, SYNC2_QUERIES, SYNC2_DOCS = 1 << 16, 64, 100  # per batch: Pearson rows; retrieval queries x documents


def _sync2_batches(rank: int) -> list:
    """Three batches per rank, of equal shapes on both ranks (a ``None``-reduced list
    syncs element by element): Pearson ``(x, y)`` and retrieval ``(scores, relevance,
    query ids)``, each rank and batch with queries of its own."""
    gen = torch.Generator().manual_seed(2000 + rank)
    out = []
    for b in range(3):
        x = torch.randn(SYNC2_ROWS, generator=gen)
        y = 0.6 * x + torch.randn(SYNC2_ROWS, generator=gen)
        rel = (torch.rand(SYNC2_QUERIES * SYNC2_DOCS, generator=gen) < 0.05).long()
        scores = torch.randn(SYNC2_QUERIES * SYNC2_DOCS, generator=gen) + 2.0 * rel
        qids = (1000 * rank + SYNC2_QUERIES * b + torch.arange(SYNC2_QUERIES)).repeat_interleave(SYNC2_DOCS)
        out.append(tuple(t.cuda() for t in (x, y, scores, rel, qids)))
    return out


def _sync2_metrics() -> dict:
    from torchmetrics_tpu_torch.regression import PearsonCorrCoef
    from torchmetrics_tpu_torch.retrieval import RetrievalMAP

    metrics = {"pearson": PearsonCorrCoef(), "rmap": RetrievalMAP()}
    for m in metrics.values():
        m.persistent(True)
    return metrics


def _sync2_rank_body(rank: int, out_dir: str) -> dict:
    """A ``PearsonCorrCoef`` (its moments stack per rank, ``dist_reduce_fx=None``) and a
    ``RetrievalMAP`` (its ``None``-reduced lists gather element by element), each
    computed across the two ranks on the packed route."""
    metrics = _sync2_metrics()
    for x, y, scores, rel, qids in _sync2_batches(rank):
        metrics["pearson"].update(x, y)
        metrics["rmap"].update(scores, rel, qids)
    local = {k: m.state_dict() for k, m in metrics.items()}
    values = {k: m.compute() for k, m in metrics.items()}
    torch.cuda.synchronize()
    torch.save({"local": local, "values": values}, os.path.join(out_dir, f"rank{rank}_tm2.pt"))
    return {
        k: {"packed_syncs": m._epoch.stats.packed_syncs, "sync_collectives": m._epoch.stats.sync_collectives,
            "eager_fallbacks": m._epoch.stats.eager_fallbacks, "after_unsync_equal": _same_state_dict(local[k], m.state_dict())}
        for k, m in metrics.items()
    }


def _sync_rank_body(rank: int, out_dir: str) -> dict:
    import numpy as np

    from torchmetrics_tpu_torch import MetricCollection, MulticlassAUROC
    from torchmetrics_tpu_torch.parallel import gather_all_tensors
    from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan
    from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

    batches = _sync_batches(rank)
    mc = MetricCollection(_sync_members())
    for p, t in batches:
        mc.update(p, t)
    mc.persistent(True)
    local = mc.state_dict()
    # the layout the packed exchange must use: its buffers, and whether it needs the metadata gather
    plan = PackedSyncPlan([(g.owner, mc._modules[g.owner]) for g in mc._groups.values()], 2)
    meta = plan.metadata_local()
    plan.finalize(None if meta is None else np.stack([meta, meta]))
    values = mc.compute()
    torch.cuda.synchronize()
    stats = mc._epoch_sync.stats
    member_fallbacks = sum(m._epoch.stats.eager_fallbacks for m in mc.values(copy_state=False) if m._epoch is not None)
    result = {
        "packed_syncs": stats.packed_syncs,
        "sync_collectives": stats.sync_collectives,
        "eager_fallbacks": stats.eager_fallbacks + member_fallbacks,
        "members_synced_alone": sum(1 for m in mc.values(copy_state=False) if m._epoch is not None),
        "buffer_keys": plan.buffer_keys(),
        "rank_invariant": plan.rank_invariant,
        "after_unsync_equal": _same_state_dict(local, mc.state_dict()),
    }
    torch.save({"local": local, "values": values}, os.path.join(out_dir, f"rank{rank}.pt"))

    result["packed_compute_ms"] = _timed_computes(mc, repeats=5)
    eager = MetricCollection(_sync_members(dist_sync_fn=gather_all_tensors))
    for p, t in batches:
        eager.update(p, t)
    eager_values = eager.compute()
    for name, value in eager_values.items():
        if not torch.allclose(value.double(), values[name].double(), atol=AUROC_ATOL, rtol=0):
            raise AssertionError(f"rank {rank}: eager {name} {value.tolist()} vs packed {values[name].tolist()}")
    result["eager_compute_ms"] = _timed_computes(eager, repeats=5)

    # empty-versus-nonempty cat state on the eager route: both ranks must raise
    exact = MulticlassAUROC(CIFAR_CLASSES)
    if rank == 0:
        exact.update(*batches[0])
    try:
        exact.sync(dist_sync_fn=gather_all_tensors)
    except TorchMetricsUserError as err:
        result["ragged_error"] = str(err)[:120]
    else:
        raise AssertionError(f"rank {rank}: syncing an empty-versus-nonempty cat state did not raise")
    return result


def _gloo_rank(rank: int, port: int, out_dir: str, body, timeout_s: float, abandon: bool = False, world: int = 2) -> None:
    """One of ``world`` gloo ranks on the one card: runs ``body(rank, out_dir)``, reports to
    ``out_dir/rank<r>.json``, then waits for the other ranks before leaving the group.
    With ``abandon`` the rank exits without tearing the group down: a collective that a
    deadline escaped may still be pending in it, and the exit closes its sockets."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    try:
        result = {"ok": True, **body(rank, out_dir)}
    except Exception as err:  # reported to the parent, which fails the phase
        import traceback

        result = {"ok": False, "error": f"{type(err).__name__}: {err}\n{traceback.format_exc()[-3000:]}"}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    if not result["ok"]:
        # leave at once: the group's sockets close, so a peer waiting in a collective
        # fails now instead of at its timeout
        _log(f"  rank {rank} failed: {result['error']}")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and not all(os.path.exists(os.path.join(out_dir, f"rank{r}.json")) for r in range(world)):
        time.sleep(0.05)
    if abandon:
        sys.stdout.flush()
        os._exit(0)
    dist.destroy_process_group()


@contextlib.contextmanager
def _two_ranks(body, timeout_s: float, name: str, abandon: bool = False, world: int = 2):
    """Spawn ``world`` ranks (two by default) running ``body`` and yield ``(results,
    out_dir)``; fails on a hang (join timeout), a rank that exits without a result, or an
    error on any rank."""
    with tempfile.TemporaryDirectory() as out_dir:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_gloo_rank, args=(r, port, out_dir, body, timeout_s, abandon, world)) for r in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout_s
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        if hung:
            raise AssertionError(f"{name}: ranks {hung} still running after {timeout_s} s")
        results = []
        for rank, proc in enumerate(procs):
            path = os.path.join(out_dir, f"rank{rank}.json")
            if not os.path.exists(path):
                raise AssertionError(f"{name}: rank {rank} exited with {proc.exitcode} and no result")
            with open(path) as f:
                results.append(json.load(f))
            if not results[-1]["ok"]:
                raise AssertionError(f"{name}: rank {rank}: {results[-1]['error']}")
            if proc.exitcode != 0:
                raise AssertionError(f"{name}: rank {rank} exited with {proc.exitcode}")
        yield results, out_dir


def _phase9_rank_body(rank: int, out_dir: str) -> dict:
    from torchmetrics_tpu_torch.engine import engine_context

    with engine_context(False):  # the eager path, as in the earlier slices
        return {**_sync_rank_body(rank, out_dir), "moments_lists": _sync2_rank_body(rank, out_dir)}


def run_sync_phase() -> dict:
    """Two spawned ranks on the one card; fails on a hang (join timeout), an error on
    either rank, a route other than the packed one, or a value off the merge_state fold."""
    with _two_ranks(_phase9_rank_body, SYNC_JOIN_TIMEOUT_S, "sync phase") as (results, out_dir):
        for rank, res in enumerate(results):
            want_collectives = len(res["buffer_keys"]) + (0 if res["rank_invariant"] else 1)
            if (res["packed_syncs"], res["eager_fallbacks"], res["members_synced_alone"]) != (1, 0, 0):
                raise AssertionError(f"sync phase: rank {rank} did not take the packed route alone: {res}")
            if res["sync_collectives"] != want_collectives:
                raise AssertionError(f"sync phase: rank {rank} issued {res['sync_collectives']} collectives, expected {want_collectives}")
            if not res["after_unsync_equal"]:
                raise AssertionError(f"sync phase: rank {rank} did not get its local state back after compute")
            for name, st in res["moments_lists"].items():
                if (st["packed_syncs"], st["eager_fallbacks"], st["after_unsync_equal"]) != (1, 0, True):
                    raise AssertionError(f"sync phase: rank {rank} {name} off the packed route or not restored: {st}")
        saved = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(2)]
        saved2 = [torch.load(os.path.join(out_dir, f"rank{r}_tm2.pt")) for r in range(2)]

    # Pearson and RetrievalMAP: the two ranks' local states folded with merge_state
    moments_lists = {}
    for name in ("pearson", "rmap"):
        folded, other = _sync2_metrics()[name], _sync2_metrics()[name]
        folded.load_state_dict(saved2[0]["local"][name])
        other.load_state_dict(saved2[1]["local"][name])
        folded.merge_state(other)
        want = folded.compute()
        diffs = []
        for rank in range(2):
            got = saved2[rank]["values"][name]
            _assert_close(f"sync {name} rank {rank}", got, want, ACC_ATOL)
            diffs.append(abs(float(got) - float(want)))
        moments_lists[name] = {
            "value": float(want), "abs_diff_to_fold": diffs,
            "sync_collectives": [r["moments_lists"][name]["sync_collectives"] for r in results],
        }
    if tuple(folded.preds[0].shape) != (SYNC2_QUERIES * SYNC2_DOCS,) or len(folded.preds) != 6:
        raise AssertionError(f"sync rmap fold: {len(folded.preds)} list elements")

    # the reference: the two ranks' local states folded with merge_state, on the card
    others = _sync_members()
    for name, folded in _sync_members().items():
        other = others[name]
        folded.load_state_dict(saved[0]["local"], prefix=f"{name}.")
        other.load_state_dict(saved[1]["local"], prefix=f"{name}.")
        folded.merge_state(other)
        want = folded.compute()
        for rank in range(2):
            got = saved[rank]["values"][name]
            if want.dtype == torch.int32:
                _equal(f"sync {name} rank {rank}", got, want)
            else:
                _assert_close(f"sync {name} rank {rank}", got, want, AUROC_ATOL if "auroc" in name else ACC_ATOL)
    summary = {
        "ranks": 2,
        "backend": "gloo (CUDA tensors, one card)",
        "batches_per_rank": list(SYNC_BATCHES),
        "buffer_keys": results[0]["buffer_keys"],
        "sync_collectives": [r["sync_collectives"] for r in results],
        "packed_compute_ms": [r["packed_compute_ms"] for r in results],
        "eager_compute_ms": [r["eager_compute_ms"] for r in results],
        "moments_lists": moments_lists,
    }
    _log(f"  2 ranks: packed route, {summary['sync_collectives']} collectives ({summary['buffer_keys']} + metadata),"
         " values equal to the merge_state fold; ragged cat state raised on both ranks; Pearson's stacked moments"
         f" and RetrievalMAP's None lists on the packed route ({moments_lists}), equal to their merge_state fold")
    return summary


# ---------------------------------------------------------------- engine paths

# (size, forwards-or-updates) of each engine path; the accuracy path ends on a ragged batch
ACC_RAGGED = 5000  # bucket 8192: 3192 pad rows


def _engines_of(mc) -> list:
    """The update engines a collection ran: its fused engine and each owner's own."""
    out = [] if mc._fused_engine is None else [("fused", mc._fused_engine)]
    return out + [(name, m._engine) for name, m in mc.items(keep_base=True, copy_state=False) if m._engine is not None]


def _check_replays(name: str, engine) -> None:
    st = engine.stats
    if st.replays != st.dispatches - st.captures:
        raise AssertionError(f"{name}: {st.replays} replays, {st.dispatches} engine steps, {st.captures} captures")


def _assert_same_states(name: str, a, b, float_rtol: float = 0.0) -> None:
    """Every state of ``a`` exactly equal to ``b``'s (``b`` on the card or the CPU); float
    states within ``float_rtol`` when it is given."""
    for attr in a._defaults:
        x, y = getattr(a, attr), getattr(b, attr)
        if isinstance(x, list):  # 0-d pieces (a CatMetric of scalars) flattened
            x, y = (torch.cat([v.reshape(-1) for v in x]), torch.cat([v.reshape(-1) for v in y])) if x else (torch.zeros(0), torch.zeros(0))
        x, y = x.cpu(), y.cpu()
        same = torch.allclose(x, y, rtol=float_rtol, atol=0) if float_rtol and x.is_floating_point() else torch.equal(x, y)
        if x.dtype != y.dtype or x.shape != y.shape or not same:
            raise AssertionError(f"{name}: state {attr} differs: {x.flatten()[:8].tolist()} vs {y.flatten()[:8].tolist()}")


def run_engine_accuracy(acc_batches: list) -> dict:
    """``MulticlassAccuracy(1000)`` with the engine on (the default for a CUDA metric):
    16 ``forward``s of 8192x1000, then one ragged update of 5000 rows (bucket 8192,
    3192 pad rows). Values and states against the eager run on the card and the run on
    the CPU; launches counted over exactly that."""
    from torchmetrics_tpu_torch import MulticlassAccuracy, ops
    from torchmetrics_tpu_torch.engine import engine_context, engine_enabled
    from torchmetrics_tpu_torch.engine.bucketing import next_bucket

    if not engine_enabled(torch.device("cuda")):
        raise AssertionError("the engine is not on by default for a CUDA metric")
    ragged = tuple(x[:ACC_RAGGED] for x in acc_batches[0])
    ops.set_launch_counts({"stat_counts": 0, "multi_threshold": 0})
    metric = MulticlassAccuracy(num_classes=ACC_CLASSES, validate_args=False)
    vals = [metric(p, t) for p, t in acc_batches]
    metric.update(*ragged)
    final = metric.compute()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    st = metric._engine.stats
    with engine_context(False):
        eager = MulticlassAccuracy(num_classes=ACC_CLASSES, validate_args=False)
        eager_vals = [eager(p, t) for p, t in acc_batches]
        eager.update(*ragged)
        eager_final = eager.compute()
    host = MulticlassAccuracy(num_classes=ACC_CLASSES, validate_args=False, device="cpu")
    for p, t in acc_batches:
        host(p.cpu(), t.cpu())
    host.update(*(x.cpu() for x in ragged))
    for i, (g, w) in enumerate(zip(vals, eager_vals)):
        _equal(f"engine accuracy forward {i}", g, w)
    _equal("engine accuracy compute", final, eager_final)
    _assert_same_states("engine accuracy vs eager", metric, eager)
    _assert_same_states("engine accuracy vs cpu", metric, host)
    n = len(acc_batches) + 1
    pad = next_bucket(ACC_RAGGED) - ACC_RAGGED
    want = {"traces": 1, "captures": 1, "dispatches": n, "replays": n - 1, "eager_fallbacks": 0, "bucket_pad_rows": pad}
    got = {k: getattr(st, k) for k in want}
    if got != want:
        raise AssertionError(f"engine accuracy counters {got}, expected {want}")
    # the warm-up step's launch, the pad-row unit's launch once per signature, one per replay
    if launches != {"stat_counts": 2 + (n - 1), "multi_threshold": 0}:
        raise AssertionError(f"engine accuracy launches {launches}, expected {n + 1} of stat_counts")
    _log(f"  MulticlassAccuracy, engine on: {len(acc_batches)} forwards + a {ACC_RAGGED}-row update, {got},"
         f" launches {launches}; states equal to eager and to the CPU")
    return {"launches": launches, "engine": st.as_dict()}


def run_engine_task(name: str, members_fn, batches: list, cpu_inputs, fused_owners: set, falling_back: set) -> dict:
    """One path's collection with the engine on, against the eager run on the card and
    the run on the CPU: every state exact; the fused owners in one graph with 0
    fallbacks; the curves' owners falling back every update, as in the JAX package."""
    from torchmetrics_tpu_torch import MetricCollection, ops
    from torchmetrics_tpu_torch.engine import engine_context

    ops.set_launch_counts({"stat_counts": 0, "multi_threshold": 0})
    mc = MetricCollection(members_fn())
    for p, t in batches:
        mc.update(p, t)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    values = mc.compute()
    with engine_context(False):
        eager = MetricCollection(members_fn())
        for p, t in batches:
            eager.update(p, t)
        eager_values = eager.compute()
    host = MetricCollection(members_fn(device="cpu"))
    for p, t in batches:
        host.update(*cpu_inputs(p, t))
    for member in mc.keys(keep_base=True):
        _assert_same_states(f"engine {name} {member} vs eager", mc[member], eager[member])
        _assert_same_states(f"engine {name} {member} vs cpu", mc[member], host[member])
        if values[member].dtype != eager_values[member].dtype or not torch.equal(values[member], eager_values[member]):
            raise AssertionError(f"engine {name} {member}: {values[member]} vs eager {eager_values[member]}")
    fused = mc._fused_engine
    owners = {n for n, _ in fused.metrics} if fused else set()
    fused_names = {n for entry in fused._cache.values() for n, _ in getattr(entry, "members", ())}
    if fused_names != fused_owners:
        raise AssertionError(f"engine {name}: fused owners {fused_names}, expected {fused_owners} (of {owners})")
    st = fused.stats
    discovery = len(batches) - st.dispatches  # a first step without every signature declared discovers eagerly
    if st.eager_fallbacks or st.captures != 1 or discovery not in (0, 1):
        raise AssertionError(f"engine {name}: fused engine {st}")
    for engine_name, engine in _engines_of(mc):
        _check_replays(f"engine {name} {engine_name}", engine)
    for member in falling_back:
        own = mc._modules[member]._engine.stats
        if own.dispatches or own.eager_fallbacks != len(batches) - discovery:
            raise AssertionError(f"engine {name}: {member} should fall back every update: {own}")
    summary = {
        "launches": launches,
        "fused": st.as_dict(),
        "falling_back": {m: mc._modules[m]._engine.stats.as_dict() for m in sorted(falling_back)},
        "discovery_steps": discovery,
    }
    _log(f"  {name}, engine on: fused {sorted(fused_names)} in one graph ({st.dispatches} steps, {st.replays} replays),"
         f" {sorted(falling_back)} eager; launches {launches}; states equal to eager and to the CPU")
    return summary


def run_engine_scenarios(acc_batches: list, cifar_batches: list, binary_batches: list) -> None:
    """Reset, clone, a ``compute`` value that is a state, a retained member handle, and
    updates without a host sync, all with the engine on."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import engine_context

    def eager_over(make, batches):
        with engine_context(False):
            m = make()
            for p, t in batches:
                m.update(p, t)
        return m

    acc = lambda: tm.MulticlassAccuracy(num_classes=ACC_CLASSES, validate_args=False)  # noqa: E731
    m = acc()
    for p, t in acc_batches[:2]:
        m.update(p, t)
    twin = m.clone()
    m.reset()
    for p, t in acc_batches[2:4]:
        m.update(p, t)
    _assert_same_states("engine reset", m, eager_over(acc, acc_batches[2:4]))
    if twin._engine is not None:
        raise AssertionError("a clone kept its engine")
    _assert_same_states("engine clone", twin, eager_over(acc, acc_batches[:2]))

    cm = tm.MulticlassConfusionMatrix(CIFAR_CLASSES, validate_args=False)
    cm.update(*cifar_batches[0])
    held = cm.compute()
    kept = held.clone()
    cm.update(*cifar_batches[1])
    torch.cuda.synchronize()
    _equal("engine compute value after the next update", held, kept)

    members = lambda: {  # noqa: E731
        "acc": tm.MulticlassAccuracy(CIFAR_CLASSES, validate_args=False),
        "prec": tm.MulticlassPrecision(CIFAR_CLASSES, validate_args=False),
        "cm": tm.MulticlassConfusionMatrix(CIFAR_CLASSES, validate_args=False),
    }
    mc, handle = MetricCollection(members()), None
    for p, t in cifar_batches[:4]:
        mc.update(p, t)
        if handle is None:
            handle = mc["prec"]
    if mc._fused_engine is None or mc._fused_engine.stats.dispatches != 4:
        raise AssertionError("the retained-handle collection did not fuse every step")
    _equal("engine retained member handle", handle.compute(), eager_over(lambda: members()["prec"], cifar_batches[:4]).compute())

    # ragged batches of logits: under threshold 0.3 a zero pad row is a positive inside a
    # sigmoided batch, so these take exact-shape graphs; at 0.5 they ride their bucket
    ragged = [tuple(x[:n] for x in binary_batches[i % 2]) for i, n in enumerate((5000, 13, 5000, 13))]
    for threshold, bucketed in ((0.3, 0), (0.5, 4)):
        make_pair = lambda: MetricCollection({  # noqa: E731
            "acc": tm.BinaryAccuracy(threshold=threshold, validate_args=False),
            "cm": tm.BinaryConfusionMatrix(threshold=threshold, validate_args=False),
        })
        pair = make_pair()
        for p, t in ragged:
            pair.update(p, t)
        want = eager_over(make_pair, ragged)
        for member in ("acc", "cm"):
            _assert_same_states(f"engine ragged logits, threshold {threshold}, {member}", pair[member], want[member])
        st = pair._fused_engine.stats
        if st.bucketed_steps != bucketed or st.eager_fallbacks or st.dispatches != len(ragged):
            raise AssertionError(f"engine ragged logits, threshold {threshold}: {st}")

    # no host sync in an engine update: a replay (accuracy) and a fused replay (binary)
    pair = MetricCollection({"f1": tm.BinaryF1Score(validate_args=False), "cm": tm.BinaryConfusionMatrix(validate_args=False)})
    for _ in range(2):  # the first step builds and captures
        m.update(*acc_batches[0])
        pair.update(*binary_batches[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m.update(*acc_batches[1])
        pair.update(*binary_batches[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if pair._fused_engine.stats.replays != 2:
        raise AssertionError(f"the binary pair did not replay its fused graph: {pair._fused_engine.stats}")
    _log("  engine scenarios: reset, clone, compute value, retained handle, ragged logits at thresholds 0.3 and 0.5"
         " hold; an accuracy replay and a fused binary replay ran under set_sync_debug_mode('error')")


def _timed(step, iters: int = 16) -> dict:
    wall = _host_us_per_call(step, iters=iters)
    prof = _device_profile(step, iters=8)
    busy = prof["device_busy_us"]
    return {
        "update_us": wall,
        "device_busy_us": busy,
        "device_idle_share": None if busy is None else max(0.0, 1 - busy / wall),
        "device_ops": prof["device_ops"],
        "input_copy_us": prof["memcpy_us"],
        "kernels_us": prof["kernels_us"],
        "empty_windows": prof["empty_windows"],
    }


def time_engine(acc_batches: list, cifar_batches: list, binary_batches: list, multilabel_batches: list) -> dict:
    """Engine on against eager per ``update`` (and per accuracy ``forward``), in turns
    (eager, engine, engine, eager) in this one call: host µs to a device sync, device
    busy time and operations, idle share, and the batch copy into the static inputs."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import MetricCollection, ops
    from torchmetrics_tpu_torch.engine import engine_context

    paths = {
        "accuracy_update": (lambda: tm.MulticlassAccuracy(ACC_CLASSES, validate_args=False), acc_batches, "update"),
        "accuracy_forward": (lambda: tm.MulticlassAccuracy(ACC_CLASSES, validate_args=False), acc_batches, "forward"),
        "collection_update": (lambda: MetricCollection(_collection_members(validate_args=False)), cifar_batches, "update"),
        "binary_update": (lambda: MetricCollection(_binary_members(validate_args=False)), binary_batches, "update"),
        "multilabel_update": (lambda: MetricCollection(_multilabel_members(validate_args=False)), multilabel_batches, "update"),
    }
    out = {}
    for name, (make, batches, kind) in paths.items():
        runs = {"eager": [], "engine": []}
        # accuracy forward: its difference between the modes lies within the spread
        # between runs, so it takes three interleaved rounds
        for mode in ("eager", "engine", "engine", "eager") * (3 if name == "accuracy_forward" else 1):
            with engine_context(mode == "engine"):
                m = make()
                call = m.update if kind == "update" else m
                call(*batches[0])  # settles groups, builds and captures
                runs[mode].append(_timed(lambda i, call=call: call(*batches[i % len(batches)])))
        out[name] = {mode: _mean_runs(rs) for mode, rs in runs.items()}
        out[name]["update_us_runs"] = {mode: [r["update_us"] for r in rs] for mode, rs in runs.items()}
    # the launch counters against the profiler's kernel events over the same engine updates
    m = tm.MulticlassAccuracy(ACC_CLASSES, validate_args=False)
    m.update(*acc_batches[0])
    torch.cuda.synchronize()
    before = ops.launch_counts()["stat_counts"]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(8):
            m.update(*acc_batches[i % len(acc_batches)])
        torch.cuda.synchronize()
    counted = ops.launch_counts()["stat_counts"] - before
    events = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and "stat_counts_kernel" in e.name)
    if events == 0 or counted != events:
        raise AssertionError(f"stat_counts: {counted} launches counted over 8 engine updates, {events} kernel events")
    out["launch_count_check"] = {"updates": 8, "counted": counted, "profiler_kernel_events": events}
    _log(f"  engine times: " + ", ".join(
        f"{k} {v['eager']['update_us']:.1f} -> {v['engine']['update_us']:.1f} us" for k, v in out.items() if "eager" in v
    ) + f"; K1 launches counted {counted}, profiler events {events}")
    return out


# ---------------------------------------------------------------- the rest of the stat-scores family

TOP_K = 5  # the standard ImageNet top-5
KAPPA_RTOL = 2e-6  # kappa's weighted float32 sums over C * C cells, added in another order
FIXED_POINT = ("rfp", "pfr", "sas")
CURVES = ("auroc", "map", *FIXED_POINT)  # binned curve states: their updates read the host


def _imagenet_family(device=None, validate_args: bool = True) -> dict:
    """ImageNet-1k logits: a stat-scores group (K1) and a confusion-matrix group
    (a 1000 x 1000 int32 state)."""
    import torchmetrics_tpu_torch as tm

    common = dict(device=device, validate_args=validate_args)
    c = ACC_CLASSES
    return {
        "acc": tm.MulticlassAccuracy(c, average="macro", **common),
        "spec": tm.MulticlassSpecificity(c, average="macro", **common),
        "hamming": tm.MulticlassHammingDistance(c, average="macro", **common),
        "iou": tm.MulticlassJaccardIndex(c, **common),
        "mcc": tm.MulticlassMatthewsCorrCoef(c, **common),
        "kappa": tm.MulticlassCohenKappa(c, weights="quadratic", **common),
    }


def _cifar_fixed_point(device=None, validate_args: bool = True) -> dict:
    """CIFAR-10 scores: AUROC and the three fixed-point metrics over one binned state (K2)."""
    import torchmetrics_tpu_torch as tm

    common = dict(thresholds=N_THRESH, device=device, validate_args=validate_args)
    c = CIFAR_CLASSES
    return {
        "auroc": tm.MulticlassAUROC(c, **common),
        "rfp": tm.MulticlassRecallAtFixedPrecision(c, min_precision=0.5, **common),
        "pfr": tm.MulticlassPrecisionAtFixedRecall(c, min_recall=0.5, **common),
        "sas": tm.MulticlassSpecificityAtSensitivity(c, min_sensitivity=0.5, **common),
    }


def _binary_family(device=None, validate_args: bool = True) -> dict:
    """The click-through-rate eval: specificity, Hamming distance, IoU, MCC, kappa and
    recall at 90 % precision beside the binned AUROC."""
    import torchmetrics_tpu_torch as tm

    common = dict(device=device, validate_args=validate_args)
    return {
        "spec": tm.BinarySpecificity(**common),
        "hamming": tm.BinaryHammingDistance(**common),
        "iou": tm.BinaryJaccardIndex(**common),
        "mcc": tm.BinaryMatthewsCorrCoef(**common),
        "kappa": tm.BinaryCohenKappa(**common),
        "rfp": tm.BinaryRecallAtFixedPrecision(min_precision=0.9, thresholds=N_THRESH, **common),
        "auroc": tm.BinaryAUROC(thresholds=N_THRESH, **common),
    }


def _multilabel_family(device=None, validate_args: bool = True) -> dict:
    """MS-COCO's 80 categories with ignored labels: exact match, Hamming distance,
    specificity, IoU, MCC and precision at 50 % recall beside the binned macro mAP."""
    import torchmetrics_tpu_torch as tm

    common = dict(num_labels=ML_LABELS, ignore_index=ML_IGNORE, device=device, validate_args=validate_args)
    return {
        "exact": tm.MultilabelExactMatch(**common),
        "hamming": tm.MultilabelHammingDistance(**common),
        "spec": tm.MultilabelSpecificity(**common),
        "iou": tm.MultilabelJaccardIndex(**common),
        "mcc": tm.MultilabelMatthewsCorrCoef(**common),
        "pfr": tm.MultilabelPrecisionAtFixedRecall(min_recall=0.5, thresholds=N_THRESH, **common),
        "map": tm.MultilabelAveragePrecision(thresholds=N_THRESH, **common),
    }


# name -> (members, groups, K1 and K2 launches per eager update, inputs for the CPU run)
_FAMILY_PATHS = {
    "imagenet": (
        _imagenet_family,
        {frozenset({"acc", "spec", "hamming"}), frozenset({"iou", "mcc", "kappa"})},
        {"stat_counts": 1, "multi_threshold": 0},
        "logits",
    ),
    "cifar": (
        _cifar_fixed_point,
        {frozenset({"auroc", "rfp", "pfr", "sas"})},
        {"stat_counts": 0, "multi_threshold": 1},
        "logits",
    ),
    "binary": (
        _binary_family,
        {frozenset({"spec", "hamming"}), frozenset({"iou", "mcc", "kappa"}), frozenset({"rfp", "auroc"})},
        {"stat_counts": 0, "multi_threshold": 1},
        "sigmoid",
    ),
    "multilabel": (
        _multilabel_family,
        {frozenset({"exact"}), frozenset({"hamming", "spec"}), frozenset({"iou", "mcc"}), frozenset({"pfr", "map"})},
        {"stat_counts": 0, "multi_threshold": 1},
        "sigmoid",
    ),
}


def _outputs(value) -> tuple:
    return value if isinstance(value, tuple) else (value,)


def _close_to_cpu(name: str, member: str, got, want) -> float:
    """A value against the CPU run's: fixed-point operating points and MCC exactly
    (host float64 from equal counts), kappa relative ``KAPPA_RTOL``, curves ``AUROC_ATOL``,
    the other ratios ``ACC_ATOL``. Returns the largest absolute difference."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(_outputs(got), _outputs(want))):
        g, w = g.detach().cpu().double(), w.detach().cpu().double()
        diff = (g - w).abs().max().item() if g.numel() else 0.0
        if member in FIXED_POINT or member == "mcc":
            ok = torch.equal(g, w)
        elif member == "kappa":
            ok = bool(((g - w).abs() <= ACC_ATOL + KAPPA_RTOL * w.abs()).all())
        else:
            ok = bool(((g - w).abs() <= (AUROC_ATOL if member in ("auroc", "map") else ACC_ATOL)).all())
        if g.shape != w.shape or not ok or not torch.isfinite(g).all():
            raise AssertionError(f"family {name} {member} output {i}: cuda {g.tolist()} vs cpu {w.tolist()}")
        worst = max(worst, diff)
    return worst


def _bit_equal(name: str, got, want) -> None:
    for i, (g, w) in enumerate(zip(_outputs(got), _outputs(want))):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{name} output {i}: engine {g.tolist()} vs eager {w.tolist()}")


def run_family_path(name: str, batches: list) -> dict:
    """One path of the rest of the stat-scores family: 16 updates eagerly, then the same
    with the engine on, then ``compute``. Groups, K1 / K2 launches per update, every state
    against the CPU run and the engine run bit-equal to eager, values within the CPU
    tests' tolerances, the fixed-point curves falling back on every engine update, and
    the stat-scores and confusion-matrix updates with no host sync."""
    from torchmetrics_tpu_torch import MetricCollection, ops
    from torchmetrics_tpu_torch.engine import engine_context

    members_fn, groups, per_update, cpu_kind = _FAMILY_PATHS[name]
    n = len(batches)
    runs = {}
    for mode in ("eager", "engine"):
        with engine_context(mode == "engine"):
            ops.set_launch_counts({"stat_counts": 0, "multi_threshold": 0})
            mc = MetricCollection(members_fn(validate_args=False))
            for p, t in batches:
                mc.update(p, t)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            runs[mode] = (mc, launches, mc.compute())
    (eager, eager_launches, eager_values), (mc, engine_launches, values) = runs["eager"], runs["engine"]

    got_groups = {frozenset(g) for g in mc.compute_groups.values()}
    if got_groups != groups or {frozenset(g) for g in eager.compute_groups.values()} != groups:
        raise AssertionError(f"family {name}: compute groups {mc.compute_groups}, expected {groups}")
    want = {k: v * n for k, v in per_update.items()}
    if eager_launches != want:
        raise AssertionError(f"family {name}: eager launches {eager_launches}, expected {want}")
    # under the engine K2 stays eager (the curves fall back); K1 runs in the fused graph:
    # the warm-up step's launch, the pad-row unit's once per signature, one per replay
    want_engine = {"stat_counts": (n + 1) if per_update["stat_counts"] else 0, "multi_threshold": want["multi_threshold"]}
    if engine_launches != want_engine:
        raise AssertionError(f"family {name}: engine launches {engine_launches}, expected {want_engine}")

    to_cpu = (lambda p, t: (p.cpu(), t.cpu())) if cpu_kind == "logits" else (lambda p, t: (_sigmoid(p).cpu(), t.cpu()))
    host = MetricCollection(members_fn(device="cpu", validate_args=False))
    for p, t in batches:
        host.update(*to_cpu(p, t))
    host_values = host.compute()
    worst = {}
    for member in mc.keys(keep_base=True):
        _assert_same_states(f"family {name} {member} engine vs eager", mc[member], eager[member])
        _assert_same_states(f"family {name} {member} vs cpu", eager[member], host[member])
        _bit_equal(f"family {name} {member}", values[member], eager_values[member])
        worst[member] = _close_to_cpu(name, member, values[member], host_values[member])

    # the engine's split: fused owners with no fallback, the curve owner eager every update
    owners = [g.owner for g in mc._groups.values()]
    curve_owners = [o for o in owners if o in CURVES]
    discovery = 0 if all(mc._cse_signatures.get(o) is not None for o in owners) else 1
    fused = mc._fused_engine
    fused_stats = None if fused is None else fused.stats.as_dict()
    if len(owners) - len(curve_owners) >= 2:
        st = fused.stats
        if st.eager_fallbacks or st.dispatches != n - discovery or st.captures != 1:
            raise AssertionError(f"family {name}: fused engine {st}")
        _check_replays(f"family {name} fused", fused)
    for owner in curve_owners:
        own = mc._modules[owner]._engine.stats
        if own.dispatches or own.eager_fallbacks != n - discovery:
            raise AssertionError(f"family {name}: {owner} should fall back every update: {own}")

    # no host sync in the stat-scores and confusion-matrix updates (eager)
    eligible = [m for k, m in members_fn(validate_args=False).items() if k not in CURVES]
    if eligible:
        with engine_context(False):
            _updates_without_sync(f"family {name}", eligible, batches[0])
    summary = {
        "groups": sorted(sorted(g) for g in got_groups),
        "launches_eager": eager_launches,
        "launches_engine": engine_launches,
        "discovery_steps": discovery,
        "fused": fused_stats,
        "falling_back": {o: mc._modules[o]._engine.stats.as_dict() for o in curve_owners},
        "max_abs_diff_to_cpu": worst,
        "values": {k: [v.tolist() if v.numel() < 12 else f"{tuple(v.shape)} tensor" for v in _outputs(val)]
                   for k, val in values.items()},
    }
    _log(f"  family {name}: groups {summary['groups']}, {n} updates eager and with the engine, launches"
         f" {eager_launches} / {engine_launches}; states equal to the CPU, engine bit-equal to eager")
    return summary


def run_top_k(acc_batches: list) -> dict:
    """``MulticlassAccuracy(top_k=5)`` on the staged stable-sort path, eagerly and with
    the engine, against the CPU; its updates with no host sync; and the top-5 selection
    alone (``select_topk``) beside ``Tensor.topk`` at 8192 x 1000."""
    from torchmetrics_tpu_torch import MulticlassAccuracy, ops
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.utilities.data import select_topk

    batches = acc_batches[:4]
    runs = {}
    for mode in ("eager", "engine"):
        with engine_context(mode == "engine"):
            ops.set_launch_counts({"stat_counts": 0, "multi_threshold": 0})
            m = MulticlassAccuracy(ACC_CLASSES, top_k=TOP_K, validate_args=False)
            for p, t in batches:
                m.update(p, t)
            runs[mode] = (m, m.compute(), ops.launch_counts())
    (eager, eager_value, _), (engine, value, launches) = runs["eager"], runs["engine"]
    host = MulticlassAccuracy(ACC_CLASSES, top_k=TOP_K, validate_args=False, device="cpu")
    for p, t in batches:
        host.update(p.cpu(), t.cpu())
    _assert_same_states("top-5 engine vs eager", engine, eager)
    _assert_same_states("top-5 vs cpu", eager, host)
    _bit_equal("top-5", value, eager_value)
    _assert_close("top-5 vs cpu", value, host.compute(), ACC_ATOL)
    st = engine._engine.stats
    if st.eager_fallbacks or st.dispatches != len(batches):
        raise AssertionError(f"top-5 under the engine: {st}")
    with engine_context(False):
        _updates_without_sync("top-5", [MulticlassAccuracy(ACC_CLASSES, top_k=TOP_K, validate_args=False)], batches[0])
    for _ in range(2):  # the first engine step builds and captures
        engine.update(*batches[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.update(*batches[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    inputs = [p for p, _ in acc_batches[:4]]
    sort_ms = _median_ms(lambda i: select_topk(inputs[i % 4], TOP_K, dim=1), iters=50)
    sort_prof = _device_profile(lambda i: select_topk(inputs[i % 4], TOP_K, dim=1), iters=20)
    topk_ms = _median_ms(lambda i: inputs[i % 4].topk(TOP_K, dim=1), iters=50)
    out = {
        "launches_engine": launches,
        "engine": st.as_dict(),
        "select_topk_ms": sort_ms,
        "select_topk_device_us": sort_prof["device_busy_us"],
        "select_topk_device_ops": sort_prof["device_ops"],
        "select_topk_kernels_us": sort_prof["kernels_us"],
        "tensor_topk_ms": topk_ms,
        "value": float(value),
    }
    _log(f"  top-5 accuracy: engine {st.dispatches} steps, no fallback, equal to eager and to the CPU;"
         f" select_topk {sort_ms * 1e3:.1f} us (Tensor.topk {topk_ms * 1e3:.1f} us)")
    return out


def check_sigmoid(binary_batches: list, multilabel_batches: list) -> dict:
    """The port's sigmoid on the card: the same logits sliced from a 2^20 (or 8192 x 80)
    batch and taken as a 7-row batch give bit-identical probabilities; and how often the
    card's and the CPU's results differ, for the port's helper and for ``torch.sigmoid``."""
    out = {}
    for name, x in (("binary_2^20", binary_batches[0][0]), ("multilabel_8192x80", multilabel_batches[0][0])):
        whole, part = _sigmoid(x), _sigmoid(x[:7].clone())
        if not torch.equal(whole[:7], part):
            raise AssertionError(f"sigmoid {name}: the first 7 rows differ from the same rows as a batch of 7")
        old_whole, old_part = torch.sigmoid(x), torch.sigmoid(x[:7].clone())
        x_cpu = x.cpu()
        out[name] = {
            "values": x.numel(),
            "helper_cuda_vs_cpu": int((whole.cpu() != _sigmoid(x_cpu)).sum()),
            "torch_sigmoid_cuda_vs_cpu": int((old_whole.cpu() != torch.sigmoid(x_cpu)).sum()),
            "torch_sigmoid_cuda_7_rows_vs_sliced": int((old_whole[:7] != old_part).sum()),
            "torch_sigmoid_cpu_7_rows_vs_sliced": int((torch.sigmoid(x_cpu)[:7] != torch.sigmoid(x_cpu[:7].clone())).sum()),
        }
    _log(f"  sigmoid: sliced rows bit-identical on the card; card vs CPU differ on "
         + ", ".join(f"{k} {v['helper_cuda_vs_cpu']} of {v['values']} (torch.sigmoid {v['torch_sigmoid_cuda_vs_cpu']})"
                     for k, v in out.items()))
    return out


def time_family(batches_by_path: dict) -> dict:
    """Each family path's collection ``update`` (``validate_args=False``), engine on
    against eager, in turns (eager, engine, engine, eager) in this one call: host µs to a
    device sync, device busy, operations, idle share and the largest device items."""
    from torchmetrics_tpu_torch import MetricCollection, MulticlassAccuracy
    from torchmetrics_tpu_torch.engine import engine_context

    paths = {name: (lambda fn=_FAMILY_PATHS[name][0]: MetricCollection(fn(validate_args=False)), batches)
             for name, batches in batches_by_path.items()}
    paths["top5"] = (lambda: MulticlassAccuracy(ACC_CLASSES, top_k=TOP_K, validate_args=False), batches_by_path["imagenet"])
    out = {}
    for name, (make, batches) in paths.items():
        runs = {"eager": [], "engine": []}
        for mode in ("eager", "engine", "engine", "eager"):
            with engine_context(mode == "engine"):
                m = make()
                m.update(*batches[0])  # settles groups, builds and captures
                runs[mode].append(_timed(lambda i, m=m: m.update(*batches[i % len(batches)])))
        out[name] = {mode: _mean_runs(rs) for mode, rs in runs.items()}
        out[name]["update_us_runs"] = {mode: [r["update_us"] for r in rs] for mode, rs in runs.items()}
    _log("  family times: " + ", ".join(
        f"{k} {v['eager']['update_us']:.1f} -> {v['engine']['update_us']:.1f} us" for k, v in out.items()
    ))
    return out


# ---------------------------------------------------------------- the eval loop: aggregators, wrappers, checkpoints

EVAL_EPOCH = 8  # MetricTracker: 2 epochs of 8 batches; the resume point
BOOT_COPIES, POISSON_BATCHES, NAN_BATCHES = 10, 4, 4
SUM_RTOL = 1e-6  # float sums and means: the card and the CPU add in other orders


class _EvalInputs:
    """Phase 13's batches on the card and their CPU copies: ImageNet-1k logits and
    targets (phase 4's), their per-sample cross-entropy and its per-batch mean, MS-COCO
    multilabel logits and targets (phase 7's; the CPU copy holds the card's sigmoid, as
    the earlier phases feed it), and 4 of those with ~1 % NaN rows."""

    def __init__(self, acc_batches: list, multilabel_batches: list, gen: torch.Generator) -> None:
        import torch.nn.functional as F

        self.acc = acc_batches
        self.loss = [F.cross_entropy(p, t, reduction="none") for p, t in acc_batches]
        self.batch_loss = [x.mean() for x in self.loss]
        self.ml = multilabel_batches
        self.ml_nan = []
        for p, t in multilabel_batches[:NAN_BATCHES]:
            p = p.clone()
            rows = torch.randperm(ML_BATCH, generator=gen)[: ML_BATCH // 100]
            p[rows.cuda(), torch.randint(0, ML_LABELS, (rows.numel(),), generator=gen).cuda()] = float("nan")
            self.ml_nan.append((p, t))
        torch.cuda.synchronize()
        self.cpu = {
            "acc": [(p.cpu(), t.cpu()) for p, t in self.acc],
            "loss": [x.cpu() for x in self.loss],
            "batch_loss": [x.cpu() for x in self.batch_loss],
            "ml": [(_sigmoid(p).cpu(), t.cpu()) for p, t in self.ml],
            "ml_nan": [(_sigmoid(p).cpu(), t.cpu()) for p, t in self.ml_nan],
        }

    def get(self, kind: str, i: int, cpu: bool):
        return self.cpu[kind][i] if cpu else getattr(self, kind)[i]


def _eval_members() -> dict:
    """name -> (make(**kw), step(metric, inputs, i, cpu), batches, K1 and K2 launches per
    eager update). Every classification member skips validation (a validating update
    reads the host, and so falls back under the engine)."""
    import torchmetrics_tpu_torch as tm

    vf = {"validate_args": False}

    def acc(**kw):
        return tm.MulticlassAccuracy(ACC_CLASSES, **vf, **kw)

    def on(kind):
        def step(m, inp, i, cpu):
            x = inp.get(kind, i, cpu)
            m.update(*x) if isinstance(x, tuple) else m.update(x)

        return step

    def multitask_step(m, inp, i, cpu):
        (p, t), (mp, mt) = inp.get("acc", i, cpu), inp.get("ml", i, cpu)
        m.update({"classes": p, "labels": mp}, {"classes": t, "labels": mt})

    def tracker_step(m, inp, i, cpu):
        if i % EVAL_EPOCH == 0:
            m.increment()
        m.update(*inp.get("acc", i, cpu))

    def tracker(**kw):
        return tm.MetricTracker(tm.MetricCollection({"acc": acc(**kw), "f1": tm.MulticlassF1Score(ACC_CLASSES, **vf, **kw)}))

    boot = dict(num_bootstraps=BOOT_COPIES, quantile=[0.025, 0.975], raw=True)
    labels = [f"class_{c}" for c in range(ACC_CLASSES)]
    auroc = dict(thresholds=N_THRESH, ignore_index=ML_IGNORE, **vf)
    none = {"stat_counts": 0, "multi_threshold": 0}
    k1 = {"stat_counts": 1, "multi_threshold": 0}
    return {
        "mean_float": (lambda **kw: tm.MeanMetric(nan_strategy=0.0, **kw), on("loss"), N_BATCHES, none),
        "mean_warn": (lambda **kw: tm.MeanMetric(**kw), on("loss"), N_BATCHES, none),
        "sum": (lambda **kw: tm.SumMetric(nan_strategy=0.0, **kw), on("batch_loss"), N_BATCHES, none),
        "max": (lambda **kw: tm.MaxMetric(nan_strategy=0.0, **kw), on("batch_loss"), N_BATCHES, none),
        "min": (lambda **kw: tm.MinMetric(nan_strategy=0.0, **kw), on("batch_loss"), N_BATCHES, none),
        "cat": (lambda **kw: tm.CatMetric(**kw), on("batch_loss"), N_BATCHES, none),
        "sum_float64": (lambda **kw: tm.SumMetric(**kw).set_dtype(torch.float64), on("batch_loss"), N_BATCHES, none),
        "running_mean": (lambda **kw: tm.RunningMean(window=5, nan_strategy=0.0, **kw), on("batch_loss"), N_BATCHES, none),
        "classwise": (lambda **kw: tm.ClasswiseWrapper(acc(average=None, **kw), labels=labels), on("acc"), N_BATCHES, k1),
        "minmax": (lambda **kw: tm.MinMaxMetric(acc(**kw)), on("acc"), N_BATCHES, k1),
        "one_minus_acc": (lambda **kw: 1 - acc(**kw), on("acc"), N_BATCHES, k1),
        "boot_multinomial": (
            lambda **kw: tm.BootStrapper(acc(**kw), sampling_strategy="multinomial", **boot), on("acc"), N_BATCHES,
            {"stat_counts": BOOT_COPIES, "multi_threshold": 0},
        ),
        "boot_poisson": (
            lambda **kw: tm.BootStrapper(acc(**kw), sampling_strategy="poisson", **boot), on("acc"), POISSON_BATCHES,
            {"stat_counts": BOOT_COPIES, "multi_threshold": 0},
        ),
        "multioutput_auroc": (
            lambda **kw: tm.MultioutputWrapper(tm.BinaryAUROC(**auroc, **kw), num_outputs=ML_LABELS, remove_nans=False),
            on("ml"), N_BATCHES, {"stat_counts": 0, "multi_threshold": ML_LABELS},
        ),
        "multioutput_auroc_nan": (
            lambda **kw: tm.MultioutputWrapper(tm.BinaryAUROC(**auroc, **kw), num_outputs=ML_LABELS, remove_nans=True),
            on("ml_nan"), NAN_BATCHES, {"stat_counts": 0, "multi_threshold": ML_LABELS},
        ),
        "multitask": (
            lambda **kw: tm.MultitaskWrapper({
                "classes": acc(**kw),
                "labels": tm.MultilabelAveragePrecision(ML_LABELS, thresholds=N_THRESH, ignore_index=ML_IGNORE, **vf, **kw),
            }),
            multitask_step, N_BATCHES, {"stat_counts": 1, "multi_threshold": 1},
        ),
        "tracker": (tracker, tracker_step, N_BATCHES, k1),
    }


def _nested(obj, path: str = ""):
    """``(path, object)`` for ``obj`` and every metric, collection and tracker inside it
    (wrappers, composites, collections and trackers opened), in a fixed order."""
    import torchmetrics_tpu_torch as tm

    yield path, obj
    if isinstance(obj, tm.MetricTracker):
        children = [(f"[{i}]", m) for i, m in enumerate(obj._metrics)]
    elif isinstance(obj, tm.MetricCollection):
        children = [(f".{k}", m) for k, m in obj.items(keep_base=True, copy_state=False)]
    elif isinstance(obj, tm.Metric):
        children = []
        for key, value in sorted((k, v) for k, v in vars(obj).items() if k != "_modules") + sorted(obj._modules.items()):
            if isinstance(value, list):
                children += [(f".{key}[{i}]", v) for i, v in enumerate(value)]
            elif isinstance(value, dict):
                children += [(f".{key}.{k}", v) for k, v in value.items()]
            else:
                children.append((f".{key}", value))
    else:
        children = []
    for suffix, child in children:
        if isinstance(child, (tm.Metric, tm.MetricCollection, tm.MetricTracker)):
            yield from _nested(child, path + suffix)


def _leaf_metrics(obj) -> list:
    """``(path, metric)`` for every metric with states inside ``obj``."""
    import torchmetrics_tpu_torch as tm

    return [(p or type(m).__name__, m) for p, m in _nested(obj) if isinstance(m, tm.Metric) and m._defaults]


def _member_engines(obj) -> list:
    """Every update engine inside ``obj``: each metric's own and each collection's fused one."""
    import torchmetrics_tpu_torch as tm

    engines = []
    for _, x in _nested(obj):
        engine = x._fused_engine if isinstance(x, tm.MetricCollection) else getattr(x, "_engine", None)
        if engine is not None:
            engines.append(engine)
    return engines


def _engine_summary(obj) -> dict:
    engines = _member_engines(obj)
    reasons: dict = {}
    for e in engines:
        for r, n in e.stats.fallback_reasons.items():
            reasons[r] = reasons.get(r, 0) + n
    total = lambda f: sum(getattr(e.stats, f) for e in engines)  # noqa: E731
    return {"engines": len(engines), "dispatches": total("dispatches"), "replays": total("replays"),
            "captures": total("captures"), "traces": total("traces"), "fallbacks": total("eager_fallbacks"),
            "fallback_reasons": reasons}


def _flat_values(value) -> list:
    """A compute result as a flat list of tensors (dicts by key, in order)."""
    if isinstance(value, dict):
        return [t for k in sorted(value) for t in _flat_values(value[k])]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _flat_values(v)]
    return [value if isinstance(value, torch.Tensor) else torch.as_tensor(value)]


def _hold_states_to_cpu(name: str, card, host) -> None:
    """Integer states exactly, float states within ``SUM_RTOL`` (dtype equal)."""
    got, want = _leaf_metrics(card), _leaf_metrics(host)
    if [p for p, _ in got] != [p for p, _ in want]:
        raise AssertionError(f"eval {name}: leaf metrics {[p for p, _ in got]} vs cpu {[p for p, _ in want]}")
    for (path, g), (_, c) in zip(got, want):
        _assert_same_states(f"eval {name}{path} vs cpu", g, c, float_rtol=SUM_RTOL)


def _hold_values_to_cpu(name: str, got, want) -> float:
    atol = AUROC_ATOL if name.startswith(("multioutput", "multitask")) else ACC_ATOL
    worst = 0.0
    for i, (g, w) in enumerate(zip(_flat_values(got), _flat_values(want))):
        g, w = g.detach().cpu().double(), w.detach().cpu().double()
        diff = (g - w).abs().max().item() if g.numel() else 0.0
        bound = atol + SUM_RTOL * w.abs()
        if g.shape != w.shape or not torch.isfinite(g).all() or not bool(((g - w).abs() <= bound).all()):
            raise AssertionError(f"eval {name} value {i}: cuda {g.flatten()[:8].tolist()} vs cpu {w.flatten()[:8].tolist()}")
        worst = max(worst, diff)
    return worst


class _RecordingSampler:
    """Stands in for the bootstrap sampler: records every draw of the real one, or
    replays recorded draws (on the CPU, for the CPU run)."""

    def __init__(self, real) -> None:
        self.real, self.draws, self.replay = real, [], None

    def __call__(self, size, strategy, generator):
        if self.replay is not None:
            return self.replay.pop(0)
        idx = self.real(size, strategy, generator)
        self.draws.append(idx)
        return idx


def _per_step_checks(name: str, m, inp, i: int, cpu: bool):
    """What a member checks after each update: the running mean against the mean of
    the last <= 5 batch losses, the min / max computed after every update."""
    if name == "running_mean":
        window = torch.stack([inp.get("batch_loss", j, cpu) for j in range(max(0, i - 4), i + 1)])
        got, want = m.compute().double(), window.double().mean()
        if not abs(float(got) - float(want)) <= SUM_RTOL * abs(float(want)):
            raise AssertionError(f"eval running_mean after update {i}: {float(got)} vs {float(want)} over its window")
        return got
    if name == "minmax":
        return m.compute()
    return None


def run_eval_loop(inp: "_EvalInputs") -> dict:
    """Phase 13: each member over its batches eagerly, then with the engine on, then on
    the CPU; states and values against the CPU, the engine run bit-equal to eager, K1 /
    K2 launches per member, the bootstrap draws, the resume from checkpoints, the
    engine's replays / captures / fallbacks by reason."""
    from torchmetrics_tpu_torch import ops
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.wrappers import bootstrapping

    members = _eval_members()
    sampler = _RecordingSampler(bootstrapping._bootstrap_sampler)
    bootstrapping._bootstrap_sampler = sampler
    out: dict = {}
    values: dict = {}
    resume = None
    try:
        for name, (make, step, n, per_update) in members.items():
            t0 = time.perf_counter()
            runs = {}
            for mode in ("eager", "engine"):
                with engine_context(mode == "engine"):
                    sampler.draws = []
                    ops.set_launch_counts({"stat_counts": 0, "multi_threshold": 0})
                    m = make()
                    if hasattr(m, "_generator"):
                        m._generator.manual_seed(13)
                    checks = []
                    for i in range(n):
                        if mode == "engine" and i == EVAL_EPOCH and name in ("mean_float", "classwise", "tracker"):
                            resume = _save_resume_point(resume, name, m)
                        step(m, inp, i, False)
                        checks.append(_per_step_checks(name, m, inp, i, False))
                    torch.cuda.synchronize()
                    launches = ops.launch_counts()
                    runs[mode] = (m, m.compute(), launches, sampler.draws, checks)
            (eager, eager_val, eager_launches, eager_draws, eager_checks) = runs["eager"]
            (engine, engine_val, engine_launches, engine_draws, engine_checks) = runs["engine"]
            for (path, a), (_, b) in zip(_leaf_metrics(engine), _leaf_metrics(eager)):
                _assert_same_states(f"eval {name}{path} engine vs eager", a, b)
            for i, (g, w) in enumerate(zip(_flat_values(engine_val), _flat_values(eager_val))):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(f"eval {name} value {i}: engine {g.flatten()[:8].tolist()} vs eager {w.flatten()[:8].tolist()}")
            values[name] = eager_val
            if name == "one_minus_acc":
                for run, val in ((eager, eager_val), (engine, engine_val)):
                    if not torch.equal(val, 1 - run.metric_b.compute()):
                        raise AssertionError(f"eval 1 - acc: {float(val)} is not 1 - {float(run.metric_b.compute())}")
            if len(eager_draws) != len(engine_draws) or any(not torch.equal(a, b) for a, b in zip(eager_draws, engine_draws)):
                raise AssertionError(f"eval {name}: the engine run drew other bootstrap rows than the eager run")

            want = {k: v * n for k, v in per_update.items()}
            if eager_launches != want:
                raise AssertionError(f"eval {name}: eager launches {eager_launches}, expected {want}")
            want_engine = _engine_launches(name, engine, n, per_update, engine_draws)
            if engine_launches != want_engine:
                raise AssertionError(f"eval {name}: engine launches {engine_launches}, expected {want_engine}")

            sampler.replay = [d.cpu() for d in eager_draws]
            t_card = time.perf_counter() - t0
            host = make(device="cpu")
            host_checks = []
            for i in range(n):
                step(host, inp, i, True)
                host_checks.append(_per_step_checks(name, host, inp, i, True))
            sampler.replay = None
            _hold_states_to_cpu(name, eager, host)
            worst = _hold_values_to_cpu(name, eager_val, host.compute())
            for i, (g, w) in enumerate(zip(eager_checks, host_checks)):
                if g is not None:
                    worst = max(worst, _hold_values_to_cpu(f"{name} step {i}", g, w))
            for i, (g, w) in enumerate(zip(engine_checks, eager_checks)):
                if g is not None and any(not torch.equal(a, b) for a, b in zip(_flat_values(g), _flat_values(w))):
                    raise AssertionError(f"eval {name} step {i}: engine {g} vs eager {w}")
            out[name] = {
                "updates": n,
                "launches_eager": eager_launches,
                "launches_engine": engine_launches,
                "engine": _engine_summary(engine),
                "bootstrap_draws": [int(d.numel()) for d in eager_draws][:BOOT_COPIES * 2],
                "max_abs_diff_to_cpu": worst,
                "seconds_card_runs": t_card,
                "seconds_with_cpu_run": time.perf_counter() - t0,
            }
            _log(f"  eval {name}: {n} updates held; launches {eager_launches} / {engine_launches};"
                 f" {t_card:.1f} s on the card, {out[name]['seconds_with_cpu_run']:.1f} s with the CPU run")
            _check_member_engine(name, out[name]["engine"], n)
            if name == "tracker":
                out[name].update(_tracker_report(engine, host))
            if name in ("tracker", "boot_multinomial"):
                fp = engine.state_footprint() if name == "boot_multinomial" else engine[-1].state_footprint()
                out[name]["state_footprint"] = fp
                if name == "boot_multinomial":
                    out[name]["copies_state_bytes"] = sum(c.state_footprint()["total_bytes"] for c in engine.metrics)
                _log(f"  eval {name} state_footprint: {fp}"
                     + (f"; its {BOOT_COPIES} copies hold {out[name]['copies_state_bytes']} bytes" if name == "boot_multinomial" else
                        f"; best_metric {out[name]['best_metric']} at step {out[name]['best_step']},"
                        f" captures per epoch {out[name]['captures_per_epoch']}"))
            runs.clear()
        a, b = values["mean_float"], values["mean_warn"]
        if not torch.allclose(a, b, rtol=SUM_RTOL, atol=0):
            raise AssertionError(f"eval: MeanMetric(nan_strategy=0.0) {float(a)} vs MeanMetric() {float(b)}")
        out["mean_float_equals_mean_warn_bitwise"] = bool(torch.equal(a, b))
        out["resume"] = _resume(resume, inp)
    finally:
        bootstrapping._bootstrap_sampler = sampler.real
    _log(f"  eval loop: {len(members)} members eagerly, with the engine and on the CPU; states held, engine"
         f" bit-equal to eager; launches eager K1 {sum(v['launches_eager']['stat_counts'] for v in out.values() if isinstance(v, dict) and 'launches_eager' in v)},"
         f" K2 {sum(v['launches_eager']['multi_threshold'] for v in out.values() if isinstance(v, dict) and 'launches_eager' in v)}")
    return out


def _engine_launches(name: str, engine, n: int, per_update: dict, draws: list) -> dict:
    """K1 / K2 launches expected with the engine on. The curves (BinaryAUROC, mAP) fall
    back, so K2 runs eagerly, once per update. K1 runs in the graphs: per signature a
    warm-up step's launch and the pad-row unit's, then one per replay, so n + 1 for a
    metric fed one batch shape; the Poisson copies' resamples fall into one or two
    shape buckets each; the tracker's epochs each capture their own graph."""
    from torchmetrics_tpu_torch.engine.bucketing import next_bucket

    k1, k2 = per_update["stat_counts"], per_update["multi_threshold"]
    if name == "boot_poisson":
        per_copy = [draws[c::BOOT_COPIES] for c in range(BOOT_COPIES)]
        k1_total = sum(len(d) + len({next_bucket(int(x.numel())) for x in d}) for d in per_copy)
    elif name == "tracker":
        k1_total = (n // EVAL_EPOCH) * (EVAL_EPOCH + 1)
    else:
        k1_total = k1 * (n + 1)
    return {"stat_counts": k1_total, "multi_threshold": k2 * n}


def _check_member_engine(name: str, st: dict, n: int) -> None:
    """The aggregators with a float strategy replay with no fallback; the host-reading
    strategies and the list state fall back on every update, counted by reason."""
    if name in ("mean_float", "sum", "max", "min"):
        if st["fallbacks"] or st["captures"] != 1 or st["replays"] != n - 1:
            raise AssertionError(f"eval {name}: should replay every update after its capture: {st}")
    expected = {"mean_warn": "host-read", "sum_float64": "host-read", "cat": "list-state"}.get(name)
    if expected and (st["dispatches"] or not any(r.startswith(expected) for r in st["fallback_reasons"])):
        raise AssertionError(f"eval {name}: should fall back ({expected}) on every update: {st}")


def _tracker_report(card, host) -> dict:
    best, step = card.best_metric(return_step=True)
    want_best, want_step = host.best_metric(return_step=True)
    if step != want_step or any(abs(best[k] - want_best[k]) > ACC_ATOL for k in best):
        raise AssertionError(f"eval tracker best_metric: cuda {best, step} vs cpu {want_best, want_step}")
    captures = [_engine_summary(epoch)["captures"] for epoch in card._metrics]
    if captures != [1] * len(captures):
        raise AssertionError(f"eval tracker: each epoch's copy should capture its own graph once, got {captures}")
    return {"best_metric": best, "best_step": step, "captures_per_epoch": captures}


def _save_resume_point(resume, name: str, metric):
    """After batch ``EVAL_EPOCH``: save the mean, the classwise wrapper's inner metric and
    the tracker's current collection to ``.npz`` files."""
    from torchmetrics_tpu_torch.utilities.checkpoint import save_metric_state

    if resume is None:
        resume = {"dir": tempfile.TemporaryDirectory(), "saved": {}}
    target = metric.metric if name == "classwise" else metric[-1] if name == "tracker" else metric
    path = os.path.join(resume["dir"].name, f"{name}.npz")
    save_metric_state(target, path)
    resume["saved"][name] = path
    return resume


def _resume(resume, inp) -> dict:
    """Restore each checkpoint into fresh metrics on the card (engine on), run the rest
    of the batches, and hold the states to the uninterrupted engine run exactly."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.utilities.checkpoint import restore_metric_state

    members = _eval_members()
    out = {}
    try:
        with engine_context(True):
            for name, path in resume["saved"].items():
                make, step, n, _ = members[name]
                whole = make()
                for i in range(n):
                    step(whole, inp, i, False)
                fresh = make()
                if name == "tracker":
                    fresh.increment()
                    restore_metric_state(fresh[-1], path)
                elif name == "classwise":
                    restore_metric_state(fresh.metric, path)
                else:
                    restore_metric_state(fresh, path)
                for i in range(EVAL_EPOCH, n):
                    step(fresh, inp, i, False)
                torch.cuda.synchronize()
                pairs = list(zip(_leaf_metrics(fresh), _leaf_metrics(whole)))
                if len(pairs) != len(_leaf_metrics(whole)):
                    raise AssertionError(f"eval resume {name}: {len(pairs)} leaf metrics, expected {len(_leaf_metrics(whole))}")
                for (path_, a), (_, b) in pairs:
                    _assert_same_states(f"eval resume {name}{path_}", a, b)
                got, want = _flat_values(fresh.compute() if name != "tracker" else fresh.compute_all()), _flat_values(
                    whole.compute() if name != "tracker" else whole.compute_all())
                if any(not torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"eval resume {name}: values differ from the uninterrupted run")
                out[name] = {"file_bytes": os.path.getsize(path), "restored_at": EVAL_EPOCH, "equal": True}
    finally:
        resume["dir"].cleanup()
    _log(f"  eval resume: {sorted(out)} saved after batch {EVAL_EPOCH}, restored on the card, equal to the uninterrupted run")
    return out


def time_eval_loop(inp: "_EvalInputs") -> dict:
    """Each member's ``update`` eagerly and with the engine on, in turns (eager, engine,
    engine, eager): host µs to a device sync, host syncs per update, device busy and idle
    share over 8 updates, the largest device items, and the engine's counters."""
    from torchmetrics_tpu_torch.engine import engine_context

    out = {}
    # the 80-copy multioutput updates take ~30 ms each, most of it host work, and the
    # profiler multiplies that: fewer updates, and one turn each way
    heavy = ("multioutput_auroc", "multioutput_auroc_nan", "multitask", "boot_poisson")
    widest = ("multioutput_auroc", "multioutput_auroc_nan")
    for name, (make, step, n, _) in _eval_members().items():
        t0 = time.perf_counter()
        timed_step = (lambda m, i: m.update(*inp.acc[i % n])) if name == "tracker" else (lambda m, i: step(m, inp, i % n, False))
        runs = {"eager": [], "engine": []}
        for mode in ("eager", "engine") if name in widest else ("eager", "engine", "engine", "eager"):
            with engine_context(mode == "engine"):
                m = make()
                if name == "tracker":
                    m.increment()
                timed_step(m, 0)  # builds and captures
                iters = 2 if name in widest else 4 if name in heavy else 16
                wall = _host_us_per_call(lambda i, m=m: timed_step(m, i), iters=iters, repeats=3)
                prof = _device_profile(lambda i, m=m: timed_step(m, i), iters=1 if name in widest else 4 if name in heavy else 8)
                busy = prof["device_busy_us"]
                runs[mode].append({
                    "update_us": wall,
                    "host_syncs_per_update": _syncs_per_call(lambda m=m: timed_step(m, 1)),
                    "device_busy_us": busy,
                    "device_idle_share": None if busy is None else max(0.0, 1 - busy / wall),
                    "device_ops": prof["device_ops"],
                    "kernels_us": prof["kernels_us"],
                    "empty_windows": prof["empty_windows"],
                    "engine": _engine_summary(m),
                })
        out[name] = {mode: _mean_runs(rs) for mode, rs in runs.items()}
        out[name]["update_us_runs"] = {mode: [r["update_us"] for r in rs] for mode, rs in runs.items()}
        out[name]["seconds"] = time.perf_counter() - t0
        eager, eng = out[name]["eager"], out[name]["engine"]
        busy = lambda r: "busy not measured" if r["device_busy_us"] is None else (  # noqa: E731
            f"busy {r['device_busy_us']:.1f} us, idle {r['device_idle_share']:.2f}")
        _log(f"  eval {name} ({out[name]['seconds']:.1f} s): eager {eager['update_us']:.1f} us ({eager['host_syncs_per_update']} syncs,"
             f" {busy(eager)}), engine {eng['update_us']:.1f} us ({eng['host_syncs_per_update']} syncs, {busy(eng)});"
             f" engine {out[name]['engine']['engine']['replays']} replays, {out[name]['engine']['engine']['captures']} captures,"
             f" fallbacks {out[name]['engine']['engine']['fallback_reasons']}")
    _check_eval_syncs(out)
    return out


def _check_eval_syncs(times: dict) -> None:
    """0 host syncs on the engine path for the float-strategy aggregators and the
    multinomial bootstrap; at most 1 per copy per update for the Poisson one; the
    multioutput wrapper's NaN removal adds at most 1 per update to what its curves read."""
    engine = {name: t["engine"]["host_syncs_per_update"] for name, t in times.items()}
    if engine["mean_warn"] != 1 or times["mean_warn"]["eager"]["host_syncs_per_update"] != 1:
        raise AssertionError(f"eval mean_warn: its NaN test should read the host once per update: {times['mean_warn']}")
    for name in ("mean_float", "sum", "max", "min", "running_mean", "boot_multinomial", "one_minus_acc", "minmax", "classwise"):
        if engine[name]:
            raise AssertionError(f"eval {name}: {engine[name]} host syncs per update on the engine path, expected 0")
    if engine["boot_poisson"] > BOOT_COPIES:
        raise AssertionError(f"eval boot_poisson: {engine['boot_poisson']} host syncs per update, at most {BOOT_COPIES}")
    extra = engine["multioutput_auroc_nan"] - engine["multioutput_auroc"]
    if extra > 1:
        raise AssertionError(f"eval multioutput NaN removal: {extra} host syncs per update beyond the curves', at most 1")


# ---------------------------------------------------------------- times


def time_kernels(gen: torch.Generator, hbm_rate: float, launches: dict, errors: dict) -> list:
    """The kernels line. ``launches`` / ``errors``: K1's and K2's on their main paths
    (``stat_counts``, ``multi_threshold``), and K2's on the ``binary`` and ``multilabel`` paths."""
    from torchmetrics_tpu_torch.ops import stat_counts as sc

    out = []
    # K1: four distinct 32.8 MB inputs in turn, so each launch reads past the 50 MB L2
    inputs = [
        (torch.randn(ACC_BATCH, ACC_CLASSES, generator=gen).cuda(), torch.randint(0, ACC_CLASSES, (ACC_BATCH,), generator=gen).cuda())
        for _ in range(4)
    ]
    k_ms = _median_ms(lambda i: sc.stat_counts(*inputs[i % 4], ACC_CLASSES), iters=50)
    k_prof = _device_profile(lambda i: sc.stat_counts(*inputs[i % 4], ACC_CLASSES), iters=20)
    p_ms = _median_ms(lambda i: sc._stat_counts_plain(*inputs[i % 4], ACC_CLASSES), iters=20)
    preds, target = inputs[0]
    # every logit and target read once, three int32 (C,) counts written
    k1_bytes = preds.nbytes + target.nbytes + 3 * ACC_CLASSES * 4
    k1_ops = preds.numel()  # one comparison per logit
    bytes_ms, ops_ms = k1_bytes / hbm_rate * 1e3, k1_ops / _F32_RATE * 1e3
    out.append(
        {
            "name": "stat_counts",
            "route": "cuda",
            "source": "torchmetrics_tpu_torch/csrc/stat_counts.cu",
            "replaces": "torchmetrics_tpu/ops/stat_counts.py:130",
            "shape": f"{ACC_BATCH}x{ACC_CLASSES} float32",
            "launches": launches["stat_counts"],
            "max_abs_err": errors["stat_counts"],
            "ms": k_ms,
            "kernel_device_ms": _kernel_ms(k_prof, "stat_counts_kernel"),
            "plain_ms": p_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "note": _NOTE,
        }
    )
    # K2 at the auroc path's shape on the path's kind of scores and on peaked ones, at
    # 1000 classes, and at the binary and multilabel paths' shapes (inputs as each
    # curve update builds them)
    for c, kind in ((CIFAR_CLASSES, "random"), (CIFAR_CLASSES, "peaked"), (1000, "random")):
        out.append(_time_multi_threshold(
            hbm_rate, lambda c=c, kind=kind: _curve_inputs(CIFAR_BATCH, c, N_THRESH, gen, kind),
            f"{CIFAR_BATCH}x{c} float32, T={N_THRESH}, {kind} scores", launches["multi_threshold"], errors["multi_threshold"],
        ))
    for kind in ("random", "peaked"):
        out.append(_time_multi_threshold(
            hbm_rate, lambda kind=kind: _binary_curve_inputs(BIN_BATCH, N_THRESH, gen, kind),
            f"{BIN_BATCH}x1 float32, T={N_THRESH}, {kind} scores (binary)", launches["binary"], errors["binary"],
        ))
    out.append(_time_multi_threshold(
        hbm_rate, lambda: _multilabel_curve_inputs(ML_BATCH, ML_LABELS, N_THRESH, gen, "random"),
        f"{ML_BATCH}x{ML_LABELS} float32, T={N_THRESH}, random scores, per-element mask (multilabel)",
        launches["multilabel"], errors["multilabel"],
    ))
    return out


def _time_multi_threshold(hbm_rate: float, make_inputs, shape: str, launches: int, err: float) -> dict:
    """K2's row of the kernels line: four distinct inputs from ``make_inputs()`` in turn."""
    from torchmetrics_tpu_torch.ops import multi_threshold as mt

    inputs = [make_inputs() for _ in range(4)]
    call = lambda i: mt.multi_threshold_confmat(*inputs[i % 4][:3], *inputs[i % 4][3])  # noqa: E731
    k_ms = _median_ms(call, iters=100)
    k_prof = _device_profile(call, iters=20)
    p_ms = _median_ms(lambda i: mt._multi_threshold_confmat_plain(*inputs[i % 4][:3], *inputs[i % 4][3]), iters=20)
    preds, positive, valid, (thr_sorted, order), _ = inputs[0]
    # the kernel reads the mask (one byte per row when it is a broadcast row mask of
    # stride 0, per element otherwise) and, for valid elements only, the score and the
    # positive flag; thresholds and order once; it writes the (T, C, 2, 2) int32 tensor
    n_valid = int(valid.sum())
    mask_bytes = valid.shape[0] if valid.stride(1) == 0 else valid.numel()
    k2_bytes = (
        mask_bytes * valid.element_size()
        + n_valid * (preds.element_size() + positive.element_size())
        + thr_sorted.nbytes
        + order.nbytes
        + thr_sorted.numel() * preds.shape[1] * 4 * 4
    )
    k2_ops = 2 * n_valid  # the two comparisons that pin each valid score's bin
    bytes_ms, ops_ms = k2_bytes / hbm_rate * 1e3, k2_ops / _F32_RATE * 1e3
    return {
        "name": "multi_threshold",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/multi_threshold.cu",
        "replaces": "torchmetrics_tpu/ops/multi_threshold.py:147",
        "shape": shape,
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "kernel_device_ms": _kernel_ms(k_prof, "multi_threshold_"),
        "device_ms": None if k_prof["device_busy_us"] is None else k_prof["device_busy_us"] / 1e3,
        "device_ops_per_call": k_prof["device_ops"],
        "plain_ms": p_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "note": _NOTE,
    }


def time_binned_update(gen: torch.Generator) -> list:
    """``_binned_multi_threshold_confmat``, K2's whole step in the curve update (kernel
    and whatever arithmetic follows it), for whichever ``torchmetrics_tpu_torch`` is
    first on ``sys.path``: two checkouts run in turns in one call compare like with like."""
    import torchmetrics_tpu_torch
    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
        _binned_multi_threshold_confmat,
    )

    rows = []
    for c, kind in ((CIFAR_CLASSES, "random"), (CIFAR_CLASSES, "peaked"), (1000, "random")):
        inputs = [_curve_inputs(CIFAR_BATCH, c, N_THRESH, gen, kind) for _ in range(4)]
        call = lambda i: _binned_multi_threshold_confmat(*inputs[i % 4][:4])  # noqa: E731
        prof = _device_profile(call, iters=20)
        rows.append(
            {
                "package": torchmetrics_tpu_torch.__file__,
                "shape": f"{CIFAR_BATCH}x{c} float32, T={N_THRESH}, {kind} scores",
                "ms": _median_ms(call, iters=100),
                "device_us": prof["device_busy_us"],
                "device_ops": prof["device_ops"],
                "kernel_device_us": None if prof["kernels_us"] is None else _kernel_ms(prof, "multi_threshold_") * 1e3,
            }
        )
    return rows


def _kernel_ms(prof: dict, fragment: str):
    """Device ms per call of the kernels whose name holds ``fragment`` (None: not measured)."""
    if prof["kernels_us"] is None:
        return None
    return sum(us for name, us in prof["kernels_us"].items() if fragment in name) / 1e3


def time_updates(acc_batches: list, auroc_batches: list) -> dict:
    """Per ``update``: host time to completion, and the device's busy time and kernels."""
    from torchmetrics_tpu_torch import MulticlassAccuracy, MulticlassAUROC

    res = {}
    for validate in (True, False):
        acc = MulticlassAccuracy(num_classes=ACC_CLASSES, validate_args=validate)
        auroc = MulticlassAUROC(num_classes=CIFAR_CLASSES, thresholds=N_THRESH, validate_args=validate)
        for name, metric, batches in (("accuracy", acc, acc_batches), ("auroc", auroc, auroc_batches)):
            step = lambda i, m=metric, b=batches: m.update(*b[i % len(b)])  # noqa: E731
            wall = _host_us_per_call(step, iters=16)
            prof = _device_profile(step, iters=8)
            busy = prof["device_busy_us"]
            res[f"{name}_validate_{validate}"] = {
                "update_us": wall,
                "device_busy_us": busy,
                "device_idle_share": None if busy is None else max(0.0, 1 - busy / wall),
                "device_ops": prof["device_ops"],
                "kernels_us": prof["kernels_us"],
            }
    # the two device -> host syncs on the path, each alone at the path's shape: the
    # unique-count of `validate_args` and the [0, 1] range check before the softmax
    acc_target = acc_batches[0][1]
    auroc_preds = auroc_batches[0][0]
    res["sync_us"] = {
        "validate_unique_8192": _host_us_per_call(lambda i: torch.unique(acc_target).numel(), iters=50),
        "softmax_range_check_8192x10": _host_us_per_call(
            lambda i: bool(((auroc_preds >= 0) & (auroc_preds <= 1)).all()), iters=50
        ),
    }
    return res


def time_collection(batches: list) -> dict:
    """The collection's ``update`` against its six members updated one by one."""
    from torchmetrics_tpu_torch import MetricCollection

    res = {}
    for validate in (True, False):
        mc = MetricCollection(_collection_members(validate_args=validate))
        mc.update(*batches[0])  # settles the compute groups
        alone = list(_collection_members(validate_args=validate).values())
        runs = (
            ("collection", lambda i: mc.update(*batches[i % len(batches)])),
            ("members_one_by_one", lambda i: [m.update(*batches[i % len(batches)]) for m in alone]),
        )
        for name, step in runs:
            wall = _host_us_per_call(step, iters=16)
            prof = _device_profile(step, iters=8)
            busy = prof["device_busy_us"]
            res[f"{name}_validate_{validate}"] = {
                "update_us": wall,
                "device_busy_us": busy,
                "device_idle_share": None if busy is None else max(0.0, 1 - busy / wall),
                "device_ops": prof["device_ops"],
                "kernels_us": prof["kernels_us"],
            }
    return res


def _syncs_per_call(fn) -> int:
    """Device -> host syncs in one ``fn()``, as ``set_sync_debug_mode("warn")`` reports
    them (a prototype: it may miss some, so this is a floor)."""
    return _with_syncs(fn)[1]


def time_task_path(members_fn, batches: list) -> dict:
    """The path's collection ``update`` with and without ``validate_args``: host time,
    device busy time, operations, idle share, the largest device items and host syncs."""
    from torchmetrics_tpu_torch import MetricCollection

    res = {}
    for validate in (True, False):
        mc = MetricCollection(members_fn(validate_args=validate))
        mc.update(*batches[0])
        step = lambda i, mc=mc: mc.update(*batches[i % len(batches)])  # noqa: E731
        wall = _host_us_per_call(step, iters=16)
        prof = _device_profile(step, iters=8)
        busy = prof["device_busy_us"]
        res[f"collection_validate_{validate}"] = {
            "update_us": wall,
            "device_busy_us": busy,
            "device_idle_share": None if busy is None else max(0.0, 1 - busy / wall),
            "device_ops": prof["device_ops"],
            "kernels_us": prof["kernels_us"],
            "host_syncs_per_update": _syncs_per_call(lambda mc=mc: mc.update(*batches[1])),
        }
    return res


# ---------------------------------------------------------------- phase 14: the engine tier

SCAN_K = 8
COMP_UPDATES, COMP_WIDTH, COMP_K = 1024, 8192, 16  # the compensated sums' stream
QUARANTINED_AT = 4  # update 5 of the accuracy path carries a NaN
TIER_ROUNDS = 3  # timing rounds, each (eager, engine, scan, async, async, scan, engine, eager)
FORWARD_PAIRS = 5


def _zero_launches() -> None:
    from torchmetrics_tpu_torch import ops

    ops.set_launch_counts({"stat_counts": 0, "multi_threshold": 0})


def _launches() -> dict:
    from torchmetrics_tpu_torch import ops

    torch.cuda.synchronize()
    return ops.launch_counts()


def _kb_total(stats) -> int:
    """Σ kb over a queue's drains: every drained step, pad steps included, launches."""
    return stats.scan_steps_folded + stats.scan_pad_steps


def _ulp32(x: float) -> float:
    """The spacing of float32 at ``x``."""
    v = torch.tensor(x, dtype=torch.float32)
    return float(torch.nextafter(v, torch.tensor(float("inf"))) - v)


def _check_compute_cache(name: str, metric, computes: int) -> dict:
    """The cached compute: one build, then replays (``engine/epoch.py``)."""
    st = metric._epoch.stats
    got = {k: getattr(st, k) for k in ("compute_traces", "compute_dispatches", "compute_cache_hits", "eager_fallbacks")}
    want = {"compute_traces": 1, "compute_dispatches": computes, "compute_cache_hits": computes - 1, "eager_fallbacks": 0}
    if got != want:
        raise AssertionError(f"{name}: cached compute counters {got} ({dict(st.fallback_reasons)}), expected {want}")
    return got


def run_scan_accuracy(acc_batches: list) -> dict:
    """Part 1: ``MulticlassAccuracy(1000)`` over 16 updates of 8192 x 1000 plus one 5000-row
    update with ``scan_steps=8`` (two drains of kb=8 and a kb=1 tail), then the same with
    ``async_dispatch=2``. States bit-equal to the eager run on the card and to the CPU run;
    K1 launched Σ kb times plus the probe's two warm-ups (its guarded update and its pad-row
    unit); a second ``compute`` replays the cached compute graph."""
    from torchmetrics_tpu_torch import MulticlassAccuracy
    from torchmetrics_tpu_torch.engine import engine_context

    stream = list(acc_batches) + [tuple(x[:ACC_RAGGED] for x in acc_batches[0])]
    with engine_context(False):
        eager = MulticlassAccuracy(ACC_CLASSES, validate_args=False)
        for p, t in stream:
            eager.update(p, t)
        eager_value = eager.compute()
    host = MulticlassAccuracy(ACC_CLASSES, validate_args=False, device="cpu")
    for p, t in stream:
        host.update(p.cpu(), t.cpu())
    out = {}
    for name, kw in (("scan", {}), ("scan_async", {"async_dispatch": 2})):
        _zero_launches()
        m = MulticlassAccuracy(ACC_CLASSES, validate_args=False, scan_steps=SCAN_K, **kw)
        for p, t in stream:
            m.update(p, t)
        value = m.compute()
        launches = _launches()
        st = m._engine.stats
        want = {"scan_dispatches": 3, "scan_steps_folded": len(stream), "scan_pad_steps": 0, "eager_fallbacks": 0}
        got = {k: getattr(st, k) for k in want}
        if got != want:
            raise AssertionError(f"scan accuracy ({name}) counters {got}, expected {want}")
        if launches != {"stat_counts": _kb_total(st) + 2, "multi_threshold": 0}:
            raise AssertionError(f"scan accuracy ({name}) launches {launches}, expected Σkb {_kb_total(st)} + 2 warm-ups")
        if kw and st.async_dispatches < 1:
            raise AssertionError(f"scan accuracy ({name}): no drain rode the worker: {st}")
        _assert_same_states(f"scan accuracy ({name}) vs eager", m, eager)
        _assert_same_states(f"scan accuracy ({name}) vs cpu", m, host)
        _equal(f"scan accuracy ({name}) compute", value, eager_value)
        m._computed = None
        _equal(f"scan accuracy ({name}) cached compute", m.compute(), eager_value)
        out[name] = {
            "launches": launches, "engine": st.as_dict(), "compute": _check_compute_cache(f"scan accuracy ({name})", m, 2),
        }
        _log(f"  accuracy, scan_steps=8{' + async_dispatch=2' if kw else ''}: {len(stream)} updates in"
             f" {st.scan_dispatches} drains (Σkb {_kb_total(st)}), async drains {st.async_dispatches}, K1 {launches['stat_counts']};"
             " states equal to eager and to the CPU")
    return out


def run_scan_collection(batches: list) -> dict:
    """Part 2: the config #2 collection with ``scan_steps=8``: the stat-scores and
    confusion-matrix owners ride the fused queue, the binned AUROC falls back and runs K2
    eagerly on every update."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import engine_context

    members = lambda **kw: _collection_members(validate_args=False, **kw)  # noqa: E731
    _zero_launches()
    mc = MetricCollection(members(), scan_steps=SCAN_K)
    for p, t in batches:
        mc.update(p, t)
    values = mc.compute()
    launches = _launches()
    with engine_context(False):
        eager = MetricCollection(members())
        for p, t in batches:
            eager.update(p, t)
        eager_values = eager.compute()
    host = MetricCollection(members(device="cpu"))
    for p, t in batches:
        host.update(p.cpu(), t.cpu())
    fe = mc._fused_engine
    st = fe.stats
    if fe._scan._plan.names != {"acc", "confmat"}:
        raise AssertionError(f"scan collection: fused owners {fe._scan._plan.names}")
    if st.scan_steps_folded != len(batches) or st.eager_fallbacks:
        raise AssertionError(f"scan collection counters {st}")
    # the fused signature is not bucketed (AUROC is no row-additive member): no pad-row
    # unit, one warm-up launch (the probe's guarded update)
    want = {"stat_counts": _kb_total(st) + 1, "multi_threshold": len(batches)}
    if launches != want:
        raise AssertionError(f"scan collection launches {launches}, expected {want}")
    for name in values:
        _assert_same_states(f"scan collection {name} vs eager", mc[name], eager[name])
        _assert_same_states(f"scan collection {name} vs cpu", mc[name], host[name])
        if not torch.equal(values[name], eager_values[name]):
            raise AssertionError(f"scan collection {name}: {values[name].tolist()} vs eager {eager_values[name].tolist()}")
    auroc_fallbacks = mc["auroc"]._engine.stats.eager_fallbacks
    if auroc_fallbacks != len(batches):
        raise AssertionError(f"scan collection: AUROC fell back {auroc_fallbacks} times, expected {len(batches)}")
    compute = {name: mc[name]._epoch.stats.as_dict() for name in values if mc[name]._epoch is not None}
    _log(f"  config #2 collection, scan_steps=8: owners acc and confmat fused in {st.scan_dispatches} drains,"
         f" AUROC eager on every update; launches {launches}; states equal to eager and to the CPU")
    return {"launches": launches, "engine": st.as_dict(), "compute": compute}


def run_scan_quarantine(acc_batches: list) -> dict:
    """Part 3: quarantine ``1`` with a NaN batch at update 5 of the accuracy path, queued:
    the state equals the run without that batch, bit for bit, and the counter reads 1."""
    from torchmetrics_tpu_torch import MulticlassAccuracy
    from torchmetrics_tpu_torch.engine import engine_context, quarantine_context

    poisoned = acc_batches[QUARANTINED_AT][0].clone()
    poisoned[17, 3] = float("nan")
    stream = list(acc_batches)
    stream[QUARANTINED_AT] = (poisoned, acc_batches[QUARANTINED_AT][1])
    clean = [b for i, b in enumerate(acc_batches) if i != QUARANTINED_AT]
    _zero_launches()
    with quarantine_context(True):
        m = MulticlassAccuracy(ACC_CLASSES, validate_args=False, scan_steps=SCAN_K)
        for p, t in stream:
            m.update(p, t)
        value = m.compute()
        launches = _launches()
        count = int(m._quarantined_count)
        with engine_context(False):
            eager_q = MulticlassAccuracy(ACC_CLASSES, validate_args=False)
            for p, t in stream:
                eager_q.update(p, t)
    with engine_context(False):
        without = MulticlassAccuracy(ACC_CLASSES, validate_args=False)
        for p, t in clean:
            without.update(p, t)
        want_value = without.compute()
    st = m._engine.stats
    if count != 1 or st.quarantined_batches != 1 or int(eager_q._quarantined_count) != 1:
        raise AssertionError(f"quarantine: counter {count}, reported {st.quarantined_batches}, eager {int(eager_q._quarantined_count)}")
    _assert_same_states("quarantine scan vs the run without the batch", m, without)
    _assert_same_states("quarantine eager vs the run without the batch", eager_q, without)
    _equal("quarantine compute", value, want_value)
    if launches["stat_counts"] != _kb_total(st) + 2:
        raise AssertionError(f"quarantine launches {launches}, expected Σkb {_kb_total(st)} + 2")
    _log(f"  quarantine: a NaN batch at update {QUARANTINED_AT + 1} of {len(stream)} skipped on the card, counter {count};"
         " the state equals the run without it")
    return {"launches": launches, "engine": st.as_dict(), "quarantined": count}


def run_compensated(gen: torch.Generator) -> dict:
    """Part 4: a compensated ``SumMetric`` and ``MeanMetric`` over 1024 updates of 8192
    float32 losses with ``scan_steps=16``, against the float64 sum (within 2 ulp), beside
    the naive float32 run's drift; the compensated states bit-equal to the eager
    compensated run on the card, within relative 1e-6 of the CPU run."""
    from torchmetrics_tpu_torch import MeanMetric, SumMetric
    from torchmetrics_tpu_torch.engine import compensated_context, engine_context

    losses = (torch.rand(COMP_UPDATES, COMP_WIDTH, generator=gen) * 4).cuda()
    ref_sum = float(losses.double().sum())
    ref_mean = ref_sum / (COMP_UPDATES * COMP_WIDTH)

    def run(device=None, **kw):
        dev = {} if device is None else {"device": device}
        s, m = SumMetric(nan_strategy=0.0, **dev, **kw), MeanMetric(nan_strategy=0.0, **dev, **kw)
        rows = losses if device is None else losses.cpu()
        for row in rows:
            s.update(row)
            m.update(row)
        return s, m, s.compute(), m.compute()

    with compensated_context(True):
        s, m, s_val, m_val = run(scan_steps=COMP_K)
        with engine_context(False):
            es, em, es_val, em_val = run()
        hs, hm, hs_val, hm_val = run(device="cpu")
    naive_s, naive_m, naive_val, naive_mean = run()
    ulp_sum, ulp_mean = _ulp32(ref_sum), _ulp32(ref_mean)
    err_sum, err_mean = float(s_val) - ref_sum, float(m_val) - ref_mean
    if abs(err_sum) > 2 * ulp_sum or abs(err_mean) > 2 * ulp_mean:
        raise AssertionError(f"compensated: sum off by {err_sum} (ulp {ulp_sum}), mean off by {err_mean} (ulp {ulp_mean})")
    for name, got, want in (("sum", s, es), ("mean", m, em)):
        _assert_same_states(f"compensated {name} scan vs eager", got, want)
        for k, r in got._comp_residuals.items():
            if not torch.equal(r, want._comp_residuals[k]):
                raise AssertionError(f"compensated {name}: residual {k} differs from the eager run")
    for name, got, want in (("sum", s, hs), ("mean", m, hm)):
        _assert_same_states(f"compensated {name} vs cpu", got, want, float_rtol=1e-6)
    st = s._engine.stats
    if st.compensated_steps != COMP_UPDATES or st.scan_steps_folded != COMP_UPDATES or st.eager_fallbacks:
        raise AssertionError(f"compensated sum counters {st}")
    out = {
        "reference_float64": ref_sum,
        "sum": float(s_val), "sum_err": err_sum, "sum_err_ulp": err_sum / ulp_sum,
        "mean": float(m_val), "mean_err": err_mean, "mean_err_ulp": err_mean / ulp_mean,
        "naive_sum": float(naive_val), "naive_sum_err": float(naive_val) - ref_sum,
        "naive_sum_err_ulp": (float(naive_val) - ref_sum) / ulp_sum,
        "naive_mean_err_ulp": (float(naive_mean) - ref_mean) / ulp_mean,
        "engine": st.as_dict(),
    }
    _log(f"  compensated: sum {float(s_val)!r} vs float64 {ref_sum!r} ({out['sum_err_ulp']:+.2f} ulp), naive"
         f" {float(naive_val)!r} ({out['naive_sum_err_ulp']:+.1f} ulp); mean {out['mean_err_ulp']:+.2f} ulp,"
         f" naive {out['naive_mean_err_ulp']:+.1f} ulp")
    return out


def check_scan_launches_against_profiler(acc_batches: list) -> dict:
    """K1's counted launches over one queued drain of kb=8 against the profiler's kernel
    events over the same updates."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torchmetrics_tpu_torch import MulticlassAccuracy, ops

    m = MulticlassAccuracy(ACC_CLASSES, validate_args=False, scan_steps=SCAN_K)
    for p, t in acc_batches[:SCAN_K]:
        m.update(p, t)
    torch.cuda.synchronize()
    before = ops.launch_counts()["stat_counts"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for p, t in acc_batches[SCAN_K : 2 * SCAN_K]:
            m.update(p, t)
        torch.cuda.synchronize()
    counted = ops.launch_counts()["stat_counts"] - before
    events = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and "stat_counts_kernel" in e.name)
    if events == 0 or counted != events or counted != SCAN_K:
        raise AssertionError(f"scan: {counted} K1 launches counted over one kb=8 drain, {events} kernel events")
    return {"updates": SCAN_K, "counted": counted, "profiler_kernel_events": events}


def check_scan_no_sync(acc_batches: list) -> None:
    """One enqueue, one drain and one join under ``set_sync_debug_mode("error")``."""
    from torchmetrics_tpu_torch import MulticlassAccuracy

    sync = MulticlassAccuracy(ACC_CLASSES, validate_args=False, scan_steps=SCAN_K)
    background = MulticlassAccuracy(ACC_CLASSES, validate_args=False, scan_steps=SCAN_K, async_dispatch=2)
    for m in (sync, background):  # build and capture the kb=8 and kb=1 graphs of every ring
        for p, t in acc_batches + acc_batches[:9]:
            m.update(p, t)
        m.compute()
    torch.cuda.synchronize()
    before = background._engine.stats.async_dispatches
    torch.cuda.set_sync_debug_mode("error")
    try:
        sync.update(*acc_batches[0])  # one enqueue
        sync._engine._scan.drain("sync-check")  # one drain (the kb=1 graph)
        for p, t in acc_batches[:SCAN_K]:  # the 8th enqueue hands the buffer to the worker
            background.update(p, t)
        background._engine._scan.join_async("sync-check")  # one join
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if background._engine.stats.async_dispatches != before + 1:
        raise AssertionError(f"the checked buffer did not ride the worker: {background._engine.stats}")
    _log("  an enqueue, a drain and a join ran under set_sync_debug_mode('error')")


def _window_us(make, batches: list, iters: int = 16, repeats: int = 5, forward: bool = False) -> float:
    """Median host µs per update (or forward) over ``iters`` calls, the queue drained and
    the device synchronized inside the window."""
    m = make()
    call = m if forward else m.update
    for i in range(iters):
        call(*batches[i % len(batches)])
    m._drain_scan("timing")
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for i in range(iters):
            call(*batches[i % len(batches)])
        m._drain_scan("timing")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6 / iters)
    del m, call
    gc.collect()  # an engine and its metric hold each other: free the graphs and slots now
    return statistics.median(times)


def _window_profile(make, batches: list, iters: int = 16) -> dict:
    m = make()
    for i in range(iters):
        m.update(*batches[i % len(batches)])
    m._drain_scan("timing")

    def window(_):
        for i in range(iters):
            m.update(*batches[i % len(batches)])
        m._drain_scan("timing")

    prof = _device_profile(window, iters=1)
    busy = prof["device_busy_us"]
    return {"device_busy_us_per_update": None if busy is None else busy / iters, "device_ops_per_update": None
            if prof["device_ops"] is None else prof["device_ops"] / iters, "empty_windows": prof["empty_windows"]}


def _step_breakdown(acc_batches: list) -> dict:
    """The host time of one engine step by part (each part repeated alone): the
    signature key, the shield (and the copy of a state that is not its buffer), the batch
    copy into the static inputs, the replay; then a scan enqueue by part. Each figure is
    the host time to launch a few calls after a device sync (median of 25), few enough
    that the launch queue never fills: the host's cost, not the device time."""
    from torchmetrics_tpu_torch import MulticlassAccuracy, ops
    from torchmetrics_tpu_torch.engine.compiled import copy_into_buffers, shield_state, state_signature, step_state

    def per_call(fn, calls: int = 16, repeats: int = 25) -> float:
        fn()
        times = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
        return statistics.median(times)

    batch = acc_batches[0]
    m = MulticlassAccuracy(ACC_CLASSES, validate_args=False)
    m.update(*batch)
    m.update(*batch)
    eng = m._engine
    (entry,) = [e for e in eng._cache.values() if hasattr(e, "plans")]
    members = [("", m)]
    inputs = list(batch)

    def key():
        in_sig = eng._eligible_inputs(members, inputs)
        states = {"": step_state(m)}
        bucket = eng._bucket(members, inputs)
        sig = tuple((a.shape, a.dtype, a.device) for a in inputs) if bucket else in_sig
        return eng._cache.get((bucket, 2, (), (("", state_signature(states[""])),), sig))

    def shield():
        for plan in entry.plans:
            shield_state(plan.metric, plan.buffers, eng.stats)
            copy_into_buffers(step_state(plan.metric), plan.buffers, eng.stats)

    def replay():
        entry.graph.replay()
        ops.add_launches(entry.launches)

    step = {
        "signature_key_us": per_call(key),
        "shield_us": per_call(shield),
        "batch_copy_us": per_call(lambda: entry.inputs.fill(inputs, eng.stats)),
        "replay_us": per_call(replay),
        "update_us": per_call(lambda: m.update(*batch)),
    }
    step["other_us"] = step["update_us"] - sum(v for k, v in step.items() if k != "update_us")

    q = MulticlassAccuracy(ACC_CLASSES, validate_args=False, scan_steps=SCAN_K)
    for _ in range(2 * SCAN_K):
        q.update(*batch)
    q._drain_scan("timing")
    queue = q._engine._scan
    (plan,) = [p for p in queue._plans.values() if hasattr(p, "rings")]
    ring = plan.rings[0]
    qmembers = [("", q)]
    slot = iter(range(1 << 30))

    def enqueue_key():
        eng_q = q._engine
        in_sig = eng_q._eligible_inputs(qmembers, inputs)
        eng_q._bucket(qmembers, inputs)
        return (2, (), in_sig, ("",), SCAN_K) == queue._fast[0]

    def drain_8():
        for p, t in [batch] * SCAN_K:
            q.update(p, t)

    enqueue = {
        "signature_key_us": per_call(enqueue_key),
        "batch_copy_us": per_call(lambda: ring.fill(next(slot) % (SCAN_K - 1), inputs, plan.bucket, q._engine.stats)),
        "update_us_amortized": per_call(drain_8, calls=2) / SCAN_K,
    }
    # the enqueue alone: seven updates that do not reach K, the drain excluded
    def seven():
        for _ in range(SCAN_K - 1):
            q.update(*batch)
        queue.discard("timing")

    enqueue["enqueue_us"] = per_call(seven, calls=2) / (SCAN_K - 1)
    enqueue["other_us"] = enqueue["enqueue_us"] - enqueue["signature_key_us"] - enqueue["batch_copy_us"]
    return {"engine_step": step, "scan_enqueue": enqueue}


def check_gil_release(acc_batches: list, windows: int = 100) -> dict:
    """Whether ``CUDAGraph.replay`` releases the GIL, from the replay calls alone.

    A spinner thread counts in a pure-Python loop. The main thread makes ``windows``
    calls of each kind, each from an idle card (a synchronize before it, outside the
    window, so the launch queue never fills), and reads the spinner's count just before
    and just after the call. A call that releases the GIL hands it to the waiting
    spinner, which then counts inside the window; a call that holds it leaves the count
    unchanged (a forced switch waits for a bytecode boundary, and there is none inside a
    C++ call). Two controls bracket the replay: ``time.sleep(1e-5)`` releases the GIL,
    ``sum(range(300))`` holds it. The replay is read as releasing when its share of
    windows with progress lies nearer the releasing control's."""
    import threading

    from torchmetrics_tpu_torch import MulticlassAccuracy

    m = MulticlassAccuracy(ACC_CLASSES, validate_args=False)
    m.update(*acc_batches[0])
    m.update(*acc_batches[0])
    (entry,) = [e for e in m._engine._cache.values() if hasattr(e, "plans")]
    graph = entry.graph
    counter = [0]
    stop = [False]

    def spin():
        while not stop[0]:
            counter[0] += 1

    def measure(call) -> dict:
        progressed, counts, spans = 0, 0, 0.0
        for _ in range(windows):
            torch.cuda.synchronize()
            c0, t0 = counter[0], time.perf_counter()
            call()
            t1, c1 = time.perf_counter(), counter[0]
            progressed += c1 > c0
            counts += c1 - c0
            spans += t1 - t0
        return {
            "windows_with_progress": progressed / windows,
            "spinner_counts_per_window": counts / windows,
            "window_us": spans / windows * 1e6,
        }

    thread = threading.Thread(target=spin, daemon=True)
    thread.start()
    try:
        out = {
            "releasing_control": measure(lambda: time.sleep(1e-5)),
            "replay": measure(graph.replay),
            "holding_control": measure(lambda: sum(range(300))),
        }
    finally:
        stop[0] = True
        thread.join()
    torch.cuda.synchronize()
    share = {k: v["windows_with_progress"] for k, v in out.items()}
    out["windows"] = windows
    out["replay_releases_gil"] = abs(share["replay"] - share["releasing_control"]) < abs(
        share["replay"] - share["holding_control"]
    )
    return out


def time_engine_tier(acc_batches: list) -> dict:
    """Per-update host µs, accuracy ``update`` at 8192 x 1000, for eager, the one-step
    engine, scan K=8 and scan K=8 + async (in turns, three rounds), with device busy and
    idle share; the step and enqueue breakdowns; the GIL check; and accuracy ``forward``
    eager against engine in five interleaved pairs."""
    from torchmetrics_tpu_torch import MulticlassAccuracy
    from torchmetrics_tpu_torch.engine import engine_context

    makers = {
        "eager": (lambda: MulticlassAccuracy(ACC_CLASSES, validate_args=False), False),
        "engine": (lambda: MulticlassAccuracy(ACC_CLASSES, validate_args=False), True),
        "scan8": (lambda: MulticlassAccuracy(ACC_CLASSES, validate_args=False, scan_steps=SCAN_K), True),
        "scan8_async": (
            lambda: MulticlassAccuracy(ACC_CLASSES, validate_args=False, scan_steps=SCAN_K, async_dispatch=2), True,
        ),
    }
    runs = {name: [] for name in makers}
    order = ("eager", "engine", "scan8", "scan8_async", "scan8_async", "scan8", "engine", "eager")
    for _ in range(TIER_ROUNDS):
        for name in order:
            make, engine = makers[name]
            with engine_context(engine):
                runs[name].append(_window_us(make, acc_batches))
    per_update = {}
    for name, (make, engine) in makers.items():
        with engine_context(engine):
            prof = _window_profile(make, acc_batches)
        mean = statistics.mean(runs[name])
        busy = prof["device_busy_us_per_update"]
        per_update[name] = {
            "update_us": mean, "update_us_runs": runs[name], **prof,
            "device_idle_share": None if busy is None else max(0.0, 1 - busy / mean),
        }
    pairs = []
    for _ in range(FORWARD_PAIRS):
        pair = {}
        for name, engine in (("eager", False), ("engine", True)):
            with engine_context(engine):
                pair[name] = _window_us(makers["eager"][0], acc_batches, forward=True)
        pairs.append(pair)
    diffs = [p["engine"] - p["eager"] for p in pairs]
    forward = {
        "pairs": pairs, "engine_minus_eager_us": diffs, "mean_diff_us": statistics.mean(diffs),
        "engine_faster_in": sum(d < 0 for d in diffs), "of": len(diffs),
    }
    out = {
        "per_update": per_update, "forward_pairs": forward, "breakdown": _step_breakdown(acc_batches),
        "gil": check_gil_release(acc_batches),
    }
    _log("  engine tier times: " + ", ".join(f"{k} {v['update_us']:.1f} us" for k, v in per_update.items())
         + f"; forward engine-eager {forward['mean_diff_us']:+.1f} us (engine faster in {forward['engine_faster_in']}/"
         f"{len(diffs)}); replay releases the GIL: {out['gil']['replay_releases_gil']}")
    print(json.dumps({"host_breakdown": out["breakdown"]}), flush=True)
    return out


def check_capture_error_raises() -> dict:
    """An operation a CUDA graph cannot hold raises out of the engine's capture, as a
    fault: it is not classified as a transient failure, retried or run eagerly instead.
    Afterwards the caller's stream is current again and the card still computes."""
    from torchmetrics_tpu_torch import Metric
    from torchmetrics_tpu_torch.engine import txn

    class Synchronizing(Metric):
        full_state_update = False

        def __init__(self):
            super().__init__()
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + x.sum()
            torch.cuda.current_stream().synchronize()  # not permitted while the stream captures

        def compute(self):
            return self.total

    m = Synchronizing()
    stream = torch.cuda.current_stream()
    x = torch.ones(64, device="cuda")
    try:
        m.update(x)
    except RuntimeError as exc:
        raised = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
        if txn.classify_dispatch_error(exc) is not None:
            raise AssertionError(f"a capture fault was classified as transient: {raised}") from exc
    else:
        raise AssertionError(f"a synchronize inside the capture did not raise: {m._engine.stats.as_dict()}")
    if torch.cuda.current_stream() != stream:
        raise AssertionError("the failed capture left another stream current")
    if float((x * 2).sum()) != 128.0:
        raise AssertionError("the card computes wrongly after a failed capture")
    _log(f"  an illegal operation inside the capture raised: {raised}")
    return {"raised": raised, "fallback_reasons": dict(m._engine.stats.fallback_reasons)}


def run_engine_tier(acc_batches: list, cifar_batches: list, gen: torch.Generator) -> dict:
    """Phase 14: the scan queue, its background drains, the quarantine and compensated
    riders and the cached compute on the paths of phases 4 and 5."""
    out = {
        "accuracy": run_scan_accuracy(acc_batches),
        "collection": run_scan_collection(cifar_batches),
        "quarantine": run_scan_quarantine(acc_batches),
        "compensated": run_compensated(gen),
        "launch_count_check": check_scan_launches_against_profiler(acc_batches),
    }
    check_scan_no_sync(acc_batches)
    out["times"] = time_engine_tier(acc_batches)
    out["capture_fault"] = check_capture_error_raises()
    return out


# ---------------------------------------------------------------- phase 15: the rest of classification, regression's sums

N_BINS = 15  # the calibration bins of the usual reliability diagram
TOP1 = 0.76  # the share of ImageNet rows whose top class is the target (a ResNet-50's top-1)
ADULT_SEX = (0.669, 0.331)  # UCI Adult's sex attribute (male, female), as in Fairlearn's docs
ADULT_RACE = (0.854, 0.096, 0.031, 0.010, 0.008)  # White, Black, Asian-Pac-Islander, Amer-Indian-Eskimo, Other
REG_BATCH = 1 << 20
REG_WIDE_BATCH, REG_OUTPUTS = 131072, 8
# float32 sums of up to 2^20 terms, reduced in other orders on the card and the CPU, some
# terms through a log or a power an ulp apart
TM_SUM_RTOL = 2e-6
# R², RSE and explained variance divide by a difference of sums (Σy² - (Σy)²/n), which
# multiplies a sum's relative error by Σy² / TSS (~4.5 on these targets)
TM_VALUE_RTOL = 1e-5
TWEEDIE_ATOL = 1e-6  # a power outside {0, 1, 2}: each row's deviance is a difference of O(1) terms
# the calibration states are bit-equal on both sides; only the bins' float32 sums differ,
# added in the atomics' order on the card
CE_SIGMAS = 6.0


def _ce_tolerance(rows: int) -> float:
    """The calibration error's tolerance between the card and the CPU: a float32 sum of
    ``rows`` terms in [0, 1] added in two orders is a random walk of roundings, whose
    standard deviation is ``2^-24 * sqrt(rows / 3)`` of the sum; the error is a weighted
    mean of the bins' relative errors, held to ``CE_SIGMAS`` of those."""
    return CE_SIGMAS * 2.0**-24 * (rows / 3) ** 0.5


def _tm_imagenet_batches(gen: torch.Generator, n_batches: int = N_BATCHES, n: int = ACC_BATCH, c: int = ACC_CLASSES) -> list:
    """ImageNet-1k logits of a confident model: the top class is the target on ``TOP1``
    of the rows and carries a margin of 4-10, so the softmax confidences spread over
    [0, 1] as a trained network's do."""
    out = []
    for _ in range(n_batches):
        target = torch.randint(0, c, (n,), generator=gen)
        top = torch.where(torch.rand(n, generator=gen) < TOP1, target, torch.randint(0, c, (n,), generator=gen))
        logits = torch.randn(n, c, generator=gen) * 1.5
        logits.scatter_add_(1, top[:, None], 4 + 6 * torch.rand(n, 1, generator=gen))
        out.append((logits.cuda(), target.cuda()))
    return out


def _tm_groups(gen: torch.Generator, n: int, shares: tuple) -> torch.Tensor:
    return torch.multinomial(torch.tensor(shares), n, replacement=True, generator=gen).cuda()


def _tm_regression_batches(gen: torch.Generator, n_batches: int = N_BATCHES, shape: tuple = (REG_BATCH,)) -> list:
    """Positive log-normal targets and predictions off by a log-normal relative error."""
    out = []
    for _ in range(n_batches):
        target = torch.exp(0.5 * torch.randn(*shape, generator=gen))
        preds = target * torch.exp(0.2 * torch.randn(*shape, generator=gen))
        out.append((preds.cuda(), target.cuda()))
    return out


def _tm_imagenet(device=None) -> dict:
    import torchmetrics_tpu_torch as tm

    c, common = ACC_CLASSES, dict(device=device, validate_args=False)
    return {
        "acc": tm.MulticlassAccuracy(c, **common),
        "ece": tm.MulticlassCalibrationError(c, n_bins=N_BINS, **common),
        "ece_l2": tm.MulticlassCalibrationError(c, n_bins=N_BINS, norm="l2", **common),
        "hinge": tm.MulticlassHingeLoss(c, **common),
        "hinge_ova": tm.MulticlassHingeLoss(c, multiclass_mode="one-vs-all", **common),
        "dice": tm.Dice(num_classes=c, average="macro", device=device),
    }


def _tm_coco(device=None) -> dict:
    import torchmetrics_tpu_torch as tm

    common = dict(num_labels=ML_LABELS, ignore_index=ML_IGNORE, device=device, validate_args=False)
    return {
        "coverage": tm.MultilabelCoverageError(**common),
        "rank_ap": tm.MultilabelRankingAveragePrecision(**common),
        "rank_loss": tm.MultilabelRankingLoss(**common),
        "map": tm.MultilabelAveragePrecision(thresholds=N_THRESH, **common),
    }


def _tm_ctr(device=None) -> dict:
    import torchmetrics_tpu_torch as tm

    common = dict(device=device, validate_args=False)
    return {
        "ece": tm.BinaryCalibrationError(n_bins=N_BINS, **common),
        "hinge": tm.BinaryHingeLoss(**common),
        "auroc": tm.BinaryAUROC(thresholds=N_THRESH, **common),
    }


def _tm_fairness(device=None) -> dict:
    """Fed ``(preds, clicks, groups)``: sex for the fairness ratios, race for the rates."""
    import torchmetrics_tpu_torch as tm

    common = dict(device=device, validate_args=False)
    return {"fair": tm.BinaryFairness(len(ADULT_SEX), task="all", **common), "rates": tm.BinaryGroupStatRates(len(ADULT_RACE), **common)}


def _tm_regression(device=None) -> dict:
    import torchmetrics_tpu_torch as tm

    d = dict(device=device)
    return {
        "mse": tm.MeanSquaredError(**d), "rmse": tm.MeanSquaredError(squared=False, **d),
        "mae": tm.MeanAbsoluteError(**d), "msle": tm.MeanSquaredLogError(**d),
        "mape": tm.MeanAbsolutePercentageError(**d), "smape": tm.SymmetricMeanAbsolutePercentageError(**d),
        "wmape": tm.WeightedMeanAbsolutePercentageError(**d), "minkowski": tm.MinkowskiDistance(p=3, **d),
        "logcosh": tm.LogCoshError(**d), "r2": tm.R2Score(**d), "rse": tm.RelativeSquaredError(**d),
        "ev": tm.ExplainedVariance(**d), "tweedie0": tm.TweedieDevianceScore(power=0.0, **d),
        "tweedie15": tm.TweedieDevianceScore(power=1.5, **d),
    }


def _tm_regression_wide(device=None) -> dict:
    import torchmetrics_tpu_torch as tm

    return {
        "mse8": tm.MeanSquaredError(num_outputs=REG_OUTPUTS, device=device),
        "r2_8": tm.R2Score(num_outputs=REG_OUTPUTS, multioutput="raw_values", device=device),
    }


class _TensorPath:
    """One phase-15 or phase-16 path. ``units``: name -> ``(make(device) -> {member:
    metric}, card args of update i)``, one collection (or one metric) each on the card;
    ``host_units``: the same members as the CPU run builds them, with the inputs as the
    card's metrics see them (the card's own softmax or sigmoid where the metric applies
    one). ``host_prepare(objs)`` runs on the CPU units after their updates (phase 16 hands
    some CPU members an independent reference compute); ``value_tol(member, w)`` and
    ``state_rtol`` (member -> relative tolerance of float states) override phase 15's."""

    def __init__(self, name: str, units: dict, host_units: dict, n: int, groups: set, per_update: dict,
                 falling_back: set, no_sync: set, ce_rows: int = 0, host_prepare=None, value_tol=None,
                 state_rtol: "dict | None" = None):
        self.name, self.units, self.host_units, self.n = name, units, host_units, n
        self.groups, self.per_update, self.falling_back, self.no_sync = groups, per_update, falling_back, no_sync
        self.ce_rows = ce_rows
        self.host_prepare, self.value_tol, self.state_rtol = host_prepare, value_tol, state_rtol or {}


def _tm_unit(members: dict):
    """A collection of ``members``, or the one metric (named by its member) when alone."""
    from torchmetrics_tpu_torch import MetricCollection

    if len(members) > 1:
        return MetricCollection(members)
    (name, metric), = members.items()
    metric._tm_name = name
    return metric


def _tm_members(objs: dict) -> dict:
    """member name -> metric over a path's units (a unit of one metric is named by its member)."""
    from torchmetrics_tpu_torch import MetricCollection

    out = {}
    for obj in objs.values():
        if isinstance(obj, MetricCollection):
            out.update(dict(obj.items(keep_base=True, copy_state=False)))
        else:
            out[obj._tm_name] = obj
    return out


def _tm_drive(path: _TensorPath, device=None) -> tuple:
    """Every unit over the path's updates (the CPU units when ``device="cpu"``), then
    ``compute``: the units and a member -> value dict."""
    objs, values = {}, {}
    for u, (make, args) in (path.host_units if device == "cpu" else path.units).items():
        obj = objs[u] = _tm_unit(make(device))
        for i in range(path.n):
            obj.update(*args(i))
    if device == "cpu" and path.host_prepare is not None:
        path.host_prepare(objs)
    for obj in objs.values():
        value = obj.compute()
        values.update({obj._tm_name: value} if hasattr(obj, "_tm_name") else value)
    return objs, values


def _tm_value_tol(path: _TensorPath, member: str, w: torch.Tensor) -> torch.Tensor:
    """A value's tolerance against the CPU run (see the constants above)."""
    if path.value_tol is not None:
        return path.value_tol(member, w)
    if member.startswith("ece"):
        return torch.full_like(w, _ce_tolerance(path.ce_rows))
    if member in ("r2", "rse", "ev", "r2_8"):
        return 1e-7 + TM_VALUE_RTOL * w.abs()
    if member == "tweedie15":
        return TWEEDIE_ATOL + TM_SUM_RTOL * w.abs()
    if member in ("auroc", "map"):
        return torch.full_like(w, AUROC_ATOL)
    return ACC_ATOL + TM_SUM_RTOL * w.abs()


def _tm_flat(value) -> list:
    if isinstance(value, dict):
        return [t for k in sorted(value) for t in _tm_flat(value[k])]
    return [t.detach().double().cpu().reshape(-1) for t in _outputs(value)]


def run_tensor_path(path: _TensorPath) -> dict:
    """16 updates eagerly, then with the engine on, then ``compute``; the same on the
    CPU. Groups, K1 / K2 launches per update, the engine's split (replays where the JAX
    engine compiles, fallbacks where it falls back), every state against the CPU run,
    the engine run's states bit-equal to eager, values within the stated tolerances,
    host syncs per update."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import engine_context

    n = path.n
    runs = {}
    for mode in ("eager", "engine"):
        with engine_context(mode == "engine"):
            _zero_launches()
            objs, values = _tm_drive(path)
            runs[mode] = (objs, _launches(), values)
    (eager, eager_launches, eager_values), (card, engine_launches, values) = runs["eager"], runs["engine"]
    host, host_values = _tm_drive(path, device="cpu")

    got_groups = set()
    for objs in (eager, card):
        found = set()
        for obj in objs.values():
            if isinstance(obj, MetricCollection):
                found |= {frozenset(g) for g in obj.compute_groups.values()}
            else:
                found.add(frozenset({obj._tm_name}))
        if found != path.groups:
            raise AssertionError(f"tensor {path.name}: compute groups {sorted(map(sorted, found))}, expected {path.groups}")
        got_groups = found
    want = {k: v * n for k, v in path.per_update.items()}
    if eager_launches != want:
        raise AssertionError(f"tensor {path.name}: eager launches {eager_launches}, expected {want}")
    # K2 stays eager under the engine (the binned curves fall back); K1 runs in the fused
    # graph: the warm-up's launch, one per replay, and the pad-row unit's once per
    # signature when the signature is bucketed
    if engine_launches["multi_threshold"] != want["multi_threshold"] or engine_launches["stat_counts"] not in (
        want["stat_counts"], want["stat_counts"] + (1 if want["stat_counts"] else 0)
    ):
        raise AssertionError(f"tensor {path.name}: engine launches {engine_launches}, eager {want}")

    members, eager_members, host_members = _tm_members(card), _tm_members(eager), _tm_members(host)
    diffs, failures = {}, []
    for m, metric in members.items():
        try:
            _assert_same_states(f"tensor {path.name} {m} engine vs eager", metric, eager_members[m])
            # the calibration states are the card's confidences and hits: bit-equal
            rtol = path.state_rtol.get(m, 0.0 if m.startswith("ece") else TM_SUM_RTOL)
            _assert_same_states(f"tensor {path.name} {m} vs cpu", eager_members[m], host_members[m], float_rtol=rtol)
        except AssertionError as exc:
            failures.append(str(exc))
        if isinstance(values[m], dict) and not list(values[m]) == list(eager_values[m]) == list(host_values[m]):
            failures.append(f"tensor {path.name} {m}: keys {list(values[m])}, eager {list(eager_values[m])}, cpu {list(host_values[m])}")
        worst = 0.0
        for i, (g, e, w) in enumerate(zip(_tm_flat(values[m]), _tm_flat(eager_values[m]), _tm_flat(host_values[m]))):
            tol = _tm_value_tol(path, m, w)
            # the calibration bins are float32 atomics: their sums differ from run to run
            if not (bool(((g - e).abs() <= tol).all()) if m.startswith("ece") else torch.equal(g, e)):
                failures.append(f"tensor {path.name} {m} value {i}: engine {g[:8].tolist()} vs eager {e[:8].tolist()}")
            if not bool(((e - w).abs() <= tol).all()) or not torch.isfinite(g).all() or g.shape != w.shape:
                failures.append(f"tensor {path.name} {m} value {i}: cuda {g[:8].tolist()} vs cpu {w[:8].tolist()}")
            rel = ((g - w).abs() / w.abs().clamp(min=1e-30)).max().item() if w.numel() else 0.0
            worst = max(worst, rel if m not in ("auroc", "map") and not m.startswith("ece") else (g - w).abs().max().item())
        diffs[m] = worst

    # the engine's split: replays where the JAX engine compiles, fallbacks where it falls back
    split = {}
    for u, obj in card.items():
        if isinstance(obj, MetricCollection):
            owners = [g.owner for g in obj._groups.values()]
            discovery = 0 if all(obj._cse_signatures.get(o) is not None for o in owners) else 1
            fused = obj._fused_engine
            eligible = [o for o in owners if o not in path.falling_back]
            if len(eligible) >= 2:
                st = fused.stats
                split[f"{u}:fused"] = st.as_dict()
                if st.eager_fallbacks or st.dispatches != n - discovery:
                    failures.append(f"tensor {path.name} {u}: fused engine {st.as_dict()}")
                _check_replays(f"tensor {path.name} {u} fused", fused)
            elif eligible:
                st = obj._modules[eligible[0]]._engine.stats
                split[eligible[0]] = st.as_dict()
                if st.eager_fallbacks or st.dispatches != n - discovery:
                    failures.append(f"tensor {path.name} {eligible[0]}: engine {st.as_dict()}")
            for o in owners:
                if o in path.falling_back:
                    st = obj._modules[o]._engine.stats
                    split[o] = st.as_dict()
                    if st.dispatches or st.eager_fallbacks != n - discovery:
                        failures.append(f"tensor {path.name}: {o} should fall back every update: {st.as_dict()}")
        elif obj._tm_name in path.falling_back:
            st = obj._engine.stats
            split[obj._tm_name] = st.as_dict()
            if st.dispatches or st.eager_fallbacks != n:
                failures.append(f"tensor {path.name}: {obj._tm_name} should fall back every update: {st.as_dict()}")
        else:
            st = obj._engine.stats
            split[obj._tm_name] = st.as_dict()
            if st.eager_fallbacks or st.dispatches != n:
                failures.append(f"tensor {path.name} {obj._tm_name}: engine {st.as_dict()}")
            _check_replays(f"tensor {path.name} {obj._tm_name}", obj._engine)
    if failures:
        raise AssertionError(f"tensor {path.name}: {len(failures)} failures, max rel diffs {diffs}: " + " | ".join(failures[:12]))

    # host syncs per update (eager), and the updates the JAX package runs without a host read
    syncs = {}
    with engine_context(False):
        for u, (make, args) in path.units.items():
            for m, metric in make().items():
                metric.update(*args(0))  # first-use allocations and plan caches are not the point
                syncs[m] = _syncs_per_call(lambda metric=metric: metric.update(*args(1)))
            quiet = [metric for m, metric in make().items() if m in path.no_sync]
            if quiet:
                _updates_without_sync(f"tensor {path.name} {u}", quiet, args(0))
    summary = {
        "groups": sorted(sorted(g) for g in got_groups),
        "launches_eager": eager_launches,
        "launches_engine": engine_launches,
        "engine_split": split,
        "host_syncs_per_update": syncs,
        "max_diff_to_cpu": diffs,
        "values": {k: [round(x, 7) for x in torch.cat(_tm_flat(v))[:8].tolist()] for k, v in values.items()},
    }
    _log(f"  tensor {path.name}: groups {summary['groups']}, {n} updates eager and with the engine, launches"
         f" {eager_launches} / {engine_launches}; states equal to the CPU, engine bit-equal to eager; syncs {syncs}")
    return summary


def _tm_paths(imagenet: list, coco: list, ctr: list, gen: torch.Generator) -> dict:
    """The four paths of phase 15 over their batches."""
    soft = [torch.softmax(p, dim=1).cpu() for p, _ in imagenet]  # the kernel the metrics run on the card
    host_imagenet = [(p.cpu(), t.cpu()) for p, t in imagenet]
    coco_host = [(_sigmoid(p).cpu(), t.cpu()) for p, t in coco]
    ctr_host = [(_sigmoid(p).cpu(), t.cpu()) for p, t in ctr]
    sex = [_tm_groups(gen, p.shape[0], ADULT_SEX) for p, _ in ctr]
    race = [_tm_groups(gen, p.shape[0], ADULT_RACE) for p, _ in ctr]
    sex_host, race_host = [g.cpu() for g in sex], [g.cpu() for g in race]
    reg = _tm_regression_batches(gen)
    wide = _tm_regression_batches(gen, shape=(REG_WIDE_BATCH, REG_OUTPUTS))
    reg_host, wide_host = [(p.cpu(), t.cpu()) for p, t in reg], [(p.cpu(), t.cpu()) for p, t in wide]

    def pick(members_fn, names):
        return lambda device=None: {k: v for k, v in members_fn(device).items() if k in names}

    n = len(imagenet)
    return {
        # one collection on the card; the CPU run of its calibration and hinge members
        # takes the card's own softmax
        "imagenet": _TensorPath(
            "imagenet", {"imagenet": (_tm_imagenet, lambda i: imagenet[i])},
            {"logits": (pick(_tm_imagenet, ("acc", "dice")), lambda i: host_imagenet[i]),
             "probs": (pick(_tm_imagenet, ("ece", "ece_l2", "hinge", "hinge_ova")), lambda i: (soft[i], host_imagenet[i][1]))},
            n, {frozenset({"acc"}), frozenset({"dice"}), frozenset({"ece", "ece_l2"}), frozenset({"hinge"}), frozenset({"hinge_ova"})},
            {"stat_counts": 1, "multi_threshold": 0}, {"ece", "hinge", "hinge_ova"}, {"acc", "dice"},
            ce_rows=n * imagenet[0][0].shape[0],
        ),
        "coco": _TensorPath(
            "coco", {"coco": (_tm_coco, lambda i: coco[i])}, {"coco": (_tm_coco, lambda i: coco_host[i])}, len(coco),
            {frozenset({"coverage"}), frozenset({"rank_ap"}), frozenset({"rank_loss"}), frozenset({"map"})},
            {"stat_counts": 0, "multi_threshold": 1}, {"map"}, {"coverage", "rank_ap", "rank_loss"},
        ),
        "ctr": _TensorPath(
            "ctr",
            {"ctr": (_tm_ctr, lambda i: ctr[i]),
             "fair": (pick(_tm_fairness, ("fair",)), lambda i: (*ctr[i], sex[i])),
             "rates": (pick(_tm_fairness, ("rates",)), lambda i: (*ctr[i], race[i]))},
            {"ctr": (_tm_ctr, lambda i: ctr_host[i]),
             "fair": (pick(_tm_fairness, ("fair",)), lambda i: (*ctr_host[i], sex_host[i])),
             "rates": (pick(_tm_fairness, ("rates",)), lambda i: (*ctr_host[i], race_host[i]))},
            len(ctr), {frozenset({"ece"}), frozenset({"hinge"}), frozenset({"auroc"}), frozenset({"fair"}), frozenset({"rates"})},
            {"stat_counts": 0, "multi_threshold": 1}, {"ece", "hinge", "auroc"}, {"fair", "rates"},
            ce_rows=len(ctr) * ctr[0][0].shape[0],
        ),
        "regression": _TensorPath(
            "regression",
            {"main": (_tm_regression, lambda i: reg[i]), "wide": (_tm_regression_wide, lambda i: wide[i])},
            {"main": (_tm_regression, lambda i: reg_host[i]), "wide": (_tm_regression_wide, lambda i: wide_host[i])},
            len(reg),
            {frozenset({"mse", "rmse"}), frozenset({"r2", "rse"}), *(frozenset({k}) for k in
             ("mae", "msle", "mape", "smape", "wmape", "minkowski", "logcosh", "ev", "tweedie0", "tweedie15", "mse8", "r2_8"))},
            {"stat_counts": 0, "multi_threshold": 0}, set(),
            {"mse", "rmse", "mae", "msle", "mape", "smape", "wmape", "minkowski", "logcosh", "r2", "rse", "ev", "tweedie0",
             "mse8", "r2_8"},
        ),
    }


def check_tweedie_replay_without_sync(reg_batch: tuple) -> dict:
    """Tweedie at power 1.5: its eager update reads the host for the domain checks; under
    the engine they skip inside the captured body, and a replay runs under
    ``set_sync_debug_mode("error")``."""
    from torchmetrics_tpu_torch import TweedieDevianceScore
    from torchmetrics_tpu_torch.engine import engine_context

    with engine_context(False):
        eager = TweedieDevianceScore(power=1.5)
        eager.update(*reg_batch)
        eager_syncs = _syncs_per_call(lambda: eager.update(*reg_batch))
    with engine_context(True):
        m = TweedieDevianceScore(power=1.5)
        m.update(*reg_batch)
        m.update(*reg_batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            m.update(*reg_batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    st = m._engine.stats
    if st.eager_fallbacks or st.dispatches != 3:
        raise AssertionError(f"tweedie 1.5 under the engine: {st.as_dict()}")
    _check_replays("tweedie 1.5", m._engine)
    _log(f"  tweedie 1.5: {eager_syncs} host syncs per eager update; a replay under set_sync_debug_mode('error')")
    return {"eager_host_syncs": eager_syncs, "engine": st.as_dict()}


def check_debiased_l2(path: _TensorPath) -> dict:
    """The l2 calibration error with ``debias`` (the functional ``_ce_compute``) on the
    ImageNet path's states, against the CPU."""
    from torchmetrics_tpu_torch.functional.classification.calibration_error import _ce_compute
    from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

    card = _tm_imagenet()["ece_l2"]
    host = _tm_imagenet(device="cpu")["ece_l2"]
    card_args, host_args = path.units["imagenet"][1], path.host_units["probs"][1]
    for i in range(path.n):
        card.update(*card_args(i))
        host.update(*host_args(i))
    got = _ce_compute(dim_zero_cat(card.confidences), dim_zero_cat(card.accuracies), N_BINS, "l2", debias=True)
    want = _ce_compute(dim_zero_cat(host.confidences), dim_zero_cat(host.accuracies), N_BINS, "l2", debias=True)
    diff = abs(float(got) - float(want))
    if diff > _ce_tolerance(path.ce_rows) or not torch.isfinite(got):
        raise AssertionError(f"debiased l2 calibration error: cuda {float(got)} vs cpu {float(want)}")
    return {"value": float(got), "abs_diff_to_cpu": diff}


def time_tensor_paths(paths: dict) -> dict:
    """Each path's ``update`` (every unit once), engine on against eager, in turns
    (eager, engine, engine, eager): host µs to a device sync, device busy, operations,
    idle share and the largest device items."""
    from torchmetrics_tpu_torch.engine import engine_context

    out = {}
    for name, path in paths.items():
        runs = {"eager": [], "engine": []}
        for mode in ("eager", "engine", "engine", "eager"):
            with engine_context(mode == "engine"):
                objs = [(_tm_unit(make()), args) for make, args in path.units.values()]

                def step(i, objs=objs):
                    for obj, args in objs:
                        obj.update(*args(i % path.n))

                step(0)  # settles groups, builds and captures
                step(1)
                runs[mode].append(_timed(step))
                del objs
                gc.collect()
        out[name] = {mode: _mean_runs(rs) for mode, rs in runs.items()}
        out[name]["update_us_runs"] = {mode: [r["update_us"] for r in rs] for mode, rs in runs.items()}
    _log("  tensor-metric times: " + ", ".join(
        f"{k} {v['eager']['update_us']:.1f} -> {v['engine']['update_us']:.1f} us" for k, v in out.items()
    ))
    return out


def run_tensor_metrics(imagenet: list, coco: list, ctr: list, gen: torch.Generator) -> dict:
    """Phase 15: calibration error, hinge loss, Dice (ImageNet-1k), the multilabel
    rankings beside a binned mAP (MS-COCO), calibration, hinge and group fairness beside
    a binned AUROC (click-through), and regression's sum-state metrics."""
    paths = _tm_paths(imagenet, coco, ctr, gen)
    out = {name: run_tensor_path(path) for name, path in paths.items()}
    out["debiased_l2"] = check_debiased_l2(paths["imagenet"])
    out["tweedie_replay"] = check_tweedie_replay_without_sync(paths["regression"].units["main"][1](0))
    out["tolerances"] = {
        "sum_rtol": TM_SUM_RTOL, "value_rtol_r2_rse_ev": TM_VALUE_RTOL, "tweedie_atol": TWEEDIE_ATOL,
        "ce_atol": {k: _ce_tolerance(p.ce_rows) for k, p in paths.items() if p.ce_rows},
    }
    out["times"] = time_tensor_paths(paths)
    return out


# ---------------------------------------------------------------- phase 16: regression's moments and cat states, retrieval

KD_TEMPERATURE = 2.0  # the teacher's softmax temperature, as knowledge distillation uses
KENDALL_BATCH = 4096
KENDALL_LEVELS = 5  # human labels on a 1-5 scale
EMB_BATCH, EMB_DIM = 8192, 768  # BERT-base sentence embeddings
MSM_QUERIES, MSM_CANDIDATES = 6980, 1000  # MS MARCO passage dev (small), BM25 top-1000
MSM_POS_SHARE = 0.857  # queries with a positive among their BM25 top-1000 (BM25 recall@1000)
MSM_SECOND_POS = 0.07  # share of those with a second positive: ~1.07 positives per query
MSM_MARGIN = 3.5  # a positive's mean score above the negatives' (unit variance)
MSM_TOP_K, MSM_MAX_K = 10, 100
TM2_PATHS = ("distill", "regression", "kendall", "embeddings", "msmarco")
# Pearson's running moments: each batch adds centred products whose float32 sums over
# 2^20 rows the card and the CPU reduce in other orders, and the running mean's update
# (n_prior * mean + Σx) / n carries each batch's rounding into the next
TM2_MOMENT_RTOL = 1e-5
# a float64 statistic rounded once to float32 on both sides (Spearman's ranks and
# Kendall's counts are exact): at most one float32 ulp apart
TM2_ROUNDED_RTOL = 2.0**-23
# the cosine's per-row dot products and norms over 768 floats, and KL's over 1000
# classes, are float32 reductions in other orders: relative 2e-6 of a row's terms
TM2_ROW_RTOL = 2e-6
# Kendall's pair scan: float32 operations per distinct pair that the work needs (two
# differences and the product of their signs), for the bound
KENDALL_OPS_PER_PAIR = 3


def _tm2_distill_batches(gen: torch.Generator) -> tuple:
    """ImageNet-1k student logits as phase 15 makes them, and a teacher that agrees with
    the student up to noise: ``(logits, labels)`` for the accuracy and ``(teacher probs,
    student probs)`` for KL(teacher ‖ student), on the card."""
    student = _tm_imagenet_batches(gen)
    kl = []
    for logits, _ in student:
        teacher = logits + torch.randn(logits.shape, generator=gen).cuda()
        kl.append((torch.softmax(teacher / KD_TEMPERATURE, dim=1), torch.softmax(logits, dim=1)))
    return student, kl


def _tm2_kendall_batches(gen: torch.Generator) -> list:
    """A ranker's scores rounded to 0.01 (ties) against human labels on a 1-5 scale that
    agree with them up to noise."""
    out = []
    for _ in range(N_BATCHES):
        score = torch.rand(KENDALL_BATCH, generator=gen)
        label = torch.clamp(torch.round(score * KENDALL_LEVELS + 0.5 + torch.randn(KENDALL_BATCH, generator=gen)), 1, KENDALL_LEVELS)
        out.append((torch.round(score * 100) / 100, label))
    return [(p.cuda(), t.cuda()) for p, t in out]


def _tm2_embedding_batches(gen: torch.Generator) -> list:
    """Pairs of 768-wide embeddings, the second a noisy copy of the first."""
    out = []
    for _ in range(N_BATCHES):
        a = torch.randn(EMB_BATCH, EMB_DIM, generator=gen)
        out.append((a.cuda(), (a + 0.8 * torch.randn(EMB_BATCH, EMB_DIM, generator=gen)).cuda()))
    return out


def _tm2_msmarco_batches(gen: torch.Generator) -> list:
    """MS MARCO passage dev (small): every query's 1000 candidates, whole queries per
    update. ``MSM_POS_SHARE`` of the queries have a positive (a second on
    ``MSM_SECOND_POS`` of them), the rest none; a re-ranker scores positives
    ``MSM_MARGIN`` above the negatives. Graded relevance 0-3 as TREC DL grades: a
    positive 2 or 3, 2 % of the negatives 1. Query ids are spread, as real ids are.
    ``(scores, binary, graded, query ids)`` per update, on the card."""
    has_pos = torch.rand(MSM_QUERIES, generator=gen) < MSM_POS_SHARE
    n_pos = has_pos.long() * (1 + (torch.rand(MSM_QUERIES, generator=gen) < MSM_SECOND_POS).long())
    slot = torch.arange(MSM_CANDIDATES).expand(MSM_QUERIES, MSM_CANDIDATES)
    binary = (slot < n_pos[:, None]).long()
    scores = torch.randn(MSM_QUERIES, MSM_CANDIDATES, generator=gen) + MSM_MARGIN * binary
    graded = binary * torch.randint(2, 4, binary.shape, generator=gen)
    graded = torch.where((binary == 0) & (torch.rand(binary.shape, generator=gen) < 0.02), 1, graded)
    qids = (1_048_578 + 7 * torch.arange(MSM_QUERIES)).expand(MSM_CANDIDATES, MSM_QUERIES).T
    out = []
    for rows in torch.tensor_split(torch.arange(MSM_QUERIES), N_BATCHES):
        out.append(tuple(x[rows].reshape(-1).cuda() for x in (scores, binary, graded, qids)))
    return out


def _tm2_distill(device=None) -> dict:
    import torchmetrics_tpu_torch as tm

    return {"acc": tm.MulticlassAccuracy(ACC_CLASSES, validate_args=False, device=device)}


def _tm2_kl(device=None) -> dict:
    import torchmetrics_tpu_torch as tm

    return {"kl": tm.KLDivergence(device=device), "kl_rows": tm.KLDivergence(reduction="none", device=device)}


def _tm2_moments(device=None, outputs: int = 1) -> dict:
    """Pearson and concordance (one group); at one output beside an MSE, so the fused
    collection graph carries the ``dist_reduce_fx=None`` moments."""
    import torchmetrics_tpu_torch as tm

    suffix = "" if outputs == 1 else str(outputs)
    members = {
        f"pearson{suffix}": tm.PearsonCorrCoef(num_outputs=outputs, device=device),
        f"ccc{suffix}": tm.ConcordanceCorrCoef(num_outputs=outputs, device=device),
    }
    if outputs == 1:
        members["mse"] = tm.MeanSquaredError(device=device)
    return members


def _tm2_spearman(device=None) -> dict:
    import torchmetrics_tpu_torch as tm

    return {"spearman": tm.SpearmanCorrCoef(device=device)}


def _tm2_kendall(device=None) -> dict:
    import torchmetrics_tpu_torch as tm

    return {
        "tau_a": tm.KendallRankCorrCoef(variant="a", device=device),
        "tau_b": tm.KendallRankCorrCoef(variant="b", device=device),
        "tau_c": tm.KendallRankCorrCoef(variant="c", device=device),
        "tau_b_test": tm.KendallRankCorrCoef(variant="b", t_test=True, device=device),
    }


def _tm2_cosine(device=None) -> dict:
    import torchmetrics_tpu_torch as tm

    return {"cosine": tm.CosineSimilarity(reduction="mean", device=device)}


def _tm2_retrieval(device=None) -> dict:
    from torchmetrics_tpu_torch import retrieval as r

    k, d = MSM_TOP_K, dict(device=device)
    return {
        "mrr": r.RetrievalMRR(**d), "map10": r.RetrievalMAP(top_k=k, **d), "p10": r.RetrievalPrecision(top_k=k, **d),
        "r10": r.RetrievalRecall(top_k=k, empty_target_action="skip", **d), "fallout10": r.RetrievalFallOut(top_k=k, **d),
        "hit10": r.RetrievalHitRate(top_k=k, **d), "rprec": r.RetrievalRPrecision(**d),
        "curve": r.RetrievalPrecisionRecallCurve(max_k=MSM_MAX_K, **d),
        "r_at_p": r.RetrievalRecallAtFixedPrecision(min_precision=0.1, max_k=MSM_MAX_K, **d),
    }


def _tm2_ndcg(device=None) -> dict:
    from torchmetrics_tpu_torch.retrieval import RetrievalNormalizedDCG

    return {"ndcg10": RetrievalNormalizedDCG(top_k=MSM_TOP_K, device=device)}


def _tm2_auroc(device=None) -> dict:
    import torchmetrics_tpu_torch as tm

    return {"auroc": tm.BinaryAUROC(thresholds=N_THRESH, validate_args=False, device=device)}


_TM2_RETRIEVAL = ("mrr", "map10", "p10", "r10", "fallout10", "hit10", "rprec", "curve", "r_at_p")


def _kendall_reference(x, y) -> dict:
    """Kendall's statistics by sorting, independent of the port's pair scan: Σ over
    pairs of sign(dx)·sign(dy) from a Fenwick tree over y's ranks walked in x order (a
    group of equal x is queried before it is inserted, so its pairs count 0), the tie
    sums from the group sizes, then tau a / b / c and the two-sided p-value of b in
    float64, as the JAX package's formulas give them."""
    import math

    import numpy as np

    x, y = x.double().numpy(), y.double().numpy()
    n = x.size
    _, x_sizes = np.unique(x, return_counts=True)
    _, y_rank, y_sizes = np.unique(y, return_inverse=True, return_counts=True)
    _, xy_sizes = np.unique(np.stack([x, y], 1), axis=0, return_counts=True)
    order = np.lexsort((y, x))
    xs, ys = x[order], y_rank[order]
    tree = [0] * (len(y_sizes) + 1)

    def below(r: int) -> int:  # inserted elements with y rank < r
        total = 0
        while r > 0:
            total, r = total + tree[r], r & (r - 1)
        return total

    s, inserted, i = 0, 0, 0
    while i < n:
        j = i
        while j < n and xs[j] == xs[i]:
            j += 1
        for k in range(i, j):
            r = int(ys[k])
            s += below(r) - (inserted - below(r + 1))
        for k in range(i, j):
            r = int(ys[k]) + 1
            while r < len(tree):
                tree[r] += 1
                r += r & -r
            inserted += 1
        i = j

    def pairs(t):
        return int((t * (t - 1) // 2).sum())

    n0, n1, n2, n3 = n * (n - 1) // 2, pairs(x_sizes), pairs(y_sizes), pairs(xy_sizes)
    con_plus_dis = n0 - n1 - n2 + n3
    m = min(len(x_sizes), len(y_sizes))
    x_p1, y_p1 = (float((t * (t - 1) * (t - 2)).sum()) for t in (x_sizes, y_sizes))
    x_p2, y_p2 = (float((t * (t - 1) * (2 * t + 5)).sum()) for t in (x_sizes, y_sizes))
    tau_b = s / math.sqrt((n0 - n1) * (n0 - n2))
    var = (n * (n - 1) * (2 * n + 5) - x_p2 - y_p2) / 18 + 2 * n1 * n2 / (n * (n - 1)) + x_p1 * y_p1 / (9 * n * (n - 1) * (n - 2))
    p_value = math.erfc(abs(s / math.sqrt(var)) / math.sqrt(2))  # 2 * Φ(-|t|)
    clip = lambda v: min(1.0, max(-1.0, v))  # noqa: E731
    return {
        "concordant": (con_plus_dis + s) // 2, "discordant": (con_plus_dis - s) // 2,
        "tau_a": clip(s / con_plus_dis), "tau_b": clip(tau_b), "tau_c": clip(2 * s / ((m - 1) / m * n**2)),
        "p_value_b": p_value,
    }


def _kendall_host_prepare(objs: dict) -> None:
    """The CPU Kendall members compute from ``_kendall_reference``: the port's own pair
    scan does n² work, too much for a CPU at 65,536 rows and four taus."""
    from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

    for name, metric in _tm_members(objs).items():
        ref = _kendall_reference(dim_zero_cat(metric.preds)[:, 0], dim_zero_cat(metric.target)[:, 0])
        tau = torch.tensor(ref[name.removesuffix("_test")], dtype=torch.float32)
        metric.compute = (lambda tau=tau, p=torch.tensor(ref["p_value_b"], dtype=torch.float32): (tau, p)) if name.endswith(
            "_test") else (lambda tau=tau: tau)
        metric._tm_reference = ref


def _numpy_pack(indexes, preds, target) -> tuple:
    """The dense matrices of the JAX package's numpy pack (``np.lexsort`` order, ``-inf``
    / 0 / False pads), independent of the port's device-side one."""
    import numpy as np

    idx, p, t = indexes.numpy(), preds.numpy(), target.numpy()
    order = np.lexsort((-p, idx))
    idx, p, t = idx[order], p[order], t[order]
    _, counts = np.unique(idx, return_counts=True)
    n_queries, max_len = len(counts), int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = np.arange(len(idx)) - np.repeat(starts, counts)
    rows = np.repeat(np.arange(n_queries), counts)
    preds_mat = np.full((n_queries, max_len), -np.inf, dtype=np.float32)
    preds_mat[rows, ranks] = p
    target_mat = np.zeros((n_queries, max_len), dtype=np.float32)
    target_mat[rows, ranks] = t
    valid = np.zeros((n_queries, max_len), dtype=bool)
    valid[rows, ranks] = True
    return torch.from_numpy(preds_mat), torch.from_numpy(target_mat), torch.from_numpy(valid)


def _retrieval_host_prepare(objs: dict) -> None:
    """The CPU retrieval members compute over ``_numpy_pack`` of their epoch: one pack
    per target kind instead of one per member (the port's pack sorts 7M rows twice)."""
    from torchmetrics_tpu_torch.retrieval import RetrievalMetric
    from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

    packs = {}
    for metric in _tm_members(objs).values():
        if isinstance(metric, RetrievalMetric):
            key = metric.allow_non_binary_target
            if key not in packs:
                packs[key] = _numpy_pack(*(dim_zero_cat(getattr(metric, a)) for a in ("indexes", "preds", "target")))
            metric._packed = lambda pack=packs[key]: pack


def _tm2_value_tol(member: str, w: torch.Tensor) -> torch.Tensor:
    """Phase 16's value tolerances against the CPU (the constants above)."""
    if member.startswith(("spearman", "tau_")):
        return TM2_ROUNDED_RTOL * w.abs()
    if member.startswith(("pearson", "ccc")):
        return 1e-7 + TM2_MOMENT_RTOL * w.abs()
    if member in ("cosine", "kl", "kl_rows"):
        return 1e-7 + TM2_ROW_RTOL * w.abs()
    if member == "auroc":
        return torch.full_like(w, AUROC_ATOL)
    return ACC_ATOL + TM_SUM_RTOL * w.abs()  # accuracy, retrieval: float32 means over queries or rows


def _tm2_paths(gen: torch.Generator) -> dict:
    """The five paths of phase 16 over their batches (host copies for the CPU run)."""
    def host(batches):
        return [tuple(x.cpu() for x in b) for b in batches]

    student, kl = _tm2_distill_batches(gen)
    reg, wide = _tm_regression_batches(gen), _tm_regression_batches(gen, shape=(REG_WIDE_BATCH, REG_OUTPUTS))
    kendall, emb, msm = _tm2_kendall_batches(gen), _tm2_embedding_batches(gen), _tm2_msmarco_batches(gen)
    student_h, kl_h, reg_h, wide_h = host(student), host(kl), host(reg), host(wide)
    kendall_h, emb_h, msm_h = host(kendall), host(emb), host(msm)
    moments8 = lambda device=None: _tm2_moments(device, REG_OUTPUTS)  # noqa: E731
    retrieval_names = frozenset(_TM2_RETRIEVAL)
    moment_rtol = {m: TM2_MOMENT_RTOL for m in ("pearson", "ccc", f"pearson{REG_OUTPUTS}", f"ccc{REG_OUTPUTS}")}
    n = N_BATCHES
    return {
        "distill": _TensorPath(
            "distill",
            {"acc": (_tm2_distill, lambda i: student[i]), "kl": (_tm2_kl, lambda i: kl[i])},
            {"acc": (_tm2_distill, lambda i: student_h[i]), "kl": (_tm2_kl, lambda i: kl_h[i])},
            n, {frozenset({"acc"}), frozenset({"kl"}), frozenset({"kl_rows"})},
            {"stat_counts": 1, "multi_threshold": 0}, {"kl_rows"}, {"acc", "kl", "kl_rows"},
            value_tol=_tm2_value_tol, state_rtol={"kl": TM2_ROW_RTOL, "kl_rows": TM2_ROW_RTOL},
        ),
        "regression": _TensorPath(
            "regression",
            {"main": (_tm2_moments, lambda i: reg[i]), "wide": (moments8, lambda i: wide[i]),
             "spearman": (_tm2_spearman, lambda i: reg[i])},
            {"main": (_tm2_moments, lambda i: reg_h[i]), "wide": (moments8, lambda i: wide_h[i]),
             "spearman": (_tm2_spearman, lambda i: reg_h[i])},
            n, {frozenset({"pearson", "ccc"}), frozenset({"mse"}), frozenset({f"pearson{REG_OUTPUTS}", f"ccc{REG_OUTPUTS}"}),
                frozenset({"spearman"})},
            {"stat_counts": 0, "multi_threshold": 0}, {"spearman"},
            {"pearson", "ccc", "mse", f"pearson{REG_OUTPUTS}", f"ccc{REG_OUTPUTS}", "spearman"},
            value_tol=_tm2_value_tol, state_rtol=moment_rtol,
        ),
        "kendall": _TensorPath(
            "kendall", {"kendall": (_tm2_kendall, lambda i: kendall[i])}, {"kendall": (_tm2_kendall, lambda i: kendall_h[i])},
            n, {frozenset({"tau_a", "tau_b", "tau_c", "tau_b_test"})}, {"stat_counts": 0, "multi_threshold": 0},
            set(_tm2_kendall("cpu")), set(_tm2_kendall("cpu")), host_prepare=_kendall_host_prepare,
            value_tol=_tm2_value_tol,
        ),
        "embeddings": _TensorPath(
            "embeddings", {"cosine": (_tm2_cosine, lambda i: emb[i])}, {"cosine": (_tm2_cosine, lambda i: emb_h[i])},
            n, {frozenset({"cosine"})}, {"stat_counts": 0, "multi_threshold": 0}, {"cosine"}, {"cosine"},
            value_tol=_tm2_value_tol,
        ),
        "msmarco": _TensorPath(
            "msmarco",
            {"retrieval": (_tm2_retrieval, lambda i: (msm[i][0], msm[i][1], msm[i][3])),
             "ndcg": (_tm2_ndcg, lambda i: (msm[i][0], msm[i][2], msm[i][3])), "auroc": (_tm2_auroc, lambda i: msm[i][:2])},
            {"retrieval": (_tm2_retrieval, lambda i: (msm_h[i][0], msm_h[i][1], msm_h[i][3])),
             "ndcg": (_tm2_ndcg, lambda i: (msm_h[i][0], msm_h[i][2], msm_h[i][3])),
             "auroc": (_tm2_auroc, lambda i: (_sigmoid(msm[i][0]).cpu(), msm_h[i][1]))},
            n, {retrieval_names, frozenset({"ndcg10"}), frozenset({"auroc"})}, {"stat_counts": 0, "multi_threshold": 1},
            {*retrieval_names, "ndcg10", "auroc"}, {"ndcg10"}, host_prepare=_retrieval_host_prepare,
            value_tol=_tm2_value_tol,
        ),
    }


def check_retrieval_pack(path: _TensorPath) -> dict:
    """The card's pack of the msmarco epoch (``retrieval.base._pack_query_groups``)
    bit-equal to ``_numpy_pack`` of the same rows, with exactly one host read."""
    from torchmetrics_tpu_torch.retrieval.base import _pack_query_groups

    make, args = path.units["retrieval"]
    epoch = [torch.cat(parts) for parts in zip(*(args(i) for i in range(path.n)))]
    scores, target, qids = epoch
    indexes, target32 = qids.to(torch.int32), target.to(torch.int32)
    got = _pack_query_groups(indexes, scores, target32)
    want = _numpy_pack(indexes.cpu(), scores.cpu(), target32.cpu())
    for name, g, w in zip(("preds", "target", "valid"), got, want):
        g = g.cpu()
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
            raise AssertionError(f"retrieval pack: {name} {g.dtype}{tuple(g.shape)} differs from the numpy pack's {w.dtype}{tuple(w.shape)}")
    syncs = _syncs_per_call(lambda: _pack_query_groups(indexes, scores, target32))
    if syncs != 1:
        raise AssertionError(f"retrieval pack: {syncs} host reads, expected 1")
    ms = _host_us_per_call(lambda i: _pack_query_groups(indexes, scores, target32), iters=3) / 1e3
    _log(f"  msmarco pack: {tuple(got[0].shape)} bit-equal to the numpy pack, 1 host read, {ms:.2f} ms")
    return {"shape": list(got[0].shape), "rows": int(scores.numel()), "host_reads": syncs, "ms": ms}


def time_tensor2_computes(paths: dict, hbm_rate: float) -> dict:
    """Each member's ``compute`` on the card after its path's 16 eager updates: ms (host
    clock to a device sync, median of three, the cached value dropped each time) and host
    syncs per compute; a retrieval compute must read the host once (twice for recall at
    fixed precision, whose pick reads its curve), as the JAX package does. Kendall's
    distinct pairs per second beside the bound of its pair scan."""
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.retrieval import RetrievalMetric

    out = {}
    with engine_context(False):
        for name, path in paths.items():
            objs = {u: _tm_unit(make()) for u, (make, _) in path.units.items()}
            for u, (_, args) in path.units.items():
                for i in range(path.n):
                    objs[u].update(*args(i))
            for m, metric in _tm_members(objs).items():
                def once(metric=metric):
                    metric._computed = None
                    metric.compute()

                once()
                torch.cuda.synchronize()
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    once()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                rec = {"ms": statistics.median(times), "host_syncs": _syncs_per_call(once)}
                if isinstance(metric, RetrievalMetric) and rec["host_syncs"] != (2 if m == "r_at_p" else 1):
                    raise AssertionError(f"{name} {m}: {rec['host_syncs']} host reads per compute")
                if m.startswith("tau_"):
                    rows = path.n * KENDALL_BATCH
                    pairs = rows * (rows - 1) // 2
                    ops_ms = pairs * KENDALL_OPS_PER_PAIR / _F32_RATE * 1e3
                    bytes_ms = 2 * rows * 4 / hbm_rate * 1e3
                    rec.update({"pairs": pairs, "pairs_per_s": pairs / (rec["ms"] / 1e3), "bound_ms": max(ops_ms, bytes_ms),
                                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
                out[f"{name}:{m}"] = rec
            del objs
            gc.collect()
    _log("  tensor2 computes: " + ", ".join(f"{k} {v['ms']:.2f} ms" for k, v in out.items()))
    return out


def run_tensor2(gen: torch.Generator, hbm_rate: float) -> dict:
    """Phase 16: knowledge-distillation KL beside accuracy (K1), Pearson / concordance /
    Spearman over regression rows, Kendall's tau over ranker scores against human
    labels, cosine similarity of sentence embeddings, and the ten retrieval metrics over
    MS MARCO's dev queries beside a binned AUROC (K2)."""
    paths = _tm2_paths(gen)
    out = {name: run_tensor_path(path) for name, path in paths.items()}
    out["msmarco_pack"] = check_retrieval_pack(paths["msmarco"])
    out["tolerances"] = {
        "moment_rtol": TM2_MOMENT_RTOL, "rounded_rtol": TM2_ROUNDED_RTOL, "row_rtol": TM2_ROW_RTOL,
        "retrieval_and_accuracy": f"{ACC_ATOL} + {TM_SUM_RTOL} relative", "auroc_atol": AUROC_ATOL,
    }
    out["computes"] = time_tensor2_computes(paths, hbm_rate)
    out["times"] = time_tensor_paths(paths)
    for name in paths:
        t = out["times"][name]

        def device(mode):
            busy, idle = t[mode]["device_busy_us"], t[mode]["device_idle_share"]
            return "no device work" if busy is None else f"busy {busy:.1f} us, idle {idle:.3f}"

        computes = {k.split(":", 1)[1]: round(v["ms"], 2) for k, v in out["computes"].items() if k.startswith(name + ":")}
        _log(f"  tensor2 {name}: update {t['eager']['update_us']:.1f} -> {t['engine']['update_us']:.1f} us (eager ->"
             f" engine), syncs per update {out[name]['host_syncs_per_update']}, {device('eager')} -> {device('engine')};"
             f" compute ms {computes}")
    return out


# ---------------------------------------------------------------- phase 17: nominal association, pairwise distances

# UCI Adult (48,842 rows): its nine categorical columns' cardinalities, "?" counted as a
# value where a column has missing entries (workclass, education, marital-status,
# occupation, relationship, race, sex, native-country, income)
ADULT_ROWS = 48842
ADULT_CARDINALITIES = (9, 16, 7, 15, 6, 5, 2, 42, 2)
# education's 16 levels and occupation's 14 (without "?"), by their shares in Adult
ADULT_EDUCATION_SHARES = (0.322, 0.224, 0.164, 0.054, 0.043, 0.042, 0.036, 0.033, 0.029, 0.020, 0.018,
                          0.016, 0.013, 0.010, 0.005, 0.002)
ADULT_OCCUPATION_SHARES = (0.134, 0.133, 0.132, 0.122, 0.119, 0.107, 0.065, 0.052, 0.045, 0.032, 0.030,
                           0.021, 0.005, 0.0003)
ADULT_MISSING_OCCUPATION = 0.058  # the share of "?" in occupation
ADULT_STREAM = 1 << 20  # education x occupation rows per update
CROWD_IMAGES, CROWD_CLASSES, CROWD_RATERS = 10000, 10, 51  # CIFAR-10H: 10,000 test images, ~51 labels each
CROWD_ACCURACY = 0.95  # a CIFAR-10H annotator's share of correct labels
PAIR_QUERIES = 2048  # Manhattan / Minkowski: 2048 queries against the 8192 embeddings
PAIR_CPU_ROWS, PAIR_CPU_ROWS_BROADCAST = 256, 16  # the CPU check's leading rows of x
NOM_PATHS = ("imagenet", "adult", "crowd")
# the card and the CPU compute the same float64 statistic from equal tables: one float32
# rounding apart at most
NOMINAL_RTOL = 1e-6
# Fleiss' kappa is float32 sums over 10,000 rows in other orders on each side
FLEISS_ATOL = 1e-5
# a float32 dot product of 768 terms summed in other orders: within 2^-16 of the
# Cauchy-Schwarz scale |x_i| |y_j| (the cosine's is 1)
PAIR_DOT_RTOL = 2.0**-16
# Euclidean: float64 norm algebra rounded once to float32, then a square root
PAIR_EUCLID_RTOL = 2.0**-22
# Manhattan and Minkowski: float32 sums of 768 positive terms in other orders
PAIR_SUM_RTOL = 1e-5
# float operations per element of the (N, M, d) work, for the bound
PAIR_OPS = {"linear": 2, "cosine": 2, "euclidean": 2, "manhattan": 3, "minkowski": 5}


def _nom_imagenet(device=None) -> dict:
    import torchmetrics_tpu_torch as tm

    c = ACC_CLASSES
    return {
        "acc": tm.MulticlassAccuracy(c, validate_args=False, device=device),
        "cramers": tm.CramersV(c, device=device), "tschuprow": tm.TschuprowsT(c, device=device),
        "pearson": tm.PearsonsContingencyCoefficient(c, device=device), "theils": tm.TheilsU(c, device=device),
    }


def _nom_adult(device=None) -> dict:
    import torchmetrics_tpu_torch as tm

    c = len(ADULT_EDUCATION_SHARES)
    return {"cramers": tm.CramersV(c, nan_strategy="drop", device=device),
            "theils": tm.TheilsU(c, nan_strategy="drop", device=device)}


def _nom_fleiss(mode: str):
    def make(device=None) -> dict:
        import torchmetrics_tpu_torch as tm

        return {f"fleiss_{mode}": tm.FleissKappa(mode=mode, device=device)}

    return make


def _adult_stream_batches(gen: torch.Generator) -> list:
    """Education (float codes) and occupation (float codes, "?" as NaN) with Adult's
    shares; occupation leans on education (a third of the rows take an occupation
    keyed to the education level). ``(occupation, education)`` per update, on the card."""
    edu_p, occ_p = torch.tensor(ADULT_EDUCATION_SHARES), torch.tensor(ADULT_OCCUPATION_SHARES)
    out = []
    for _ in range(N_BATCHES):
        edu = torch.multinomial(edu_p, ADULT_STREAM, replacement=True, generator=gen)
        occ = torch.multinomial(occ_p, ADULT_STREAM, replacement=True, generator=gen)
        occ = torch.where(torch.rand(ADULT_STREAM, generator=gen) < 0.33, edu % len(ADULT_OCCUPATION_SHARES), occ).float()
        occ = torch.where(torch.rand(ADULT_STREAM, generator=gen) < ADULT_MISSING_OCCUPATION, float("nan"), occ)
        out.append((occ.cuda(), edu.float().cuda()))
    return out


def _adult_matrix(gen: torch.Generator) -> torch.Tensor:
    """48,842 x 9 int64 codes with Adult's cardinalities, each column a noisy function of
    one latent profile (so the columns associate), on the card."""
    latent = torch.randint(0, 1 << 20, (ADULT_ROWS,), generator=gen)
    cols = []
    for k, card in enumerate(ADULT_CARDINALITIES):
        keyed = (latent // (k + 1) + 7 * k) % card
        cols.append(torch.where(torch.rand(ADULT_ROWS, generator=gen) < 0.5, keyed, torch.randint(0, card, (ADULT_ROWS,), generator=gen)))
    return torch.stack(cols, 1).cuda()


def _crowd_batches(gen: torch.Generator) -> tuple:
    """CIFAR-10H-shaped ratings: each image's true class and ``CROWD_RATERS`` labels, a
    share ``CROWD_ACCURACY`` of them right. Per update (625 images): the count rows
    ``(625, 10)`` int64, and probs ``(625, 10, 51)`` float32 whose argmax over the classes
    is each rater's label (so both modes count the same rows)."""
    truth = torch.randint(0, CROWD_CLASSES, (CROWD_IMAGES, 1), generator=gen)
    wrong = torch.randint(0, CROWD_CLASSES, (CROWD_IMAGES, CROWD_RATERS), generator=gen)
    labels = torch.where(torch.rand(CROWD_IMAGES, CROWD_RATERS, generator=gen) < CROWD_ACCURACY, truth, wrong)
    counts = (labels[:, :, None] == torch.arange(CROWD_CLASSES)).sum(1)
    probs = torch.rand(CROWD_IMAGES, CROWD_CLASSES, CROWD_RATERS, generator=gen)
    probs += 2.0 * (labels[:, None, :] == torch.arange(CROWD_CLASSES)[None, :, None])
    rows = torch.tensor_split(torch.arange(CROWD_IMAGES), N_BATCHES)
    return [(counts[r].cuda(),) for r in rows], [(probs[r].cuda(),) for r in rows]


def _nom_value_tol(member: str, w: torch.Tensor) -> torch.Tensor:
    if member == "acc":
        return ACC_ATOL + TM_SUM_RTOL * w.abs()
    if member.startswith("fleiss"):
        return torch.full_like(w, FLEISS_ATOL)
    return NOMINAL_RTOL * w.abs()


def _nom_paths(imagenet: list, gen: torch.Generator) -> dict:
    """The three metric paths of phase 17 over their batches (host copies for the CPU run)."""
    def host(batches):
        return [tuple(x.cpu() for x in b) for b in batches]

    adult = _adult_stream_batches(gen)
    counts, probs = _crowd_batches(gen)
    imagenet_h, adult_h, counts_h, probs_h = host(imagenet), host(adult), host(counts), host(probs)
    tables = frozenset({"cramers", "tschuprow", "pearson", "theils"})
    n, none = N_BATCHES, {"stat_counts": 0, "multi_threshold": 0}
    fleiss = {"fleiss_counts", "fleiss_probs"}
    return {
        "imagenet": _TensorPath(
            "imagenet", {"imagenet": (_nom_imagenet, lambda i: imagenet[i])},
            {"imagenet": (_nom_imagenet, lambda i: imagenet_h[i])}, n, {frozenset({"acc"}), tables},
            {"stat_counts": 1, "multi_threshold": 0}, set(), {"acc", *tables}, value_tol=_nom_value_tol,
        ),
        "adult": _TensorPath(
            "adult", {"adult": (_nom_adult, lambda i: adult[i])}, {"adult": (_nom_adult, lambda i: adult_h[i])},
            n, {frozenset({"cramers", "theils"})}, none, set(), {"cramers", "theils"}, value_tol=_nom_value_tol,
        ),
        "crowd": _TensorPath(
            "crowd", {"counts": (_nom_fleiss("counts"), lambda i: counts[i]), "probs": (_nom_fleiss("probs"), lambda i: probs[i])},
            {"counts": (_nom_fleiss("counts"), lambda i: counts_h[i]), "probs": (_nom_fleiss("probs"), lambda i: probs_h[i])},
            n, {frozenset({m}) for m in fleiss}, none, fleiss, fleiss, value_tol=_nom_value_tol,
        ),
    }


def check_nominal_compute_reads(paths: dict) -> dict:
    """Each table metric's ``compute`` on the card reads the host once (the table) and
    returns float32 on the card; its ms, host clock to a device sync, median of three."""
    from torchmetrics_tpu_torch.engine import engine_context

    out = {}
    with engine_context(False):
        for name in ("imagenet", "adult"):
            make, args = paths[name].units[name]
            for m, metric in make().items():
                if m == "acc":
                    continue
                for i in range(2):
                    metric.update(*args(i))

                def once(metric=metric):
                    metric._computed = None
                    return metric.compute()

                value = once()
                reads = _syncs_per_call(once)
                if reads != 1 or value.device.type != "cuda" or value.dtype != torch.float32:
                    raise AssertionError(f"nominal {name} {m}: {reads} host reads per compute, {value.dtype} on {value.device}")
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    once()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                out[f"{name}:{m}"] = {"host_reads": reads, "ms": statistics.median(times)}
    _log("  nominal computes: " + ", ".join(f"{k} {v['ms']:.2f} ms ({v['host_reads']} read)" for k, v in out.items()))
    return out


def _call_record(fn, iters: int, hbm_rate: float, nbytes: int, ops: int) -> dict:
    """Host ms per call to a device sync, device busy and idle share, the largest device
    items and host syncs of ``fn()``, beside the least time the card could take: the
    bytes it must move over the HBM rate, or its float operations over 67 TFLOP/s
    (float32 and float64 alike on an H100)."""
    ms = _host_us_per_call(lambda i: fn(), iters=iters, repeats=3) / 1e3
    prof = _device_profile(lambda i: fn(), iters=iters)
    busy = prof["device_busy_us"]
    bytes_ms, ops_ms = nbytes / hbm_rate * 1e3, ops / _F32_RATE * 1e3
    return {
        "ms": ms, "device_busy_us": busy, "device_idle_share": None if busy is None else max(0.0, 1 - busy / (ms * 1e3)),
        "device_ops": prof["device_ops"], "kernels_us": prof["kernels_us"], "host_syncs": _syncs_per_call(fn),
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
    }


def run_adult_matrices(gen: torch.Generator, hbm_rate: float) -> dict:
    """The four ``*_matrix`` functionals over Adult's nine columns (36 pairs, each one
    ``unique`` sync and one table read) on the card, each equal to the CPU's."""
    import torchmetrics_tpu_torch.functional as F

    matrix = _adult_matrix(gen)
    host = matrix.cpu()
    out = {}
    for name in ("cramers_v_matrix", "tschuprows_t_matrix", "pearsons_contingency_coefficient_matrix", "theils_u_matrix"):
        fn = getattr(F, name)
        got, want = fn(matrix), fn(host)
        k = len(ADULT_CARDINALITIES)
        if got.shape != (k, k) or got.device.type != "cuda" or not torch.isfinite(got).all():
            raise AssertionError(f"adult {name}: {got.dtype}{tuple(got.shape)} on {got.device}")
        diff = (got.cpu() - want).abs()
        if not bool((diff <= NOMINAL_RTOL * want.abs()).all()):
            raise AssertionError(f"adult {name}: card {got.flatten()[:6].tolist()} vs cpu {want.flatten()[:6].tolist()}")
        # the bound: the matrix read once and the result written once
        rec = _call_record(lambda fn=fn: fn(matrix), 1, hbm_rate, matrix.numel() * 8 + k * k * 4, 0)
        rec.update({"max_abs_diff_to_cpu": diff.max().item(), "pairs": k * (k - 1) // 2})
        out[name] = rec
    _log("  adult matrices: " + ", ".join(f"{k} {v['ms']:.1f} ms, {v['host_syncs']} syncs" for k, v in out.items()))
    return out


def _pair_tol(kind: str, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, reduction) -> torch.Tensor:
    if kind == "linear":
        scale = torch.linalg.norm(x, dim=1)[:, None] * torch.linalg.norm(y, dim=1)[None, :]
        tol = PAIR_DOT_RTOL * scale
        return tol.mean(-1) if reduction == "mean" else tol
    if kind == "cosine":
        return torch.full_like(w, PAIR_DOT_RTOL)
    return (PAIR_EUCLID_RTOL if kind == "euclidean" else PAIR_SUM_RTOL) * w.abs() + 1e-6


def run_pairwise(gen: torch.Generator, hbm_rate: float) -> dict:
    """BERT-base-sized embeddings: linear, cosine and euclidean over 8192 x 768 against
    itself, Manhattan and Minkowski (p = 3) of 2048 queries against the 8192, each with
    ``reduction=None`` and ``"mean"``; the leading rows held against the CPU. Beside the
    distances at ``reduction=None``, the time of ``torch.cdist`` on the same inputs."""
    import torchmetrics_tpu_torch.functional as F

    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must run at 'highest' precision (no TF32) for the card to agree with the CPU")
    a = torch.randn(EMB_BATCH, EMB_DIM, generator=gen)
    b = a + 0.8 * torch.randn(EMB_BATCH, EMB_DIM, generator=gen)
    a_card, queries = a.cuda(), b[:PAIR_QUERIES].cuda()
    calls = [
        ("linear", F.pairwise_linear_similarity, a_card, None, {}),
        ("cosine", F.pairwise_cosine_similarity, a_card, None, {}),
        ("euclidean", F.pairwise_euclidean_distance, a_card, None, {}),
        ("manhattan", F.pairwise_manhattan_distance, queries, a_card, {}),
        ("minkowski", F.pairwise_minkowski_distance, queries, a_card, {"exponent": 3}),
    ]
    out = {}
    for kind, fn, x, y, kw in calls:
        sub = PAIR_CPU_ROWS if y is None else PAIR_CPU_ROWS_BROADCAST
        other = x if y is None else y
        for reduction in (None, "mean"):
            name = f"{kind}_{reduction or 'none'}"
            got = fn(x, y, reduction=reduction, **kw)
            host_x, host_other = x[:sub].cpu(), other.cpu()
            want = fn(host_x, host_other, reduction=reduction, zero_diagonal=y is None, **kw)
            g = got[:sub].cpu()
            tol = _pair_tol(kind, host_x, host_other, want, reduction)
            if g.shape != want.shape or not torch.isfinite(got).all() or not bool(((g - want).abs() <= tol).all()):
                raise AssertionError(f"pairwise {name}: card {g.flatten()[:6].tolist()} vs cpu {want.flatten()[:6].tolist()}")
            rows, others = x.shape[0], other.shape[0]
            # the inputs read once and the output written once; PAIR_OPS per (row, other, dim) element
            nbytes = ((rows + (0 if y is None else others)) * EMB_DIM + rows * (others if reduction is None else 1)) * 4
            rec = _call_record(lambda: fn(x, y, reduction=reduction, **kw), 3, hbm_rate, nbytes,
                               PAIR_OPS[kind] * rows * others * EMB_DIM)
            rec.update({"shape": [rows, others, EMB_DIM], "cpu_rows": sub, "max_abs_diff_to_cpu": (g - want).abs().max().item()})
            # one library call of the same distances, timed beside, used nowhere in the port
            p = {"euclidean": 2.0, "manhattan": 1.0, "minkowski": 3.0}.get(kind)
            rec["library_ms"] = None if p is None or reduction else _host_us_per_call(
                lambda i: torch.cdist(x, other, p=p), iters=3, repeats=3) / 1e3
            out[name] = rec
            del got
    _log("  pairwise: " + ", ".join(
        f"{k} {v['ms']:.2f} ms (bound {v['bound_ms']:.3f}, {v['bound_by']}; torch.cdist {v['library_ms']})" for k, v in out.items()
    ))
    return out


def run_nominal_pairwise(imagenet: list, gen: torch.Generator, hbm_rate: float) -> dict:
    """Phase 17: the four table metrics beside accuracy (K1) over ImageNet-1k logits, Cramér's
    V and Theil's U over UCI Adult's education x occupation stream with missing values
    dropped, the four ``*_matrix`` functionals over Adult's nine columns, Fleiss' kappa
    over CIFAR-10H ratings in both modes, and the five pairwise functionals over
    BERT-base-sized embeddings."""
    paths = _nom_paths(imagenet, gen)
    out = {name: run_tensor_path(path) for name, path in paths.items()}
    counts_value, probs_value = (out["crowd"]["values"][m] for m in ("fleiss_counts", "fleiss_probs"))
    if counts_value != probs_value:
        raise AssertionError(f"crowd: counts mode {counts_value} and probs mode {probs_value} count the same rows")
    out["computes"] = check_nominal_compute_reads(paths)
    out["adult_matrices"] = run_adult_matrices(gen, hbm_rate)
    out["pairwise"] = run_pairwise(gen, hbm_rate)
    out["tolerances"] = {
        "nominal_rtol": NOMINAL_RTOL, "fleiss_atol": FLEISS_ATOL, "pair_dot_rtol_of_norms": PAIR_DOT_RTOL,
        "pair_euclid_rtol": PAIR_EUCLID_RTOL, "pair_sum_rtol": PAIR_SUM_RTOL,
    }
    out["times"] = time_tensor_paths(paths)
    for name in paths:
        t = out["times"][name]

        def device(mode):
            busy, idle = t[mode]["device_busy_us"], t[mode]["device_idle_share"]
            return "no device work" if busy is None else f"busy {busy:.1f} us, idle {idle:.3f}"

        items = {k[:48]: round(v, 1) for k, v in list((t["eager"]["kernels_us"] or {}).items())[:4]}
        _log(f"  nominal {name}: update {t['eager']['update_us']:.1f} -> {t['engine']['update_us']:.1f} us (eager ->"
             f" engine), syncs per update {out[name]['host_syncs_per_update']}, {device('eager')} -> {device('engine')};"
             f" largest eager items {items}")
    return out


# ---------------------------------------------------------------- phase 18: the tensor half of the image domain

IMG_BATCH, IMG_CHANNELS, IMG_SIZE = 32, 3, 256  # BASELINE #3: 256 x 256 RGB outputs of a generator
IMG_COARSE = 32  # the targets are smooth: seeded 32 x 32 noise, upsampled
PSNRB_BLOCK = 8
PSNRB_DC_STEP = 0.02  # the luma of a JPEG-like decode: each 8 x 8 block shifted by a quantised DC error
PAN_BATCH, PAN_BANDS, PAN_RATIO = 8, 4, 4  # 4-band multispectral (B, G, R, NIR), pansharpened at ratio 4
PAN_GAINS = (0.55, 0.7, 0.8, 1.0)  # the bands' reflectance scales over one scene
VOL_UPDATES, VOL_SHAPE, VOL_SIGMA = 4, (2, 1, 64, 128, 128), (1.5, 1.0, 1.0)
IMAGE_PATHS = ("ssim", "pansharpening", "volume")
# SSIM, MS-SSIM, UQI and D-lambda: absolute, against the CPU run (windowed moments from
# band products summed in other orders)
IMG_SSIM_ATOL = 1e-5
# PSNR, PSNR-B, ERGAS, RASE, RMSE-SW and SAM, and every float sum state: relative
IMG_RTOL = 1e-5
# TV: float32 sums of |differences| in other orders
IMG_TV_RTOL = 1e-6
IMG_SSIM_MEMBERS = ("ssim", "msssim", "uqi", "dlambda", "ssim3d")
PAN_LISTS = ("ergas", "sam", "dlambda", "rase", "uqi")


def _smooth(gen: torch.Generator, shape: tuple, coarse: tuple) -> torch.Tensor:
    """Seeded smooth images in [0, 1]: coarse noise upsampled (bilinear or trilinear) to
    ``shape`` with a little fine texture."""
    import torch.nn.functional as F

    mode = "bilinear" if len(shape) == 4 else "trilinear"
    low = torch.rand(*shape[:2], *coarse, generator=gen)
    img = F.interpolate(low, size=shape[2:], mode=mode, align_corners=False)
    return (img + 0.05 * torch.rand(*shape, generator=gen)).clamp(0, 1)


def _blurred_noisy(target: torch.Tensor, gen: torch.Generator, noise: float) -> torch.Tensor:
    """A 3-wide box blur of ``target`` with gaussian noise, clipped to [0, 1]."""
    import torch.nn.functional as F

    pool = F.avg_pool2d if target.ndim == 4 else F.avg_pool3d
    blurred = pool(target, 3, stride=1, padding=1, count_include_pad=False)
    return (blurred + noise * torch.randn(*target.shape, generator=gen)).clamp(0, 1)


def _img_batches(gen: torch.Generator, n: int = N_BATCHES, b: int = IMG_BATCH, size: int = IMG_SIZE) -> tuple:
    """``(preds, target)`` RGB batches and their BT.601 luma (the predictions' luma with an
    8 x 8 blocking artifact), on the card."""
    rgb, luma = [], []
    weights = torch.tensor([0.299, 0.587, 0.114]).view(1, 3, 1, 1)
    for _ in range(n):
        target = _smooth(gen, (b, IMG_CHANNELS, size, size), (IMG_COARSE, IMG_COARSE))
        preds = _blurred_noisy(target, gen, 0.03)
        rgb.append((preds.cuda(), target.cuda()))
        dc = torch.randint(-1, 2, (b, 1, size // PSNRB_BLOCK, size // PSNRB_BLOCK), generator=gen) * PSNRB_DC_STEP
        dc = dc.repeat_interleave(PSNRB_BLOCK, 2).repeat_interleave(PSNRB_BLOCK, 3)
        y_pred = ((preds * weights).sum(1, keepdim=True) + dc).clamp(0, 1)
        luma.append((y_pred.cuda(), (target * weights).sum(1, keepdim=True).cuda()))
    return rgb, luma


def _pan_batches(gen: torch.Generator, n: int = N_BATCHES, b: int = PAN_BATCH, size: int = IMG_SIZE) -> list:
    """4-band scenes (reflectances in (0.02, 1]) and their pansharpened estimates: the
    scene averaged over ``PAN_RATIO`` x ``PAN_RATIO`` cells, upsampled again, with noise."""
    import torch.nn.functional as F

    gains = torch.tensor(PAN_GAINS).view(1, PAN_BANDS, 1, 1)
    out = []
    for _ in range(n):
        scene = _smooth(gen, (b, 1, size, size), (IMG_COARSE, IMG_COARSE))
        bands = (scene * gains + 0.1 * _smooth(gen, (b, PAN_BANDS, size, size), (8, 8))).clamp(0.02, 1)
        low = F.avg_pool2d(bands, PAN_RATIO)
        sharpened = F.interpolate(low, scale_factor=PAN_RATIO, mode="bilinear", align_corners=False)
        preds = (sharpened + 0.01 * torch.randn(*bands.shape, generator=gen)).clamp(0.02, 1)
        out.append((preds.cuda(), bands.cuda()))
    return out


def _vol_batches(gen: torch.Generator, n: int = VOL_UPDATES, shape: tuple = VOL_SHAPE) -> list:
    """Smooth volumes (a CT or MRI patch) and blurred, noised reconstructions, on the card."""
    out = []
    for _ in range(n):
        target = _smooth(gen, shape, tuple(max(2, s // 8) for s in shape[2:]))
        out.append((_blurred_noisy(target, gen, 0.02).cuda(), target.cuda()))
    return out


def _img_collection(device=None) -> dict:
    from torchmetrics_tpu_torch import image

    return {
        "ssim": image.StructuralSimilarityIndexMeasure(data_range=1.0, device=device),
        "msssim": image.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=device),
        "psnr": image.PeakSignalNoiseRatio(device=device),
    }


def _img_psnrb(device=None) -> dict:
    from torchmetrics_tpu_torch import image

    return {"psnrb": image.PeakSignalNoiseRatioWithBlockedEffect(block_size=PSNRB_BLOCK, device=device)}


def _img_tv(device=None) -> dict:
    from torchmetrics_tpu_torch import image

    return {"tv": image.TotalVariation(device=device)}


def _pan_members(device=None) -> dict:
    from torchmetrics_tpu_torch import image

    return {
        "ergas": image.ErrorRelativeGlobalDimensionlessSynthesis(ratio=PAN_RATIO, device=device),
        "sam": image.SpectralAngleMapper(device=device),
        "dlambda": image.SpectralDistortionIndex(device=device),
        "rase": image.RelativeAverageSpectralError(device=device),
        "uqi": image.UniversalImageQualityIndex(device=device),
        "rmse_sw": image.RootMeanSquaredErrorUsingSlidingWindow(device=device),
    }


def _vol_members(device=None) -> dict:
    from torchmetrics_tpu_torch import image

    return {"ssim3d": image.StructuralSimilarityIndexMeasure(sigma=VOL_SIGMA, device=device)}


def _img_value_tol(member: str, w: torch.Tensor) -> torch.Tensor:
    if member in IMG_SSIM_MEMBERS:
        return torch.full_like(w, IMG_SSIM_ATOL)
    return (IMG_TV_RTOL if member == "tv" else IMG_RTOL) * w.abs()


def _img_paths(rgb: list, luma: list, pan: list, vol: list) -> dict:
    """The three paths of phase 18 over their batches (host copies for the CPU run)."""
    def host(batches):
        return [tuple(x.cpu() for x in b) for b in batches]

    rgb_h, luma_h, pan_h, vol_h = host(rgb), host(luma), host(pan), host(vol)
    none = {"stat_counts": 0, "multi_threshold": 0}
    ssim_members = {"ssim", "msssim", "psnr", "psnrb", "tv"}
    float_states = {m: IMG_RTOL for m in ssim_members | {"rmse_sw", "ssim3d"}}
    float_states["tv"] = IMG_TV_RTOL
    return {
        "ssim": _TensorPath(
            "ssim",
            {"collection": (_img_collection, lambda i: rgb[i]), "luma": (_img_psnrb, lambda i: luma[i]),
             "tv": (_img_tv, lambda i: rgb[i][:1])},
            {"collection": (_img_collection, lambda i: rgb_h[i]), "luma": (_img_psnrb, lambda i: luma_h[i]),
             "tv": (_img_tv, lambda i: rgb_h[i][:1])},
            len(rgb), {frozenset({m}) for m in ssim_members}, none, set(), ssim_members,
            value_tol=_img_value_tol, state_rtol=float_states,
        ),
        "pansharpening": _TensorPath(
            "pansharpening", {"pan": (_pan_members, lambda i: pan[i])}, {"pan": (_pan_members, lambda i: pan_h[i])},
            len(pan), {frozenset(PAN_LISTS), frozenset({"rmse_sw"})}, none, set(PAN_LISTS), {"rmse_sw", *PAN_LISTS},
            value_tol=_img_value_tol, state_rtol=float_states,
        ),
        "volume": _TensorPath(
            "volume", {"volume": (_vol_members, lambda i: vol[i])}, {"volume": (_vol_members, lambda i: vol_h[i])},
            len(vol), {frozenset({"ssim3d"})}, none, set(), {"ssim3d"},
            value_tol=_img_value_tol, state_rtol=float_states,
        ),
    }


def _host_to_device_copies(fn, iters: int = 2) -> int:
    """Host-to-device copies the profiler records over ``iters`` calls of ``fn(i)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and "HtoD" in e.name)


def check_ssim_path_without_host_traffic(path: _TensorPath) -> dict:
    """The ssim path's units, eagerly and with the engine: after the first update no
    update reads the host (``set_sync_debug_mode("error")``, and 0 syncs in ``"warn"``) or
    copies anything to the card (no ``HtoD`` copy in a profile of two updates); with the
    engine the collection's three members replay in one fused graph."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import engine_context

    out = {}
    for mode in ("eager", "engine"):
        with engine_context(mode == "engine"):
            units = [(_tm_unit(make()), args) for make, args in path.units.values()]

            def step(i, units=units):
                for obj, args in units:
                    obj.update(*args(i % path.n))

            step(0)  # the first update: group discovery, the band and index caches
            step(1)  # the engine's capture
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                step(2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            syncs = _syncs_per_call(lambda: step(3))
            copies = _host_to_device_copies(lambda i: step(4 + i))
            if syncs or copies:
                raise AssertionError(f"image ssim {mode}: {syncs} host syncs, {copies} host-to-device copies per 2 updates")
            rec = {"host_syncs_per_update": syncs, "host_to_device_copies_per_2_updates": copies}
            if mode == "engine":
                mc = next(obj for obj, _ in units if isinstance(obj, MetricCollection))
                st = mc._fused_engine.stats
                if st.eager_fallbacks or st.dispatches != 5:  # six steps, the first one discovering groups
                    raise AssertionError(f"image ssim: the collection's fused engine {st.as_dict()}")
                _check_replays("image ssim collection", mc._fused_engine)
                rec["fused"] = st.as_dict()
            out[mode] = rec
            del units
            gc.collect()
    _log(f"  image ssim: 0 host syncs and 0 host-to-device copies per update after the first, eagerly and with the"
         f" engine (set_sync_debug_mode('error')); fused replays {out['engine']['fused']['replays']}")
    return out


def check_image_gradients(rgb: list) -> dict:
    """``image_gradients`` of the predictions on the card, bit-equal to the CPU's (one
    subtraction per element)."""
    from torchmetrics_tpu_torch.functional import image_gradients

    preds = rgb[0][0]
    dy, dx = image_gradients(preds)
    want = image_gradients(preds.cpu())
    for name, g, w in (("dy", dy, want[0]), ("dx", dx, want[1])):
        if g.shape != w.shape or not torch.equal(g.cpu(), w):
            raise AssertionError(f"image_gradients {name}: card {g.flatten()[:6].tolist()} vs cpu {w.flatten()[:6].tolist()}")
    syncs = _syncs_per_call(lambda: image_gradients(preds))
    return {"shape": list(dy.shape), "bit_equal_to_cpu": True, "host_syncs": syncs}


def _gemm_share(fn, iters: int = 4) -> dict:
    """Device µs per call of ``fn(i)``: all of it, and the part in matrix-product
    kernels (cuBLAS / CUTLASS names) — the band products of the filters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    busy = gemm = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us() / iters
            busy += us
            if any(k in e.name.lower() for k in ("gemm", "xmma", "cutlass")):
                gemm += us
    return {"device_busy_us": busy or None, "band_product_us": gemm or None,
            "band_share": gemm / busy if busy else None}


def time_band_products(rgb: list, hbm_rate: float) -> dict:
    """SSIM's two band products over BASELINE #3's five-map stack (5 x 32 x 3 planes of
    266 x 266, an 11-tap gaussian, pad 5), CUDA-event time, beside the least time the card
    could take for the band design (its MACs over 67 TFLOP/s) and for the separable
    filter it stands for (11 taps per axis over 67 TFLOP/s, or bytes over the HBM rate,
    whichever is larger: the filter's own stack and maps, and a whole update's two
    images), and beside
    one depthwise ``F.conv2d`` of the same stack with the 11 x 11 gaussian (a library call
    used nowhere in the port). Then the band products' share of an SSIM update's device
    time and of the whole ssim path's."""
    import torch.nn.functional as F

    from torchmetrics_tpu_torch.functional.image.helper import _filter_separable_2d, _gaussian_np, _reflect_pad_2d

    preds, target = rgb[0]
    b, c, h, w = preds.shape
    taps = _gaussian_np(11, 1.5)
    p, t = _reflect_pad_2d(preds, 5, 5), _reflect_pad_2d(target, 5, 5)
    stack = torch.cat([p, t, p * p, t * t, p * t])  # (5B, C, 266, 266)
    planes, n_in = stack.shape[0] * c, stack.shape[-1]
    n_out = n_in - len(taps) + 1
    band = _filter_separable_2d(stack, taps, taps)
    kernel = torch.from_numpy(taps).float()
    weight = (kernel[:, None] * kernel[None, :]).expand(c, 1, len(taps), len(taps)).contiguous().cuda()
    conv = F.conv2d(stack, weight, groups=c)
    diff = (band - conv).abs().max().item()  # the same filter: float32 rounding apart
    band_ms = _median_ms(lambda i: _filter_separable_2d(stack, taps, taps), iters=10)
    conv_ms = _median_ms(lambda i: F.conv2d(stack, weight, groups=c), iters=10)
    band_flop = 2 * planes * (n_out * n_in * n_in + n_out * n_out * n_in)
    tap_flop = 2 * planes * len(taps) * (n_out * n_in + n_out * n_out)
    nbytes = stack.numel() * 4 + band.numel() * 4  # the filter alone: the stack read, the maps written
    update_bytes = 2 * preds.numel() * 4  # a whole SSIM update: the two images read once
    ssim_metric = _img_collection()["ssim"]
    ssim_share = _gemm_share(lambda i: ssim_metric.update(*rgb[i % len(rgb)]))
    collection = _tm_unit(_img_collection())
    path_share = _gemm_share(lambda i: collection.update(*rgb[i % len(rgb)]))
    out = {
        "stack": list(stack.shape), "planes": planes,
        "band_ms": band_ms, "band_gflop": band_flop / 1e9, "band_bound_ms": band_flop / _F32_RATE * 1e3,
        "tap_gflop": tap_flop / 1e9, "tap_bytes_mb": nbytes / 1e6,
        "tap_bound_ms": max(tap_flop / _F32_RATE, nbytes / hbm_rate) * 1e3,
        "tap_bound_by": "operations" if tap_flop / _F32_RATE >= nbytes / hbm_rate else "bytes",
        "update_bytes_mb": update_bytes / 1e6,
        "tap_update_bound_ms": max(tap_flop / _F32_RATE, update_bytes / hbm_rate) * 1e3,
        "library_conv2d_ms": conv_ms, "conv2d_max_abs_diff": diff,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "ssim_update": ssim_share, "ssim_collection_update": path_share,
    }
    _log(f"  band products {out['stack']}: {band_ms * 1e3:.1f} us against {out['band_bound_ms'] * 1e3:.1f} us"
         f" ({out['band_gflop']:.1f} GFLOP at 67 TFLOP/s) and the tap-by-tap bounds {out['tap_bound_ms'] * 1e3:.1f} us"
         f" ({out['tap_bound_by']}; the filter alone) and {out['tap_update_bound_ms'] * 1e3:.1f} us ({out['tap_gflop']:.2f}"
         f" GFLOP or the update's {out['update_bytes_mb']:.1f} MB); F.conv2d depthwise {conv_ms * 1e3:.1f} us; share of an SSIM update's device time"
         f" {ssim_share['band_share']}, of the collection's {path_share['band_share']}")
    return out


def check_image_computes(paths: dict) -> dict:
    """Each pansharpening ``cat`` member alone over the 16 updates: its ``compute``'s ms
    (host clock to a device sync, median of three) and host reads."""
    from torchmetrics_tpu_torch.engine import engine_context

    make, args = paths["pansharpening"].units["pan"]
    out = {}
    with engine_context(False):
        for m, metric in make().items():
            if m not in PAN_LISTS:
                continue
            for i in range(paths["pansharpening"].n):
                metric.update(*args(i))

            def once(metric=metric):
                metric._computed = None
                return metric.compute()

            value = once()
            reads = _syncs_per_call(once)
            if value.device.type != "cuda" or not torch.isfinite(value).all():
                raise AssertionError(f"image pansharpening {m}: {value} on {value.device}")
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                once()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[m] = {"host_reads": reads, "ms": statistics.median(times)}
            del metric
            gc.collect()
    _log("  pansharpening computes: " + ", ".join(f"{k} {v['ms']:.2f} ms ({v['host_reads']} reads)" for k, v in out.items()))
    return out


def run_images(gen: torch.Generator, hbm_rate: float) -> dict:
    """Phase 18: SSIM, MS-SSIM and PSNR in one collection beside PSNR-B on the luma and TV
    (BASELINE #3's 256 x 256 batches), the pansharpening metrics over 4-band scenes, and
    3-D SSIM over volumes; each path eagerly, with the engine and on the CPU."""
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must run at 'highest' precision (no TF32) for the card to agree with the CPU")
    rgb, luma = _img_batches(gen)
    paths = _img_paths(rgb, luma, _pan_batches(gen), _vol_batches(gen))
    out = {name: run_tensor_path(path) for name, path in paths.items()}
    out["ssim_host_traffic"] = check_ssim_path_without_host_traffic(paths["ssim"])
    out["image_gradients"] = check_image_gradients(rgb)
    out["band_products"] = time_band_products(rgb, hbm_rate)
    out["computes"] = check_image_computes(paths)
    out["tolerances"] = {"ssim_atol": IMG_SSIM_ATOL, "rtol": IMG_RTOL, "tv_rtol": IMG_TV_RTOL}
    out["times"] = time_tensor_paths(paths)
    for name in paths:
        t = out["times"][name]

        def device(mode):
            busy, idle = t[mode]["device_busy_us"], t[mode]["device_idle_share"]
            return "no device work" if busy is None else f"busy {busy:.1f} us, idle {idle:.3f}"

        items = {k[:48]: round(v, 1) for k, v in list((t["eager"]["kernels_us"] or {}).items())[:4]}
        _log(f"  image {name}: update {t['eager']['update_us']:.1f} -> {t['engine']['update_us']:.1f} us (eager ->"
             f" engine), syncs per update {out[name]['host_syncs_per_update']}, {device('eager')} -> {device('engine')};"
             f" largest eager items {items}")
    return out



# ---------------------------------------------------------------- phase 19: the model half of the image domain

FIDM_UPDATES, FIDM_BATCH, FIDM_SIZE = 32, 32, 256  # BASELINE #3: 1024 real and 1024 fake 256 x 256 images per side
FIDM_CHECK_UPDATES = 2  # per side, held against the CPU run
FIDM_RAGGED = 20  # one ragged update: bucket 32, 12 zero pad images
KID_CHECK_SUBSETS, KID_CHECK_SIZE = 10, 50  # the CPU comparison's KID (64 samples per side)
LPIPS_NETS = ("alex", "vgg", "squeeze")
LPIPS_UPDATES, LPIPS_BATCH = 16, 32  # super-resolution / translation eval: 512 pairs of 256 x 256
# float32 features of the card (cuDNN, no TF32) against the CPU's (oneDNN): other
# summation orders through ~94 convolutions. Measured at ~1e-6 of a tap's scale; TF32
# would give ~1e-3. Taps, feature states and the float64 sums of them: |card - cpu| <=
# FEATURE_SCALE_TOL x max|cpu|.
FEATURE_SCALE_TOL = 1e-4
# FID moves ~0.4x a relative feature perturbation (a CPU probe at 1e-6 .. 1e-4)
FIDM_VALUE_RTOL = 1e-4
# the full run's FID against scipy.linalg.sqrtm of Σ₁Σ₂ in float64 (1.2e-7 apart on a CPU probe)
FIDM_SQRTM_RTOL = 1e-5
# KID: float32 kernel sums over 50 x 50 subsets cancel; a CPU probe put float32 2.6e-4 of
# the mean away from float64. Mean and std: |card - cpu| <= KID_TOL x |cpu mean|
KID_TOL = 2e-3
# IS: the seeded trunk's logits are nearly the same for every image (IS - 1 ~ 4e-5, a few
# float32 steps above 1), so the phase's IS reads the ``logits`` tap (the fc with its
# bias) of the seeded trunk with the fc re-centred and scaled: bias -weight @ (the mean
# 2048 feature of 8 fake images, the side IS scores), then weight and bias scaled so that
# on those images each logit's std is IS_LOGIT_STD. The logits then spread over the
# images, IS sits well above 1 and no probability underflows, and log IS is held to a
# relative tolerance: on a CPU probe (IS 3.17 over 24 images of 64 x 64), noise of
# 1.5e-6 of the features' scale (the card's measured tap difference) moved log IS by at
# most 2.1e-5 of itself. The std over the splits is held to the same bound, times the mean.
IS_LOGIT_STD = 2.0
IS_LOG_RTOL = 5e-4
# the ragged update: other convolution algorithms for 32 rows than for 20, and the
# pad-subtract identity in float64
FIDM_RAGGED_TOL = 1e-5
# LPIPS distances (~0.1): absolute. Their gradient through ``img1`` (backward at full
# float32): relative L2 distance to the CPU's. A pair's normalized features nearly cancel
# in ``(n0 - n1)**2``, so float32 rounding is amplified: a CPU probe put VGG's float32
# gradient 5.3e-4 (relative L2; 4.0e-3 of its largest element) from float64's, AlexNet's
# and SqueezeNet's ~5e-6; the float64 CPU gradient is reported beside it.
LPIPS_ATOL, LPIPS_GRAD_L2_TOL = 1e-5, 2e-2


def _gan_batches(gen: torch.Generator, n: int, b: int, size: int) -> tuple:
    """Seeded uint8 images on the card: ``real`` smooth scenes (32 x 32 noise upsampled,
    fine texture), ``fake`` a generator's samples (coarser, noisier, brighter)."""
    real = [(_smooth(gen, (b, 3, size, size), (32, 32)) * 255).to(torch.uint8).cuda() for _ in range(n)]
    fake = []
    for _ in range(n):
        img = _smooth(gen, (b, 3, size, size), (16, 16))
        img = (0.8 * img + 0.15 + 0.1 * torch.rand(img.shape, generator=gen)).clamp(0, 1)
        fake.append((img * 255).to(torch.uint8).cuda())
    return real, fake


def _scale_diff(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """``max|got - want| / max|want|`` (got on the card, want on the CPU); raise above ``tol``."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: card {tuple(got.shape)} (finite: {bool(torch.isfinite(got).all())}), cpu {tuple(want.shape)}")
    scale = want.abs().max().item() or 1.0
    diff = (got - want).abs().max().item() / scale
    if diff > tol:
        raise AssertionError(f"{name}: max |card - cpu| is {diff:.3e} of the scale {scale:.4g} (tolerance {tol})")
    return diff


def _state_diffs(name: str, card, host, tol: float) -> dict:
    out = {}
    for attr in card._defaults:
        x, y = getattr(card, attr), getattr(host, attr)
        if isinstance(x, list):
            x, y = torch.cat(x), torch.cat(y)
        if not x.is_floating_point():
            if not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError(f"{name} {attr}: card {x.tolist()} vs cpu {y.tolist()}")
            continue
        out[attr] = _scale_diff(f"{name} {attr}", x, y, tol)
    return out


def _is_head_state(fake: list) -> dict:
    """The seeded trunk's state dict on the CPU with the IS head described at
    ``IS_LOGIT_STD``: made once on the card, then loaded by the card's and the CPU's IS."""
    import warnings

    from torchmetrics_tpu_torch.models import inception as inc

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-trunk warning
        trunk = inc.fid_inception_v3_extractor(("2048", "logits_unbiased"), allow_random=True)
    feats = trunk(fake[0][:8])[0].cpu()
    state = {k: v.cpu().clone() for k, v in trunk.model.state_dict().items()}
    centred = feats - feats.mean(dim=0)
    gain = IS_LOGIT_STD / (centred @ state["fc.weight"].T).std(dim=0).mean()
    state["fc.weight"] = state["fc.weight"] * gain
    state["fc.bias"] = -(state["fc.weight"] @ feats.mean(dim=0))
    return state


def _fidm_metrics(is_state: dict, device=None, kid_subsets=None) -> dict:
    """FID at 2048 and KID (its defaults unless ``kid_subsets = (subsets, size)``) on the
    seeded random trunk; IS on that trunk's ``logits`` tap with the head ``is_state`` holds."""
    import warnings

    from torchmetrics_tpu_torch.image import FrechetInceptionDistance, InceptionScore, KernelInceptionDistance
    from torchmetrics_tpu_torch.models import inception as inc

    kid_kwargs = {} if kid_subsets is None else {"subsets": kid_subsets[0], "subset_size": kid_subsets[1]}
    head = inc.fid_inception_v3_extractor("logits", state_dict=is_state, device=device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-trunk and the feature-buffer warnings
        return {
            "fid": FrechetInceptionDistance(2048, allow_random_features=True, device=device),
            "kid": KernelInceptionDistance(allow_random_features=True, device=device, **kid_kwargs),
            "is": InceptionScore(head, num_features=1008, device=device),
        }


def _fidm_drive(metrics: dict, real: list, fake: list, flags: tuple) -> None:
    """Real then fake, update by update: FID and KID on both sides, IS on the fake side."""
    for r, f in zip(real, fake):
        metrics["fid"].update(r, flags[0])
        metrics["kid"].update(r, True)
        metrics["fid"].update(f, flags[1])
        metrics["kid"].update(f, False)
        metrics["is"].update(f)


def _fidm_values(metrics: dict, seed: int) -> dict:
    import numpy as np

    out = {"fid": metrics["fid"].compute()}
    for k in ("kid", "is"):
        np.random.seed(seed)  # the host subsets / permutation of both runs
        out[k] = metrics[k].compute()
    return out


def check_fid_trunk(real: list) -> dict:
    """The seeded trunk: the same weights on the card and on the CPU; its six taps on two
    images against the CPU's; TF32 off inside its forward."""
    from torchmetrics_tpu_torch.models import inception as inc

    taps = inc.TAPS
    card = inc.fid_inception_v3_extractor(taps, allow_random=True)
    host = inc.fid_inception_v3_extractor(taps, allow_random=True, device="cpu")
    for (k, v), w in zip(card.model.state_dict().items(), host.model.state_dict().values()):
        if not torch.equal(v.cpu(), w):
            raise AssertionError(f"fid trunk: weight {k} differs between the card and the CPU")
    seen = []
    hook = card.model.Conv2d_1a_3x3.conv.register_forward_hook(
        lambda *_: seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    )
    try:
        got = card(real[0][:2])
    finally:
        hook.remove()
    if seen != [(False, False)]:
        raise AssertionError(f"fid trunk: TF32 flags (cudnn, matmul) inside the forward were {seen}")
    want = host(real[0][:2].cpu())
    diffs = {t: _scale_diff(f"fid trunk tap {t}", g, w, FEATURE_SCALE_TOL) for t, g, w in zip(taps, got, want)}
    _log(f"  fid trunk: weights equal to the CPU's, TF32 off in the forward; taps against the CPU (max diff / scale) {diffs}")
    return {"weights_equal": True, "tf32_in_forward": seen[0], "tap_diffs": diffs}


def _fidm_sqrtm(fid) -> dict:
    """The Fréchet distance from the states as read back, with scipy's float64 sqrtm of
    Σ₁Σ₂ (pytorch-fid's recipe: an offset on the diagonal only if the root is not finite)."""
    import warnings

    import numpy as np
    from scipy import linalg

    st = {k: getattr(fid, k).double().cpu().numpy() for k in fid._defaults}
    n_r, n_f = float(st["real_features_num_samples"]), float(st["fake_features_num_samples"])
    mu1, mu2 = st["real_features_sum"] / n_r, st["fake_features_sum"] / n_f
    s1 = (st["real_features_cov_sum"] - n_r * np.outer(mu1, mu1)) / (n_r - 1)
    s2 = (st["fake_features_cov_sum"] - n_f * np.outer(mu2, mu2)) / (n_f - 1)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # fewer samples than features: a singular product
        covmean = linalg.sqrtm(s1.dot(s2))
        if not np.isfinite(covmean).all():
            offset = np.eye(s1.shape[0]) * 1e-6
            covmean = linalg.sqrtm((s1 + offset).dot(s2 + offset))
    seconds = time.perf_counter() - t0
    value = float(((mu1 - mu2) ** 2).sum() + np.trace(s1) + np.trace(s2) - 2 * np.trace(np.real(covmean)))
    return {"value": value, "imag_max": float(np.abs(np.imag(covmean)).max()) if np.iscomplexobj(covmean) else 0.0,
            "host_s": seconds}


def run_fid_path(real: list, fake: list) -> dict:
    """BASELINE #3's FID: FID, KID and IS over the 32 + 32 updates, eagerly and with the
    engine; the first 2 updates per side against the CPU; the full run against scipy."""
    from torchmetrics_tpu_torch.engine import engine_context

    on, off = torch.tensor(True).cuda(), torch.tensor(False).cuda()
    out = {"trunk": check_fid_trunk(real)}

    # the first updates per side: the card against the CPU, states and values
    c = FIDM_CHECK_UPDATES
    is_state = _is_head_state(fake)
    with engine_context(False):
        card = _fidm_metrics(is_state, kid_subsets=(KID_CHECK_SUBSETS, KID_CHECK_SIZE))
        _fidm_drive(card, real[:c], fake[:c], (on, off))
        host = _fidm_metrics(is_state, "cpu", kid_subsets=(KID_CHECK_SUBSETS, KID_CHECK_SIZE))
        _fidm_drive(host, [r.cpu() for r in real[:c]], [f.cpu() for f in fake[:c]], (True, False))
        got, want = _fidm_values(card, 11), _fidm_values(host, 11)
    check = {k: _state_diffs(f"fid path {k}", card[k], host[k], FEATURE_SCALE_TOL) for k in card}
    fid_rel = abs(got["fid"].item() - want["fid"].item()) / abs(want["fid"].item())
    kid_abs = max(abs(g.item() - w.item()) for g, w in zip(got["kid"], want["kid"])) / abs(want["kid"][0].item())
    (is_mean, is_std), (want_mean, want_std) = [[float(x) for x in v] for v in (got["is"], want["is"])]
    is_log_rel = abs(math.log(is_mean) - math.log(want_mean)) / abs(math.log(want_mean))
    is_std_rel = abs(is_std - want_std) / (abs(math.log(want_mean)) * want_mean)
    if fid_rel > FIDM_VALUE_RTOL or kid_abs > KID_TOL or max(is_log_rel, is_std_rel) > IS_LOG_RTOL:
        raise AssertionError(f"fid path, first {c} updates per side: fid rel {fid_rel:.3e}, kid {kid_abs:.3e} of its"
                             f" mean, is log rel {is_log_rel:.3e} std {is_std_rel:.3e}; card {got} cpu {want}")
    out["against_cpu"] = {"updates_per_side": c, "state_diffs": check, "fid_rel": fid_rel, "kid_diff_of_mean": kid_abs,
                          "is_log_rel": is_log_rel, "is_std_rel": is_std_rel,
                          "values_card": {k: [float(x) for x in _outputs(v)] for k, v in got.items()}}
    del card, host
    gc.collect()

    # the whole run, eagerly and with the engine: KID / IS fall back on their lists
    runs = {}
    for mode in ("eager", "engine"):
        with engine_context(mode == "engine"):
            _zero_launches()
            metrics = _fidm_metrics(is_state)
            _fidm_drive(metrics, real, fake, (on, off))
            runs[mode] = (metrics, _launches())
    (eager, eager_launches), (engine, engine_launches) = runs["eager"], runs["engine"]
    if any(eager_launches.values()) or any(engine_launches.values()):
        raise AssertionError(f"fid path: K1 / K2 launched ({eager_launches}, {engine_launches})")
    _assert_same_states("fid path fid engine vs eager", engine["fid"], eager["fid"])
    n = len(real)
    st = engine["fid"]._engine.stats
    if st.eager_fallbacks or st.dispatches != 2 * n or st.bucketed_steps:
        raise AssertionError(f"fid path: the FID engine should replay every full batch in its exact shape: {st.as_dict()}")
    _check_replays("fid path fid", engine["fid"]._engine)
    split = {"fid": st.as_dict()}
    for k, updates in (("kid", 2 * n), ("is", n)):
        kst = engine[k]._engine.stats
        split[k] = kst.as_dict()
        if kst.dispatches or dict(kst.fallback_reasons) != {"list-state": updates}:
            raise AssertionError(f"fid path: {k} should fall back on its lists every update: {kst.as_dict()}")

    # host syncs per FID update with a tensor flag, eagerly and with the engine
    syncs = {}
    for mode, m in (("eager", eager["fid"]), ("engine", engine["fid"])):
        with engine_context(mode == "engine"):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                m.update(real[0], on)
                m.update(fake[0], off)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            syncs[mode] = _syncs_per_call(lambda m=m: m.update(real[1], on))
    if any(syncs.values()):
        raise AssertionError(f"fid path: host syncs per FID update {syncs}")
    _assert_same_states("fid path fid engine vs eager after the sync checks", engine["fid"], eager["fid"])

    # the full run's FID against scipy, then one ragged update
    values = {mode: _fidm_values(r[0], 3) for mode, r in runs.items()}
    if not torch.equal(values["engine"]["fid"], values["eager"]["fid"]):
        raise AssertionError(f"fid path: FID engine {values['engine']['fid'].item()} vs eager {values['eager']['fid'].item()}")
    ref = _fidm_sqrtm(eager["fid"])
    fid_value = values["eager"]["fid"].item()
    sqrtm_rel = abs(fid_value - ref["value"]) / abs(ref["value"])
    if not (math.isfinite(fid_value) and sqrtm_rel <= FIDM_SQRTM_RTOL):
        raise AssertionError(f"fid path: FID {fid_value} vs scipy sqrtm {ref['value']} (rel {sqrtm_rel:.3e})")
    for mode, m in (("eager", eager["fid"]), ("engine", engine["fid"])):
        with engine_context(mode == "engine"):
            m.update(real[2][:FIDM_RAGGED], on)
    ragged = _state_diffs("fid path ragged update engine vs eager", engine["fid"], eager["fid"], FIDM_RAGGED_TOL)
    if engine["fid"]._engine.stats.bucket_pad_rows != FIDM_BATCH - FIDM_RAGGED:
        raise AssertionError(f"fid path: the ragged update's pad rows {engine['fid']._engine.stats.as_dict()}")
    out.update({
        "updates_per_side": n, "batch": FIDM_BATCH, "launches_eager": eager_launches, "launches_engine": engine_launches,
        "engine_split": split, "host_syncs_per_update": syncs,
        "values": {k: [float(x) for x in _outputs(v)] for k, v in values["eager"].items()},
        "sqrtm": {**ref, "rel_diff": sqrtm_rel}, "ragged_state_diffs": ragged,
    })
    _log(f"  fid path: {n} + {n} updates of {FIDM_BATCH} x 3 x {FIDM_SIZE} x {FIDM_SIZE}; FID {fid_value:.6g} (scipy sqrtm"
         f" rel {sqrtm_rel:.2e}), KID {out['values']['kid']}, IS {out['values']['is']}; engine bit-equal to eager,"
         f" syncs per update {syncs}; first {c} per side against the CPU: fid rel {fid_rel:.2e}")
    out["times"] = time_fid_path(runs, real, fake)
    return out


def time_fid_path(runs: dict, real: list, fake: list) -> dict:
    """The trunk's forward alone and its share of an update's device time; FID update µs,
    eager against engine in turns; FID compute ms and its eigendecompositions; host reads
    per compute; KID compute ms and its peak memory; IS compute ms."""
    import warnings

    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance

    on = torch.tensor(True).cuda()
    fid = runs["eager"][0]["fid"]
    trunk = fid.inception
    n = len(real)
    forward_ms = _median_ms(lambda i: trunk(real[i % n]), iters=4, repeats=3, warmup=2)
    trunk_prof = _device_profile(lambda i: trunk(real[i % n]), iters=2)
    # the trunk's convolutions and fc (the 2048 tap computes them all) over 67 TFLOP/s
    flops = _conv_flops(trunk, real[0])
    out = {"trunk_forward_ms": forward_ms, "trunk_device_us": trunk_prof["device_busy_us"],
           "trunk_kernels_us": trunk_prof["kernels_us"], "trunk_gflop_per_update": flops / 1e9,
           "trunk_bound_ms": flops / _F32_RATE * 1e3, "trunk_bound_by": "operations"}
    runs_t = {"eager": [], "engine": []}
    for mode in ("eager", "engine", "engine", "eager"):
        with engine_context(mode == "engine"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # the random-trunk warning
                m = FrechetInceptionDistance(2048, allow_random_features=True)

            def step(i, m=m):
                m.update(real[i % n], on)

            step(0)
            step(1)
            runs_t[mode].append(_timed(step, iters=8))
            del m
            gc.collect()
    for mode, rs in runs_t.items():
        rec = _mean_runs(rs)
        busy = rec["device_busy_us"]
        rec["trunk_share"] = None if busy is None or trunk_prof["device_busy_us"] is None else trunk_prof["device_busy_us"] / busy
        out[f"update_{mode}"] = rec
    out["update_us_runs"] = {mode: [r["update_us"] for r in rs] for mode, rs in runs_t.items()}

    def compute_once(_=None):
        fid._computed = None
        return fid.compute()

    out["fid_compute_ms"] = _host_us_per_call(compute_once, iters=1, repeats=3) / 1e3
    cov = fid.real_features_cov_sum / float(fid.real_features_num_samples)
    out["eigh_ms"] = _median_ms(lambda i: torch.linalg.eigh(cov), iters=1, repeats=3, warmup=1)
    out["eigvalsh_ms"] = _median_ms(lambda i: torch.linalg.eigvalsh(cov), iters=1, repeats=3, warmup=1)
    out["eigh_share_of_compute"] = (out["eigh_ms"] + out["eigvalsh_ms"]) / out["fid_compute_ms"]
    # textbook counts: 4/3 n^3 to tridiagonalize, 2 n^3 more to back-transform the
    # vectors; over the float64 tensor-core peak (NVIDIA's data sheet, SXM)
    n_feat = cov.shape[0]
    out["eigh_bound_ms"] = (4 / 3 + 2) * n_feat**3 / _F64_RATE * 1e3
    out["eigvalsh_bound_ms"] = 4 / 3 * n_feat**3 / _F64_RATE * 1e3
    out["host_reads_per_fid_compute"] = _syncs_per_call(compute_once)

    import numpy as np

    kid = runs["eager"][0]["kid"]
    np.random.seed(5)
    kid._computed = None
    kid.compute()  # first use: the gather and product workspaces
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kid._computed = None
    kid.compute()
    torch.cuda.synchronize()
    out["kid_compute_ms"] = (time.perf_counter() - t0) * 1e3
    # the three batched products, 2 x subsets x m x m x d each, over 67 TFLOP/s
    d = kid.real_features[0].shape[-1]
    out["kid_products_bound_ms"] = 3 * 2 * kid.subsets * kid.subset_size**2 * d / _F32_RATE * 1e3
    out["kid_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["kid_peak_over_live_bytes"] = out["kid_peak_bytes"] - base
    kid._computed = None
    out["host_reads_per_kid_compute"] = _syncs_per_call(kid.compute)
    inc = runs["eager"][0]["is"]

    def is_once(_=None):
        inc._computed = None
        return inc.compute()

    out["is_compute_ms"] = _host_us_per_call(is_once, iters=1, repeats=3) / 1e3
    _log(f"  fid times: trunk forward {forward_ms:.2f} ms per {FIDM_BATCH} images (bound {out['trunk_bound_ms']:.2f} ms,"
         f" {out['trunk_gflop_per_update']:.1f} GFLOP); FID update"
         f" {out['update_eager']['update_us']:.1f} -> {out['update_engine']['update_us']:.1f} us (eager -> engine),"
         f" trunk share {out['update_eager']['trunk_share']}; FID compute {out['fid_compute_ms']:.1f} ms (eigh"
         f" {out['eigh_ms']:.1f} + eigvalsh {out['eigvalsh_ms']:.1f} ms against bounds {out['eigh_bound_ms']:.2f} +"
         f" {out['eigvalsh_bound_ms']:.2f}, {out['host_reads_per_fid_compute']} host reads);"
         f" KID compute {out['kid_compute_ms']:.1f} ms (products' bound {out['kid_products_bound_ms']:.1f} ms), peak"
         f" {out['kid_peak_bytes'] / 2**30:.2f} GiB; IS compute"
         f" {out['is_compute_ms']:.1f} ms")
    return out


def _conv_flops(fn, x: torch.Tensor) -> int:
    """Floating-point operations of the convolutions and linear layers in one ``fn(x)``
    (2 per multiply-add, counted from each layer's output shape by forward hooks)."""
    flops = []

    def hook(mod, _, out):
        if isinstance(mod, torch.nn.Conv2d):
            flops.append(2 * out.numel() * mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1])
        elif isinstance(mod, torch.nn.Linear):
            flops.append(2 * out.numel() * mod.in_features)

    model = getattr(fn, "model", fn)  # an extractor holds its trunk; a backbone is one
    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            fn(x)
    finally:
        for h in handles:
            h.remove()
    return sum(flops)


def _lpips_pairs(gen: torch.Generator, n: int, b: int, size: int) -> list:
    """``(img1, img2)`` in [-1, 1] on the card: a smooth reference and a blurred, noisy
    restoration of it (a super-resolution output against its ground truth)."""
    out = []
    for _ in range(n):
        target = _smooth(gen, (b, 3, size, size), (IMG_COARSE, IMG_COARSE))
        preds = _blurred_noisy(target, gen, 0.05)
        out.append(((preds * 2 - 1).cuda(), (target * 2 - 1).cuda()))
    return out


def run_lpips_path(pairs: list) -> dict:
    """Each backbone: 16 updates eagerly and with the engine, then ``compute``; the first
    batch's first 4 pairs and a gradient through ``img1`` against the CPU; the engine's
    split (the range check reads the host: every update falls back, as in the JAX
    engine); update µs and the backbone's share of the device time."""
    import warnings

    import copy

    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.functional.image.lpips import make_lpips_net
    from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity
    from torchmetrics_tpu_torch.models._common import full_float32

    def make(net, device=None):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return LearnedPerceptualImagePatchSimilarity(net, allow_random_backbone=True, device=device)

    n = len(pairs)
    out = {}
    for net in LPIPS_NETS:
        runs = {}
        for mode in ("eager", "engine"):
            with engine_context(mode == "engine"):
                _zero_launches()
                m = make(net)
                for a, b in pairs:
                    m.update(a, b)
                runs[mode] = (m, m.compute(), _launches())
        (eager, value, launches), (engine, engine_value, engine_launches) = runs["eager"], runs["engine"]
        if any(launches.values()) or any(engine_launches.values()):
            raise AssertionError(f"lpips {net}: K1 / K2 launched ({launches}, {engine_launches})")
        st = engine._engine.stats
        want_split = {"host-read:_local_scalar_dense": 1, "uncompilable-signature": n - 1}
        if st.dispatches or dict(st.fallback_reasons) != want_split:
            raise AssertionError(f"lpips {net}: the engine should fall back every update {want_split}: {st.as_dict()}")
        if not (torch.equal(engine_value, value) and torch.isfinite(value)):
            raise AssertionError(f"lpips {net}: engine {engine_value.item()} vs eager {value.item()}")
        a, b = pairs[0][0][:4], pairs[0][1][:4]
        host = make(net, "cpu")
        got, want = eager.net(a, b).squeeze(), host.net(a.cpu(), b.cpu()).squeeze()
        diff = (got.cpu() - want).abs().max().item()
        if diff > LPIPS_ATOL:
            raise AssertionError(f"lpips {net}: first 4 pairs card {got.tolist()} vs cpu {want.tolist()}")
        grads = []
        host64 = make_lpips_net(copy.deepcopy(host.net.feats_fn).double(), [w.double() for w in host.net.lin_weights])
        for x, y, fn in ((a[:2], b[:2], eager.net), (a[:2].cpu(), b[:2].cpu(), host.net),
                         (a[:2].cpu().double(), b[:2].cpu().double(), host64)):
            x = x.clone().requires_grad_(True)
            with full_float32():  # the backward at full float32 too, as the forward runs
                fn(x, y).mean().backward()
            grads.append(x.grad.detach().double().cpu())
        card, cpu32, cpu64 = grads
        l2 = {"card_vs_cpu": ((card - cpu32).norm() / cpu32.norm()).item(),
              "card_vs_cpu_float64": ((card - cpu64).norm() / cpu64.norm()).item(),
              "cpu_vs_cpu_float64": ((cpu32 - cpu64).norm() / cpu64.norm()).item(),
              "card_vs_cpu_max_of_scale": ((card - cpu32).abs().max() / cpu32.abs().max()).item()}
        if not (torch.isfinite(card).all() and l2["card_vs_cpu"] <= LPIPS_GRAD_L2_TOL):
            raise AssertionError(f"lpips {net}: gradient against the CPU {l2}")
        with engine_context(False):
            syncs = _syncs_per_call(lambda: eager.update(*pairs[1]))  # the range check's one read
        out[net] = {"value": value.item(), "pairs_abs_diff": diff, "grad_diff": l2, "host_syncs_per_update": syncs,
                    "engine_split": st.as_dict(), "launches_eager": launches, "launches_engine": engine_launches}
        del runs, eager, engine, host
        gc.collect()
        out[net]["times"] = time_lpips(make(net), pairs)
        t = out[net]["times"]
        _log(f"  lpips {net}: {n} updates of {LPIPS_BATCH} pairs, LPIPS {out[net]['value']:.6f}, first 4 pairs within"
             f" {diff:.2e} of the CPU, gradient {l2['card_vs_cpu']:.2e} (relative L2; the CPU's float32 against float64"
             f" {l2['cpu_vs_cpu_float64']:.2e}), {syncs} host syncs per update; update {t['eager']['update_us']:.1f} ->"
             f" {t['engine']['update_us']:.1f} us (eager -> engine), backbone share {t['backbone_share']}")
    return out


def time_lpips(m, pairs: list) -> dict:
    """One backbone's update, eager and engine in turns (the engine falls back), and the
    backbone's share of the update's device time (its forward on both images)."""
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.functional.image.lpips import scaling_layer

    from torchmetrics_tpu_torch.models._common import full_float32

    n = len(pairs)
    runs = {"eager": [], "engine": []}
    for mode in ("eager", "engine", "engine", "eager"):
        with engine_context(mode == "engine"):
            def step(i):
                m.update(*pairs[i % n])

            step(0)
            runs[mode].append(_timed(step, iters=8))
    out = {mode: _mean_runs(rs) for mode, rs in runs.items()}
    feats = m.net.feats_fn

    def backbone_step(i):
        with torch.no_grad(), full_float32():  # as the pipeline runs it
            return feats(scaling_layer(pairs[i % n][0])), feats(scaling_layer(pairs[i % n][1]))

    backbone = _device_profile(backbone_step, iters=4)
    busy = out["eager"]["device_busy_us"]
    flops = 2 * _conv_flops(feats, pairs[0][0])
    out.update({
        "backbone_device_us": backbone["device_busy_us"],
        "backbone_share": None if busy is None or backbone["device_busy_us"] is None else backbone["device_busy_us"] / busy,
        "backbone_gflop_per_update": flops / 1e9, "backbone_bound_ms": flops / _F32_RATE * 1e3,
    })
    return out


def run_image_models(gen: torch.Generator, smi: str) -> dict:
    """Phase 19: the ``fid`` path (FID, KID and IS over BASELINE #3's 256 x 256 batches)
    and the ``lpips`` path (three backbones over super-resolution pairs)."""
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must run at 'highest' precision (no TF32) for the card to agree with the CPU")
    real, fake = _gan_batches(gen, FIDM_UPDATES, FIDM_BATCH, FIDM_SIZE)
    out = {"card": smi, "fid": run_fid_path(real, fake)}
    del real, fake
    gc.collect()
    torch.cuda.empty_cache()
    out["lpips"] = run_lpips_path(_lpips_pairs(gen, LPIPS_UPDATES, LPIPS_BATCH, FIDM_SIZE))
    out["tolerances"] = {
        "feature_scale": FEATURE_SCALE_TOL, "fid_value_rtol": FIDM_VALUE_RTOL, "fid_sqrtm_rtol": FIDM_SQRTM_RTOL,
        "kid_of_mean": KID_TOL, "is_log_rel": IS_LOG_RTOL, "ragged_scale": FIDM_RAGGED_TOL, "lpips_atol": LPIPS_ATOL,
        "lpips_grad_l2": LPIPS_GRAD_L2_TOL,
    }
    return out


# ---------------------------------------------------------------- phase 20: the text domain

TEXT_PAIRS, TEXT_UPDATES = 512, 8  # BASELINE #4: newstest2016 en-de sized pairs, 8 updates of 64
TEXT_BATCH = TEXT_PAIRS // TEXT_UPDATES
TEXT_VOCAB = 4000  # the seeded word list (Zipf frequencies)
TEXT_CPU_UPDATES = 2  # the host metrics' prefix held against the CPU
TEXT_TIMED = 4  # timed updates per member and per collection
# roberta-large, the reference BERTScore's default backbone
ROBERTA = {"layers": 24, "hidden": 1024, "heads": 16, "ffn": 4096, "vocab": 50265, "positions": 514}
BERT_MAX_LENGTH = 512  # BERTScore's default max_length: every row runs at width 512
BERT_CHUNK = 64  # encoder rows per forward
BERT_CPU_PAIRS = 2  # the functional's first pairs, scored on the CPU too
# the modular compute's pairs held against a CPU BERTScore that took the same updates:
# one in each update, at another offset in each
BERT_CPU_ROWS = tuple(u * (TEXT_PAIRS // TEXT_UPDATES) + u for u in range(TEXT_UPDATES))
# GPT-2's published shapes: vocabulary 50257, context 1024
PPL_BATCH, PPL_CONTEXT, PPL_VOCAB, PPL_UPDATES = 8, 1024, 50257, 4
PPL_IGNORED = 0.05
INFOLM_VOCAB, INFOLM_BUCKETS = 50265, 512
INFOLM_CPU_PAIRS = 16
INFOLM_MEASURES = (
    ("kl_divergence", None, None), ("alpha_divergence", 0.5, None), ("beta_divergence", None, 0.5),
    ("ab_divergence", 0.5, 0.3), ("renyi_divergence", 0.5, None), ("l1_distance", None, None),
    ("l2_distance", None, None), ("l_infinity_distance", None, None), ("fisher_rao_distance", None, None),
)
# the HF route: a seeded BertForMaskedLM at bert-base width, saved by the script
HF_BERT = {"layers": 12, "hidden": 768, "heads": 12, "ffn": 3072, "vocab": 30522, "positions": 512}
HF_INFOLM_PAIRS = 16  # InfoLM runs one forward per token position
HF_CPU_PAIRS = 2
# tolerances: counts exact; the host metrics' float states and values (float32 sums of
# host counts) relative 1e-6; perplexity relative 1e-5 (float32 sums over 2048 tokens in
# another order); BERTScore absolute 1e-4 (24 float32 encoder layers, TF32 off, summed in
# another order on each side); InfoLM relative 1e-5 (float32 distributions and sums over
# 50265 tokens; the HF route's masked-LM distributions relative 1e-4)
TEXT_RTOL = 1e-6
PPL_CPU_RTOL = 1e-5
BERT_CPU_ATOL = 1e-4
INFOLM_CPU_RTOL = 1e-5
HF_INFOLM_CPU_RTOL = 1e-4
TEXT_PATHS = ("mt", "asr", "squad")


def _wmt_pairs(n: int, seed: int) -> tuple:
    """``n`` seeded pairs shaped like WMT16 newstest2016 en-de: predictions of 5-80 words
    (mean ~22) drawn with Zipf frequencies from a seeded vocabulary of 4000 words; each
    reference an edit of its prediction (~30 % of words substituted, a few inserted and
    dropped, one clause moved to the end); about a third of the pairs hold two or three
    ``.``-separated sentences."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words: set = set()
    while len(words) < TEXT_VOCAB:
        words.add("".join(rng.choice(letters, rng.integers(2, 11))))
    vocab = sorted(words)
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()

    def draw(k: int) -> list:
        return [vocab[i] for i in rng.choice(len(vocab), size=k, p=p)]

    def sentences(ws: list, parts: int) -> str:
        cuts = sorted(rng.choice(np.arange(1, len(ws)), min(parts - 1, len(ws) - 1), replace=False))
        chunks = [ws[i:j] for i, j in zip([0, *cuts], [*cuts, len(ws)])]
        return ". ".join(" ".join(c) for c in chunks) + "."

    preds, targets = [], []
    for _ in range(n):
        pred = draw(int(np.clip(np.round(np.exp(rng.normal(3.0, 0.45))), 5, 80)))
        tgt = [w if rng.random() > 0.3 else draw(1)[0] for w in pred]
        for _ in range(rng.poisson(0.6)):
            tgt.insert(rng.integers(len(tgt) + 1), draw(1)[0])
        for _ in range(rng.poisson(0.6)):
            if len(tgt) > 3:
                del tgt[rng.integers(len(tgt))]
        a, b = sorted(rng.choice(np.arange(1, len(tgt)), 2, replace=False))
        tgt = tgt[:a] + tgt[b:] + tgt[a:b]
        if rng.random() < 1 / 3:
            parts = int(rng.integers(2, 4))
            preds.append(sentences(pred, parts))
            targets.append(sentences(tgt, parts))
        else:
            preds.append(" ".join(pred))
            targets.append(" ".join(tgt))
    return preds, targets, vocab


def _squad_pairs(n: int, vocab: list, seed: int) -> tuple:
    """``n`` seeded SQuAD question / answer dicts: 1-3 gold answers of 1-4 words each; the
    prediction is the first answer (40 %), empty (10 %) or an overlapping span."""
    import numpy as np

    rng = np.random.default_rng(seed)
    preds, target = [], []
    for i in range(n):
        answers = [" ".join(rng.choice(vocab[:400], rng.integers(1, 5))) for _ in range(rng.integers(1, 4))]
        u = rng.random()
        if u < 0.4:
            pred = answers[0]
        elif u < 0.5:
            pred = ""
        else:
            pred = " ".join(answers[0].split()[: rng.integers(1, 3)] + list(rng.choice(vocab[:400], rng.integers(0, 3))))
        preds.append({"prediction_text": pred, "id": f"q{i}"})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"q{i}"})
    return preds, target


def _text_members(path: str, device=None) -> dict:
    """``mt``: the translation metrics, references as one-element lists (SacreBLEU's update
    takes references as lists, as the JAX package's does); ``asr``: the WER family on flat
    strings; ``squad``: SQuAD."""
    import torchmetrics_tpu_torch.text as tt

    kw = {"device": device}
    if path == "mt":
        return {
            "bleu": tt.BLEUScore(**kw), "sacrebleu": tt.SacreBLEUScore(tokenize="13a", **kw), "chrf": tt.CHRFScore(**kw),
            "ter": tt.TranslationEditRate(**kw), "eed": tt.ExtendedEditDistance(**kw),
            "rouge": tt.ROUGEScore(rouge_keys=("rouge1", "rouge2", "rougeL", "rougeLsum"), **kw),
        }
    if path == "asr":
        return {
            "wer": tt.WordErrorRate(**kw), "cer": tt.CharErrorRate(**kw), "mer": tt.MatchErrorRate(**kw),
            "wil": tt.WordInfoLost(**kw), "wip": tt.WordInfoPreserved(**kw),
        }
    return {"squad": tt.SQuAD(**kw)}


def _text_batches(preds: list, targets: list, squad: tuple) -> dict:
    b = TEXT_BATCH
    return {
        "mt": [(preds[i : i + b], [[t] for t in targets[i : i + b]]) for i in range(0, TEXT_PAIRS, b)],
        "asr": [(preds[i : i + b], targets[i : i + b]) for i in range(0, TEXT_PAIRS, b)],
        "squad": [(squad[0][i : i + b], squad[1][i : i + b]) for i in range(0, TEXT_PAIRS, b)],
    }


def _text_state_diff(name: str, card, host, rtol: float = TEXT_RTOL) -> float:
    """Every state of ``card`` against ``host``: strings and whole numbers equal, other
    floats within ``rtol``; the largest relative difference."""
    worst = 0.0
    for attr in host._defaults:
        x, y = getattr(card, attr), getattr(host, attr)
        if isinstance(y, list):
            if y and isinstance(y[0], str):
                if x != y:
                    raise AssertionError(f"{name}: string state {attr} differs")
                continue
            if len(x) != len(y):
                raise AssertionError(f"{name}: list state {attr} holds {len(x)} vs {len(y)} entries")
            x = torch.cat([v.reshape(-1) for v in x]) if x else torch.zeros(0)
            y = torch.cat([v.reshape(-1) for v in y]) if y else torch.zeros(0)
        x, y = x.cpu(), y.cpu()
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{name}: state {attr} {x.dtype} {tuple(x.shape)} vs {y.dtype} {tuple(y.shape)}")
        if not x.is_floating_point() or torch.equal(y, y.round()):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: state {attr} differs: {x.flatten()[:6].tolist()} vs {y.flatten()[:6].tolist()}")
            continue
        rel = ((x.double() - y.double()).abs() / y.double().abs().clamp(min=1e-30)).max().item() if y.numel() else 0.0
        if rel > rtol:
            raise AssertionError(f"{name}: state {attr} relative difference {rel:.3e} > {rtol}")
        worst = max(worst, rel)
    return worst


def _values_diff(name: str, got: dict, want: dict, rtol: float) -> float:
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        rel = abs(g - w) / max(abs(w), 1e-30) if (g != w) else 0.0
        if not (math.isfinite(g) and rel <= rtol):
            raise AssertionError(f"{name}: {k} {g} vs {w} (relative {rel:.3e} > {rtol})")
        worst = max(worst, rel)
    return worst


def _with_syncs(fn):
    """``fn()``'s value and the device -> host syncs in it (``set_sync_debug_mode("warn")``)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            value = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return value, sum("synchronizing CUDA operation" in str(w.message) for w in caught)


class _CpuRows:
    """The CPU side of a card-against-CPU check of BERTScore at the corpus' size:
    ``forward(pairs)`` is an encoder that runs ``encode`` on the CPU for the rows
    ``pairs`` only (each row once, kept by its tokens; ``None``: every row) and gives
    zero rows for the others. A pair's scores read its own two rows and the idf table,
    which is counted from the tokens, so the held pairs' scores are those of a CPU metric
    that ran the encoder over the whole corpus."""

    def __init__(self, encode) -> None:
        self.encode, self.rows = encode, {}

    def forward(self, pairs=None):
        def fwd(ids, mask):
            idx = list(range(ids.shape[0])) if pairs is None else list(pairs)
            keys = {i: (ids[i].numpy().tobytes(), mask[i].numpy().tobytes()) for i in idx}
            todo = [i for i in idx if keys[i] not in self.rows]
            if todo:
                with torch.no_grad():
                    emb = self.encode(ids[todo], mask[todo])
                for i, e in zip(todo, emb):
                    self.rows[keys[i]] = e
            first = self.rows[keys[idx[0]]]
            out = torch.zeros((ids.shape[0],) + tuple(first.shape), dtype=first.dtype)
            for i in idx:
                out[i] = self.rows[keys[i]]
            return out

        return fwd


def _score_diff(card: dict, host: dict, pairs) -> float:
    """The largest absolute difference of precision, recall and F1 at ``pairs``."""
    sel = list(pairs)
    return max((card[k][sel].cpu() - host[k][sel]).abs().max().item() for k in ("precision", "recall", "f1"))


class _PartTimer:
    """Host seconds spent in named methods of given objects, by part: each method is
    shadowed by an instance attribute that times it (``restore`` puts them back)."""

    def __init__(self) -> None:
        self.seconds: dict = {}
        self._patched: list = []

    def wrap(self, obj, attr: str, part: str) -> None:
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[part] = self.seconds.get(part, 0.0) + time.perf_counter() - t0

        had = attr in obj.__dict__
        self._patched.append((obj, attr, obj.__dict__.get(attr), had))
        obj.__dict__[attr] = timed

    def restore(self) -> None:
        for obj, attr, old, had in reversed(self._patched):
            if had:
                obj.__dict__[attr] = old
            else:
                del obj.__dict__[attr]
        self._patched.clear()


def _collection_breakdown(make, batches: list, rounds: int = 2) -> dict:
    """Where a text collection's update goes, µs per update by part, engine on (the
    card's default): the fused-step attempt, each owner's update wrapper outside its body
    (input placement, counters, the engine's refusal), the engine's refusal alone, the
    update bodies (the host string work), and the views' re-materialization."""
    from torchmetrics_tpu_torch import MetricCollection

    mc = MetricCollection(make())
    mc.update(*batches[0])  # the discovery step
    owners = [mc._modules[g.owner] for g in mc._groups.values()]
    timer = _PartTimer()
    timer.wrap(mc, "_fused_step", "fused_step_attempt")
    timer.wrap(mc, "_materialize_group_views", "views")
    for m in owners:
        timer.wrap(m, "update", "owner_update_total")
        timer.wrap(m, "_engine_step", "engine_refusal")
        timer.wrap(m, "_raw_update", "update_bodies")
    n = 0
    t0 = time.perf_counter()
    try:
        for _ in range(rounds):
            for batch in batches:
                mc.update(*batch)
                n += 1
        torch.cuda.synchronize()
    finally:
        timer.restore()
    total = (time.perf_counter() - t0) / n * 1e6
    s = {k: v / n * 1e6 for k, v in timer.seconds.items()}
    wrapper = s.get("owner_update_total", 0.0) - s.get("update_bodies", 0.0) - s.get("engine_refusal", 0.0)
    parts = {
        "fused_step_attempt_us": s.get("fused_step_attempt", 0.0),
        "engine_refusal_us": s.get("engine_refusal", 0.0),
        "owner_wrapper_rest_us": wrapper,
        "views_us": s.get("views", 0.0),
        "update_bodies_us": s.get("update_bodies", 0.0),
    }
    parts["collection_rest_us"] = total - sum(parts.values())
    return {"update_us": total, "owners": len(owners), "members": len(mc), **parts,
            "overhead_us": total - parts["update_bodies_us"],
            "fused_engine": None if mc._fused_engine is None else mc._fused_engine.stats.as_dict()}


def _engine_reasons(mc) -> dict:
    """Fallback reasons summed over a collection's member engines and its fused engine."""
    reasons: dict = {}
    engines = [m._engine for m in mc._modules.values() if m._engine is not None]
    if mc._fused_engine is not None:
        engines.append(mc._fused_engine)
    for eng in engines:
        for r, k in eng.stats.fallback_reasons.items():
            reasons[r] = reasons.get(r, 0) + k
    return reasons


def run_text_host_paths(batches: dict) -> dict:
    """The host metrics: each path eagerly and with the engine over the 8 updates (the
    engine run bit-equal to the eager one), its first updates against the CPU, the
    engine's split, host-to-device copies, host µs by member and for the collection
    against its members one by one, device operations and idle share, and the collection
    fallback's cost by part."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import engine_context

    out = {}
    for path in TEXT_PATHS:
        data = batches[path]
        runs = {}
        for mode in ("eager", "engine"):
            with engine_context(mode == "engine"):
                _zero_launches()
                mc = MetricCollection(_text_members(path))
                for batch in data:
                    mc.update(*batch)
                launches = _launches()
                runs[mode] = (mc, launches, _flat_text_value_all(mc.compute()))
        (eager, eager_launches, values), (engine, engine_launches, engine_values) = runs["eager"], runs["engine"]
        if any(eager_launches.values()) or any(engine_launches.values()):
            raise AssertionError(f"text {path}: K1 / K2 launched ({eager_launches}, {engine_launches})")
        for name in eager:
            _text_state_diff(f"text {path} {name} engine vs eager", engine[name], eager[name], 0.0)
        if engine_values != values:
            raise AssertionError(f"text {path}: engine values {engine_values} vs eager {values}")
        reasons = _engine_reasons(engine)
        if any(r not in ("non-tensor-input", "list-state") for r in reasons):
            raise AssertionError(f"text {path}: unexpected engine fallbacks {reasons}")

        # the first updates against the CPU
        card = MetricCollection(_text_members(path))
        host = MetricCollection(_text_members(path, "cpu"))
        for batch in data[:TEXT_CPU_UPDATES]:
            card.update(*batch)
            host.update(*batch)
        state_rel = max(_text_state_diff(f"text {path} {n}", card[n], host[n]) for n in host)
        value_rel = _values_diff(f"text {path} values", _flat_text_value_all(card.compute()),
                                 _flat_text_value_all(host.compute()), TEXT_RTOL)
        # host reads per member compute (a pageable copy back to the card counts too)
        compute_syncs = {}
        for name in card:
            card[name]._computed = None
            compute_syncs[name] = _with_syncs(card[name].compute)[1]

        # host µs: each member alone, the collection (engine on, the card's default)
        members_us = {}
        for name, m in _text_members(path).items():
            m.update(*data[0])
            members_us[name] = _host_us_per_call(lambda i, m=m: m.update(*data[i % len(data)]), iters=TEXT_TIMED, repeats=1)
        mc = MetricCollection(_text_members(path))
        mc.update(*data[0])
        step = lambda i, mc=mc: mc.update(*data[i % len(data)])  # noqa: E731
        collection_us = _host_us_per_call(step, iters=TEXT_TIMED, repeats=1)
        prof = _device_profile(step, iters=2)
        busy = prof["device_busy_us"]
        out[path] = {
            "updates": len(data), "pairs_per_update": TEXT_BATCH, "launches_eager": eager_launches,
            "launches_engine": engine_launches, "values": values, "engine_fallbacks": reasons,
            "against_cpu": {"updates": TEXT_CPU_UPDATES, "state_rel": state_rel, "value_rel": value_rel},
            "member_update_us": members_us, "members_one_by_one_us": sum(members_us.values()),
            "collection_update_us": collection_us,
            "h2d_copies_per_update": _host_to_device_copies(step, iters=2) / 2,
            "host_syncs_per_compute": compute_syncs,
            "host_syncs_per_update": _syncs_per_call(lambda: step(1)),
            "device_busy_us": busy, "device_ops": prof["device_ops"],
            "device_idle_share": None if busy is None else max(0.0, 1 - busy / collection_us),
            "kernels_us": prof["kernels_us"],
            "fallback_breakdown": _collection_breakdown(lambda: _text_members(path), data[:4], rounds=1),
        }
        _log(f"  text {path}: {len(data)} updates of {TEXT_BATCH}; collection {collection_us:.0f} µs per update against"
             f" its members one by one {sum(members_us.values()):.0f}; {out[path]['h2d_copies_per_update']:.0f} host-to-device"
             f" copies per update; fallbacks {reasons}; CPU prefix state rel {state_rel:.2e}, values {value_rel:.2e}")
    return out


def _flat_text_value_all(values: dict) -> dict:
    """A collection's flat ``compute`` as Python floats."""
    return {k: float(v) for k, v in values.items()}


# ---- BERTScore at roberta-large's width


class _EncoderLayer(torch.nn.Module):
    """One post-LN transformer layer (RoBERTa's): self-attention, then a GELU FFN."""

    def __init__(self, hidden: int, heads: int, ffn: int) -> None:
        super().__init__()
        self.heads = heads
        self.qkv = torch.nn.Linear(hidden, 3 * hidden)
        self.out = torch.nn.Linear(hidden, hidden)
        self.ln1 = torch.nn.LayerNorm(hidden, eps=1e-5)
        self.fc1 = torch.nn.Linear(hidden, ffn)
        self.fc2 = torch.nn.Linear(ffn, hidden)
        self.ln2 = torch.nn.LayerNorm(hidden, eps=1e-5)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, length, h = x.shape
        q, k, v = self.qkv(x).view(b, length, 3, self.heads, h // self.heads).permute(2, 0, 3, 1, 4)
        a = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        x = self.ln1(x + self.out(a.transpose(1, 2).reshape(b, length, h)))
        return self.ln2(x + self.fc2(torch.nn.functional.gelu(self.fc1(x))))


class _TextEncoder(torch.nn.Module):
    """A RoBERTa-shaped encoder: word and position embeddings (positions offset by 2, as
    RoBERTa's), layer norm, ``layers`` post-LN layers; seeded weights (normal 0.02, as
    BERT's init; layer norms the identity; biases 0)."""

    def __init__(self, layers: int, hidden: int, heads: int, ffn: int, vocab: int, positions: int) -> None:
        super().__init__()
        self.word = torch.nn.Embedding(vocab, hidden)
        self.pos = torch.nn.Embedding(positions, hidden)
        self.ln = torch.nn.LayerNorm(hidden, eps=1e-5)
        self.layers = torch.nn.ModuleList(_EncoderLayer(hidden, heads, ffn) for _ in range(layers))
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif ".ln" in name or name.startswith("ln"):
                    p.fill_(1.0)
                else:
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        self.eval()

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        outs = []
        for i in range(0, ids.shape[0], BERT_CHUNK):
            idc, mc = ids[i : i + BERT_CHUNK], mask[i : i + BERT_CHUNK]
            pos = torch.arange(2, 2 + idc.shape[1], device=idc.device)
            x = self.ln(self.word(idc) + self.pos(pos)[None])
            bias = ((1.0 - mc.to(x.dtype)) * -1e9)[:, None, None, :]
            for layer in self.layers:
                x = layer(x, bias)
            outs.append(x)
        return torch.cat(outs)

    def flops_per_token(self, length: int) -> int:
        """Multiply-adds x 2 of the linear layers and the attention products, per token."""
        h, f = self.ln.normalized_shape[0], self.layers[0].fc1.out_features
        per_layer = 2 * (4 * h * h + 2 * h * f) + 4 * length * h
        return per_layer * len(self.layers)


def _word_tokenizer(vocab_size: int, max_length: int):
    """Word-level tokens (a word's id: a hash into [3, vocab)), ``<s>`` = 0 and ``</s>`` = 2
    around them, zero padding to ``max_length``: every row at width ``max_length``."""
    import zlib

    def tokenize(sentences: list) -> dict:
        ids = torch.zeros(len(sentences), max_length, dtype=torch.int64)
        for i, s in enumerate(sentences):
            toks = [0] + [zlib.crc32(w.encode()) % (vocab_size - 3) + 3 for w in s.split()][: max_length - 2] + [2]
            ids[i, : len(toks)] = torch.tensor(toks)
        return {"input_ids": ids, "attention_mask": (torch.arange(max_length)[None] < torch.tensor(
            [min(len(s.split()), max_length - 2) + 2 for s in sentences])[:, None]).to(torch.int64)}

    return tokenize


def run_bert_score(preds: list, targets: list, hbm_rate: float) -> dict:
    """BERTScore over the 512 pairs at roberta-large's width through an injected encoder
    and tokenizer: 8 updates of 64 pairs, then ``compute`` with ``idf=False`` and with
    ``idf=True``; the greedy-cosine product against its bound; both computes at
    ``BERT_CPU_ROWS`` against CPU metrics that took the same updates, and the functional's
    first pairs against the CPU."""
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.functional.text import bert as bert_fn
    from torchmetrics_tpu_torch.functional.text import bert_score
    from torchmetrics_tpu_torch.text import BERTScore

    import copy

    cpu_encoder = _TextEncoder(**ROBERTA)
    encoder = copy.deepcopy(cpu_encoder).cuda()  # the same seeded weights
    tokenizer = _word_tokenizer(ROBERTA["vocab"], BERT_MAX_LENGTH)
    enc_events: list = []  # (start, end) CUDA events around each encoder call

    def forward(ids, mask):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.no_grad():
            x = encoder(ids, mask)
        end.record()
        enc_events.append((start, end))
        return x

    out: dict = {"encoder": {k: v for k, v in ROBERTA.items()}, "max_length": BERT_MAX_LENGTH}
    b = TEXT_BATCH
    runs = {}
    for mode in ("eager", "engine"):
        with engine_context(mode == "engine"):
            _zero_launches()
            metrics = {idf: BERTScore(model=forward, user_tokenizer=tokenizer, idf=idf, max_length=BERT_MAX_LENGTH)
                       for idf in (False, True)}
            t0 = time.perf_counter()
            for i in range(0, TEXT_PAIRS, b):
                for m in metrics.values():
                    m.update(preds[i : i + b], targets[i : i + b])
            torch.cuda.synchronize()
            runs[mode] = {"metrics": metrics, "update_us": (time.perf_counter() - t0) / (2 * TEXT_UPDATES) * 1e6}
    engine_metrics = runs["engine"]["metrics"]
    for idf in (False, True):
        st = engine_metrics[idf]._engine.stats
        if st.dispatches or dict(st.fallback_reasons) != {"list-state": TEXT_UPDATES}:
            raise AssertionError(f"bert_score: the updates should fall back on their lists: {st.as_dict()}")
        _text_state_diff("bert_score engine vs eager", engine_metrics[idf], runs["eager"]["metrics"][idf], 0.0)
    computes, values = {}, {}
    for idf, m in engine_metrics.items():
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        enc_events.clear()
        t0 = time.perf_counter()
        value, reads = _with_syncs(m.compute)
        ms = (time.perf_counter() - t0) * 1e3
        enc_ms = sum(a.elapsed_time(b) for a, b in enc_events)
        f1 = value["f1"]
        if f1.shape != (TEXT_PAIRS,) or not torch.isfinite(f1).all() or not ((f1 > 0) & (f1 <= 1 + 1e-6)).all():
            raise AssertionError(f"bert_score idf={idf}: f1 {f1.shape} {f1[:4].tolist()}")
        values[idf] = value
        computes[f"idf_{idf}"] = {
            "compute_ms": ms, "encoder_ms": enc_ms, "encoder_share": enc_ms / ms,
            "peak_mib_over_live": (torch.cuda.max_memory_allocated() - live) / 2**20,
            "host_reads_per_compute": reads,
            "f1_mean": f1.mean().item(), "precision_mean": value["precision"].mean().item(),
        }
    launches = _launches()

    # the padding: real tokens against the width-512 rows the encoder runs
    tok = tokenizer(preds + targets)
    real = int(tok["attention_mask"].sum())
    rows = TEXT_PAIRS
    out["padding"] = {
        "real_tokens": real, "encoder_tokens": 2 * rows * BERT_MAX_LENGTH, "real_share": real / (2 * rows * BERT_MAX_LENGTH),
    }
    flops = 2 * rows * BERT_MAX_LENGTH * encoder.flops_per_token(BERT_MAX_LENGTH)
    out["encoder_flops"] = flops
    out["encoder_bound_ms"] = flops / 67e12 * 1e3

    # the greedy-cosine product at the compute's shapes, against its float32 bound
    gen = torch.Generator(device="cuda").manual_seed(5)
    pe = torch.randn(rows, BERT_MAX_LENGTH, ROBERTA["hidden"], device="cuda", generator=gen)
    te = torch.randn(rows, BERT_MAX_LENGTH, ROBERTA["hidden"], device="cuda", generator=gen)
    pm = torch.ones(rows, BERT_MAX_LENGTH, device="cuda")
    from torchmetrics_tpu_torch.models._common import full_float32

    def bmm():
        with full_float32():
            return torch.bmm(pe, te.transpose(1, 2))

    bmm_ms = _median_ms(lambda i: bmm(), iters=5, repeats=3)
    cos_ms = _median_ms(lambda i: bert_fn._greedy_cosine_scores(pe, pm, te, pm, pm, pm), iters=3, repeats=3)
    bmm_flops = 2 * rows * BERT_MAX_LENGTH * BERT_MAX_LENGTH * ROBERTA["hidden"]
    out["greedy_cosine"] = {
        "bmm_ms": bmm_ms, "scores_ms": cos_ms, "flops": bmm_flops, "bound_ms": bmm_flops / 67e12 * 1e3,
        "bmm_bytes_bound_ms": 4 * (2 * rows * BERT_MAX_LENGTH * ROBERTA["hidden"] + rows * BERT_MAX_LENGTH**2) / hbm_rate * 1e3,
    }
    del pe, te, pm

    # the card against the CPU (the same seeded weights): each modular compute at
    # BERT_CPU_ROWS against a CPU metric that took the same 8 updates (the state
    # concatenation and the corpus-wide idf included), then the functional's first pairs
    host_rows = _CpuRows(cpu_encoder)
    against = {}
    for idf, value in values.items():
        host_m = BERTScore(model=host_rows.forward(BERT_CPU_ROWS), user_tokenizer=tokenizer, idf=idf,
                           max_length=BERT_MAX_LENGTH, device="cpu")
        for i in range(0, TEXT_PAIRS, b):
            host_m.update(preds[i : i + b], targets[i : i + b])
        against[f"modular_idf_{idf}"] = _score_diff(value, host_m.compute(), BERT_CPU_ROWS)
        del host_m
    n = BERT_CPU_PAIRS
    card = bert_score(preds[:n], targets[:n], model=forward, user_tokenizer=tokenizer, idf=True)
    host = bert_score(preds[:n], targets[:n], model=host_rows.forward(), user_tokenizer=tokenizer, idf=True, device="cpu")
    against["functional"] = _score_diff(card, host, range(n))
    diff = max(against.values())
    if not diff <= BERT_CPU_ATOL:
        raise AssertionError(f"bert_score: card against CPU {against} > {BERT_CPU_ATOL}")
    out.update({
        "pairs": TEXT_PAIRS, "updates": TEXT_UPDATES, "update_us": {k: v["update_us"] for k, v in runs.items()},
        "computes": computes, "launches": launches,
        "against_cpu": {"modular_pairs": list(BERT_CPU_ROWS), "functional_pairs": n, "max_abs_diff": against},
        "engine_split": engine_metrics[False]._engine.stats.as_dict(),
    })
    _log(f"  bert_score: {TEXT_PAIRS} pairs at width {BERT_MAX_LENGTH}, {ROBERTA['layers']} x {ROBERTA['hidden']}; compute idf=False"
         f" {computes['idf_False']['compute_ms']:.0f} ms (encoder {computes['idf_False']['encoder_share']:.3f}),"
         f" idf=True {computes['idf_True']['compute_ms']:.0f} ms; bmm {bmm_ms:.2f} ms against"
         f" {out['greedy_cosine']['bound_ms']:.2f}; real tokens {out['padding']['real_share']:.3f}; CPU {diff:.2e}")
    del encoder, cpu_encoder, runs, engine_metrics, values, host_rows
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---- perplexity at GPT-2's shapes


def run_perplexity(hbm_rate: float) -> dict:
    """4 updates of (8, 1024, 50257) logits with ~5 % ``ignore_index``, float32 then
    bfloat16, eagerly and with the engine (which must replay, with 0 syncs per update);
    device time per update against the bytes bound; a two-row slice against the CPU."""
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.functional.text import perplexity
    from torchmetrics_tpu_torch.text import Perplexity

    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        batches = []
        for _ in range(PPL_UPDATES):
            logits = (torch.randn(PPL_BATCH, PPL_CONTEXT, PPL_VOCAB, device="cuda", generator=gen) * 2).to(dtype)
            target = torch.randint(0, PPL_VOCAB, (PPL_BATCH, PPL_CONTEXT), device="cuda", generator=gen)
            target = torch.where(torch.rand(target.shape, device="cuda", generator=gen) < PPL_IGNORED, IGNORE, target)
            batches.append((logits, target))
        runs = {}
        for mode in ("eager", "engine"):
            with engine_context(mode == "engine"):
                _zero_launches()
                m = Perplexity(ignore_index=IGNORE)
                for logits, target in batches:
                    m.update(logits, target)
                runs[mode] = (m, _launches())
        (eager, eager_launches), (engine, engine_launches) = runs["eager"], runs["engine"]
        st = engine._engine.stats
        if st.eager_fallbacks or st.dispatches != PPL_UPDATES or st.captures > 1:
            raise AssertionError(f"perplexity {name}: the engine should replay every update: {st.as_dict()}")
        _check_replays(f"perplexity {name}", engine._engine)
        if not (torch.equal(engine.count, eager.count) and torch.equal(engine.total_log_probs, eager.total_log_probs)):
            raise AssertionError(f"perplexity {name}: engine {engine.total_log_probs.item()} vs eager {eager.total_log_probs.item()}")
        syncs = {}
        for mode, m in (("eager", eager), ("engine", engine)):
            with engine_context(mode == "engine"):
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    m.update(*batches[0])
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                syncs[mode] = _syncs_per_call(lambda m=m: m.update(*batches[1]))
        if any(syncs.values()):
            raise AssertionError(f"perplexity {name}: host syncs per update {syncs}")
        value = eager.compute().item()
        # two rows of the first batch, the card against the CPU
        logits, target = batches[0]
        card = perplexity(logits[:2], target[:2], ignore_index=IGNORE).item()
        host = perplexity(logits[:2].cpu(), target[:2].cpu(), ignore_index=IGNORE).item()
        rel = abs(card - host) / abs(host)
        if not (math.isfinite(value) and rel <= PPL_CPU_RTOL):
            raise AssertionError(f"perplexity {name}: {value}; two rows card {card} vs CPU {host} (rel {rel:.3e})")
        # device time per update: the functional update's ops, CUDA events
        from torchmetrics_tpu_torch.functional.text.perplexity import _perplexity_update

        update_ms = _median_ms(lambda i: _perplexity_update(logits, target, IGNORE), iters=10, repeats=3)
        nbytes = logits.numel() * logits.element_size() + target.numel() * target.element_size()
        prof = _device_profile(lambda i: eager.update(*batches[i % PPL_UPDATES]), iters=4)
        times = {}
        for mode, m in (("eager", eager), ("engine", engine), ("engine", engine), ("eager", eager)):
            with engine_context(mode == "engine"):
                times.setdefault(mode, []).append(
                    _host_us_per_call(lambda i, m=m: m.update(*batches[i % PPL_UPDATES]), iters=PPL_UPDATES, repeats=1))
        out[name] = {
            "updates": PPL_UPDATES, "shape": [PPL_BATCH, PPL_CONTEXT, PPL_VOCAB], "value": value,
            "launches_eager": eager_launches, "launches_engine": engine_launches, "engine": st.as_dict(),
            "host_syncs_per_update": syncs, "against_cpu": {"rows": 2, "card": card, "cpu": host, "rel": rel},
            "device_ms_per_update": update_ms, "bytes": nbytes, "bound_ms": nbytes / hbm_rate * 1e3,
            "device_busy_us": prof["device_busy_us"], "device_ops": prof["device_ops"], "kernels_us": prof["kernels_us"],
            "update_us": {k: sum(v) / len(v) for k, v in times.items()},
        }
        _log(f"  perplexity {name}: {PPL_UPDATES} x {PPL_BATCH} x {PPL_CONTEXT} x {PPL_VOCAB}; {value:.6g}; update"
             f" {update_ms:.3f} ms against {out[name]['bound_ms']:.3f} ms (bytes); engine replays {st.replays}, syncs {syncs}")
        del batches, runs, eager, engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---- InfoLM over injected distributions


class _BagOfWordsLM:
    """An injected masked-LM stand-in: a sentence's distribution over ``INFOLM_VOCAB``
    tokens is the softmax of its words' mean row of a seeded (buckets, vocab) table (each
    word hashed to a bucket); counted on the host, one copy, a product on ``device``."""

    def __init__(self, device) -> None:
        gen = torch.Generator().manual_seed(3)
        self.table = (torch.randn(INFOLM_BUCKETS, INFOLM_VOCAB, generator=gen) * 2).to(device)
        self.device = torch.device(device)

    def __call__(self, sentences: list) -> torch.Tensor:
        import zlib

        import numpy as np

        counts = np.zeros((len(sentences), INFOLM_BUCKETS), np.float32)
        for i, s in enumerate(sentences):
            for w in s.split():
                counts[i, zlib.crc32(w.encode()) % INFOLM_BUCKETS] += 1
        counts /= np.maximum(counts.sum(1, keepdims=True), 1)
        from torchmetrics_tpu_torch.models._common import full_float32

        with full_float32():
            logits = torch.from_numpy(counts).to(self.device) @ self.table
        return torch.softmax(logits, dim=-1)


def run_infolm(preds: list, targets: list) -> dict:
    """The nine information measures over injected (512, 50265) distributions, eagerly and
    with the engine (every update falls back on its lists; the engine's states equal to
    the eager ones, its value within ``TEXT_RTOL``), each engine ``compute`` timed and
    held against a CPU metric that took the same updates; the functional's first 16 pairs
    against the CPU."""
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.functional.text import infolm
    from torchmetrics_tpu_torch.text import InfoLM

    model, cpu_model = _BagOfWordsLM("cuda"), _BagOfWordsLM("cpu")
    out = {}
    b = TEXT_BATCH
    n = INFOLM_CPU_PAIRS
    for measure, alpha, beta in INFOLM_MEASURES:
        kw = {"information_measure": measure, "alpha": alpha, "beta": beta}
        runs = {}
        for mode in ("eager", "engine"):
            with engine_context(mode == "engine"):
                _zero_launches()
                m = InfoLM(model=model, **kw)
                for i in range(0, TEXT_PAIRS, b):
                    m.update(preds[i : i + b], targets[i : i + b])
                launches = _launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                value, reads = _with_syncs(m.compute)
                runs[mode] = {"metric": m, "launches": launches, "value": value.item(), "reads": reads,
                              "ms": (time.perf_counter() - t0) * 1e3}
        m = runs["engine"]["metric"]
        st = m._engine.stats
        if st.dispatches or dict(st.fallback_reasons) != {"list-state": TEXT_UPDATES}:
            raise AssertionError(f"infolm {measure}: the updates should fall back on their lists: {st.as_dict()}")
        _text_state_diff(f"infolm {measure} engine vs eager", m, runs["eager"]["metric"], 0.0)
        value, reads, ms = (runs["engine"][k] for k in ("value", "reads", "ms"))
        eager_value = runs["eager"]["value"]
        engine_rel = abs(value - eager_value) / max(abs(eager_value), 1e-30)
        if not engine_rel <= TEXT_RTOL:
            raise AssertionError(f"infolm {measure}: engine {value} vs eager {eager_value} (rel {engine_rel:.3e})")
        host_m = InfoLM(model=cpu_model, **kw, device="cpu")
        for i in range(0, TEXT_PAIRS, b):
            host_m.update(preds[i : i + b], targets[i : i + b])
        host_value = host_m.compute().item()
        modular_rel = abs(value - host_value) / max(abs(host_value), 1e-30)
        card = infolm(preds[:n], targets[:n], model=model, **kw).item()
        host = infolm(preds[:n], targets[:n], model=cpu_model, **kw, device="cpu").item()
        rel = max(modular_rel, abs(card - host) / max(abs(host), 1e-30))
        if not (math.isfinite(value) and rel <= INFOLM_CPU_RTOL):
            raise AssertionError(f"infolm {measure}: {value} vs CPU {host_value}; {n} pairs card {card} vs CPU {host}"
                                 f" (rel {rel:.3e})")
        out[measure] = {"value": value, "compute_ms": ms, "eager_compute_ms": runs["eager"]["ms"],
                        "host_syncs_per_compute": reads, "against_cpu_rel": rel, "engine_against_eager_rel": engine_rel,
                        "launches": runs["engine"]["launches"], "launches_eager": runs["eager"]["launches"]}
        del runs, m
    _log(f"  infolm: nine measures over ({TEXT_PAIRS}, {INFOLM_VOCAB}); compute"
         f" {min(v['compute_ms'] for v in out.values()):.1f}-{max(v['compute_ms'] for v in out.values()):.1f} ms")
    return out


# ---- the HF route


def _hf_checkpoint(vocab_words: list, directory: str) -> str:
    """A seeded ``BertForMaskedLM`` at bert-base width and a ``BertTokenizer`` over a
    vocabulary file written here, saved with ``save_pretrained`` into ``directory``."""
    import transformers

    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words = specials + vocab_words
    words += [f"[unused{i}]" for i in range(HF_BERT["vocab"] - len(words))]
    path = os.path.join(directory, "vocab.txt")
    with open(path, "w") as f:
        f.write("\n".join(words))
    transformers.BertTokenizer(path).save_pretrained(directory)
    config = transformers.BertConfig(
        vocab_size=HF_BERT["vocab"], hidden_size=HF_BERT["hidden"], num_hidden_layers=HF_BERT["layers"],
        num_attention_heads=HF_BERT["heads"], intermediate_size=HF_BERT["ffn"],
        max_position_embeddings=HF_BERT["positions"],
    )
    torch.manual_seed(0)
    transformers.BertForMaskedLM(config).save_pretrained(directory)
    return directory


def run_hf_route(preds: list, targets: list, vocab: list) -> dict:
    """``BERTScore(model_name_or_path=dir)`` over the 512 pairs and ``InfoLM(model_name_or_path=dir)``
    over 16 (one forward per position), on a checkpoint the script writes; the compute at
    ``BERT_CPU_ROWS`` against a CPU metric that took the same updates, and the
    functionals' first pairs against the CPU. The model the loader caches stays on the
    CPU: the card runs its copy."""
    import transformers

    from torchmetrics_tpu_torch.functional.text import bert_score, infolm
    from torchmetrics_tpu_torch.text import BERTScore, InfoLM
    from torchmetrics_tpu_torch.utilities import hf

    out = {"transformers": transformers.__version__, "model": dict(HF_BERT)}
    with tempfile.TemporaryDirectory() as d:
        _hf_checkpoint(vocab, d)
        b = TEXT_BATCH
        m = BERTScore(model_name_or_path=d, idf=True)
        for i in range(0, TEXT_PAIRS, b):
            m.update(preds[i : i + b], targets[i : i + b])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value, bert_reads = _with_syncs(m.compute)
        bert_ms = (time.perf_counter() - t0) * 1e3
        f1 = value["f1"]
        if f1.shape != (TEXT_PAIRS,) or not torch.isfinite(f1).all():
            raise AssertionError(f"hf bert_score: f1 {f1.shape} {f1[:4].tolist()}")
        # the card against the CPU: the same loader, tokenizer and cached CPU model
        cpu_model, _ = hf.load_hf_model_and_tokenizer(d)
        host_rows = _CpuRows(hf.hf_embedding_forward(cpu_model))
        host_m = BERTScore(model_name_or_path=d, user_forward_fn=host_rows.forward(BERT_CPU_ROWS), idf=True, device="cpu")
        for i in range(0, TEXT_PAIRS, b):
            host_m.update(preds[i : i + b], targets[i : i + b])
        against = {"modular_idf_True": _score_diff(value, host_m.compute(), BERT_CPU_ROWS)}
        del host_m
        n = HF_CPU_PAIRS
        card = bert_score(preds[:n], targets[:n], model_name_or_path=d, idf=True)
        host = bert_score(preds[:n], targets[:n], model_name_or_path=d, idf=True, device="cpu")
        against["functional"] = _score_diff(card, host, range(n))
        bert_diff = max(against.values())
        if not bert_diff <= BERT_CPU_ATOL:
            raise AssertionError(f"hf bert_score: card against CPU {against} > {BERT_CPU_ATOL}")
        placed = {"cached": next(cpu_model.parameters()).device.type,
                  "card_copy": next(hf.model_on(cpu_model, "cuda").parameters()).device.type}
        if placed != {"cached": "cpu", "card_copy": "cuda"}:
            raise AssertionError(f"hf: the shared model was moved: {placed}")

        k = HF_INFOLM_PAIRS
        il = InfoLM(model_name_or_path=d, idf=False)
        il.update(preds[:k], targets[:k])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info_value, info_reads = _with_syncs(il.compute)
        info_ms = (time.perf_counter() - t0) * 1e3
        info_value = info_value.item()
        info_card = infolm(preds[:n], targets[:n], model_name_or_path=d, idf=False).item()
        info_host = infolm(preds[:n], targets[:n], model_name_or_path=d, idf=False, device="cpu").item()
        info_rel = abs(info_card - info_host) / max(abs(info_host), 1e-30)
        if not (math.isfinite(info_value) and info_rel <= HF_INFOLM_CPU_RTOL):
            raise AssertionError(f"hf infolm: {info_value}; card {info_card} vs CPU {info_host} (rel {info_rel:.3e})")
        hf.load_hf_model_and_tokenizer.cache_clear()
    out.update({
        "bert_score": {"pairs": TEXT_PAIRS, "compute_ms": bert_ms, "host_syncs_per_compute": bert_reads,
                       "f1_mean": f1.mean().item(), "model_devices": placed,
                       "against_cpu": {"modular_pairs": list(BERT_CPU_ROWS), "functional_pairs": n,
                                       "max_abs_diff": against}},
        "infolm": {"pairs": k, "compute_ms": info_ms, "host_syncs_per_compute": info_reads, "value": info_value,
                   "against_cpu": {"pairs": n, "card": info_card, "cpu": info_host, "rel": info_rel}},
    })
    _log(f"  hf route (transformers {transformers.__version__}): BERTScore {TEXT_PAIRS} pairs {bert_ms:.0f} ms (CPU"
         f" {bert_diff:.2e}); InfoLM {k} pairs {info_ms:.0f} ms (CPU rel {info_rel:.2e})")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_text(gen: torch.Generator, hbm_rate: float, smi: str) -> dict:
    """Phase 20: the host metrics, BERTScore at roberta-large's width, perplexity at GPT-2's
    shapes, InfoLM, and the HF route."""
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must run at 'highest' precision (no TF32) for the card to agree with the CPU")
    preds, targets, vocab = _wmt_pairs(TEXT_PAIRS, seed=14)
    squad = _squad_pairs(TEXT_PAIRS, vocab, seed=15)
    words = [len(p.split()) for p in preds]
    out = {
        "card": smi,
        "corpus": {"pairs": TEXT_PAIRS, "updates": TEXT_UPDATES, "mean_words": sum(words) / len(words),
                   "min_words": min(words), "max_words": max(words), "multi_sentence": sum("." in p for p in preds)},
    }
    out["host"] = run_text_host_paths(_text_batches(preds, targets, squad))
    out["bert_score"] = run_bert_score(preds, targets, hbm_rate)
    out["perplexity"] = run_perplexity(hbm_rate)
    out["infolm"] = run_infolm(preds, targets)
    out["hf"] = run_hf_route(preds, targets, vocab)
    out["tolerances"] = {"host_rtol": TEXT_RTOL, "perplexity_cpu_rtol": PPL_CPU_RTOL, "bert_cpu_atol": BERT_CPU_ATOL,
                         "infolm_cpu_rtol": INFOLM_CPU_RTOL, "hf_infolm_cpu_rtol": HF_INFOLM_CPU_RTOL}
    return out


# ---------------------------------------------------------------- phase 21: the detection domain

COCO_IMAGES, COCO_CLASSES, COCO_DETS = 5000, 80, 100  # BASELINE #5: COCO val2017, 80 classes, top-100 post-NMS
COCO_W, COCO_H = 640, 480
COCO_GT_MEAN, COCO_GT_CAP = 7.3, 63  # ground truths per image: COCO val's mean, and the cap
COCO_AREA_SHARES = (0.41, 0.34, 0.25)  # small / medium / large ground truths, as in COCO val
COCO_UPDATE = 16  # images per update
COCO_NUMPY_IMAGES = 500  # the C++ evaluator against the numpy matcher route
COCO_PACKED_CPU_IMAGES = 1024  # the packed route's CPU run: its first 64 updates
MAP_ROUTE_TOL = 1e-12  # the C++ evaluator and the numpy route add the same float64 terms
MAP_BINS_TOL = 1e-3  # the packed route's 1024 score bins against the host route
SEGM_IMAGES, SEGM_DETS = 64, 20  # dense 480 x 640 masks at 100 per image over 5000 images would need ~150 GB
IOU_IMAGES = 512
IOU_ATOL = 1e-6
PANOPTIC_MAPS, PANOPTIC_UPDATE = 8, 2
PANOPTIC_THINGS, PANOPTIC_STUFFS = frozenset(range(80)), frozenset(range(80, 133))  # COCO panoptic: 80 + 53
DET_PATHS = ("coco_list", "coco_packed", "segm", "iou_family", "panoptic", "sync2")
DET_SYNC_TIMEOUT_S = 300


def _coco_val(seed: int, n: int = COCO_IMAGES) -> dict:
    """``n`` images shaped like COCO val2017 (numpy, from ``seed``): 640 x 480 frames;
    ground truths per image drawn to a mean of ~7.3 (a negative binomial, capped at 63)
    with 41 / 34 / 25 % small / medium / large areas and Zipf-like class frequencies;
    exactly 100 detections per image, sorted by score as a post-NMS detector emits them:
    each ground truth found with probability 0.9 at a spread of IoU (90 % with its own
    label), a lower-scored duplicate for 30 % of them, false positives filling the rest.
    Boxes are xyxy float32; ground truths pad to 63 slots."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = COCO_GT_CAP
    p = 2.0 / (2.0 + COCO_GT_MEAN)
    n_gt = np.minimum(rng.negative_binomial(2, p, n), g)
    weights = 1.0 / np.arange(1, COCO_CLASSES + 1) ** 0.9
    weights /= weights.sum()

    def boxes(shape, size_class):
        lo = np.array([4.0**2, 32.0**2, 96.0**2])[size_class]
        hi = np.array([32.0**2, 96.0**2, 400.0**2])[size_class]
        area = np.exp(rng.uniform(np.log(lo), np.log(hi)))
        ar = np.exp(rng.uniform(np.log(0.5), np.log(2.0), shape))
        w = np.minimum(np.sqrt(area * ar), COCO_W - 1)
        h = np.minimum(np.sqrt(area / ar), COCO_H - 1)
        x = rng.uniform(0, COCO_W - w)
        y = rng.uniform(0, COCO_H - h)
        return np.stack([x, y, x + w, y + h], -1)

    def jitter(b, lo, hi):
        wh = np.concatenate([b[..., 2:] - b[..., :2]] * 2, -1)
        out = b + rng.normal(size=b.shape) * wh * rng.uniform(lo, hi, b.shape[:-1] + (1,))
        out[..., 0::2] = np.clip(out[..., 0::2], 0, COCO_W)
        out[..., 1::2] = np.clip(out[..., 1::2], 0, COCO_H)
        return out

    size_class = rng.choice(3, (n, g), p=np.asarray(COCO_AREA_SHARES) / sum(COCO_AREA_SHARES))
    gt = boxes((n, g), size_class)
    gt_labels = rng.choice(COCO_CLASSES, (n, g), p=weights)
    valid_gt = np.arange(g)[None, :] < n_gt[:, None]
    wrong = lambda shape: rng.choice(COCO_CLASSES, shape, p=weights)  # noqa: E731
    hit_labels = np.where(rng.random((n, g)) < 0.9, gt_labels, wrong((n, g)))
    dup_labels = np.where(rng.random((n, g)) < 0.9, gt_labels, wrong((n, g)))
    cand_boxes = np.concatenate(
        [jitter(gt, 0.01, 0.2), jitter(gt, 0.15, 0.45), boxes((n, COCO_DETS), rng.choice(3, (n, COCO_DETS)))], 1
    )
    cand_scores = np.concatenate(
        [rng.beta(5, 2, (n, g)), rng.beta(2, 3, (n, g)), rng.beta(1, 5, (n, COCO_DETS))], 1
    )
    cand_labels = np.concatenate([hit_labels, dup_labels, wrong((n, COCO_DETS))], 1)
    cand_ok = np.concatenate(
        [valid_gt & (rng.random((n, g)) < 0.9), valid_gt & (rng.random((n, g)) < 0.3), np.ones((n, COCO_DETS), bool)], 1
    )
    keep = np.argsort(~cand_ok, axis=1, kind="stable")[:, :COCO_DETS]  # found, duplicates, then false positives
    take = lambda a: np.take_along_axis(a, keep if a.ndim == 2 else keep[..., None], axis=1)  # noqa: E731
    det, score, label = take(cand_boxes), take(cand_scores), take(cand_labels)
    order = np.argsort(-score, axis=1, kind="stable")
    det = np.take_along_axis(det, order[..., None], axis=1)
    score, label = np.take_along_axis(score, order, axis=1), np.take_along_axis(label, order, axis=1)
    return {
        "det_boxes": det.astype(np.float32), "det_scores": score.astype(np.float32), "det_labels": label.astype(np.int64),
        "gt_boxes": np.where(valid_gt[..., None], gt, 0).astype(np.float32),
        "gt_labels": np.where(valid_gt, gt_labels, -1).astype(np.int64), "gt_counts": n_gt.astype(np.int64),
        "size_class": size_class[valid_gt],
    }


def _coco_images(data: dict, lo: int, hi: int, device) -> tuple:
    """Images ``lo:hi`` as the per-image dicts of the list route: views of tensors made
    once on ``device`` (a detector's outputs, already there)."""
    t = {k: torch.from_numpy(v).to(device) for k, v in data.items() if k != "size_class"}
    preds = [{"boxes": t["det_boxes"][i], "scores": t["det_scores"][i], "labels": t["det_labels"][i]} for i in range(lo, hi)]
    counts = data["gt_counts"]
    target = [{"boxes": t["gt_boxes"][i, : counts[i]], "labels": t["gt_labels"][i, : counts[i]]} for i in range(lo, hi)]
    return preds, target


def _coco_packed_dicts(data: dict, lo: int, hi: int, device) -> list:
    """Images ``lo:hi`` as packed-dict batches of ``COCO_UPDATE`` on ``device``, at the
    detector's widths (100 detection and 63 ground-truth slots)."""
    out = []
    for s in range(lo, hi, COCO_UPDATE):
        e = min(s + COCO_UPDATE, hi)
        t = lambda k: torch.from_numpy(data[k][s:e]).to(device)  # noqa: E731
        out.append((
            {"boxes": t("det_boxes"), "scores": t("det_scores"), "labels": t("det_labels"),
             "num_boxes": torch.full((e - s,), COCO_DETS, dtype=torch.int64, device=device)},
            {"boxes": t("gt_boxes"), "labels": t("gt_labels"), "num_boxes": t("gt_counts")},
        ))
    return out


def _det_values(out: dict) -> dict:
    return {k: v.detach().cpu() for k, v in out.items()}


def _det_equal(name: str, got: dict, want: dict) -> float:
    """Every value of two compute dicts equal, dtypes included; returns 0.0."""
    if set(got) != set(want):
        raise AssertionError(f"{name}: keys {sorted(set(got) ^ set(want))} differ")
    for k in want:
        _equal(f"{name} {k}", got[k].detach().cpu(), want[k].detach().cpu())
    return 0.0


def _det_max_diff(got: dict, want: dict) -> float:
    return max((got[k].detach().cpu().double() - want[k].detach().cpu().double()).abs().max().item() for k in want)


def _device_reads(fn):
    """``fn()``'s value, the ``.cpu()`` copies of card tensors in it, and the host syncs
    ``set_sync_debug_mode("warn")`` reports."""
    reads = []
    real = torch.Tensor.cpu

    def counted(self, *args, **kwargs):
        if self.is_cuda:
            reads.append(tuple(self.shape))
        return real(self, *args, **kwargs)

    torch.Tensor.cpu = counted
    try:
        value, syncs = _with_syncs(fn)
    finally:
        torch.Tensor.cpu = real
    return value, len(reads), syncs


def _timed_native(fn):
    """``fn()``'s value and the seconds spent inside ``native.coco_eval_bbox``."""
    from torchmetrics_tpu_torch import native

    spent = [0.0]
    real = native.coco_eval_bbox

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            spent[0] += time.perf_counter() - t0

    native.coco_eval_bbox = timed
    try:
        return fn(), spent[0]
    finally:
        native.coco_eval_bbox = real


def _coco_route_agreement(data: dict) -> dict:
    """The first ``COCO_NUMPY_IMAGES`` images through the port's two host evaluators: the
    C++ epoch call and the numpy route (``_calculate``: numpy IoU and PR curves around the
    per-(image, class) C++ matcher); the largest difference of their float64 precision
    and recall tensors."""
    import numpy as np

    from torchmetrics_tpu_torch import native
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision

    m = MeanAveragePrecision(class_metrics=True, device="cpu")
    m.update(*_coco_images(data, 0, COCO_NUMPY_IMAGES, "cpu"))
    captured = {}
    real = native.coco_eval_bbox
    native.coco_eval_bbox = lambda *a, **k: captured.setdefault("pr", real(*a, **k))
    try:
        t0 = time.perf_counter()
        m._compute_native_bbox()
        native_s = time.perf_counter() - t0
    finally:
        native.coco_eval_bbox = real
    t0 = time.perf_counter()
    dets, scores, dl, gts, gl = m._host_lists()
    classes = m._get_classes(dl, gl)
    precision, recall = m._calculate(classes, dets, scores, dl, gts, gl)
    numpy_s = time.perf_counter() - t0
    diff = max(float(np.abs(captured["pr"][0] - precision).max()), float(np.abs(captured["pr"][1] - recall).max()))
    if diff > MAP_ROUTE_TOL:
        raise AssertionError(f"coco_list: the C++ evaluator and the numpy route differ by {diff} over {COCO_NUMPY_IMAGES} images")
    return {"images": COCO_NUMPY_IMAGES, "max_abs_diff": diff, "native_s": native_s, "numpy_route_s": numpy_s}


def run_coco_list(data: dict) -> dict:
    """``MeanAveragePrecision()`` at the defaults with class metrics over every image, in
    updates of 16, on the card and on the CPU."""
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision, mean_ap

    preds, target = _coco_images(data, 0, COCO_IMAGES, "cuda")
    m = MeanAveragePrecision(class_metrics=True)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, COCO_IMAGES, COCO_UPDATE):
        m.update(preds[s : s + COCO_UPDATE], target[s : s + COCO_UPDATE])
    torch.cuda.synchronize()
    updates = -(-COCO_IMAGES // COCO_UPDATE)
    update_us = (time.perf_counter() - t0) * 1e6 / updates
    evals = mean_ap._STATS.map_host_evals
    t0 = time.perf_counter()
    (value, native_s), reads, syncs = _device_reads(lambda: _timed_native(m.compute))
    compute_ms = (time.perf_counter() - t0) * 1e3
    launches = _launches()
    if reads > 9 or mean_ap._STATS.map_host_evals != evals + 1:
        raise AssertionError(f"coco_list: {reads} device reads per compute (at most 9), host evals {mean_ap._STATS.map_host_evals - evals}")
    if value["map"].device.type != m.device.type or not 0.05 < float(value["map"]) < 0.95:
        raise AssertionError(f"coco_list: map {float(value['map'])} on {value['map'].device}")

    cpu = MeanAveragePrecision(class_metrics=True, device="cpu")
    cpu_preds, cpu_target = _coco_images(data, 0, COCO_IMAGES, "cpu")
    for s in range(0, COCO_IMAGES, COCO_UPDATE):
        cpu.update(cpu_preds[s : s + COCO_UPDATE], cpu_target[s : s + COCO_UPDATE])
    _det_equal("coco_list card against the CPU", value, cpu.compute())
    agreement = _coco_route_agreement(data)
    out = {
        "images": COCO_IMAGES, "updates": updates, "update_us": update_us, "compute_ms": compute_ms,
        "native_ms": native_s * 1e3, "native_share": native_s * 1e3 / compute_ms,
        "device_reads_per_compute": reads, "host_syncs_per_compute": syncs,
        "values": {k: float(v) for k, v in value.items() if v.ndim == 0},
        "cpu_max_abs_diff": 0.0, "numpy_route": agreement, "launches": launches,
        "gt_per_image": float(data["gt_counts"].mean()),
        "gt_area_shares": [float((data["size_class"] == c).mean()) for c in range(3)],
    }
    _log(f"  coco_list: {update_us:.1f} µs per update of 16, compute {compute_ms:.1f} ms (C++ {native_s * 1e3:.1f} ms),"
         f" {reads} device reads, map {out['values']['map']:.4f}, equal to the CPU run; C++ against numpy route"
         f" {agreement['max_abs_diff']:.2e} over {COCO_NUMPY_IMAGES} images")
    return out, _det_values(value)


def _hist_states(m) -> tuple:
    return tuple(getattr(m, a).detach().clone() for a in ("map_tp_hist", "map_fp_hist", "map_n_pos"))


def run_coco_packed(data: dict, list_values: dict) -> tuple:
    """``PackedMeanAveragePrecision(80)`` over the same images in widened ``(16, 128, 6)``
    / ``(16, 64, 5)`` batches, eagerly and with the engine: histograms equal both ways and
    to the CPU run over the first 1024 images, ``map`` against ``coco_list``'s."""
    from torchmetrics_tpu_torch.detection import PackedMeanAveragePrecision
    from torchmetrics_tpu_torch.detection.ingraph import pack_detections

    batches = [pack_detections(p, t) for p, t in _coco_packed_dicts(data, 0, COCO_IMAGES, "cuda")]
    if tuple(batches[0][0].shape) != (COCO_UPDATE, 128, 6) or tuple(batches[0][2].shape) != (COCO_UPDATE, 64, 5):
        raise AssertionError(f"coco_packed: widened to {tuple(batches[0][0].shape)} / {tuple(batches[0][2].shape)}")
    n_cpu = COCO_PACKED_CPU_IMAGES // COCO_UPDATE
    runs, prefix, values, launches = {}, {}, {}, {}
    for mode in ("eager", "engine"):
        m = PackedMeanAveragePrecision(COCO_CLASSES, class_metrics=True, compiled_update=mode == "engine")
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            m.update(*b)
            if i + 1 == n_cpu:
                prefix[mode] = _hist_states(m)
        torch.cuda.synchronize()
        runs[mode] = (m, (time.perf_counter() - t0) * 1e6 / len(batches))
        values[mode] = m.compute()
        launches[mode] = _launches()
    eager, engine = runs["eager"][0], runs["engine"][0]
    st = engine._engine.stats
    _check_replays("coco_packed", engine._engine)
    if st.eager_fallbacks or st.dispatches != len(batches):
        raise AssertionError(f"coco_packed: engine {st.dispatches} dispatches, {st.eager_fallbacks} fallbacks {dict(st.fallback_reasons)}")
    for a, b, name in zip(_hist_states(eager), _hist_states(engine), ("tp", "fp", "n_pos")):
        _equal(f"coco_packed {name} engine against eager", b, a)
    cpu = PackedMeanAveragePrecision(COCO_CLASSES, class_metrics=True, device="cpu")
    for b in batches[:n_cpu]:
        cpu.update(*(x.cpu() for x in b))
    for a, b, name in zip(_hist_states(cpu), prefix["engine"], ("tp", "fp", "n_pos")):
        _equal(f"coco_packed {name} card against the CPU ({COCO_PACKED_CPU_IMAGES} images)", b.cpu(), a)
    value = values["engine"]
    _det_equal("coco_packed engine compute against eager", value, values["eager"])
    ep = engine._epoch.stats
    if ep.compute_dispatches != 1 or ep.eager_fallbacks:
        raise AssertionError(f"coco_packed: compute {ep.as_dict()}")
    headline = ("map", "map_50", "map_75", "map_small", "map_medium", "map_large", "mar_1", "mar_10", "mar_100")
    bins_diff = {k: abs(float(value[k]) - float(list_values[k])) for k in headline}
    if bins_diff["map"] > MAP_BINS_TOL:
        raise AssertionError(f"coco_packed: map {float(value['map'])} against the list route's {float(list_values['map'])}")

    out = {"batches": len(batches), "widths": [128, 64], "cpu_images": COCO_PACKED_CPU_IMAGES,
           "engine_run": {"replays": st.replays, "captures": st.captures, "dispatches": st.dispatches,
                          "bucket_sizes": sorted(st.bucket_sizes), "compute_dispatches": ep.compute_dispatches},
           "values": {k: float(v) for k, v in value.items() if v.ndim == 0}, "abs_diff_to_list": bins_diff,
           "run_us_per_update": {mode: runs[mode][1] for mode in runs},
           "launches_eager": launches["eager"], "launches_engine": launches["engine"]}
    for mode in ("eager", "engine"):  # the runs' own metrics, warm, go on taking updates
        t = runs[mode][0]
        step = lambda i, t=t: t.update(*batches[i % len(batches)])  # noqa: E731
        wall = _host_us_per_call(step, iters=16)
        prof = _device_profile(step, iters=4)
        busy = prof["device_busy_us"]
        out[mode] = {
            "update_us": wall, "device_busy_us": busy, "device_ops": prof["device_ops"],
            "device_idle_share": None if busy is None else max(0.0, 1 - busy / wall),
            "kernels_us": prof["kernels_us"], "host_syncs_per_update": _syncs_per_call(lambda t=t: t.update(*batches[1])),
        }
        if out[mode]["host_syncs_per_update"]:
            raise AssertionError(f"coco_packed {mode}: {out[mode]['host_syncs_per_update']} host syncs per update")
    t0 = time.perf_counter()
    engine._computed = None
    engine.compute()
    torch.cuda.synchronize()
    out["compute_ms"] = (time.perf_counter() - t0) * 1e3
    _log(f"  coco_packed: eager {out['eager']['update_us']:.1f} µs ({out['eager']['device_ops']} device ops) /"
         f" engine {out['engine']['update_us']:.1f} µs per update, {st.replays} replays, {st.captures} captures;"
         f" histograms equal eager / engine / CPU; map {out['values']['map']:.6f} against the list route's"
         f" {float(list_values['map']):.6f} ({bins_diff['map']:.2e})")
    return out, _det_values(value)


def _ellipse_masks(boxes: torch.Tensor) -> torch.Tensor:
    """(n, 480, 640) bool masks: the ellipse inscribed in each xyxy box."""
    yy = torch.arange(COCO_H, device=boxes.device, dtype=torch.float32)[None, :, None] + 0.5
    xx = torch.arange(COCO_W, device=boxes.device, dtype=torch.float32)[None, None, :] + 0.5
    c = (boxes[:, :2] + boxes[:, 2:]) / 2
    r = ((boxes[:, 2:] - boxes[:, :2]) / 2).clamp(min=0.5)
    return ((xx - c[:, None, None, 0]) / r[:, None, None, 0]) ** 2 + ((yy - c[:, None, None, 1]) / r[:, None, None, 1]) ** 2 <= 1


def run_segm(data: dict) -> dict:
    """``iou_type="segm"`` on dense 480 x 640 masks (the first 64 images, their 20 best
    detections) and on RLE dicts of the same masks: equal to each other and to the CPU run."""
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision
    from torchmetrics_tpu_torch.native import rle_encode

    preds, target = _coco_images(data, 0, SEGM_IMAGES, "cuda")
    dense_p = [{"masks": _ellipse_masks(p["boxes"][:SEGM_DETS]), "scores": p["scores"][:SEGM_DETS],
                "labels": p["labels"][:SEGM_DETS]} for p in preds]
    dense_t = [{"masks": _ellipse_masks(t["boxes"]), "labels": t["labels"]} for t in target]
    host = [d["masks"].cpu().numpy() for d in (*dense_p, *dense_t)]
    t0 = time.perf_counter()
    rles = [[rle_encode(m) for m in masks] for masks in host]
    encode_s = time.perf_counter() - t0
    rle_p = [{**d, "masks": r} for d, r in zip(dense_p, rles[:SEGM_IMAGES])]
    rle_t = [{**d, "masks": r} for d, r in zip(dense_t, rles[SEGM_IMAGES:])]
    cpu_p = [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in d.items()} for d in dense_p]
    cpu_t = [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in d.items()} for d in dense_t]
    out, values = {"images": SEGM_IMAGES, "detections_per_image": SEGM_DETS, "rle_encode_s": encode_s,
                   "mask_bytes": sum(m.nbytes for m in host)}, {}
    for name, (p, t, device) in {"dense": (dense_p, dense_t, None), "rle": (rle_p, rle_t, None),
                                 "cpu": (cpu_p, cpu_t, "cpu")}.items():
        m = MeanAveragePrecision(iou_type="segm", class_metrics=True, device=device)
        _zero_launches()
        for s in range(0, SEGM_IMAGES, COCO_UPDATE):
            m.update(p[s : s + COCO_UPDATE], t[s : s + COCO_UPDATE])
        t0 = time.perf_counter()
        (values[name], reads, _) = _device_reads(m.compute)
        out[name] = {"compute_ms": (time.perf_counter() - t0) * 1e3, "device_reads": reads, "launches": _launches()}
    out["launches"] = {k: out["dense"]["launches"][k] + out["rle"]["launches"][k] for k in out["dense"]["launches"]}
    _det_equal("segm dense against RLE", values["dense"], values["rle"])
    _det_equal("segm card against the CPU", values["dense"], values["cpu"])
    out["map"] = float(values["dense"]["map"])
    if not 0.05 < out["map"] < 0.95:
        raise AssertionError(f"segm: map {out['map']}")
    _log(f"  segm: {SEGM_IMAGES} images x {SEGM_DETS} masks of 480 x 640, dense {out['dense']['compute_ms']:.0f} ms"
         f" ({out['dense']['device_reads']} reads) / RLE {out['rle']['compute_ms']:.0f} ms compute, equal to each other"
         f" and to the CPU run (map {out['map']:.4f})")
    return out


def run_iou_family(data: dict) -> dict:
    """IoU, GIoU, DIoU and CIoU over 512 images in updates of 16, on the card and the CPU."""
    from torchmetrics_tpu_torch import detection

    preds, target = _coco_images(data, 0, IOU_IMAGES, "cuda")
    cpu_preds, cpu_target = _coco_images(data, 0, IOU_IMAGES, "cpu")
    out = {"images": IOU_IMAGES}
    for name in ("IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
                 "CompleteIntersectionOverUnion"):
        card, cpu = getattr(detection, name)(), getattr(detection, name)(device="cpu")
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(0, IOU_IMAGES, COCO_UPDATE):
            card.update(preds[s : s + COCO_UPDATE], target[s : s + COCO_UPDATE])
        torch.cuda.synchronize()
        update_us = (time.perf_counter() - t0) * 1e6 / (IOU_IMAGES // COCO_UPDATE)
        value, reads, _ = _device_reads(card.compute)
        launches = _launches()
        for s in range(0, IOU_IMAGES, COCO_UPDATE):
            cpu.update(cpu_preds[s : s + COCO_UPDATE], cpu_target[s : s + COCO_UPDATE])
        want = cpu.compute()
        diff = _det_max_diff(value, want)
        if reads != 3 or diff > IOU_ATOL or set(value) != set(want):
            raise AssertionError(f"iou_family {name}: {reads} reads per compute, {diff} from the CPU run")
        out[name] = {"update_us": update_us, "device_reads_per_compute": reads, "cpu_max_abs_diff": diff,
                     "value": float(next(iter(value.values()))), "launches": launches}
    short = {"IntersectionOverUnion": "IoU", "GeneralizedIntersectionOverUnion": "GIoU",
             "DistanceIntersectionOverUnion": "DIoU", "CompleteIntersectionOverUnion": "CIoU"}
    _log("  iou_family: " + ", ".join(f"{short[k]} {v['value']:.4f}"
                                       f" ({v['update_us']:.0f} µs per update, {v['cpu_max_abs_diff']:.1e})"
                                       for k, v in out.items() if isinstance(v, dict)))
    metrics = [v for v in out.values() if isinstance(v, dict)]
    out["launches"] = {k: sum(v["launches"][k] for v in metrics) for k in metrics[0]["launches"]}
    return out


def _panoptic_maps(seed: int) -> tuple:
    """``PANOPTIC_MAPS`` COCO-panoptic-shaped (480, 640, 2) maps of (category, instance):
    stuff bands (53 stuff categories), 6-15 thing instances (80 categories) as ellipses, an
    unlabeled (void) patch; the prediction shifts the instances by a few pixels, relabels
    10 %, drops 10 % and adds a false one."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:COCO_H, :COCO_W]
    target = np.zeros((PANOPTIC_MAPS, COCO_H, COCO_W, 2), np.int64)
    preds = np.zeros_like(target)
    for i in range(PANOPTIC_MAPS):
        cuts = np.sort(rng.integers(0, COCO_H, rng.integers(2, 5)))
        band = np.searchsorted(cuts, yy[:, 0], side="right")
        stuff = rng.integers(80, 133, len(cuts) + 1)
        target[i, ..., 0] = stuff[band][:, None]
        preds[i] = target[i]
        k = int(rng.integers(6, 16))
        for inst in range(1, k + 2):
            cx, cy = rng.uniform(0, COCO_W), rng.uniform(0, COCO_H)
            rx, ry = rng.uniform(8, 120), rng.uniform(8, 100)
            cat = int(rng.integers(0, 80))
            dx, dy = rng.normal(0, 3, 2)
            shape_t = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
            shape_p = ((xx - cx - dx) / rx) ** 2 + ((yy - cy - dy) / ry) ** 2 <= 1
            if inst <= k:
                target[i][shape_t] = (cat, inst)
            if inst <= k and rng.random() < 0.1:
                continue  # a missed instance
            p_cat = int(rng.integers(0, 80)) if rng.random() < 0.1 else cat
            preds[i][shape_p] = (p_cat, inst)
        y0, x0 = int(rng.integers(0, COCO_H - 40)), int(rng.integers(0, COCO_W - 40))
        target[i, y0 : y0 + 40, x0 : x0 + 40] = (255, 0)  # unlabeled pixels
    return preds, target


def run_panoptic() -> dict:
    """``PanopticQuality`` and ``ModifiedPanopticQuality`` on 8 maps in updates of 2, on the
    card and on the CPU."""
    from torchmetrics_tpu_torch.detection import ModifiedPanopticQuality, PanopticQuality

    preds, target = _panoptic_maps(21)
    card_p, card_t = torch.from_numpy(preds).cuda(), torch.from_numpy(target).cuda()
    out = {"maps": PANOPTIC_MAPS, "shape": list(preds.shape[1:])}
    for cls in (PanopticQuality, ModifiedPanopticQuality):
        card = cls(set(PANOPTIC_THINGS), set(PANOPTIC_STUFFS))
        cpu = cls(set(PANOPTIC_THINGS), set(PANOPTIC_STUFFS), device="cpu")
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(0, PANOPTIC_MAPS, PANOPTIC_UPDATE):
            card.update(card_p[s : s + PANOPTIC_UPDATE], card_t[s : s + PANOPTIC_UPDATE])
        torch.cuda.synchronize()
        update_us = (time.perf_counter() - t0) * 1e6 / (PANOPTIC_MAPS // PANOPTIC_UPDATE)
        value = card.compute()
        launches = _launches()
        for s in range(0, PANOPTIC_MAPS, PANOPTIC_UPDATE):
            cpu.update(torch.from_numpy(preds[s : s + PANOPTIC_UPDATE]), torch.from_numpy(target[s : s + PANOPTIC_UPDATE]))
        for attr in ("iou_sum", "true_positives", "false_positives", "false_negatives"):
            _equal(f"panoptic {cls.__name__} {attr}", getattr(card, attr).cpu(), getattr(cpu, attr))
        _equal(f"panoptic {cls.__name__} value", value.cpu(), cpu.compute())
        out[cls.__name__] = {"update_us": update_us, "value": float(value), "launches": launches,
                             "true_positives": int(card.true_positives.sum()), "false_positives": int(card.false_positives.sum())}
    out["launches"] = {k: sum(out[c.__name__]["launches"][k] for c in (PanopticQuality, ModifiedPanopticQuality))
                       for k in launches}
    _log(f"  panoptic: PQ {out['PanopticQuality']['value']:.4f} ({out['PanopticQuality']['update_us'] / 1e3:.1f} ms"
         f" per update of 2), modified {out['ModifiedPanopticQuality']['value']:.4f}, equal to the CPU run")
    return out


def _det_sync_rank_body(rank: int, out_dir: str) -> dict:
    """Rank ``rank``'s half of the images through the packed-dict and packed routes, each
    computed across the two ranks; then ragged per-image lists, which must raise."""
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision, PackedMeanAveragePrecision
    from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

    data = _coco_val(15)
    half = COCO_IMAGES // 2
    batches = _coco_packed_dicts(data, rank * half, (rank + 1) * half, "cuda")
    _zero_launches()
    packed_dict = MeanAveragePrecision(class_metrics=True)
    packed = PackedMeanAveragePrecision(COCO_CLASSES, class_metrics=True)
    for p, t in batches:
        packed_dict.update(p, t)
        packed.update_batch(p, t)
    values = {"packed_dict": _det_values(packed_dict.compute()), "packed": _det_values(packed.compute())}
    torch.save(values, os.path.join(out_dir, f"rank{rank}_det.pt"))
    res = {"batches": len(batches), "packed_dict_syncs": packed_dict._epoch.stats.packed_syncs,
           "packed_syncs": packed._epoch.stats.packed_syncs}
    preds, target = _coco_images(data, 0, 3 + rank, "cuda")
    ragged = MeanAveragePrecision()
    ragged.update(preds, target)
    try:
        ragged.compute()
    except TorchMetricsUserError as err:
        res["ragged_error"] = str(err)[:120]
    else:
        raise AssertionError(f"rank {rank}: ragged per-image lists ({3 + rank} images) did not raise")
    res["launches"] = _launches()
    return res


def run_detection_sync(data: dict, packed_values: dict) -> dict:
    """Two spawned ranks on the one card, 2500 images each: the packed-dict route equal to
    one process over all 5000 (in the order the sync interleaves the batches), the packed
    route equal to ``coco_packed``'s single-process run, ragged lists raising on both."""
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision

    t0 = time.perf_counter()
    with _two_ranks(_det_sync_rank_body, DET_SYNC_TIMEOUT_S, "detection sync") as (results, out_dir):
        saved = [torch.load(os.path.join(out_dir, f"rank{r}_det.pt")) for r in range(2)]
    ranks_s = time.perf_counter() - t0
    half = COCO_IMAGES // 2
    per_rank = [_coco_packed_dicts(data, r * half, (r + 1) * half, "cuda") for r in range(2)]
    one = MeanAveragePrecision(class_metrics=True)
    for pair in zip(*per_rank):  # element-major: rank 0's batch k, then rank 1's
        for p, t in pair:
            one.update(p, t)
    want = _det_values(one.compute())
    for rank, res in enumerate(results):
        if (res["packed_dict_syncs"], res["packed_syncs"]) != (1, 1):
            raise AssertionError(f"detection sync: rank {rank} off the packed sync route: {res}")
        _det_equal(f"detection sync rank {rank} packed-dict against one process", saved[rank]["packed_dict"], want)
        _det_equal(f"detection sync rank {rank} packed against one process", saved[rank]["packed"], packed_values)
    out = {"ranks": 2, "backend": "gloo (CUDA tensors, one card)", "images_per_rank": half,
           "batches_per_rank": results[0]["batches"], "ranks_s": ranks_s,
           "ragged_error": results[0]["ragged_error"], "map": float(want["map"]),
           "launches": {k: sum(r["launches"][k] for r in results) for k in results[0]["launches"]}}
    _log(f"  sync2: 2 ranks x {half} images, packed-dict and packed routes equal to one process;"
         f" ragged per-image lists raised on both ranks ({ranks_s:.1f} s)")
    return out


def run_detection(smi: str, native_build_s: float) -> dict:
    """Phase 21: the detection domain at COCO val's width (``native_build_s``: phase 2's
    g++ build of the host C++ it runs)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    data = _coco_val(15)
    out = {"card": smi, "data_s": time.perf_counter() - t0,
           "data": {"images": COCO_IMAGES, "classes": COCO_CLASSES, "detections_per_image": COCO_DETS,
                    "gt_per_image": float(data["gt_counts"].mean()), "gt_max": int(data["gt_counts"].max())}}
    out["native_build_s"] = native_build_s
    out["coco_list"], list_values = run_coco_list(data)
    out["coco_packed"], packed_values = run_coco_packed(data, list_values)
    out["segm"] = run_segm(data)
    out["iou_family"] = run_iou_family(data)
    out["panoptic"] = run_panoptic()
    out["sync2"] = run_detection_sync(data, packed_values)
    # each path counted its own run (sync2: both ranks'); the detection domain runs no K1 / K2
    counts = {**{p: out[p]["launches"] for p in DET_PATHS if p != "coco_packed"},
              "coco_packed": out["coco_packed"]["launches_eager"], "coco_packed_engine": out["coco_packed"]["launches_engine"]}
    if any(n for c in counts.values() for n in c.values()):
        raise AssertionError(f"detection: K1 / K2 launched {counts}")
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"  phase 21: {out['phase_s']:.1f} s (and the g++ build in phase 2: {native_build_s:.1f} s)")
    return out


# ---------------------------------------------------------------- phase 22: audio and multimodal

AUDIO_PATHS = ("dns", "sdr", "pit2", "pit3", "pit4", "pit_sdr", "csisnr", "clip")
#: phase 22 under the engine on the card: the paths whose updates replay as captured
#: graphs, and the first fallback reason of each other path. The SDR solve's reason
#: holds where MAGMA is in PyTorch's build and cuSOLVER was not chosen
#: (``functional/audio/sdr.py``); elsewhere its paths replay.
AUDIO_REPLAYING = ("dns", "csisnr", "pit2", "pit3")
AUDIO_FALLBACK_REASONS = {
    "sdr": "uncapturable:linalg_solve_ex(magma)",
    "pit_sdr": "uncapturable:linalg_solve_ex(magma)",
    "pit4": "host-read:linear_sum_assignment",
    "clip": "non-tensor-input",
}
#: host syncs per eager update each path must show; SDR's are printed, not held
AUDIO_SYNCS = {"dns": 0, "csisnr": 0, "pit2": 0, "pit3": 0, "pit4": 1}
AUDIO_UPDATES = 16
DNS_SHAPE = (16, 160_000)  # 10 s at 16 kHz: the DNS Challenge test clips
DNS_DC = 0.5  # the spread of the clips' DC offsets, against unit-variance speech
WSJ_SAMPLES = 32_000  # 4 s at 8 kHz: WSJ0-2mix's "min" setting
SDR_SHAPE = (16, WSJ_SAMPLES)
SDR_FILTER = 512
PIT_BATCH, PIT_SDR_BATCH = 8, 4
PIT_SPEAKERS = {"pit2": 2, "pit3": 3, "pit4": 4, "pit_sdr": 2}
CSISNR_SHAPE = (16, 257, 251)  # the STFT of 4 s at 16 kHz, n_fft 512, hop 256
AUDIO_RTOL = 1e-5  # the card against the CPU: float32 sums in another order; SDR in float64
CLIP_UPDATES, CLIP_BATCH, CLIP_IMAGE = 4, 64, (3, 480, 640)  # COCO val2017's common image size
CLIP_WORDS = (8, 16)  # words per caption
CLIP_CPU_PAIRS = 4
CLIP_ATOL = 1e-3  # on the 0-100 scale
# openai/clip-vit-large-patch14's published widths
CLIP_VISION = {"hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16, "intermediate_size": 4096,
               "image_size": 224, "patch_size": 14}
CLIP_TEXT = {"vocab_size": 49408, "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
             "intermediate_size": 3072, "max_position_embeddings": 77}
CLIP_PROJECTION = 768
FP32_PEAK = 67e12  # the card's float32 rate outside the tensor cores (NVIDIA's data sheet, SXM, 700 W)


def _dns_members(device=None) -> dict:
    """The ``dns`` path's collection: SNR, SI-SNR and SI-SDR."""
    from torchmetrics_tpu_torch.audio import (
        ScaleInvariantSignalDistortionRatio,
        ScaleInvariantSignalNoiseRatio,
        SignalNoiseRatio,
    )

    return {"snr": SignalNoiseRatio(device=device), "si_snr": ScaleInvariantSignalNoiseRatio(device=device),
            "si_sdr": ScaleInvariantSignalDistortionRatio(device=device)}


def _audio_metric(path: str, device=None):
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.audio import (
        ComplexScaleInvariantSignalNoiseRatio,
        PermutationInvariantTraining,
        SignalDistortionRatio,
    )
    from torchmetrics_tpu_torch.functional.audio import (
        scale_invariant_signal_distortion_ratio,
        signal_distortion_ratio,
    )

    if path == "dns":
        return MetricCollection(_dns_members(device))
    if path == "sdr":
        return SignalDistortionRatio(filter_length=SDR_FILTER, device=device)
    if path == "csisnr":
        return ComplexScaleInvariantSignalNoiseRatio(device=device)
    if path == "pit_sdr":
        return PermutationInvariantTraining(signal_distortion_ratio, "permutation-wise", device=device)
    return PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, "speaker-wise", "max", device=device)


def _audio_batches(path: str, n: int = AUDIO_UPDATES) -> list:
    """``n`` seeded ``(preds, target)`` batches on the card: a target and a noised copy
    (PIT: the copy's speakers shuffled per sample)."""
    gen = torch.Generator(device="cuda").manual_seed(22_000 + AUDIO_PATHS.index(path))
    randn = lambda shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731

    def pair(shape: tuple, dc: float = 0.0) -> tuple:
        target = randn(shape) + dc * randn((*shape[:-1], 1))
        return target + 0.3 * randn(shape), target

    if path == "dns":
        # each clip with a DC offset: on zero-mean clips SI-SNR's first sums equal
        # SI-SDR's, and the collection's discovery merges the two into one group
        return [pair(DNS_SHAPE, dc=DNS_DC) for _ in range(n)]
    if path == "sdr":
        return [pair(SDR_SHAPE) for _ in range(n)]
    if path == "csisnr":
        return [tuple(torch.view_as_complex(x) for x in pair((*CSISNR_SHAPE, 2))) for _ in range(n)]
    b, spk = (PIT_SDR_BATCH if path == "pit_sdr" else PIT_BATCH), PIT_SPEAKERS[path]
    out = []
    for _ in range(n):
        target = randn((b, spk, WSJ_SAMPLES))
        order = torch.argsort(torch.rand((b, spk), generator=gen, device="cuda"), dim=1)
        out.append((target.gather(1, order[:, :, None].expand_as(target)) + 0.5 * randn(target.shape), target))
    return out


def _audio_engines(m) -> list:
    from torchmetrics_tpu_torch import MetricCollection

    if isinstance(m, MetricCollection):
        return _engines_of(m)
    return [] if m._engine is None else [("", m._engine)]


def _audio_engine_fallbacks(m) -> int:
    """Eager fallbacks over a metric's (or a collection's) update engines."""
    return sum(e.stats.eager_fallbacks for _, e in _audio_engines(m))


def _audio_engine_record(m) -> dict:
    reasons: dict = {}
    for _, e in _audio_engines(m):
        for r, k in e.stats.fallback_reasons.items():
            reasons[r] = reasons.get(r, 0) + k
    engines = [e for _, e in _audio_engines(m)]
    return {"dispatches": sum(e.stats.dispatches for e in engines), "replays": sum(e.stats.replays for e in engines),
            "captures": sum(e.stats.captures for e in engines), "fallbacks": _audio_engine_fallbacks(m),
            "fallback_reasons": reasons}


def _audio_values(value) -> dict:
    return dict(value) if isinstance(value, dict) else {"": value}


def _check_audio_engine(path: str, m, n: int, solve_capturable: bool) -> dict:
    """The engine split of one path against ``AUDIO_REPLAYING`` / ``AUDIO_FALLBACK_REASONS``."""
    rec = _audio_engine_record(m)
    replaying = path in AUDIO_REPLAYING or (path in ("sdr", "pit_sdr") and solve_capturable)
    if replaying:
        for name, e in _audio_engines(m):
            _check_replays(f"{path} {name}", e)
        # a collection's first update is its discovery step, run eagerly
        if rec["fallbacks"] or rec["replays"] != rec["dispatches"] - rec["captures"] or rec["dispatches"] < n - (path == "dns"):
            raise AssertionError(f"{path}: expected to replay, engine {rec}")
    else:
        reason = AUDIO_FALLBACK_REASONS[path]
        want = {reason: n} if path == "clip" else {reason: 1, "uncompilable-signature": n - 1}
        if rec["fallback_reasons"] != want or rec["dispatches"]:
            raise AssertionError(f"{path}: expected to fall back as {want}, engine {rec}")
    rec["replaying"] = replaying
    return rec


def run_audio_path(path: str, hbm_rate: float) -> dict:
    """One phase 22 audio path: 16 updates eagerly and with the engine, then ``compute``;
    each held against the same port run on the CPU, the engine against eager bit for
    bit, PIT's best permutations against the CPU's update by update; host µs per
    update, device busy, operations and idle share, the largest device items and host
    syncs per update, both ways."""
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.functional.audio import permutation_invariant_training
    from torchmetrics_tpu_torch.functional.audio.sdr import _solve_capturable

    batches = _audio_batches(path)
    runs, values, launches, first = {}, {}, {}, {"eager": [], "engine": []}
    for mode in ("eager", "engine"):
        with engine_context(mode == "engine"):
            m = _audio_metric(path)
            _zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, b in enumerate(batches):
                m.update(*b)
                if i < 3:  # the first updates: warm-ups, discovery, the capture
                    torch.cuda.synchronize()
                    first[mode].append((time.perf_counter() - t0) * 1e3 - sum(first[mode]))
            torch.cuda.synchronize()
            runs[mode] = (m, (time.perf_counter() - t0) * 1e6 / len(batches))
            values[mode] = _audio_values(m.compute())
            launches[mode] = _launches()
    with engine_context(False):
        cpu = _audio_metric(path, "cpu")
        for b in batches:
            cpu.update(*(x.cpu() for x in b))
        cpu_values = _audio_values(cpu.compute())
    rel = {}
    for k, want in cpu_values.items():
        _equal(f"{path} {k} engine against eager", values["engine"][k], values["eager"][k])
        got = values["eager"][k].cpu()
        rel[k] = float(((got - want).abs() / want.abs()).max())
        if not torch.isfinite(got).all() or rel[k] > AUDIO_RTOL:
            raise AssertionError(f"{path} {k}: {float(got)} on the card, {float(want)} on the CPU")
    out = {"updates": len(batches), "input_shapes": [list(x.shape) for x in batches[0]],
           "values": {k: float(v) for k, v in values["eager"].items()}, "rel_diff_to_cpu": rel,
           "launches_eager": launches["eager"], "launches_engine": launches["engine"],
           "engine_run": _check_audio_engine(path, runs["engine"][0], len(batches), _solve_capturable(torch.device("cuda"))),
           "run_us_per_update": {mode: runs[mode][1] for mode in runs}, "first_updates_ms": first}
    if path == "dns":
        owners = sorted(g.owner for g in runs["eager"][0]._groups.values())
        if owners != sorted(_dns_members("cpu")):
            raise AssertionError(f"dns: the collection's groups are owned by {owners}")
    if path.startswith("pit"):
        m = runs["eager"][0]
        perm_rel = 0.0
        for i, b in enumerate(batches):
            card = permutation_invariant_training(*b, m.metric_func, m.mode, m.eval_func)
            host = permutation_invariant_training(*(x.cpu() for x in b), m.metric_func, m.mode, m.eval_func)
            _equal(f"{path} best permutation, update {i}", card[1].cpu(), host[1])
            perm_rel = max(perm_rel, float(((card[0].cpu() - host[0]).abs() / host[0].abs()).max()))
        if perm_rel > AUDIO_RTOL:
            raise AssertionError(f"{path}: best values {perm_rel} apart, card against CPU")
        out["best_value_rel_diff_to_cpu"] = perm_rel
    nbytes = sum(x.nbytes for x in batches[0])
    for mode in ("eager", "engine"):
        with engine_context(mode == "engine"):
            t = runs[mode][0]
            step = lambda i, t=t: t.update(*batches[i % len(batches)])  # noqa: E731
            wall = _host_us_per_call(step, iters=8, repeats=3)
            prof = _device_profile(step, iters=4)
            busy = prof["device_busy_us"]
            syncs = _syncs_per_call(lambda t=t: t.update(*batches[1]))
        out[mode] = {
            "update_us": wall, "device_busy_us": busy, "device_ops": prof["device_ops"],
            "device_idle_share": None if busy is None else max(0.0, 1 - busy / wall),
            "kernels_us": prof["kernels_us"], "host_syncs_per_update": syncs,
            "bytes_bound_us": nbytes / hbm_rate * 1e6,
        }
    want_syncs = AUDIO_SYNCS.get(path)
    if want_syncs is not None and out["eager"]["host_syncs_per_update"] != want_syncs:
        raise AssertionError(f"{path}: {out['eager']['host_syncs_per_update']} host syncs per eager update, not {want_syncs}")
    if out["engine_run"]["replaying"] and out["engine"]["host_syncs_per_update"]:
        raise AssertionError(f"{path}: {out['engine']['host_syncs_per_update']} host syncs per replayed update")
    er = out["engine_run"]
    _log(f"  {path}: eager {out['eager']['update_us']:.1f} µs ({out['eager']['device_ops']} device ops,"
         f" {out['eager']['host_syncs_per_update']} syncs) / engine {out['engine']['update_us']:.1f} µs per update;"
         f" {er['replays']} replays, fallbacks {er['fallback_reasons']}; {out['values']} (CPU {max(rel.values()):.1e})")
    return out


def _clip_words() -> list:
    """The caption vocabulary: 600 three-letter words, onset + vowel + coda, from three
    disjoint letter sets, so BPE merges each word whole (onset + vowel, then the coda)."""
    return [a + b + c for a in "bcdfghjklm" for b in "aeiouy" for c in "npqrstvwxz"]


def _clip_checkpoint(directory: str) -> str:
    """A seeded ``CLIPModel`` at openai/clip-vit-large-patch14's widths, a ``CLIPTokenizer``
    over ``_clip_words`` and a ``CLIPImageProcessor`` at its 224 defaults, saved with
    ``save_pretrained`` into ``directory``."""
    import string

    import transformers

    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for ch in string.ascii_lowercase:
        vocab[ch], vocab[ch + "</w>"] = len(vocab), len(vocab) + 1
    merges = ["#version: 0.2"]
    for w in _clip_words():
        if w[:2] not in vocab:
            vocab[w[:2]] = len(vocab)
            merges.append(f"{w[0]} {w[1]}")
    for w in _clip_words():
        vocab[w + "</w>"] = len(vocab)
        merges.append(f"{w[:2]} {w[2]}</w>")
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("\n".join(merges) + "\n")
    transformers.CLIPTokenizer(os.path.join(directory, "vocab.json"), os.path.join(directory, "merges.txt")).save_pretrained(directory)
    transformers.CLIPImageProcessor().save_pretrained(directory)
    config = transformers.CLIPConfig(
        text_config={**CLIP_TEXT, "projection_dim": CLIP_PROJECTION, "bos_token_id": 0, "eos_token_id": 1, "pad_token_id": 1},
        vision_config={**CLIP_VISION, "projection_dim": CLIP_PROJECTION},
        projection_dim=CLIP_PROJECTION,
    )
    torch.manual_seed(0)
    transformers.CLIPModel(config).save_pretrained(directory)
    return directory


def _clip_captions(gen: torch.Generator) -> list:
    words = _clip_words()
    out = []
    for _ in range(CLIP_UPDATES):
        lengths = torch.randint(CLIP_WORDS[0], CLIP_WORDS[1] + 1, (CLIP_BATCH,), generator=gen).tolist()
        out.append([" ".join(words[j] for j in torch.randint(0, len(words), (k,), generator=gen).tolist()) for k in lengths])
    return out


def run_clip() -> dict:
    """``CLIPScore(model_name_or_path=<dir>)`` on a seeded ViT-L/14 checkpoint the script
    writes: 4 updates of 64 (3 x 480 x 640 uint8 image, 8-16 word caption) pairs, eagerly
    and with the engine (which falls back: captions are strings); the processor's host
    ms and the towers' device ms per update beside the towers' float32 bound; the card's
    scores on the first 4 pairs against the CPU's."""
    from torch.utils.flop_counter import FlopCounterMode

    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.functional.multimodal.clip_score import (
        _clip_score_update,
        _get_model_and_processor,
        _host_images,
    )
    from torchmetrics_tpu_torch.models._common import full_float32
    from torchmetrics_tpu_torch.multimodal import CLIPScore
    from torchmetrics_tpu_torch.utilities.hf import model_on

    out: dict = {}
    gen = torch.Generator(device="cuda").manual_seed(22_100)
    images = [torch.randint(0, 256, (CLIP_BATCH, *CLIP_IMAGE), generator=gen, device="cuda", dtype=torch.uint8)
              for _ in range(CLIP_UPDATES)]
    captions = _clip_captions(torch.Generator().manual_seed(22_101))
    with tempfile.TemporaryDirectory() as directory:
        t0 = time.perf_counter()
        _clip_checkpoint(directory)
        out["checkpoint_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _get_model_and_processor(directory)
        out["load_s"] = time.perf_counter() - t0
        runs, values, launches = {}, {}, {}
        for mode in ("eager", "engine"):
            with engine_context(mode == "engine"):
                m = CLIPScore(model_name_or_path=directory)
                _zero_launches()
                each = []
                for img, cap in zip(images, captions):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m.update(img, cap)
                    torch.cuda.synchronize()
                    each.append((time.perf_counter() - t0) * 1e3)
                # the first update copies the towers to the card (``model_on``)
                runs[mode] = (m, statistics.median(each[1:]), each)
                values[mode] = m.compute()
                launches[mode] = _launches()
        m = runs["eager"][0]
        towers = model_on(m.model, m.device)
        if next(towers.parameters()).device.type != "cuda" or next(m.model.parameters()).device.type != "cpu":
            raise AssertionError("clip: the towers that ran are not on the card, or the cached model moved")
        _equal("clip engine against eager", values["engine"], values["eager"])
        value = float(values["eager"])
        if not math.isfinite(value) or not 0.0 <= value <= 100.0:
            raise AssertionError(f"clip: CLIPScore {value}")
        out.update({"value": value, "mean_score_unclamped": float(m.score / m.n_samples), "update_ms": {mode: runs[mode][1] for mode in runs},
                    "each_update_ms": {mode: runs[mode][2] for mode in runs},
                    "launches_eager": launches["eager"], "launches_engine": launches["engine"],
                    "engine_run": _check_audio_engine("clip", runs["engine"][0], CLIP_UPDATES, False),
                    "towers_device": str(next(towers.parameters()).device)})

        # the split of an update: the processor on the host, the towers on the card
        proc_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            processed = m.processor(text=captions[0], images=_host_images(list(images[0])), return_tensors="pt",
                                    padding=True)
            proc_ms.append((time.perf_counter() - t0) * 1e3)
        pv, ids, mask = (processed[k].cuda() for k in ("pixel_values", "input_ids", "attention_mask"))

        def run_towers(_i=0):
            with torch.no_grad(), full_float32():
                towers.visual_projection(towers.vision_model(pixel_values=pv).pooler_output)
                towers.text_projection(towers.text_model(input_ids=ids, attention_mask=mask).pooler_output)

        towers_ms = _median_ms(run_towers, iters=2, repeats=3, warmup=1)
        counter = FlopCounterMode(display=False)
        with counter:
            run_towers()
        flops = counter.get_total_flops()
        step = lambda i: m.update(images[i % CLIP_UPDATES], captions[i % CLIP_UPDATES])  # noqa: E731
        prof = _device_profile(step, iters=1)
        wall_ms = runs["eager"][1]
        busy = prof["device_busy_us"]
        out.update({
            "processor_host_ms": statistics.median(proc_ms), "towers_device_ms": towers_ms,
            "towers_flops": flops, "towers_fp32_bound_ms": flops / FP32_PEAK * 1e3,
            "towers_share_of_bound": flops / FP32_PEAK * 1e3 / towers_ms,
            "device_busy_ms": None if busy is None else busy / 1e3, "device_ops": prof["device_ops"],
            "device_idle_share": None if busy is None else max(0.0, 1 - busy / 1e3 / wall_ms),
            "kernels_us": prof["kernels_us"], "tokens": list(ids.shape),
            "host_syncs_per_update": _syncs_per_call(lambda: m.update(images[1], captions[1])),
        })

        card, _ = _clip_score_update(images[0][:CLIP_CPU_PAIRS], captions[0][:CLIP_CPU_PAIRS], m.model, m.processor,
                                     None, "cuda")
        host, _ = _clip_score_update(images[0][:CLIP_CPU_PAIRS].cpu(), captions[0][:CLIP_CPU_PAIRS], m.model,
                                     m.processor, None, "cpu")
        out["cpu_pairs_abs_diff"] = float((card.cpu() - host).abs().max())
        if out["cpu_pairs_abs_diff"] > CLIP_ATOL:
            raise AssertionError(f"clip: scores {card.tolist()} on the card, {host.tolist()} on the CPU")
        _get_model_and_processor.cache_clear()
    _log(f"  clip: {out['update_ms']['eager']:.0f} ms per update ({out['processor_host_ms']:.0f} ms processor on the"
         f" host, {towers_ms:.0f} ms towers on the card against a {out['towers_fp32_bound_ms']:.0f} ms float32 bound);"
         f" CLIPScore {value:.4f}, first {CLIP_CPU_PAIRS} pairs {out['cpu_pairs_abs_diff']:.1e} from the CPU")
    return out


def run_audio(smi: str, hbm_rate: float) -> dict:
    """Phase 22: the audio and multimodal domains."""
    t_phase = time.perf_counter()
    out: dict = {"card": smi}
    for path in AUDIO_PATHS:
        t0 = time.perf_counter()
        out[path] = run_clip() if path == "clip" else run_audio_path(path, hbm_rate)
        out[path]["path_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    # each path counted its own runs; the audio and multimodal domains run no K1 / K2
    counts = {f"{p}_{mode}": out[p][f"launches_{mode}"] for p in AUDIO_PATHS for mode in ("eager", "engine")}
    if any(n for c in counts.values() for n in c.values()):
        raise AssertionError(f"audio: K1 / K2 launched {counts}")
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"  phase 22: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 23: fault-tolerant sync and elastic snapshots

RES_UPDATES = N_BATCHES  # per rank: config #2's 16 updates of 8192 x 10 scores
RES_POLICY = {"deadline_ms": 2000.0, "retries": 2, "backoff_ms": 1.0, "verify_payload": True}
RES_TIMED = 3  # compute timings per arm, in turns
RES_DEADLINE_MS = 500.0  # the genuine deadline: rank 1 sleeps three times it
RES_DEADLINE_SLACK_MS = 500.0
RES_JOIN_TIMEOUT_S = 300
RES_ELASTIC_UPDATES = 8  # per copy: phase 4's and phase 5's batches, 8 each
RES_FLOAT_RTOL = 1e-6
PREEMPT_BATCHES, PREEMPT_SIGNAL_AFTER, PREEMPT_EVERY = 24, 10, 4
PREEMPT_TIMEOUT_S = 300


def _res_batches(rank: int) -> list:
    """Rank ``rank``'s 16 batches of config #2's CIFAR-10-width scores, on the card."""
    gen = torch.Generator().manual_seed(2300 + rank)
    return [
        (_scores_with_edge_rows(CIFAR_BATCH, CIFAR_CLASSES, gen), torch.randint(0, CIFAR_CLASSES, (CIFAR_BATCH,), generator=gen).cuda())
        for _ in range(RES_UPDATES)
    ]


def _res_compute(mc, policy=None, faults=()) -> dict:
    """One 2-rank ``compute`` of ``mc`` from its local states under ``policy`` and the
    planted ``faults``, from zeroed counters: its values or typed error, ms, counters,
    fault events, and whether the local states came back."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch.diag import diag_context
    from torchmetrics_tpu_torch.engine.stats import reset_engine_stats
    from torchmetrics_tpu_torch.parallel import SyncFaultError, fault_context, resilience_context

    before = mc.state_dict()
    for m in mc.values(copy_state=False):
        m._computed = None
    reset_engine_stats()
    dist.barrier()
    torch.cuda.synchronize()
    out: dict = {}
    with contextlib.ExitStack() as stack:
        if policy is not None:
            stack.enter_context(resilience_context(**policy))
        stack.enter_context(fault_context(*faults))
        rec = stack.enter_context(diag_context())
        t0 = time.perf_counter()
        try:
            out["values"] = mc.compute()
        except SyncFaultError as err:
            out["error"] = {"class": type(err).__name__, "rank": err.rank, "attempts": err.attempts, "retryable": err.retryable}
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3
    st = mc._epoch_sync.stats if mc._epoch_sync is not None else None
    out["stats"] = {k: getattr(st, k) if st else 0 for k in ("packed_syncs", "sync_collectives", "sync_retries", "sync_degraded_folds")}
    out["events"] = [[e.kind, list(e.data["survivors"]) if "survivors" in e.data else e.data.get("rank")]
                     for e in rec.snapshot() if e.kind.startswith("sync.")]
    out["local_back"] = _same_state_dict(before, mc.state_dict())
    return out


def _res_rank_body(rank: int, out_dir: str) -> dict:
    """Part A on one gloo rank: config #2's collection over its own 16 updates (K1 and
    K2 once each per update, eagerly), then ``compute`` under the six scenarios from the
    same local states, and the two arms of a policy's cost in turns."""
    import numpy as np

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.ops import multi_threshold, stat_counts
    from torchmetrics_tpu_torch.parallel import CollectiveTimeout, CorruptPayload, RankDrop
    from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan

    with engine_context(False):
        batches = _res_batches(rank)
        torch.cuda.synchronize()
        mc = MetricCollection(_collection_members())
        stat_counts.LAUNCHES = multi_threshold.LAUNCHES = 0
        for p, t in batches:
            mc.update(p, t)
        torch.cuda.synchronize()
        launches = {"stat_counts": stat_counts.LAUNCHES, "multi_threshold": multi_threshold.LAUNCHES}
        mc.persistent(True)
        local = mc.state_dict()
        plan = PackedSyncPlan([(g.owner, mc._modules[g.owner]) for g in mc._groups.values()], 2)
        meta = plan.metadata_local()
        plan.finalize(None if meta is None else np.stack([meta, meta]))

        scenarios = {
            "no_policy": (None, ()),
            "policy": (RES_POLICY, ()),
            "corrupt": (RES_POLICY, (CorruptPayload(rank=1, times=1),)),
            "timeout": (RES_POLICY, (CollectiveTimeout(times=1),)),
            "rank_drop": (RES_POLICY, (RankDrop(rank=1),)),
            "rank_drop_strict": ({**RES_POLICY, "degraded": False}, (RankDrop(rank=1),)),
        }
        results, values = {}, {}
        for name, (policy, faults) in scenarios.items():
            res = _res_compute(mc, policy, faults)
            values[name] = res.pop("values", None)
            results[name] = res
        # host reads of a compute without and with the policy (its crc reads)
        reads = {}
        for name in ("no_policy", "policy"):
            policy = scenarios[name][0]
            reads[name] = _with_syncs(lambda: _res_compute(mc, policy))[1]
        times = {"no_policy": [], "policy": []}
        for _ in range(RES_TIMED):
            for name in ("no_policy", "policy"):
                times[name].append(_res_compute(mc, scenarios[name][0])["ms"])
        torch.cuda.synchronize()
    torch.save({"local": local, "values": values}, os.path.join(out_dir, f"res{rank}.pt"))
    return {
        "launches": launches, "scenarios": results, "host_reads": reads,
        "compute_ms": {k: statistics.median(v) for k, v in times.items()},
        "buffer_keys": plan.buffer_keys(), "rank_invariant": plan.rank_invariant,
    }


def _res_deadline_body(rank: int, out_dir: str) -> dict:
    """The genuine deadline: rank 1 sleeps three times the deadline before its
    ``compute``, so rank 0's first collective waits on a live rank that is late."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.parallel import CollectiveTimeoutError, resilience_context

    with engine_context(False):
        mc = MetricCollection(_collection_members())
        for p, t in _res_batches(rank)[:2]:
            mc.update(p, t)
        torch.cuda.synchronize()
        if rank == 1:
            time.sleep(3 * RES_DEADLINE_MS / 1e3)
        out: dict = {}
        t0 = time.perf_counter()
        try:
            with resilience_context(deadline_ms=RES_DEADLINE_MS, retries=2, backoff_ms=1.0):
                mc.compute()
            out["completed"] = True
        except CollectiveTimeoutError as err:
            out["error"] = {"in_flight": err.in_flight, "retryable": err.retryable, "attempts": err.attempts, "label": err.label}
        out["ms"] = (time.perf_counter() - t0) * 1e3
    return out


def run_resilience_2rank() -> dict:
    """Part A: the six scenarios on two gloo ranks, then the genuine deadline in a pair
    of its own; fails on a hang, a scenario off its contract, or a value off its fold."""
    with _two_ranks(_res_rank_body, RES_JOIN_TIMEOUT_S, "resilience") as (results, out_dir):
        saved = [torch.load(os.path.join(out_dir, f"res{r}.pt")) for r in range(2)]
    want_retries = {"corrupt": 1, "timeout": 1}
    for rank, res in enumerate(results):
        if res["launches"] != {"stat_counts": RES_UPDATES, "multi_threshold": RES_UPDATES}:
            raise AssertionError(f"resilience rank {rank}: launches {res['launches']}, expected {RES_UPDATES} of each")
        want_collectives = len(res["buffer_keys"]) + (0 if res["rank_invariant"] else 1)
        for name, sc in res["scenarios"].items():
            st = sc["stats"]
            degraded = 1 if name == "rank_drop" else 0
            if (st["sync_retries"], st["sync_degraded_folds"]) != (want_retries.get(name, 0), degraded):
                raise AssertionError(f"resilience rank {rank} {name}: retries / degraded folds {st}")
            if not sc["local_back"]:
                raise AssertionError(f"resilience rank {rank} {name}: the local states did not come back")
            if name == "rank_drop_strict":
                if sc.get("error", {}).get("class") != "RankUnreachableError" or sc["error"]["rank"] != 1:
                    raise AssertionError(f"resilience rank {rank}: degraded=False gave {sc}")
                continue
            if "error" in sc:
                raise AssertionError(f"resilience rank {rank} {name}: {sc['error']}")
            if name in ("no_policy", "policy") and st["sync_collectives"] != want_collectives:
                raise AssertionError(f"resilience rank {rank} {name}: {st['sync_collectives']} collectives, expected {want_collectives}")
        if ["sync.degraded", [0]] not in res["scenarios"]["rank_drop"]["events"]:
            raise AssertionError(f"resilience rank {rank}: no sync.degraded event naming the survivors (0,)")

    # scenario 1 against the merge_state fold of the two ranks' states, on the card
    others = _collection_members()
    for name, folded in _collection_members().items():
        folded.load_state_dict(saved[0]["local"], prefix=f"{name}.")
        others[name].load_state_dict(saved[1]["local"], prefix=f"{name}.")
        folded.merge_state(others[name])
        want = folded.compute()
        alone = _collection_members()[name]
        alone.load_state_dict(saved[0]["local"], prefix=f"{name}.")
        want_degraded = alone.compute()
        for rank in range(2):
            vals = saved[rank]["values"]
            if want.dtype == torch.int32:
                _equal(f"resilience {name} rank {rank}", vals["no_policy"][name], want)
            else:
                _assert_close(f"resilience {name} rank {rank}", vals["no_policy"][name], want, AUROC_ATOL if "auroc" in name else ACC_ATOL)
            for sc in ("policy", "corrupt", "timeout"):
                _bit_equal(f"resilience {name} rank {rank} {sc}", vals[sc][name], vals["no_policy"][name])
            _bit_equal(f"resilience {name} rank {rank} rank_drop", vals["rank_drop"][name], want_degraded)

    with _two_ranks(_res_deadline_body, RES_JOIN_TIMEOUT_S, "resilience deadline", abandon=True) as (late, _):
        pass
    err = late[0].get("error")
    if not err or not err["in_flight"] or err["retryable"] or err["attempts"] != 1:
        raise AssertionError(f"resilience deadline: rank 0 gave {late[0]}")
    if late[0]["ms"] > RES_DEADLINE_MS + RES_DEADLINE_SLACK_MS:
        raise AssertionError(f"resilience deadline: rank 0 escaped after {late[0]['ms']:.1f} ms")
    summary = {
        "ranks": 2, "backend": "gloo (CUDA tensors, one card)", "updates_per_rank": RES_UPDATES,
        "buffer_keys": results[0]["buffer_keys"],
        "launches": {k: sum(r["launches"][k] for r in results) for k in ("stat_counts", "multi_threshold")},
        "scenarios": {name: [{"ms": r["scenarios"][name]["ms"], **r["scenarios"][name]["stats"],
                              **({"error": r["scenarios"][name]["error"]} if "error" in r["scenarios"][name] else {})}
                             for r in results] for name in results[0]["scenarios"]},
        "compute_ms": [r["compute_ms"] for r in results],
        "host_reads": [r["host_reads"] for r in results],
        "deadline": {"deadline_ms": RES_DEADLINE_MS, "rank0": late[0], "rank1": late[1]},
    }
    _log(f"  2 ranks: six scenarios held; compute {summary['compute_ms']} ms (median of {RES_TIMED}, no policy / policy),"
         f" host reads {summary['host_reads']}; the genuine deadline escaped on rank 0 after {late[0]['ms']:.1f} ms"
         f" (rank 1: {late[1]})")
    return summary


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _res_assert_states(name: str, got, want) -> None:
    """Counts exactly, floats to relative 1e-6, every state on the card."""
    for key, w in want.items():
        g = got[key]
        if isinstance(w, int):
            if g != w:
                raise AssertionError(f"{name}: {key} {g} vs {w}")
            continue
        gl, wl = (g, w) if isinstance(w, list) else ([g], [w])
        if len(gl) != len(wl):
            raise AssertionError(f"{name}: {key} holds {len(gl)} pieces, the fold {len(wl)}")
        for a, b in zip(gl, wl):
            if not _on_card(a) or a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{name}: {key} {a.dtype}{tuple(a.shape)} on {a.device} vs {b.dtype}{tuple(b.shape)}")
            if b.is_floating_point():
                if not torch.allclose(a, b, rtol=RES_FLOAT_RTOL, atol=0):
                    raise AssertionError(f"{name}: {key} off the fold by {float((a - b).abs().max())}")
            elif not torch.equal(a, b):
                raise AssertionError(f"{name}: {key} differs from the fold")


def _fold_states(state_dicts: list, members: dict) -> dict:
    """The ``merge_state`` fold of per-rank state dicts, member by member on the card
    (``members``: key prefix -> a factory of that member; ``""`` for a lone metric)."""
    out = {}
    for prefix, make in members.items():
        head = make()
        head.persistent(True)
        head.load_state_dict(state_dicts[0], prefix=prefix)
        for sd in state_dicts[1:]:
            other = make()
            other.load_state_dict(sd, prefix=prefix)
            head.merge_state(other)
        out.update(head.state_dict(prefix=prefix))
    return out


def run_resilience_elastic(acc_batches: list, cifar_batches: list) -> dict:
    """Part B: two copies each of ``MulticlassAccuracy(1000)`` and config #2's
    collection stand for two ranks (8 batches each, with the engine), saved as shards
    and restored into worlds of 1 and 3 on the card; a flipped byte and ``last_good``."""
    import shutil

    from torchmetrics_tpu_torch import MetricCollection, MulticlassAccuracy
    from torchmetrics_tpu_torch.diag import diag_context
    from torchmetrics_tpu_torch.ops import multi_threshold, stat_counts
    from torchmetrics_tpu_torch.parallel import SnapshotIntegrityError, restore_resharded, save_state_shard
    from torchmetrics_tpu_torch.parallel.elastic import shard_path

    makers = {
        "accuracy": lambda: MulticlassAccuracy(ACC_CLASSES, validate_args=False),
        "collection": lambda: MetricCollection(_collection_members(validate_args=False)),
    }
    members = {
        "accuracy": {"": makers["accuracy"]},
        "collection": {f"{n}.": (lambda n=n: _collection_members(validate_args=False)[n]) for n in _collection_members()},
    }
    feeds = {"accuracy": acc_batches, "collection": cifar_batches}
    out: dict = {}
    with tempfile.TemporaryDirectory() as root:
        for kind, make in makers.items():
            copies = [make() for _ in range(2)]
            for c in copies:
                c.persistent(True)
            prev, latest = os.path.join(root, kind, "prev"), os.path.join(root, kind, "latest")
            os.makedirs(prev)
            os.makedirs(latest)
            stat_counts.LAUNCHES = multi_threshold.LAUNCHES = 0
            for step in range(RES_ELASTIC_UPDATES):
                if step == RES_ELASTIC_UPDATES // 2:
                    # the previous complete set, half way, and its fold
                    want_prev = _fold_states([c.state_dict() for c in copies], members[kind])
                    for rank, c in enumerate(copies):
                        save_state_shard(c, shard_path(os.path.join(prev, "ck"), rank, 2), rank=rank, world_size=2)
                for rank, c in enumerate(copies):
                    c.update(*feeds[kind][RES_ELASTIC_UPDATES * rank + step])
            torch.cuda.synchronize()
            launches = {"stat_counts": stat_counts.LAUNCHES, "multi_threshold": multi_threshold.LAUNCHES}
            want = _fold_states([c.state_dict() for c in copies], members[kind])
            save_ms = []
            for rank, c in enumerate(copies):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                save_state_shard(c, shard_path(os.path.join(latest, "ck"), rank, 2), rank=rank, world_size=2)
                save_ms.append((time.perf_counter() - t0) * 1e3)
            shard_bytes = [os.path.getsize(shard_path(os.path.join(latest, "ck"), r, 2)) for r in range(2)]
            restore_ms = {}
            for world in (1, 3):
                restored, times = [], []
                for rank in range(world):
                    m = make()
                    m.persistent(True)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    restore_resharded(m, latest, rank=rank, world_size=world)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    restored.append(m)
                got = _fold_states([m.state_dict() for m in restored], members[kind])
                _res_assert_states(f"elastic {kind} 2->{world}", got, want)
                restore_ms[str(world)] = times
            # a flipped byte in one shard: integrity error on every rank, then last_good
            bad = os.path.join(root, kind, "bad")
            shutil.copytree(latest, bad)
            victim = shard_path(os.path.join(bad, "ck"), 1, 2)
            with open(victim, "r+b") as fh:
                data = bytearray(fh.read())
                data[len(data) // 2] ^= 0xFF
                fh.seek(0)
                fh.write(data)
            for rank in range(2):
                try:
                    restore_resharded(make(), bad, rank=rank, world_size=2)
                except SnapshotIntegrityError:
                    pass
                else:
                    raise AssertionError(f"elastic {kind}: a flipped byte restored without an integrity error")
            fallback = make()
            fallback.persistent(True)
            with diag_context() as rec:
                restore_resharded(fallback, bad, rank=0, world_size=1, last_good=prev)
            if rec.count("snapshot.fallback") != 1:
                raise AssertionError(f"elastic {kind}: no snapshot.fallback event")
            _res_assert_states(f"elastic {kind} last_good", _fold_states([fallback.state_dict()], members[kind]), want_prev)
            out[kind] = {"launches": launches, "shard_bytes": shard_bytes, "save_ms": save_ms, "restore_ms": restore_ms}
    _log("  elastic: " + "; ".join(
        f"{k} shards {v['shard_bytes']} B, save {[round(x, 2) for x in v['save_ms']]} ms, restore 2->1"
        f" {[round(x, 2) for x in v['restore_ms']['1']]} / 2->3 {[round(x, 2) for x in v['restore_ms']['3']]} ms,"
        f" launches {v['launches']}" for k, v in out.items()))
    return out


def _preempt_batches() -> list:
    gen = torch.Generator().manual_seed(2400)
    return [
        (torch.randn(ACC_BATCH, ACC_CLASSES, generator=gen), torch.randint(0, ACC_CLASSES, (ACC_BATCH,), generator=gen))
        for _ in range(PREEMPT_BATCHES)
    ]


def _preempt_child(out_dir: str, scan_steps: int) -> None:
    """Accuracy updates on the card under a ``ContinuousSnapshotter`` (every 4 updates)
    until SIGTERM; a chained handler, run after the snapshotter's flush, writes each
    completed sequence's fingerprint and update count, the flush ms and the launches."""
    import signal

    from torchmetrics_tpu_torch import MulticlassAccuracy
    from torchmetrics_tpu_torch.ops import multi_threshold, stat_counts
    from torchmetrics_tpu_torch.parallel import ContinuousSnapshotter, SnapshotPolicy, state_fingerprint

    torch.cuda.set_device(0)
    batches = [(p.cuda(), t.cuda()) for p, t in _preempt_batches()]
    m = MulticlassAccuracy(ACC_CLASSES, validate_args=False, scan_steps=scan_steps or None)
    snap = ContinuousSnapshotter(m, out_dir, policy=SnapshotPolicy(every_updates=PREEMPT_EVERY))
    seqs: dict = {}
    flush_ms: list = []
    real_flush = snap.flush

    def timed_flush(reason: str = "manual") -> str:
        t0 = time.perf_counter()
        path = real_flush(reason)
        if reason.startswith("signal"):
            flush_ms.append((time.perf_counter() - t0) * 1e3)
        return path

    snap.flush = timed_flush

    def note() -> None:
        if snap.seq and str(snap.seq) not in seqs:
            seqs[str(snap.seq)] = [state_fingerprint(m), m.update_count]

    def report(signum, frame) -> None:
        note()
        with open(os.path.join(out_dir, "child.json"), "w") as f:
            json.dump({"seqs": seqs, "flush_ms": flush_ms, "launches": {
                "stat_counts": stat_counts.LAUNCHES, "multi_threshold": multi_threshold.LAUNCHES}}, f)
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)

    signal.signal(signal.SIGTERM, report)
    snap.install_signal_handlers(signals=(signal.SIGTERM,))
    stat_counts.LAUNCHES = multi_threshold.LAUNCHES = 0
    for i, (p, t) in enumerate(batches):
        m.update(p, t)
        snap.note_update()
        note()
        with open(os.path.join(out_dir, "progress"), "w") as f:
            f.write(str(i + 1))
        time.sleep(0.02)
    while True:
        time.sleep(1.0)


def run_resilience_preempt() -> dict:
    """Part C: SIGTERM a child after about 10 updates; ``restore_latest`` on the card,
    the remaining batches, and the uninterrupted run must agree; again with
    ``scan_steps=8`` (the flush drains the queue)."""
    import signal

    from torchmetrics_tpu_torch import MulticlassAccuracy
    from torchmetrics_tpu_torch.parallel import restore_latest, state_fingerprint
    from torchmetrics_tpu_torch.parallel.elastic import list_snapshots

    batches = [(p.cuda(), t.cuda()) for p, t in _preempt_batches()]
    whole = MulticlassAccuracy(ACC_CLASSES, validate_args=False)
    for p, t in batches:
        whole.update(p, t)
    want = whole.compute()
    out: dict = {}
    ctx = multiprocessing.get_context("spawn")
    for scan in (0, 8):
        with tempfile.TemporaryDirectory() as d:
            proc = ctx.Process(target=_preempt_child, args=(d, scan))
            proc.start()
            progress = os.path.join(d, "progress")
            deadline = time.monotonic() + PREEMPT_TIMEOUT_S
            try:
                while time.monotonic() < deadline and proc.is_alive():
                    try:
                        with open(progress) as f:
                            done = int(f.read() or 0)
                    except (OSError, ValueError):
                        done = 0
                    if done >= PREEMPT_SIGNAL_AFTER:
                        break
                    time.sleep(0.01)
                else:
                    raise AssertionError(f"preempt scan={scan}: the child reached no {PREEMPT_SIGNAL_AFTER} updates")
                proc.terminate()  # SIGTERM
                proc.join(PREEMPT_TIMEOUT_S)
            finally:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
            if proc.exitcode != -signal.SIGTERM:
                raise AssertionError(f"preempt scan={scan}: the child exited with {proc.exitcode}")
            with open(os.path.join(d, "child.json")) as f:
                child = json.load(f)
            fresh = MulticlassAccuracy(ACC_CLASSES, validate_args=False)
            seq = restore_latest(fresh, d)
            if seq != list_snapshots(d)[-1][0]:
                raise AssertionError(f"preempt scan={scan}: restored sequence {seq} is not the newest")
            fp, count = child["seqs"][str(seq)]
            if state_fingerprint(fresh) != fp or fresh.update_count != count or not _on_card(fresh.tp):
                raise AssertionError(f"preempt scan={scan}: sequence {seq} restored off the child's state at {count} updates")
            for p, t in batches[count:]:
                fresh.update(p, t)
            for attr in whole._defaults:
                if not torch.equal(getattr(fresh, attr), getattr(whole, attr)):
                    raise AssertionError(f"preempt scan={scan}: {attr} differs from the uninterrupted run")
            _bit_equal(f"preempt scan={scan}", fresh.compute(), want)
            out[f"scan{scan}"] = {"restored_seq": seq, "restored_updates": count, "flush_ms": child["flush_ms"],
                                  "signal_flushed": bool(child["flush_ms"]), "launches": child["launches"]}
    _log("  preempt: " + "; ".join(f"{k}: seq {v['restored_seq']} at {v['restored_updates']} updates, flush"
                                   f" {v['flush_ms']} ms, launches {v['launches']}" for k, v in out.items()))
    return out


def run_resilience(acc_batches: list, cifar_batches: list, gen: torch.Generator, smi: str) -> dict:
    """Phase 23: K1 and K2 against their plain versions, then parts A-C."""
    t_phase = time.perf_counter()
    errors = {"stat_counts": check_stat_counts(gen), "multi_threshold": check_multi_threshold(gen)}
    out = {"card": smi, "kernel_errors": errors}
    out["sync_2rank"] = run_resilience_2rank()
    out["elastic"] = run_resilience_elastic(acc_batches, cifar_batches)
    out["preempt"] = run_resilience_preempt()
    out["launches"] = {
        "eager": out["sync_2rank"]["launches"],
        "engine": {k: sum(v["launches"][k] for v in out["elastic"].values()) for k in ("stat_counts", "multi_threshold")},
        "preempt_engine": {k: sum(v["launches"][k] for v in out["preempt"].values()) for k in ("stat_counts", "multi_threshold")},
    }
    for side, counts in out["launches"].items():
        # accuracy's path (the preemption children) runs K1 alone
        needed = ("stat_counts",) if side == "preempt_engine" else tuple(counts)
        if not all(counts[k] for k in needed):
            raise AssertionError(f"phase 23 {side}: a kernel of the path was not launched: {counts}")
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"  phase 23: {out['phase_s']:.1f} s on {smi}; launches {out['launches']}")
    print(json.dumps({"resilience_summary": {
        "card": smi, "compute_ms": out["sync_2rank"]["compute_ms"], "host_reads": out["sync_2rank"]["host_reads"],
        "deadline_ms": out["sync_2rank"]["deadline"]["rank0"]["ms"],
        "elastic": {k: {kk: v[kk] for kk in ("shard_bytes", "save_ms", "restore_ms")} for k, v in out["elastic"].items()},
        "flush_ms": {k: v["flush_ms"] for k, v in out["preempt"].items()}, "launches": out["launches"],
    }}), flush=True)
    return out


# ---------------------------------------------------------------- phase 24: the diagnostics plane

DIAG_WARM = N_BATCHES  # warm engine updates per owner under the guard (the builds come first)
DIAG_EVERY_N = 4  # profile_context(every_n): 4 probes per 16 warm updates
DIAG_ROUNDS = 11  # the overhead arms, in turns; medians
DIAG_PASSES = 4  # passes over the 16 batches per round: 64 updates
DIAG_ARMS = ("off", "recorder", "sentinel", "profile", "guard", "lineage", "all")
DIAG_STRAGGLER_MS = 20.0  # rank 1 enters the second packed sync this late
DIAG_STRAGGLER_US = 10_000.0  # the threshold that delay must cross
DIAG_DEADLINE_MS = 500.0  # the genuine deadline: rank 1 is late by three times it
DIAG_JOIN_TIMEOUT_S = 300


def _diag_float_sum(device=None):
    """A float-sum metric whose state takes a NaN as it comes (the aggregators' NaN
    strategies replace or drop it before the state)."""
    from torchmetrics_tpu_torch.metric import Metric

    class DiagFloatSum(Metric):
        full_state_update = False

        def __init__(self) -> None:
            super().__init__(device=device)
            self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

        def update(self, x: torch.Tensor) -> None:
            self.total = self.total + x.sum()

        def compute(self) -> torch.Tensor:
            return self.total

    return DiagFloatSum()


def _diag_engine_members(device=None) -> dict:
    """Config #2's members the engine runs: the binned AUROC's update reads the host (its
    [0, 1] range check, in both packages), so it cannot run under a strict guard."""
    members = _collection_members(device=device, validate_args=False)
    members.pop("auroc")
    return members


@contextlib.contextmanager
def _diag_arm(arm: str, rec=None):
    """The diagnostics knobs of one overhead arm: each alone, all, or none (lineage is on
    by default, so ``off`` turns it off)."""
    from torchmetrics_tpu_torch.diag import diag_context, lineage_context, profile_context, sentinel_context, transfer_guard

    on = (lambda knob: arm in (knob, "all"))
    with contextlib.ExitStack() as stack:
        stack.enter_context(lineage_context(on("lineage")))
        stack.enter_context(sentinel_context(on("sentinel")))
        if on("recorder"):
            stack.enter_context(diag_context(recorder=rec))
        if on("profile"):
            stack.enter_context(profile_context(every_n=DIAG_EVERY_N))
        if on("guard"):
            stack.enter_context(transfer_guard("strict"))
        yield


def _diag_overhead(make, batches: list) -> dict:
    """Host µs per ``update`` (to a device sync) under each arm, one metric per arm (the
    sentinel changes the step's signature), warmed, then DIAG_ROUNDS rounds in turns of
    DIAG_PASSES passes over the batches."""
    from torchmetrics_tpu_torch.diag import FlightRecorder

    recs = {arm: FlightRecorder(1 << 16) for arm in DIAG_ARMS}
    metrics = {arm: make() for arm in DIAG_ARMS}  # built outside the guard (a default's copy in syncs)
    for arm in DIAG_ARMS:
        with _diag_arm(arm, recs[arm]):
            for p, t in batches[:3]:
                metrics[arm].update(p, t)
    torch.cuda.synchronize()
    times = {arm: [] for arm in DIAG_ARMS}
    for _ in range(DIAG_ROUNDS):
        for arm in DIAG_ARMS:
            m = metrics[arm]
            with _diag_arm(arm, recs[arm]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for p, t in batches * DIAG_PASSES:
                    m.update(p, t)
                torch.cuda.synchronize()
                times[arm].append((time.perf_counter() - t0) / (len(batches) * DIAG_PASSES) * 1e6)
    med = {arm: statistics.median(v) for arm, v in times.items()}
    return {"update_us": med, "over_off_us": {arm: med[arm] - med["off"] for arm in DIAG_ARMS}, "runs_us": times}


def _diag_owner_rows(rows: list, owner: str) -> dict:
    return {f"{r['kind']}:{r['series']}": {k: r[k] for k in ("count", "p50", "p90", "p99")} for r in rows if r["owner"] == owner}


def run_diag_guarded(acc_batches: list, cifar_batches: list) -> dict:
    """Config #1 and config #2's engine members under the strict guard with the recorder,
    the sentinel and a profile on: every build and 16 warm updates, then ``compute``, each
    bit-equal to the same run with the diagnostics off; the binned AUROC alone under the
    log guard, its readbacks counted; then the overhead of each knob."""
    from torchmetrics_tpu_torch import MetricCollection, MulticlassAccuracy, MulticlassAUROC
    from torchmetrics_tpu_torch.diag import (
        diag_context,
        histograms_snapshot,
        ledger_snapshot,
        profile_context,
        profile_snapshot,
        read_sentinel,
        sentinel_context,
        transfer_guard,
    )
    from torchmetrics_tpu_torch.engine.stats import reset_engine_stats

    paths = {
        # make, and the update sequence: a cold build, then 16 warm (the collection's
        # groups are settled by their signatures when it is built: its first step fuses)
        "accuracy": (lambda: MulticlassAccuracy(ACC_CLASSES, validate_args=False), [acc_batches[0]] + acc_batches),
        "collection": (lambda: MetricCollection(_diag_engine_members()), [cifar_batches[0]] + cifar_batches),
    }
    out = {}
    for name, (make, seq) in paths.items():
        reset_engine_stats()
        m = make()
        _zero_launches()
        with sentinel_context(True), diag_context(capacity=1 << 14) as rec, profile_context(every_n=DIAG_EVERY_N):
            with transfer_guard("strict"):
                for p, t in seq:
                    m.update(p, t)
                torch.cuda.synchronize()
            events = dict(rec.counts)
            # the epoch boundary under the log guard: a compute's own host reads are counted
            with transfer_guard("log"):
                start = rec._seq
                value = m.compute()
                members = list(m.items(keep_base=True, copy_state=False)) if isinstance(m, MetricCollection) else [(name, m)]
                flags = {k: read_sentinel(o)["flags"] for k, o in members}
                torch.cuda.synchronize()
            compute_reads: dict = {}
            for e in rec.snapshot():
                if e.seq > start and e.kind == "transfer.host":
                    key = f"{e.data['layer']}:{e.data['op']}"
                    compute_reads[key] = compute_reads.get(key, 0) + 1
        launches = _launches()
        if events.get("transfer.host", 0) or events.get("transfer.blocked", 0):
            raise AssertionError(f"diag_guarded {name}: readbacks in the updates {events}")
        if name == "accuracy" and compute_reads:
            raise AssertionError(f"diag_guarded accuracy: readbacks in compute {compute_reads}")
        if any(flags.values()):
            raise AssertionError(f"diag_guarded {name}: the sentinel reads {flags}")
        # the engine whose dispatches the probes count: the metric's, or the collection's fused step
        site = f"{m._fused_engine.stats.owner}:fused" if isinstance(m, MetricCollection) else f"{m._engine.stats.owner}:update"
        sites = profile_snapshot()["per_site"]
        probe_site = sites.get(site, {})
        hists = _diag_owner_rows(histograms_snapshot(), site.rsplit(":", 1)[0])
        ledger = ledger_snapshot()["executables"]
        if probe_site.get("warm_dispatches") != DIAG_WARM or probe_site.get("probes") != DIAG_WARM // DIAG_EVERY_N:
            raise AssertionError(f"diag_guarded {name}: probes {sites}, expected {DIAG_WARM // DIAG_EVERY_N} per {DIAG_WARM} warm at {site}")
        # the same sequence with every diagnostic off: bit-equal values
        plain = make()
        for p, t in seq:
            plain.update(p, t)
        want = plain.compute()
        for key, got in (value.items() if isinstance(value, dict) else [(name, value)]):
            w = want[key] if isinstance(want, dict) else want
            if not torch.equal(got, w):
                raise AssertionError(f"diag_guarded {name} {key}: {got} differs from the run without diagnostics")
        prof = _device_profile(lambda i, m=plain, seq=seq: m.update(*seq[i % len(seq)]), iters=8)
        out[name] = {
            "updates": len(seq), "launches": launches, "events": {k: events[k] for k in sorted(events)},
            "compute_readbacks": compute_reads,
            "sentinel": flags, "probes": probe_site, "histograms": hists,
            "device_busy_us_per_update": prof["device_busy_us"],
            "ledger": [{k: r[k] for k in ("owner", "kind", "compile_ms", "capture_ms", "pool_bytes", "static_input_bytes",
                                          "state_bytes", "flops")} for r in ledger],
        }
        _log(f"  {name}: {len(seq)} updates under the strict guard, 0 readbacks; compute's readbacks {compute_reads}; sentinel 0;"
             f" probes {probe_site.get('probes')} / {probe_site.get('warm_dispatches')} warm;"
             f" device_us {hists.get('update:device_us', hists.get('fused:device_us'))};"
             f" profiler {prof['device_busy_us']} µs per update; launches {launches}; ledger {len(ledger)} entries")
    # the binned AUROC alone: its range check reads the host once per update, on both layers
    reset_engine_stats()
    auroc = MulticlassAUROC(CIFAR_CLASSES, thresholds=N_THRESH, validate_args=False)
    _zero_launches()

    def reads_of(events) -> dict:
        counts: dict = {}
        for e in events:
            if e.kind == "transfer.host":
                key = f"{e.data['layer']}:{e.data['op']}"
                counts[key] = counts.get(key, 0) + 1
        return counts

    # two log scopes: the native layer's warnings are recorded when its scope ends
    with diag_context() as rec:
        with transfer_guard("log"):
            for p, t in cifar_batches:
                auroc.update(p, t)
            torch.cuda.synchronize()
        start = rec._seq
        with transfer_guard("log"):
            auroc.compute()
            torch.cuda.synchronize()
    reads = reads_of(e for e in rec.snapshot() if e.seq <= start)
    compute_reads = reads_of(e for e in rec.snapshot() if e.seq > start)
    out["auroc_log"] = {"launches": _launches(), "update_readbacks": reads, "compute_readbacks": compute_reads,
                        "updates": len(cifar_batches)}
    if reads.get("python:Tensor.__bool__", 0) < len(cifar_batches):
        raise AssertionError(f"diag auroc: readbacks {reads}, expected the range check on every update")
    _log(f"  auroc (binned, T={N_THRESH}) under the log guard: updates {reads} over {len(cifar_batches)}, compute {compute_reads}")
    # the plane's overhead, per knob, on the card
    out["overhead"] = {
        "accuracy": _diag_overhead(lambda: MulticlassAccuracy(ACC_CLASSES, validate_args=False), acc_batches),
        "collection": _diag_overhead(lambda: MetricCollection(_diag_engine_members()), cifar_batches),
    }
    for name, o in out["overhead"].items():
        _log(f"  {name} update µs by arm (median of {DIAG_ROUNDS}, in turns): "
             + ", ".join(f"{a} {o['update_us'][a]:.1f}" for a in DIAG_ARMS))
    return out


def _diag_planted(device) -> dict:
    """The planted cases on ``device``: each case's sentinel bitmask (and the quarantined
    run's states against the run without the poisoned batch)."""
    from torchmetrics_tpu_torch import MulticlassAccuracy, SumMetric
    from torchmetrics_tpu_torch.diag import read_sentinel, sentinel_context
    from torchmetrics_tpu_torch.engine import compensated_context, engine_context, quarantine_context

    gen = torch.Generator().manual_seed(2400)
    logits = [torch.randn(ACC_BATCH, ACC_CLASSES, generator=gen) for _ in range(4)]
    labels = [torch.randint(0, ACC_CLASSES, (ACC_BATCH,), generator=gen) for _ in range(4)]
    poisoned = [x.clone() for x in logits]
    poisoned[2][7, 3] = float("nan")
    losses = [torch.rand(ACC_BATCH, generator=gen) for _ in range(4)]
    losses[1][100] = float("nan")
    dev = lambda x: x.to(device)  # noqa: E731
    out = {}
    with engine_context(True), sentinel_context(True):
        with quarantine_context(True):
            q = MulticlassAccuracy(ACC_CLASSES, validate_args=False, device=device)
            for p, t in zip(poisoned, labels):
                q.update(dev(p), dev(t))
            out["input_poisoned"] = read_sentinel(q)["flags"]
        clean = MulticlassAccuracy(ACC_CLASSES, validate_args=False, device=device)
        for i, (p, t) in enumerate(zip(logits, labels)):
            if i != 2:
                clean.update(dev(p), dev(t))
        out["quarantine_states_clean"] = all(torch.equal(getattr(q, k), getattr(clean, k)) for k in q._defaults)
        s = _diag_float_sum(device)
        for x in losses:
            s.update(dev(x))
        out["nan"] = read_sentinel(s)["flags"]
        with compensated_context(True):
            c = SumMetric(nan_strategy=0.0, device=device)
            c.update(dev(torch.full((ACC_BATCH,), 2.0**12)))  # 2^25: the float32 ulp is 4
            for _ in range(3):
                c.update(dev(torch.full((ACC_BATCH,), 2.0**-14)))  # +0.5 each: absorbed
            out["precision_loss"] = read_sentinel(c)["flags"]
        o = MulticlassAccuracy(ACC_CLASSES, validate_args=False, device=device)
        o.update(dev(logits[0]), dev(labels[0]))
        o.tp = torch.full_like(o.tp, 2**30 + 1)  # an int32 count past half its range
        o.update(dev(logits[1]), dev(labels[1]))
        out["overflow_suspect"] = read_sentinel(o)["flags"]
    return out


def run_diag_planted() -> dict:
    """The planted cases on the card and on the CPU: equal bitmasks, each with its bit."""
    from torchmetrics_tpu_torch.diag import SENTINEL_BITS

    _zero_launches()
    card = _diag_planted("cuda")
    launches = _launches()
    host = _diag_planted("cpu")
    for case, bits in card.items():
        if bits != host[case]:
            raise AssertionError(f"diag_planted {case}: card {bits} != CPU {host[case]}")
        if case in SENTINEL_BITS and not bits & SENTINEL_BITS[case]:
            raise AssertionError(f"diag_planted {case}: the bit is not set ({bits:#x})")
    if not card["quarantine_states_clean"]:
        raise AssertionError("diag_planted: the quarantined batch moved a state")
    _log(f"  planted: {card} (the CPU run equal); launches {launches}")
    return {"card": card, "cpu": host, "launches": launches}


def _diag_rank_body(rank: int, out_dir: str) -> dict:
    """One gloo rank: config #2's collection with the engine, the profile on, then five
    packed syncs: calibration, a NaN on rank 1 alone, a divergent rank-invariant state,
    rank 1 late by DIAG_STRAGGLER_MS (the straggler), rank 1 late past the deadline (the
    escape that degrades onto the straggler). Every event goes to one recorder, exported
    on the host's monotonic clock for the merged timeline."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.diag import (
        FlightRecorder,
        audit_context,
        diag_context,
        profile_context,
        provenance_of,
        read_sentinel,
        sentinel_context,
        set_straggler_threshold_us,
    )
    from torchmetrics_tpu_torch.parallel import DelayRank, fault_context, resilience_context

    mc = MetricCollection(_collection_members(validate_args=False))
    _zero_launches()
    for p, t in _res_batches(rank):
        mc.update(p, t)
    launches = _launches()
    rec = FlightRecorder(1 << 15)
    out: dict = {"launches": launches}

    def compute(faults=(), policy=None, late_s=0.0):
        for m in mc.values(copy_state=False):
            m._computed = None
        dist.barrier()
        torch.cuda.synchronize()
        time.sleep(late_s)
        start = rec._seq
        with fault_context(*faults), (resilience_context(**policy) if policy else contextlib.nullcontext()):
            try:
                mc.compute()
                err = None
            except Exception as exc:  # reported: the deadline's late rank expects its own escape
                err = type(exc).__name__
        torch.cuda.synchronize()
        return [e for e in rec.snapshot() if e.seq > start], err

    set_straggler_threshold_us(DIAG_STRAGGLER_US)
    with diag_context(recorder=rec), profile_context(every_n=DIAG_EVERY_N), sentinel_context(True):
        events, _ = compute()
        out["calibrate_metadata_gathers"] = sum(1 for e in events if e.kind == "collective" and e.data["label"] == "meta")
        s = _diag_float_sum()
        s.update(torch.tensor([float("nan")], device="cuda") if rank == 1 else torch.ones(1, device="cuda"))
        s.compute()
        out["sentinel_bits"] = read_sentinel(s)["bits"]
        with audit_context(True):
            mc["acc"]._rank_invariant_states = frozenset({"tp"})
            events, _ = compute()
            mc["acc"]._rank_invariant_states = frozenset()
        out["audit"] = [[e.data["attr"], e.data["flag"]] for e in events if e.kind == "sync.audit"]
        faults = (DelayRank(rank=1, delay_ms=DIAG_STRAGGLER_MS, label="meta"),) if rank == 1 else ()
        events, _ = compute(faults)
        out["straggler"] = [{"rank": e.data["rank"], "skew_us": e.data["skew_us"]} for e in events if e.kind == "sync.straggler"]
        t0 = time.perf_counter()
        events, err = compute(policy={"deadline_ms": DIAG_DEADLINE_MS, "retries": 0},
                              late_s=3 * DIAG_DEADLINE_MS / 1e3 if rank == 1 else 0.0)
        out["deadline"] = {
            "error": err, "ms": (time.perf_counter() - t0) * 1e3,
            "degraded": [list(e.data["survivors"]) for e in events if e.kind == "sync.degraded"],
            "coverage": [[e.data["members"], e.data["excluded"]] for e in events if e.kind == "lineage.coverage"],
        }
        prov = provenance_of(mc._epoch_sync.stats.owner) if mc._epoch_sync is not None else None
        out["deadline"]["provenance"] = None if prov is None else prov.coverage
    with open(os.path.join(out_dir, f"diag_events{rank}.json"), "w") as f:
        json.dump([{"seq": e.seq, "ts_us": (rec.t0 + e.ts) * 1e6, "kind": e.kind, "owner": e.owner,
                    **{k: (v if isinstance(v, (int, float, bool, str)) else str(v)) for k, v in e.data.items()}}
                   for e in rec.snapshot()], f)
    return out


def run_diag_2rank() -> dict:
    """Two gloo ranks on the card: the straggler named on both, the deadline escape that
    degrades with it as the culprit (coverage: members ``(0,)``, 1 excluded), the NaN of
    rank 1 on both after the OR fold, the audit on both, and the merged timeline."""
    from torchmetrics_tpu_torch.diag import merge_timelines

    with _two_ranks(_diag_rank_body, DIAG_JOIN_TIMEOUT_S, "diag 2-rank", abandon=True) as (results, out_dir):
        streams = []
        for rank in range(2):
            with open(os.path.join(out_dir, f"diag_events{rank}.json")) as f:
                streams.append({"rank": rank, "events": json.load(f)})
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "timeline.json")
            trace = merge_timelines(streams, path=path)
            timeline = {"events": len(trace["traceEvents"]), "bytes": os.path.getsize(path)}
    for rank, r in enumerate(results):
        if r["calibrate_metadata_gathers"] != 1:
            raise AssertionError(f"diag 2-rank rank {rank}: {r['calibrate_metadata_gathers']} metadata gathers with the timeline on")
        if r["sentinel_bits"] != ["nan"]:
            raise AssertionError(f"diag 2-rank rank {rank}: sentinel {r['sentinel_bits']} after the OR fold")
        if ["tp", "rank-invariant-divergence"] not in r["audit"]:
            raise AssertionError(f"diag 2-rank rank {rank}: audit {r['audit']}")
        if [s["rank"] for s in r["straggler"]] != [1] or r["straggler"][0]["skew_us"] <= DIAG_STRAGGLER_US:
            raise AssertionError(f"diag 2-rank rank {rank}: straggler {r['straggler']}")
        if not all(r["launches"].values()):
            raise AssertionError(f"diag 2-rank rank {rank}: a kernel of the path was not launched: {r['launches']}")
    dl = results[0]["deadline"]
    if dl["error"] is not None or dl["degraded"] != [[0]] or ["0", "1:sync-fault"] not in dl["coverage"]:
        raise AssertionError(f"diag 2-rank: rank 0's deadline escape {dl}")
    if (dl["provenance"] or {}).get("members") != ["0"]:
        raise AssertionError(f"diag 2-rank: provenance coverage {dl['provenance']}")
    launches = {k: sum(r["launches"][k] for r in results) for k in ("stat_counts", "multi_threshold")}
    _log(f"  2 ranks: straggler rank {results[0]['straggler'][0]['rank']} skew {results[0]['straggler'][0]['skew_us']} /"
         f" {results[1]['straggler'][0]['skew_us']} µs; deadline escape {dl['ms']:.1f} ms -> degraded {dl['degraded']},"
         f" coverage {dl['provenance']}; rank 1: {results[1]['deadline']['error']}; sentinel {results[0]['sentinel_bits']} /"
         f" {results[1]['sentinel_bits']}; audit {results[0]['audit']}; timeline {timeline}")
    return {"ranks": results, "timeline": timeline, "launches": launches}


def run_diag(acc_batches: list, cifar_batches: list, gen: torch.Generator, smi: str) -> dict:
    """Phase 24: K1 and K2 against their plain versions, then the guarded paths, the
    planted cases and the two ranks."""
    t_phase = time.perf_counter()
    errors = {"stat_counts": check_stat_counts(gen), "multi_threshold": check_multi_threshold(gen)}
    out = {"card": smi, "kernel_errors": errors}
    out["guarded"] = run_diag_guarded(acc_batches, cifar_batches)
    out["planted"] = run_diag_planted()
    out["two_rank"] = run_diag_2rank()
    out["launches"] = {
        "guarded_accuracy": out["guarded"]["accuracy"]["launches"],
        "guarded_collection": out["guarded"]["collection"]["launches"],
        "auroc_log": out["guarded"]["auroc_log"]["launches"],
        "planted": out["planted"]["launches"],
        "two_rank": out["two_rank"]["launches"],
    }
    needed = {"guarded_accuracy": ("stat_counts",), "guarded_collection": ("stat_counts",),
              "auroc_log": ("multi_threshold",), "planted": ("stat_counts",), "two_rank": ("stat_counts", "multi_threshold")}
    for side, counts in out["launches"].items():
        if not all(counts[k] for k in needed[side]):
            raise AssertionError(f"phase 24 {side}: a kernel of the path was not launched: {counts}")
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"  phase 24: {out['phase_s']:.1f} s on {smi}; launches {out['launches']}")
    print(json.dumps({"diag_summary": {
        "card": smi,
        "overhead_us": {k: v["update_us"] for k, v in out["guarded"]["overhead"].items()},
        "device_us": {k: out["guarded"][k]["histograms"] for k in ("accuracy", "collection")},
        "device_busy_us_per_update": {k: out["guarded"][k]["device_busy_us_per_update"] for k in ("accuracy", "collection")},
        "probes": {k: out["guarded"][k]["probes"] for k in ("accuracy", "collection")},
        "auroc_readbacks": {k: out["guarded"]["auroc_log"][k] for k in ("update_readbacks", "compute_readbacks")},
        "compute_readbacks": {k: out["guarded"][k]["compute_readbacks"] for k in ("accuracy", "collection")},
        "planted": out["planted"]["card"], "two_rank": {
            "straggler": [r["straggler"] for r in out["two_rank"]["ranks"]],
            "deadline": out["two_rank"]["ranks"][0]["deadline"], "timeline": out["two_rank"]["timeline"]},
        "launches": out["launches"], "phase_s": out["phase_s"],
    }}), flush=True)
    return out


# ---------------------------------------------------------------- phase 25: the serving plane

SERVE_BUCKETS, SERVE_BUCKET_SIZE = 8, 4  # a 32-update trailing window at 4-update granularity
SERVE_UPDATES = 48  # the ring turns over
SERVE_TIMED = 16  # updates per timing arm and round
SERVE_ROUNDS = 5  # timing rounds, the arms in turns; medians
TENANT_UPDATES, TENANT_DISTINCT, TENANT_BATCH = 6000, 5000, 512
TENANT_CAPACITY, TENANT_POOL, TENANT_SAMPLE = 4096, 16, 32
SWEEP_TENANTS, SWEEP_CAPACITY = 10_000, 16384
SKETCH_UPDATES = 16
HLL_P, HLL_BATCH, HLL_DISTINCT, HLL_TOL = 14, 1 << 16, 10**6, 0.03
HH_K, HH_DEPTH, HH_WIDTH, HH_BATCH, HH_ZIPF, HH_TOP = 32, 4, 2048, 1 << 20, 1.1, 10
KLL_K, KLL_BATCH, KLL_CPU_UPDATES = 256, 1 << 16, 2
SNAP_UPDATES = 256  # the windowed loop a scrape thread reads while it runs
SNAP_CHECKED = 6  # watermarks held against a fresh run over their covered updates
SNAP_READS, SNAP_MAX_UPDATES = 12, 8192  # reads the scrape thread must make while the loop runs
FED_PODS, FED_UPDATES, FED_STREAM, FED_KLL = 4, 4, 1 << 16, 1 << 12  # KLL: 16 runs per update
SERVE_2RANK_UPDATES, SERVE_2RANK_IDS, SERVE_2RANK_KLL = 4, 24, 1 << 12  # per rank; the hh ids fit the top-k
SERVE_JOIN_TIMEOUT_S = 300


def _serve_reads(rec, kinds=("transfer.host", "transfer.blocked")) -> dict:
    """The recorder's readback events by ``kind:layer:op``."""
    counts: dict = {}
    for e in rec.snapshot():
        if e.kind in kinds:
            key = f"{e.kind}:{e.data.get('layer')}:{e.data.get('op')}"
            counts[key] = counts.get(key, 0) + 1
    return counts


def _serve_window(base, **kwargs):
    from torchmetrics_tpu_torch.serve import WindowedMetric

    return WindowedMetric(base, buckets=SERVE_BUCKETS, bucket_size=SERVE_BUCKET_SIZE, **kwargs)


def _covered(count: int) -> list:
    """The 0-based updates the ring covers after ``count`` updates."""
    last = (count - 1) // SERVE_BUCKET_SIZE
    return list(range(max(0, last - SERVE_BUCKETS + 1) * SERVE_BUCKET_SIZE, count))


def _serve_update_us(arms: dict, batches: list) -> dict:
    """Host µs per ``update`` (to a device sync) of each arm's metric, warmed, then
    SERVE_ROUNDS rounds with the arms in turns; medians and the runs."""
    for m in arms.values():
        for b in batches[:2]:
            m.update(*b)
    torch.cuda.synchronize()
    runs: dict = {name: [] for name in arms}
    for _ in range(SERVE_ROUNDS):
        for name, m in arms.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(SERVE_TIMED):
                m.update(*batches[i % len(batches)])
            torch.cuda.synchronize()
            runs[name].append((time.perf_counter() - t0) * 1e6 / SERVE_TIMED)
    return {"update_us": {k: statistics.median(v) for k, v in runs.items()}, "runs_us": runs}


def run_serve_windowed(acc_batches: list) -> dict:
    """Config #1 in a trailing window over 48 updates (the ring turns over), under the
    strict guard with the recorder on: 0 readbacks, one capture, no fallback, one K1
    launch per update, replays included; ``compute`` against a fresh metric over exactly
    the covered updates, every state against the port's CPU run; then the update µs
    against the bare metric's, eagerly and with the engine, in turns."""
    from torchmetrics_tpu_torch import MulticlassAccuracy
    from torchmetrics_tpu_torch.diag import diag_context, transfer_guard
    from torchmetrics_tpu_torch.engine import engine_context

    stream = [acc_batches[u % len(acc_batches)] for u in range(SERVE_UPDATES)]
    m = _serve_window(MulticlassAccuracy(ACC_CLASSES, validate_args=False))
    _zero_launches()
    with engine_context(True), diag_context(capacity=1 << 14) as rec, transfer_guard("strict"):
        for p, t in stream:
            m.update(p, t)
        torch.cuda.synchronize()
    launches = _launches()
    reads = _serve_reads(rec)
    st = m._engine.stats
    engine = {"traces": st.traces, "captures": st.captures, "replays": st.replays, "eager_fallbacks": st.eager_fallbacks}
    if reads:
        raise AssertionError(f"serve windowed: readbacks under the strict guard {reads}")
    if (st.captures, st.eager_fallbacks) != (1, 0) or launches["stat_counts"] != SERVE_UPDATES:
        raise AssertionError(f"serve windowed: engine {engine}, launches {launches}")
    value = m.compute()
    fresh = MulticlassAccuracy(ACC_CLASSES, validate_args=False, compiled_update=False)
    for u in _covered(SERVE_UPDATES):
        fresh.update(*stream[u])
    for key in fresh._defaults:
        if not torch.equal(getattr(m, "win_" + key).sum(0), getattr(fresh, key)):
            raise AssertionError(f"serve windowed: the folded ring's {key} differs from the covered updates'")
    _assert_close("serve windowed compute", value, fresh.compute(), ACC_ATOL)
    cpu = _serve_window(MulticlassAccuracy(ACC_CLASSES, validate_args=False, device="cpu"))
    cpu_batches = [(p.cpu(), t.cpu()) for p, t in acc_batches]
    for u in range(SERVE_UPDATES):
        cpu.update(*cpu_batches[u % len(cpu_batches)])
    _assert_states_equal("serve windowed", m, cpu)
    _assert_close("serve windowed against the CPU", value, cpu.compute(), ACC_ATOL)
    times = _serve_update_us(
        {
            "bare_eager": MulticlassAccuracy(ACC_CLASSES, validate_args=False, compiled_update=False),
            "bare_engine": MulticlassAccuracy(ACC_CLASSES, validate_args=False, compiled_update=True),
            "window_eager": _serve_window(MulticlassAccuracy(ACC_CLASSES, validate_args=False), compiled_update=False),
            "window_engine": _serve_window(MulticlassAccuracy(ACC_CLASSES, validate_args=False), compiled_update=True),
        },
        acc_batches,
    )
    _log(f"  windowed accuracy: {SERVE_UPDATES} updates, 0 readbacks, engine {engine}, launches {launches};"
         f" compute {float(value):.6f} over updates {_covered(SERVE_UPDATES)[0]}-{SERVE_UPDATES - 1};"
         " update µs " + ", ".join(f"{k} {v:.1f}" for k, v in times["update_us"].items()))
    return {"updates": SERVE_UPDATES, "launches": launches, "engine": engine, "readbacks": reads,
            "value": float(value), "times": times}


def run_serve_windowed_auroc(cifar_batches: list) -> dict:
    """Config #2's binned AUROC in the same window, under the log guard: its [0, 1] range
    check reads the host on every update (in both packages), so the engine falls back
    and each update launches K2 eagerly; the readbacks and launches are recorded."""
    from torchmetrics_tpu_torch import MulticlassAUROC
    from torchmetrics_tpu_torch.diag import diag_context, transfer_guard

    stream = [cifar_batches[u % len(cifar_batches)] for u in range(SERVE_UPDATES)]
    m = _serve_window(MulticlassAUROC(CIFAR_CLASSES, thresholds=N_THRESH, validate_args=False))
    _zero_launches()
    with diag_context(capacity=1 << 14) as rec:
        with transfer_guard("log"):
            for p, t in stream:
                m.update(p, t)
            torch.cuda.synchronize()
    launches = _launches()
    reads = _serve_reads(rec, ("transfer.host",))
    blocked = _serve_reads(rec, ("transfer.blocked",))
    st = m._engine.stats
    if blocked or reads.get("transfer.host:python:Tensor.__bool__", 0) < SERVE_UPDATES:
        raise AssertionError(f"serve windowed auroc: readbacks {reads}, blocked {blocked}")
    if launches["multi_threshold"] < SERVE_UPDATES:
        raise AssertionError(f"serve windowed auroc: K2 launched {launches['multi_threshold']} times over {SERVE_UPDATES} updates")
    value = m.compute()
    fresh = MulticlassAUROC(CIFAR_CLASSES, thresholds=N_THRESH, validate_args=False, compiled_update=False)
    for u in _covered(SERVE_UPDATES):
        fresh.update(*stream[u])
    _assert_close("serve windowed auroc compute", value, fresh.compute(), AUROC_ATOL)
    cpu = _serve_window(MulticlassAUROC(CIFAR_CLASSES, thresholds=N_THRESH, validate_args=False, device="cpu"))
    for p, t in stream:
        cpu.update(p.cpu(), t.cpu())
    _assert_states_equal("serve windowed auroc", m, cpu)
    _log(f"  windowed auroc (T={N_THRESH}): {SERVE_UPDATES} updates under the log guard, readbacks {reads};"
         f" fallbacks {dict(st.fallback_reasons)}; launches {launches}; compute {float(value):.6f}")
    return {"updates": SERVE_UPDATES, "launches": launches, "readbacks": reads,
            "fallback_reasons": dict(st.fallback_reasons), "value": float(value)}


def _tenant_stream(seed: int = 25) -> tuple:
    """6000 updates from 5000 distinct 40-bit tenant ids (each once, then 1000 repeats,
    shuffled), each update a seeded pick from the pool of batches."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = np.unique(rng.integers(0, 1 << 40, 2 * TENANT_DISTINCT))[:TENANT_DISTINCT]
    ids = rng.permutation(ids)
    order = np.concatenate([ids, rng.choice(ids, TENANT_UPDATES - TENANT_DISTINCT)])
    rng.shuffle(order)
    return order, rng.integers(0, TENANT_POOL, TENANT_UPDATES)


def run_serve_tenants(gen: torch.Generator) -> dict:
    """``TenantSlices`` over config #1 (macro accuracy over 1000 classes, capacity 4096)
    for 6000 updates of 512 x 1000 logits from 5000 distinct tenants, so the table
    spills: under the strict guard, one capture for every tenant, one K1 launch per
    update; the global state and a seeded sample of 32 tracked tenants exact against
    the CPU's counts, an untracked tenant ``None``. Then the sum sweep (capacity 16384,
    10^4 tenants) timed."""
    import numpy as np

    from torchmetrics_tpu_torch import MulticlassAccuracy, SumMetric
    from torchmetrics_tpu_torch.diag import diag_context, transfer_guard
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.serve import TenantSlices
    from torchmetrics_tpu_torch.serve.snapshot import read_host
    from torchmetrics_tpu_torch.serve.window import run_base_compute

    pool_cpu = [
        (torch.randn(TENANT_BATCH, ACC_CLASSES, generator=gen), torch.randint(0, ACC_CLASSES, (TENANT_BATCH,), generator=gen))
        for _ in range(TENANT_POOL)
    ]
    pool = [(p.cuda(), t.cuda()) for p, t in pool_cpu]
    order, picks = _tenant_stream()
    ids = torch.as_tensor(order, device="cuda")
    make = lambda device=None: MulticlassAccuracy(ACC_CLASSES, average="macro", validate_args=False, device=device)  # noqa: E731
    t = TenantSlices(make(), capacity=TENANT_CAPACITY)
    torch.cuda.synchronize()
    _zero_launches()
    with engine_context(True), diag_context(capacity=1 << 14) as rec, transfer_guard("strict"):
        t0 = time.perf_counter()
        for u in range(TENANT_UPDATES):
            t.update(ids[u], *pool[picks[u]])
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    launches = _launches()
    reads = _serve_reads(rec)
    st = t._engine.stats
    engine = {"traces": st.traces, "captures": st.captures, "replays": st.replays, "eager_fallbacks": st.eager_fallbacks}
    if reads:
        raise AssertionError(f"serve tenants: readbacks under the strict guard {reads}")
    if (st.traces, st.captures, st.eager_fallbacks) != (1, 1, 0) or launches["stat_counts"] != TENANT_UPDATES:
        raise AssertionError(f"serve tenants: engine {engine}, launches {launches}")
    footprint = t.state_footprint()
    # the CPU's counts: each pool batch's contribution, weighted by how often it came
    contrib = []
    for p, tg in pool_cpu:
        c = make("cpu")
        c.update(p, tg)
        contrib.append({k: getattr(c, k).to(torch.int64) for k in c._defaults})
    keys = tuple(contrib[0])
    uses = np.bincount(picks, minlength=TENANT_POOL)
    want_global = {k: sum(int(uses[b]) * contrib[b][k] for b in range(TENANT_POOL)) for k in keys}
    for k in keys:
        if not torch.equal(getattr(t, "seg_" + k).sum(0).cpu().to(torch.int64), want_global[k]):
            raise AssertionError(f"serve tenants: the global {k} differs from the CPU's counts")
    template_cpu = make("cpu")
    _assert_close("serve tenants global compute", t.compute(),
                  run_base_compute(template_cpu, {k: v.to(torch.int32) for k, v in want_global.items()}), ACC_ATOL)
    tenant_count, spilled = t.tenant_count(), t.spilled_count()
    rng = np.random.default_rng(26)
    distinct = np.unique(order)
    table = read_host(t, ("tenant_ids",))["tenant_ids"]
    tracked = [int(i) for i in distinct if t._host_slot(int(i), table) is not None]
    untracked = [int(i) for i in distinct if t._host_slot(int(i), table) is None]
    if len(tracked) != tenant_count or not untracked or spilled == 0:
        raise AssertionError(f"serve tenants: {len(tracked)} tracked of {tenant_count}, {len(untracked)} untracked, {spilled} spilled")
    for tid in rng.choice(tracked, TENANT_SAMPLE, replace=False):
        tid = int(tid)
        mask = order == tid
        want = {k: sum(int(n) * contrib[b][k] for b, n in enumerate(np.bincount(picks[mask], minlength=TENANT_POOL))) for k in keys}
        rows = read_host(t, tuple("seg_" + k for k in keys), index=t._host_slot(tid, table))
        for k in keys:
            if not np.array_equal(rows["seg_" + k].astype(np.int64), want[k].numpy()):
                raise AssertionError(f"serve tenants: tenant {tid}'s {k} differs from the CPU's counts")
        _assert_close(f"serve tenant {tid}", t.tenant_value(tid),
                      run_base_compute(template_cpu, {k: v.to(torch.int32) for k, v in want.items()}), ACC_ATOL)
        if t.tenant_updates(tid) != int(mask.sum()):
            raise AssertionError(f"serve tenants: tenant {tid} counted {t.tenant_updates(tid)} updates, sent {int(mask.sum())}")
    if any(t.tenant_value(int(i)) is not None for i in untracked[:TENANT_SAMPLE]):
        raise AssertionError("serve tenants: an untracked tenant gave a value")
    report = t.spill_report()
    del t
    gc.collect()
    # the sum sweep: one tenant per update, 10^4 of them, one graph
    sweep = TenantSlices(SumMetric(nan_strategy=0.0), capacity=SWEEP_CAPACITY)
    sweep_ids = torch.arange(SWEEP_TENANTS, device="cuda")
    sweep_vals = (sweep_ids + 1).to(torch.float32)
    with engine_context(True), diag_context(capacity=1 << 12) as srec, transfer_guard("strict"):
        t0 = time.perf_counter()
        for tid in range(SWEEP_TENANTS):
            sweep.update(sweep_ids[tid], sweep_vals[tid])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
    sw = sweep._engine.stats
    want_total = SWEEP_TENANTS * (SWEEP_TENANTS + 1) / 2
    if _serve_reads(srec) or (sw.traces, sw.eager_fallbacks) != (1, 0):
        raise AssertionError(f"serve sweep: readbacks {_serve_reads(srec)}, traces {sw.traces}, fallbacks {sw.eager_fallbacks}")
    if abs(float(sweep.compute()) - want_total) > 1e-5 * want_total:  # float32 sums over 16385 slots
        raise AssertionError(f"serve sweep: global {float(sweep.compute())}, expected {want_total}")
    spot = {tid: sweep.tenant_value(tid) for tid in (0, 1234, 5678, 9999)}
    if any(v is not None and float(v) != tid + 1 for tid, v in spot.items()):
        raise AssertionError(f"serve sweep: spot values {spot}")
    out = {
        "updates": TENANT_UPDATES, "distinct": TENANT_DISTINCT, "launches": launches, "engine": engine,
        "state_bytes": footprint["total_bytes"], "tenant_count": tenant_count, "spilled_count": spilled,
        "untracked": len(untracked), "spill_heavy_hitters": len(report["heavy_hitters"]),
        "loop_s": loop_s, "update_us": loop_s * 1e6 / TENANT_UPDATES,
        "sweep": {"tenants": SWEEP_TENANTS, "update_us": sweep_s * 1e6 / SWEEP_TENANTS, "traces": sw.traces,
                  "tracked": sweep.tenant_count(), "spilled": sweep.spilled_count(),
                  "state_bytes": sweep.state_footprint()["total_bytes"]},
    }
    _log(f"  tenants: {TENANT_UPDATES} updates from {TENANT_DISTINCT} tenants, 0 readbacks, engine {engine},"
         f" launches {launches}; {footprint['total_bytes'] / 1e6:.1f} MB of state; {tenant_count} tracked,"
         f" {spilled} spilled updates; {out['update_us']:.1f} µs per update; sweep {out['sweep']}")
    return out


def _sketch_streams(seed: int = 27) -> dict:
    """Host streams: 16 x 2^16 ids holding exactly 10^6 distinct 62-bit ids, 16 x 2^20
    Zipf(1.1) ids, 16 x 2^16 log-normal latencies (ms)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    distinct = rng.permutation(np.unique(rng.integers(0, 1 << 62, HLL_DISTINCT + 1000)))[:HLL_DISTINCT]
    hll = np.concatenate([distinct, rng.choice(distinct, SKETCH_UPDATES * HLL_BATCH - HLL_DISTINCT)])
    rng.shuffle(hll)
    return {
        "hll": hll.reshape(SKETCH_UPDATES, HLL_BATCH),
        "hh": rng.zipf(HH_ZIPF, (SKETCH_UPDATES, HH_BATCH)).astype(np.int64),
        "kll": rng.lognormal(mean=3.0, sigma=1.0, size=(SKETCH_UPDATES, KLL_BATCH)).astype(np.float32),
    }


def _sketch_timing(eager, engine, batches: list, eager_updates: int, profile_eager: bool) -> dict:
    """µs per update of an eager metric (after one warm-up update where
    ``eager_updates > 1``: the first call loads the kernels) and of an already built
    engine metric's replays, and the device operations of one update (both routes
    run the same operations; ``profile_eager`` profiles the eager one too)."""
    if eager_updates > 1:
        eager.update(batches[-1])
    torch.cuda.synchronize()
    out = {}
    for name, m, n in (("eager", eager, eager_updates), ("replayed", engine, len(batches))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            m.update(batches[i % len(batches)])
        torch.cuda.synchronize()
        out[f"{name}_us"] = (time.perf_counter() - t0) * 1e6 / n
        if name == "replayed" or profile_eager:
            out[f"{name}_device_ops"] = _device_profile(lambda i, m=m: m.update(batches[i % len(batches)]), iters=1)["device_ops"]
    return out


def run_serve_sketches() -> dict:
    """HLL (p=14) over 10^6 distinct ids (±3 %), HeavyHitters over Zipf(1.1) ids (the
    true top 10 among its 32), KLL (k=256) over log-normal latencies (p50 and p99 within
    the proven rank bound), with the engine; registers, grid, top-k pair and compactors
    bit-equal to the port's CPU run (KLL's after its first 4 updates)."""
    import numpy as np

    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.serve import CardinalitySketch, HeavyHitters, KLLSketch

    streams = _sketch_streams()
    makers = {
        "hll": lambda device=None, **kw: CardinalitySketch(p=HLL_P, device=device, **kw),
        "hh": lambda device=None, **kw: HeavyHitters(k=HH_K, depth=HH_DEPTH, width=HH_WIDTH, device=device, **kw),
        "kll": lambda device=None, **kw: KLLSketch(k=KLL_K, device=device, **kw),
    }
    out = {}
    for name, make in makers.items():
        t0 = time.perf_counter()
        host = streams[name]
        batches = [torch.as_tensor(host[u], device="cuda") for u in range(SKETCH_UPDATES)]
        m = make()
        cpu = make("cpu")
        cpu_updates = KLL_CPU_UPDATES if name == "kll" else SKETCH_UPDATES
        held = None
        with engine_context(True):
            for u, b in enumerate(batches):
                m.update(b)
                if u + 1 == cpu_updates:
                    held = {k: getattr(m, k).clone() for k in m._defaults}
        torch.cuda.synchronize()
        st = m._engine.stats
        for u in range(cpu_updates):
            cpu.update(torch.as_tensor(host[u]))
        for k in m._defaults:
            if not torch.equal(held[k].cpu(), getattr(cpu, k)):
                raise AssertionError(f"serve sketch {name}: state {k} differs from the CPU run after {cpu_updates} updates")
        if (st.traces, st.eager_fallbacks) != (1, 0):
            raise AssertionError(f"serve sketch {name}: traces {st.traces}, fallbacks {dict(st.fallback_reasons)}")
        row = {"updates": SKETCH_UPDATES, "captures": st.captures, "replays": st.replays}
        if name == "hll":
            est = float(m.compute())
            row.update(estimate=est, truth=HLL_DISTINCT, rel_err=abs(est - HLL_DISTINCT) / HLL_DISTINCT)
            if row["rel_err"] > HLL_TOL:
                raise AssertionError(f"serve hll: estimate {est} of {HLL_DISTINCT} distinct ids")
        elif name == "hh":
            ids, counts = (x.cpu().numpy() for x in m.compute())
            values, freq = np.unique(host, return_counts=True)
            top = values[np.argsort(-freq, kind="stable")[:HH_TOP]]
            missing = sorted(set(top.tolist()) - set(ids.tolist()))
            row.update(true_top=top.tolist(), found=ids[:HH_TOP].tolist(), counts=counts[:HH_TOP].tolist())
            if missing:
                raise AssertionError(f"serve heavy hitters: the true top {HH_TOP} ids {missing} are not among the {HH_K}")
        else:
            sorted_all = np.sort(host.reshape(-1))
            n = sorted_all.size
            bound = m.rank_error_bound(n)
            est = m.compute().cpu().numpy()
            row["quantiles"] = {}
            for q, e in zip(m.qs, est):
                rank = int(np.searchsorted(sorted_all, e, side="right"))
                target = math.ceil(q * n)
                row["quantiles"][str(q)] = {"estimate": float(e), "exact": float(sorted_all[target - 1]), "rank_error": rank - target}
                if abs(rank - target) > bound:
                    raise AssertionError(f"serve kll: q={q} estimate {e} at rank {rank}, exact rank {target}, bound {bound}")
            row["rank_error_bound"] = bound
        t_check = time.perf_counter() - t0
        # KLL: one eager update (~156k launches), and one profiler window (a window of
        # that many events takes ~40 s to read)
        row.update(_sketch_timing(make(compiled_update=False), m, batches, 1 if name == "kll" else 4, name != "kll"))
        row["check_s"], row["total_s"] = t_check, time.perf_counter() - t0
        out[name] = row
        _log(f"  sketch {name}: {row}")
    return out


def run_serve_snapshot_sidecar(acc_batches: list) -> dict:
    """A scrape thread reads ``snapshot_compute()`` and the sidecar's endpoints while the
    windowed loop runs under the strict guard: the loop reads nothing back, updates land
    between a snapshot and its read, every frozen value equals a fresh run over the
    updates its watermark covers, the live value moves on. Then two sidecars' telemetry
    merged by a ``FleetTelemetry`` and its SLOs, with a planted degraded pull."""
    import urllib.error
    import urllib.request

    import numpy as np

    from torchmetrics_tpu_torch import MulticlassAccuracy
    from torchmetrics_tpu_torch.diag import diag_context, hist, slo_context, transfer_guard
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.parallel import RankDrop, fault_context
    from torchmetrics_tpu_torch.serve import FleetTelemetry, MetricsSidecar, snapshot_compute, take_snapshot
    from torchmetrics_tpu_torch.serve import stats as serve_stats

    stream = lambda u: acc_batches[u % len(acc_batches)]  # noqa: E731
    m = _serve_window(MulticlassAccuracy(ACC_CLASSES, validate_args=False))
    with engine_context(True):
        m.update(*stream(0))  # the build, before the scraper starts
    torch.cuda.synchronize()

    def get(port: int, path: str) -> tuple:
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
                status, ctype, body = resp.status, resp.headers.get("Content-Type"), resp.read()
        except urllib.error.HTTPError as err:
            status, ctype, body = err.code, err.headers.get("Content-Type"), err.read()
        return status, ctype, body, (time.perf_counter() - t0) * 1e3

    paths = ("/metrics", "/healthz", "/slo", "/state", "/telemetry.bin")
    side = torch.cuda.Stream()
    serve_stats.reset_serve_stats()
    snaps: list = []
    scrapes: list = []
    errors: list = []
    started, done = threading.Event(), threading.Event()
    hist.reset_histograms()
    with MetricsSidecar(port=0, state_target={"window": m}) as sidecar:

        def scraper() -> None:
            try:
                i = 0
                while not done.is_set() or i < 4:
                    # a snapshot, one sidecar scrape, then the value read: the loop
                    # keeps updating between the snapshot and its read
                    snap = take_snapshot(m)
                    path = paths[i % len(paths)]
                    status, ctype, body, ms = get(sidecar.port, path)
                    scrapes.append({"path": path, "status": status, "type": ctype, "bytes": len(body), "ms": ms,
                                    "tm_tpu_serve": b"tm_tpu_serve_" in body})
                    value = snapshot_compute(m, snap)
                    snaps.append((snap.update_count, value, m.update_count))
                    started.set()
                    i += 1
            except BaseException as err:  # noqa: BLE001 -- reported to the loop thread
                errors.append(f"{type(err).__name__}: {err}")
                started.set()

        thread = threading.Thread(target=scraper, name="serve-scraper", daemon=True)
        thread.start()
        if not started.wait(120):
            raise AssertionError("serve snapshot: the scrape thread never took a snapshot")
        with engine_context(True), diag_context(capacity=1 << 14) as rec, transfer_guard("strict"):
            # back to back, in two halves: the first on the default stream, the second on
            # a side stream (a snapshot's copy must follow the stream that wrote last; the
            # switch waits, as a loop's own writes must). Each half runs SNAP_UPDATES / 2
            # updates at least, and on until the scrape thread has read SNAP_READS / 2
            # times during it
            u = 1
            for half, on in enumerate((None, side)):
                torch.cuda.synchronize()
                first_read, half_end, switch = len(snaps), (half + 1) * SNAP_UPDATES // 2, u
                with torch.cuda.stream(on):
                    while u <= half_end or (len(snaps) - first_read < SNAP_READS // 2 and u < (half + 1) * SNAP_MAX_UPDATES // 2):
                        m.update(*stream(u))
                        u += 1
            torch.cuda.synchronize()
        done.set()
        loop_updates = u
        thread.join(300)
        if thread.is_alive() or errors:
            raise AssertionError(f"serve snapshot: scrape thread alive {thread.is_alive()}, errors {errors}")
        server_hist = {r["series"]: r for r in hist.histograms_snapshot() if r["owner"] == "sidecar"}
    served = serve_stats.serve_state()
    reads = _serve_reads(rec)
    if reads:
        raise AssertionError(f"serve snapshot: readbacks in the loop {reads}")
    between = [after - w for w, _, after in snaps]
    if max(between) <= 0:
        raise AssertionError(f"serve snapshot: no update landed between a snapshot and its read ({len(snaps)} snapshots)")
    watermarks = sorted({w for w, _, _ in snaps})
    # the side stream wrote every update from `switch` on
    if not (watermarks[0] < switch <= watermarks[-1]):
        raise AssertionError(f"serve snapshot: no snapshot in each half of the loop (watermarks {watermarks}, switch {switch})")
    # every watermark taken while the loop ran on the side stream, and a spread of the rest
    early = [w for w in watermarks if w < switch]
    checked = sorted({early[i] for i in np.linspace(0, len(early) - 1, min(SNAP_CHECKED, len(early))).astype(int)}
                     | {w for w in watermarks if w >= switch})
    for w in checked:
        value = next(v for ww, v, _ in snaps if ww == w)
        fresh = MulticlassAccuracy(ACC_CLASSES, validate_args=False, compiled_update=False)
        for u in _covered(w):
            fresh.update(*stream(u))
        _assert_close(f"serve snapshot at watermark {w}", value, fresh.compute(), ACC_ATOL)
    live = float(m.compute())
    if live == float(snaps[0][1]):
        raise AssertionError("serve snapshot: the live value never moved from the first snapshot's")
    bad = [s for s in scrapes if s["status"] != 200]
    metrics_ok = [s for s in scrapes if s["path"] == "/metrics"]
    if bad or not metrics_ok or not all(s["type"] == "text/plain; version=0.0.4" and s["tm_tpu_serve"] for s in metrics_ok):
        raise AssertionError(f"serve sidecar: scrapes {bad or metrics_ok}")
    client_ms = np.asarray([s["ms"] for s in scrapes])
    out = {
        "loop_updates": loop_updates, "snapshots": len(snaps), "updates_between_max": max(between),
        "updates_between_mean": float(np.mean(between)), "watermarks_checked": checked,
        "side_stream_from": switch, "side_stream_snapshots": sum(w >= switch for w, _, _ in snaps), "readbacks": reads,
        "snapshot_retries": served["snapshot_retries"], "snapshots_counted": served["snapshots"],
        "scrapes": len(scrapes), "scrapes_by_path": {p: sum(s["path"] == p for s in scrapes) for p in paths},
        "scrape_client_ms": {"p50": float(np.percentile(client_ms, 50)), "p99": float(np.percentile(client_ms, 99))},
        "scrape_server_us": {k: server_hist["scrape_us"][k] for k in ("count", "p50", "p99")} if "scrape_us" in server_hist else None,
    }
    # the fleet: two pods' telemetry envelopes merged, the SLOs evaluated on the merge
    with MetricsSidecar(port=0) as a, MetricsSidecar(port=0) as b:
        fleet = FleetTelemetry({"a": f"http://127.0.0.1:{a.port}/telemetry.bin", "b": f"http://127.0.0.1:{b.port}/telemetry.bin"})
        with MetricsSidecar(port=0, fleet_target=fleet) as fs, slo_context(100.0, 10.0):
            first = fleet.pull_round()
            status, _, body, _ = get(fs.port, "/fleet/slo")
            before = next(r for r in json.loads(body) if r["id"] == "fleet-degraded-pulls")
            with fault_context(RankDrop(1, label="fleet-pull*")):
                planted = fleet.pull_round()
            status2, _, body2, _ = get(fs.port, "/fleet/slo")
            after = next(r for r in json.loads(body2) if r["id"] == "fleet-degraded-pulls")
            status3, ctype3, body3, _ = get(fs.port, "/fleet/metrics")
    if first != {"a": True, "b": True} or planted.get("b") is not False or (status, status2) != (200, 200):
        raise AssertionError(f"serve fleet: pulls {first} then {planted}, status {status} {status2}")
    if before["breaching"] or not (after["breaching"] and after["blocking"]) or status3 != 200:
        raise AssertionError(f"serve fleet: fleet-degraded-pulls {before} then {after}; /fleet/metrics {status3}")
    out["fleet"] = {"pulls": first, "planted": planted, "slo_before": before, "slo_after": after,
                    "fleet_metrics_bytes": len(body3), "fleet_metrics_type": ctype3}
    _log(f"  snapshot + sidecar: {len(snaps)} snapshots over {loop_updates} updates, updates between ≤ {max(between)},"
         f" 0 readbacks; {len(scrapes)} scrapes, client ms {out['scrape_client_ms']}, server µs {out['scrape_server_us']};"
         f" fleet slo {before['breaching']} -> {after['breaching']}")
    return out


def _fed_members(device=None) -> tuple:
    """One pod's metrics: config #2's collection and the three sketches."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.serve import CardinalitySketch, HeavyHitters, KLLSketch

    mc = MetricCollection(_collection_members(device=device, validate_args=False))
    sketches = {"hll": CardinalitySketch(p=HLL_P, device=device), "hh": HeavyHitters(k=HH_K, depth=HH_DEPTH, width=HH_WIDTH, device=device),
                "kll": KLLSketch(k=KLL_K, device=device)}
    return mc, sketches


def _fed_pod(seed: int) -> tuple:
    """One pod on the card over its own seeded batches: ``(collection, sketches)``."""
    import numpy as np

    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    mc, sketches = _fed_members()
    for _ in range(FED_UPDATES):
        scores = torch.randn(CIFAR_BATCH, CIFAR_CLASSES, generator=gen).softmax(dim=1).cuda()
        target = torch.randint(0, CIFAR_CLASSES, (CIFAR_BATCH,), generator=gen).cuda()
        mc.update(scores, target)
        sketches["hll"].update(torch.as_tensor(rng.integers(0, 1 << 40, FED_STREAM), device="cuda"))
        sketches["hh"].update(torch.as_tensor(rng.zipf(HH_ZIPF, FED_STREAM), device="cuda"))
        sketches["kll"].update(torch.as_tensor(rng.lognormal(3.0, 1.0, FED_KLL).astype(np.float32), device="cuda"))
    return mc, sketches


def _fed_targets(mc, sketches) -> dict:
    return {**dict(mc.items(keep_base=True, copy_state=False)), **sketches}


def run_serve_federation() -> dict:
    """Four pods on the card, each config #2's collection and the three sketches: their
    envelopes ingested in a shuffled order and folded, the fold equal to the pods'
    ``merge_state`` fold (the heavy-hitter pair to its joint fold over the merged grid)
    and byte-stable across two arrival orders; one pod made stale, the next fold over
    three pods, stamped degraded."""
    import random

    from torchmetrics_tpu_torch.serve import FederationAggregator, pack_envelope
    from torchmetrics_tpu_torch.serve.sketch import merge_topk

    _zero_launches()
    pods = {f"pod{i}": _fed_pod(300 + i) for i in range(FED_PODS)}
    torch.cuda.synchronize()
    launches = _launches()
    if min(launches.values()) < FED_PODS * FED_UPDATES:
        raise AssertionError(f"serve federation: pod launches {launches}")
    envelopes = {pid: pack_envelope(_fed_targets(*pod)) for pid, pod in pods.items()}
    env_bytes = {pid: len(e[0]) for pid, e in envelopes.items()}

    def template():
        return _fed_targets(*_fed_members())  # a definition only: the aggregator never reads its state

    order = list(pods)
    random.Random(28).shuffle(order)
    folds = []
    for arrival in (order, list(reversed(order))):
        agg = FederationAggregator(template())
        for pid in arrival:
            agg.ingest(pid, *envelopes[pid])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        folded = agg.fold()
        torch.cuda.synchronize()
        folds.append((agg, folded, (time.perf_counter() - t0) * 1e3))
    (agg, folded, fold_ms), (_, folded2, fold2_ms) = folds
    for owner, states in folded.items():
        for attr, v in states.items():
            w = folded2[owner][attr]
            if v.dtype != w.dtype or v.cpu().numpy().tobytes() != w.cpu().numpy().tobytes():
                raise AssertionError(f"serve federation: {owner}.{attr} differs between two arrival orders")

    def merged(members: list) -> dict:
        out = {}
        for owner in folded:
            m = _fed_targets(*pods[members[0]])[owner].clone()
            for pid in members[1:]:
                m.merge_state(_fed_targets(*pods[pid])[owner])
            out[owner] = m
        return out

    def hold(fold: dict, members: list, name: str) -> dict:
        ref = merged(members)
        for owner, states in fold.items():
            for attr, v in states.items():
                if owner == "hh" and attr in ("hh_ids", "hh_counts"):
                    continue
                if not torch.equal(v, getattr(ref[owner], attr)):
                    raise AssertionError(f"{name}: {owner}.{attr} differs from the merge_state fold")
        ids, counts = merge_topk(fold["hh"]["cms"], torch.cat([_fed_targets(*pods[p])["hh"].hh_ids for p in members]), HH_K, HH_DEPTH, HH_WIDTH)
        if not (torch.equal(ids, fold["hh"]["hh_ids"]) and torch.equal(counts, fold["hh"]["hh_counts"])):
            raise AssertionError(f"{name}: the top-k pair differs from the joint fold over the merged grid")
        return ref

    ref = hold(folded, sorted(pods), "serve federation")
    values = agg.compute_global()
    for owner in ("acc", "acc_w", "auroc", "hll"):
        _assert_close(f"serve federation {owner}", values[owner], ref[owner].compute(), AUROC_ATOL)
    # a stale pod: the next fold covers the other three, stamped degraded
    stale = FederationAggregator(template(), staleness_s=3600.0)
    for pid in order:
        stale.ingest(pid, *envelopes[pid])
    stale._slots["pod2"].ts -= 7200.0
    degraded = stale.fold()
    coverage = stale.last_coverage
    hold(degraded, ["pod0", "pod1", "pod3"], "serve federation degraded")
    if stale.stats.federation_degraded_folds != 1 or [e["id"] for e in coverage["excluded"]] != ["pod2"] or coverage["complete"]:
        raise AssertionError(f"serve federation: degraded fold coverage {coverage}")
    out = {"pods": FED_PODS, "launches": launches, "envelope_bytes": env_bytes, "fold_ms": [fold_ms, fold2_ms],
           "owners": sorted(folded), "degraded_coverage": coverage, "ingests": agg.stats.federation_ingests}
    _log(f"  federation: {FED_PODS} pods, envelopes {env_bytes} B, fold {fold_ms:.1f} / {fold2_ms:.1f} ms,"
         f" byte-stable; degraded fold excludes {coverage['excluded']}")
    return out


def _serve_rank_streams(rank: int) -> dict:
    import numpy as np

    rng = np.random.default_rng(400 + rank)
    return {
        "hll": rng.integers(0, 1 << 40, (SERVE_2RANK_UPDATES, HLL_BATCH)),
        "hh": (rng.zipf(1.3 + 0.2 * rank, (SERVE_2RANK_UPDATES, HLL_BATCH)) + 5 * rank) % SERVE_2RANK_IDS,
        "kll": rng.lognormal(3.0, 1.0, (SERVE_2RANK_UPDATES, SERVE_2RANK_KLL)).astype(np.float32),
    }


def _serve_rank_sketches() -> dict:
    """The three sketches, eager (the packed sync is what the ranks hold)."""
    from torchmetrics_tpu_torch.serve import CardinalitySketch, HeavyHitters, KLLSketch

    kw = {"compiled_update": False}
    return {"hll": CardinalitySketch(p=HLL_P, **kw), "hh": HeavyHitters(k=HH_K, depth=HH_DEPTH, width=HH_WIDTH, **kw),
            "kll": KLLSketch(k=KLL_K, **kw)}


def _serve_rank_body(rank: int, out_dir: str) -> dict:
    """One rank: its sketches over its own stream, synced through the packed plan, held
    against the single-rank union of both streams (the compactors against
    ``kll_merge`` of the two)."""
    from torchmetrics_tpu_torch.serve.quantile import kll_merge

    streams = [_serve_rank_streams(r) for r in range(2)]
    local, union = _serve_rank_sketches(), _serve_rank_sketches()
    per_rank = [_serve_rank_sketches()["kll"] for _ in range(2)]
    for name in local:
        for u in range(SERVE_2RANK_UPDATES):
            local[name].update(torch.as_tensor(streams[rank][name][u], device="cuda"))
        for r in range(2):
            for u in range(SERVE_2RANK_UPDATES):
                batch = torch.as_tensor(streams[r][name][u], device="cuda")
                if name == "kll":
                    per_rank[r].update(batch)
                else:
                    union[name].update(batch)
    collectives = {}
    for name, m in local.items():
        with m.sync_context():
            synced = {k: getattr(m, k).clone() for k in m._defaults}
        collectives[name] = m._epoch.stats.sync_collectives if m._epoch is not None else None
        if name == "kll":
            want = {"compactors": kll_merge(torch.stack([per_rank[0].compactors, per_rank[1].compactors])),
                    "geo_counts": per_rank[0].geo_counts + per_rank[1].geo_counts}
        else:
            want = {k: getattr(union[name], k) for k in m._defaults}
        for k, v in want.items():
            if not torch.equal(synced[k], v):
                raise AssertionError(f"rank {rank}: the synced {name}.{k} differs from the single-rank union")
    return {"collectives": collectives, "top": local["hh"].hh_ids[:4].tolist()}


def run_serve_2rank() -> dict:
    """Two gloo ranks on the one card, each with its own sketch streams, synced through
    the packed plan: registers, grid and joint top-k equal to the single-rank union,
    compactors to ``kll_merge`` of the two."""
    with _two_ranks(_serve_rank_body, SERVE_JOIN_TIMEOUT_S, "serve sketch 2-rank") as (results, _):
        out = {"ranks": results}
    _log(f"  sketch_2rank: collectives per sync {results[0]['collectives']}, equal to the union on both ranks")
    return out


def run_serve(acc_batches: list, cifar_batches: list, gen: torch.Generator, smi: str) -> dict:
    """Phase 25: K1 and K2 against their plain versions, then the serving plane on the
    card with the engine on."""
    t_phase = time.perf_counter()
    errors = {"stat_counts": check_stat_counts(gen), "multi_threshold": check_multi_threshold(gen)}
    out = {"card": smi, "kernel_errors": errors}
    out["subphase_s"] = {}
    for name, run in (
        ("windowed", lambda: run_serve_windowed(acc_batches)),
        ("windowed_auroc", lambda: run_serve_windowed_auroc(cifar_batches)),
        ("tenants", lambda: run_serve_tenants(gen)),
        ("sketches", run_serve_sketches),
        ("snapshot", lambda: run_serve_snapshot_sidecar(acc_batches)),
        ("federation", run_serve_federation),
        ("sketch_2rank", run_serve_2rank),
    ):
        t0 = time.perf_counter()
        out[name] = run()
        out["subphase_s"][name] = time.perf_counter() - t0
        gc.collect()
    out["launches"] = {
        "windowed_engine": out["windowed"]["launches"],
        "windowed_auroc": out["windowed_auroc"]["launches"],
        "tenants_engine": out["tenants"]["launches"],
        "federation": out["federation"]["launches"],
    }
    needed = {"windowed_engine": ("stat_counts",), "windowed_auroc": ("multi_threshold",),
              "tenants_engine": ("stat_counts",), "federation": ("stat_counts", "multi_threshold")}
    for side, counts in out["launches"].items():
        if not all(counts[k] for k in needed[side]):
            raise AssertionError(f"phase 25 {side}: a kernel of the path was not launched: {counts}")
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"  phase 25: {out['phase_s']:.1f} s on {smi}; launches {out['launches']}")
    print(json.dumps({"serve_summary": {
        "card": smi,
        "windowed": {k: out["windowed"][k] for k in ("engine", "readbacks", "launches")},
        "windowed_update_us": out["windowed"]["times"]["update_us"],
        "windowed_auroc": {k: out["windowed_auroc"][k] for k in ("readbacks", "launches", "fallback_reasons")},
        "tenants": {k: out["tenants"][k] for k in ("engine", "launches", "state_bytes", "tenant_count", "spilled_count",
                                                   "update_us", "sweep")},
        "sketches": {k: {kk: v for kk, v in row.items() if kk.endswith(("_us", "_ops")) or kk in ("rel_err", "rank_error_bound")}
                     for k, row in out["sketches"].items()},
        "snapshot": {k: out["snapshot"][k] for k in ("snapshots", "snapshot_retries", "updates_between_max", "scrape_client_ms",
                                                     "scrape_server_us")},
        "fleet": {k: out["snapshot"]["fleet"][k] for k in ("pulls", "planted")},
        "federation": {k: out["federation"][k] for k in ("envelope_bytes", "fold_ms")},
        "sketch_2rank_collectives": out["sketch_2rank"]["ranks"][0]["collectives"],
        "subphase_s": out["subphase_s"], "phase_s": out["phase_s"],
    }}), flush=True)
    return out


# ---------------------------------------------------------------- phase 26: sharded state

SHARD_RANKS = 4
VOCAB = 128256  # Llama 3's vocab_size (its public config.json)
VOCAB_TOKENS, VOCAB_UPDATES = 2048, 16
SHARD_CM_CLASSES, SHARD_CM_PAIRS, SHARD_CM_UPDATES = 32768, 1 << 20, 16
SHARD_2X2_UPDATES = 8  # per data row
GPT2_VOCAB = 50257  # 4 does not divide it: the rule degrades to replication
SHARD_JOIN_TIMEOUT_S = 360


@contextlib.contextmanager
def _counting_collectives():
    """Count every ``torch.distributed`` collective issued in the block (a list the
    block's caller reads): the update loop must issue none."""
    import torch.distributed as dist

    names = ("all_gather", "all_reduce", "broadcast", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all")
    calls: list = []
    saved = {n: getattr(dist, n) for n in names if hasattr(dist, n)}

    def counting(real, n):
        def call(*a, **k):
            calls.append(n)
            return real(*a, **k)
        return call

    for n, real in saved.items():
        setattr(dist, n, counting(real, n))
    try:
        yield calls
    finally:
        for n, real in saved.items():
            setattr(dist, n, real)


def _vocab_collection(**kwargs):
    """Macro accuracy, precision, recall and F1 at Llama 3's vocabulary: one compute
    group, so one K1 per update."""
    from torchmetrics_tpu_torch import MetricCollection, MulticlassAccuracy, MulticlassF1Score, MulticlassPrecision, MulticlassRecall

    common = dict(average="macro", validate_args=False, device="cuda", **kwargs)
    return MetricCollection({
        "acc": MulticlassAccuracy(VOCAB, **common), "prec": MulticlassPrecision(VOCAB, **common),
        "rec": MulticlassRecall(VOCAB, **common), "f1": MulticlassF1Score(VOCAB, **common),
    })


def _vocab_batches() -> list:
    """Two seeded batches of 2048 tokens x 128,256 float32 logits (1.05 GB each), drawn
    on the card; every rank draws the same ones (inputs are replicated over ``state``)."""
    gen = torch.Generator(device="cuda").manual_seed(2026)
    return [
        (torch.randn(VOCAB_TOKENS, VOCAB, generator=gen, device="cuda"),
         torch.randint(0, VOCAB, (VOCAB_TOKENS,), generator=gen, device="cuda"))
        for _ in range(2)
    ]


def _owner_states(mc) -> dict:
    """The compute-group owner's states (assembled when sharded)."""
    from torchmetrics_tpu_torch.parallel import sharding

    owner = next(iter(mc.values(copy_state=False)))
    return {k: sharding.assemble(getattr(owner, k)) for k in owner._defaults}


def _timed_updates(mc, batches: list, n: int) -> float:
    """Median µs per update over ``n`` updates, CUDA events around each."""
    times = []
    for i in range(n):
        p, t = batches[i % len(batches)]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        mc.update(p, t)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def _shard_vocab(rank: int) -> dict:
    """The 1-D mesh of 4 ranks at Llama 3's vocabulary: eager and with the engine."""
    from torchmetrics_tpu_torch.diag import diag_context, transfer_guard
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.parallel import sharding

    batches = _vocab_batches()
    out: dict = {}
    with engine_context(True):  # the one-process replicated run, on this rank
        ref = _vocab_collection(sync_on_compute=False)
        out["replicated_per_device_bytes"] = next(iter(ref.values(copy_state=False))).state_footprint()["per_device_bytes"]
        _zero_launches()
        ref_us = _timed_updates(ref, batches, VOCAB_UPDATES)
        ref_states, ref_values = _owner_states(ref), {k: v.clone() for k, v in ref.compute().items()}
    out["replicated_update_us_engine"] = ref_us
    with engine_context(False):
        eager_ref = _vocab_collection(sync_on_compute=False)
        out["replicated_update_us_eager"] = _timed_updates(eager_ref, batches, VOCAB_UPDATES)
        del eager_ref
    for mode, enabled in (("eager", False), ("engine", True)):
        with engine_context(enabled), sharding.mesh_context(SHARD_RANKS):
            mc = _vocab_collection()
            owner = next(iter(mc.values(copy_state=False)))
            shapes = {k: list(sharding.local(getattr(owner, k)).shape) for k in owner._defaults}
            if shapes != {k: [VOCAB // SHARD_RANKS] for k in ("tp", "fp", "tn", "fn")}:
                raise AssertionError(f"shard_vocab rank {rank}: shards {shapes}")
            foot = owner.state_footprint()
            _zero_launches()
            with _counting_collectives() as calls, diag_context() as rec, transfer_guard("log"):
                update_us = _timed_updates(mc, batches, VOCAB_UPDATES)
            launches = _launches()
            reads = _serve_reads(rec)
            if calls or reads:
                raise AssertionError(f"shard_vocab {mode} rank {rank}: the update loop issued {calls} / read {reads}")
            if launches["stat_counts"] < 1:
                raise AssertionError(f"shard_vocab {mode} rank {rank}: K1 was not launched: {launches}")
            states = _owner_states(mc)
            for k, want in ref_states.items():
                _equal(f"shard_vocab {mode} rank {rank} {k}", states[k], want)
            with _counting_collectives() as calls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                values = mc.compute()
                torch.cuda.synchronize()
                compute_ms = (time.perf_counter() - t0) * 1e3
            for k, want in ref_values.items():
                _equal(f"shard_vocab {mode} rank {rank} compute {k}", values[k], want)
            out[mode] = {
                "update_us": update_us, "launches": launches, "compute_ms": compute_ms,
                "compute_collectives": len(calls),
                "per_device_bytes": foot["per_device_bytes"], "total_bytes": foot["total_bytes"],
                "update_collectives": 0, "update_host_reads": 0,
            }
            if foot["per_device_bytes"] * SHARD_RANKS != foot["total_bytes"]:
                raise AssertionError(f"shard_vocab rank {rank}: footprint {foot}")
            del mc, owner
    return out


def _confmat_pairs() -> list:
    gen = torch.Generator(device="cuda").manual_seed(2032)
    return [
        (torch.randint(0, SHARD_CM_CLASSES, (SHARD_CM_PAIRS,), generator=gen, device="cuda"),
         torch.randint(0, SHARD_CM_CLASSES, (SHARD_CM_PAIRS,), generator=gen, device="cuda"))
        for _ in range(SHARD_CM_UPDATES)
    ]


def _peak_update(m, p, t) -> tuple:
    """``(µs, peak bytes above the live allocation)`` of one update."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    m.update(p, t)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3, torch.cuda.max_memory_allocated() - base


def _shard_confmat(rank: int) -> dict:
    """``MulticlassConfusionMatrix(32768)`` on the 1-D mesh: each rank counts its 8192
    rows; the peak memory of every eager update and of every engine update after the
    build (warm-up, static buffers, graph pool: reported apart) stays below one (C, C)
    matrix; the compute is held against a replicated run made rank by rank."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch import MulticlassConfusionMatrix
    from torchmetrics_tpu_torch.diag import diag_context, transfer_guard
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.parallel import sharding

    pairs = _confmat_pairs()
    full_bytes = SHARD_CM_CLASSES * SHARD_CM_CLASSES * 4
    out: dict = {}
    with sharding.mesh_context(SHARD_RANKS), engine_context(False):
        eager = MulticlassConfusionMatrix(SHARD_CM_CLASSES, validate_args=False, device="cuda")
        eager_runs = [_peak_update(eager, p, t) for p, t in pairs[:3]]
        out["eager_update_us"] = statistics.median(us for us, _ in eager_runs)
        out["eager_peak_bytes"] = max(b for _, b in eager_runs)
        del eager
        torch.cuda.empty_cache()
    with engine_context(True), sharding.mesh_context(SHARD_RANKS):
        m = MulticlassConfusionMatrix(SHARD_CM_CLASSES, validate_args=False, device="cuda")
        shape = list(sharding.local(m.confmat).shape)
        if shape != [SHARD_CM_CLASSES // SHARD_RANKS, SHARD_CM_CLASSES]:
            raise AssertionError(f"shard_confmat rank {rank}: shard {shape}")
        with _counting_collectives() as calls, diag_context() as rec, transfer_guard("log"):
            runs = [_peak_update(m, p, t) for p, t in pairs]
        times, peaks = [us for us, _ in runs], [b for _, b in runs]
        reads = _serve_reads(rec)
        if calls or reads:
            raise AssertionError(f"shard_confmat rank {rank}: the update loop issued {calls} / read {reads}")
        if max(peaks[1:] + [out["eager_peak_bytes"]]) >= full_bytes:
            raise AssertionError(f"shard_confmat rank {rank}: an update allocated {peaks} / {out['eager_peak_bytes']} B"
                                 " >= a (C, C) matrix")
        out["shard_bytes"] = sharding.local(m.confmat).nbytes
        lo, hi = sharding.local_rows(m, "confmat")
        shard = sharding.local(m.confmat).clone()
        m._engine = None  # its graph pool and static buffers go before the replicated run
        del m, rec, runs
    gc.collect()
    torch.cuda.empty_cache()
    out["update_us_sharded"] = statistics.median(times[1:])
    out["build_peak_bytes"] = peaks[0]
    out["peak_update_bytes"] = max(peaks[1:])
    for r in range(SHARD_RANKS):  # the replicated run (eager), one rank at a time: 4.29 GB of state
        dist.barrier()
        if r != rank:
            continue
        with engine_context(False):
            ref = MulticlassConfusionMatrix(SHARD_CM_CLASSES, validate_args=False, device="cuda", sync_on_compute=False)
            rtimes = [_peak_update(ref, p, t)[0] for p, t in pairs]
            _equal(f"shard_confmat rank {rank} rows {lo}:{hi}", shard, ref.confmat[lo:hi])
            out["eager_update_us_replicated"] = statistics.median(rtimes[1:])
            del ref
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _shard_2x2_batches(row: int) -> list:
    gen = torch.Generator().manual_seed(2600 + row)
    return [
        (_scores_with_edge_rows(CIFAR_BATCH, CIFAR_CLASSES, gen), torch.randint(0, CIFAR_CLASSES, (CIFAR_BATCH,), generator=gen).cuda())
        for _ in range(SHARD_2X2_UPDATES)
    ]


def _shard_2x2(rank: int) -> dict:
    """Config #2's collection on a (data 2, state 2) mesh: each data row its own batches;
    the synced compute is held against a replicated run over both rows' batches."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import engine_context, engine_report, reset_engine_stats
    from torchmetrics_tpu_torch.ops import multi_threshold as mt
    from torchmetrics_tpu_torch.ops import stat_counts as sc
    from torchmetrics_tpu_torch.parallel import sharding

    out: dict = {}
    with engine_context(True), sharding.mesh_context(data=2, state=2) as mesh:
        row = mesh.coordinate()["data"]
        batches = _shard_2x2_batches(row)
        mc = MetricCollection(_collection_members(device="cuda", validate_args=False))
        sharded = sorted(f"{n}.{k}" for n, m in mc.items(keep_base=True, copy_state=False) for k in m._defaults
                         if sharding.is_sharded(getattr(m, k)))
        _zero_launches()
        with _counting_collectives() as calls:
            for p, t in batches:
                mc.update(p, t)
        out["launches"] = _launches()
        if calls:
            raise AssertionError(f"shard_2x2 rank {rank}: the update loop issued {calls}")
        if not (out["launches"]["stat_counts"] and out["launches"]["multi_threshold"]):
            raise AssertionError(f"shard_2x2 rank {rank}: a kernel of the path was not launched: {out['launches']}")
        reset_engine_stats()
        with _counting_collectives() as calls:
            values = {k: v.clone() for k, v in mc.compute().items()}
        rep = engine_report()
        out["sync"] = {
            "collectives": len(calls), "sync_collectives": rep["sync_collectives"], "gather_skipped": rep["gather_skipped"],
            "psum_syncs": rep["psum_syncs"], "ingraph_syncs": rep["ingraph_syncs"], "packed_syncs": rep["packed_syncs"],
        }
        out["sharded_states"] = sharded
        preds, target = batches[0]
        _equal(f"shard_2x2 rank {rank} K1", sc.stat_counts(preds, target, CIFAR_CLASSES), sc._stat_counts_plain(preds, target, CIFAR_CLASSES))
        gen = torch.Generator().manual_seed(2602)
        inp = _curve_inputs(CIFAR_BATCH, CIFAR_CLASSES, N_THRESH, gen, "random")
        _equal(f"shard_2x2 rank {rank} K2", mt.multi_threshold_confmat(*inp[:3], *inp[3]),
               mt._multi_threshold_confmat_plain(*inp[:3], *inp[3]))
        del mc
    with engine_context(True):
        ref = MetricCollection(_collection_members(device="cuda", validate_args=False, sync_on_compute=False))
        for p, t in _shard_2x2_batches(0) + _shard_2x2_batches(1):
            ref.update(p, t)
        want = ref.compute()
    for k, w in want.items():
        if w.dtype.is_floating_point:
            _assert_close(f"shard_2x2 rank {rank} {k}", values[k], w, AUROC_ATOL if "auroc" in k else ACC_ATOL)
        else:
            _equal(f"shard_2x2 rank {rank} {k}", values[k], w)
    return out


def _shard_degrade(rank: int) -> dict:
    """GPT-2's vocabulary on the 4-rank mesh: replicated, one ``shard.fallback`` per state."""
    from torchmetrics_tpu_torch import MulticlassAccuracy
    from torchmetrics_tpu_torch.diag import diag_context
    from torchmetrics_tpu_torch.engine import engine_report, reset_engine_stats
    from torchmetrics_tpu_torch.parallel import sharding

    reset_engine_stats()
    with sharding.mesh_context(SHARD_RANKS), diag_context() as rec:
        m = MulticlassAccuracy(GPT2_VOCAB, validate_args=False, device="cuda")
    out = {"sharded": sharding.is_sharded(m.tp), "shard_degrades": engine_report()["shard_degrades"],
           "fallback_events": rec.count("shard.fallback")}
    if out != {"sharded": False, "shard_degrades": 4, "fallback_events": 4}:
        raise AssertionError(f"shard degrade rank {rank}: {out}")
    return out


def _shard_rank_body(rank: int, out_dir: str) -> dict:
    out: dict = {}
    for name, run in (("shard_vocab", _shard_vocab), ("shard_confmat", _shard_confmat),
                      ("shard_2x2", _shard_2x2), ("degrade", _shard_degrade)):
        t0 = time.perf_counter()
        out[name] = run(rank)
        out[name]["s"] = time.perf_counter() - t0
        if rank == 0:
            _log(f"  rank 0: {name} done in {out[name]['s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def time_vocab_kernel(hbm_rate: float, launches: int, launches_by_rank: dict) -> dict:
    """K1 at 2048 x 128,256 float32 (the global-histogram variant): equal to its plain
    version, then its row of the kernels line."""
    from torchmetrics_tpu_torch.ops import stat_counts as sc

    batches = _vocab_batches()
    err = 0.0
    for ignore in (None, IGNORE):
        preds, target = batches[0]
        err = max(err, _equal(f"stat_counts {VOCAB_TOKENS}x{VOCAB} ignore={ignore}",
                              sc.stat_counts(preds, target, VOCAB, ignore), sc._stat_counts_plain(preds, target, VOCAB, ignore)))
    call = lambda i: sc.stat_counts(*batches[i % 2], VOCAB)  # noqa: E731
    k_ms = _median_ms(call, iters=20)
    k_prof = _device_profile(call, iters=10)
    p_ms = _median_ms(lambda i: sc._stat_counts_plain(*batches[i % 2], VOCAB), iters=5)
    preds, target = batches[0]
    k1_bytes = preds.nbytes + target.nbytes + 3 * VOCAB * 4
    bytes_ms, ops_ms = k1_bytes / hbm_rate * 1e3, preds.numel() / _F32_RATE * 1e3
    return {
        "name": "stat_counts",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/stat_counts.cu",
        "replaces": "torchmetrics_tpu/ops/stat_counts.py:130",
        "shape": f"{VOCAB_TOKENS}x{VOCAB} float32 (global histogram)",
        "launches": launches,
        "launches_by_path": launches_by_rank,
        "max_abs_err": err,
        "ms": k_ms,
        "kernel_device_ms": _kernel_ms(k_prof, "stat_counts_kernel"),
        "device_ms": None if k_prof["device_busy_us"] is None else k_prof["device_busy_us"] / 1e3,
        "device_ops_per_call": k_prof["device_ops"],
        "plain_ms": p_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "note": _NOTE,
    }


def run_shard(hbm_rate: float, smi: str) -> dict:
    """Phase 26: sharded state on a mesh of 4 gloo ranks sharing the card, then K1 at
    Llama 3's vocabulary against its plain version."""
    t_phase = time.perf_counter()
    # the four ranks share the card with this process: hand back its cached blocks first
    reserved = torch.cuda.memory_reserved()
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"  this process: {reserved} B reserved before the phase, {torch.cuda.memory_reserved()} B after emptying its cache")
    with _two_ranks(_shard_rank_body, SHARD_JOIN_TIMEOUT_S, "shard phase", world=SHARD_RANKS) as (results, _):
        ranks = results
    gc.collect()
    torch.cuda.empty_cache()
    launches = {
        "shard_vocab_eager": [r["shard_vocab"]["eager"]["launches"]["stat_counts"] for r in ranks],
        "shard_vocab_engine": [r["shard_vocab"]["engine"]["launches"]["stat_counts"] for r in ranks],
        "shard_2x2_engine": [r["shard_2x2"]["launches"]["stat_counts"] for r in ranks],
        "shard_2x2_k2": [r["shard_2x2"]["launches"]["multi_threshold"] for r in ranks],
    }
    kernel = time_vocab_kernel(hbm_rate, launches["shard_vocab_engine"][0], launches)
    out = {"card": smi, "ranks": ranks, "launches": launches, "vocab_kernel": kernel}
    out["phase_s"] = time.perf_counter() - t_phase
    r0 = ranks[0]
    _log(
        f"  shard_vocab: update {r0['shard_vocab']['engine']['update_us']:.1f} us sharded vs"
        f" {r0['shard_vocab']['replicated_update_us_engine']:.1f} us replicated (engine);"
        f" compute {r0['shard_vocab']['engine']['compute_ms']:.2f} ms; state bytes per rank"
        f" {[r['shard_vocab']['engine']['per_device_bytes'] for r in ranks]}"
    )
    _log(
        f"  shard_confmat: update {r0['shard_confmat']['update_us_sharded']:.1f} us sharded (engine),"
        f" eager {r0['shard_confmat']['eager_update_us']:.1f} us sharded vs"
        f" {r0['shard_confmat']['eager_update_us_replicated']:.1f} us replicated; peak per update"
        f" {[r['shard_confmat']['peak_update_bytes'] for r in ranks]} B (eager {r0['shard_confmat']['eager_peak_bytes']},"
        f" the build {r0['shard_confmat']['build_peak_bytes']})"
    )
    _log(f"  shard_2x2: sync {r0['shard_2x2']['sync']}; launches {launches}")
    _log(f"  K1 {kernel['shape']}: {kernel['ms']:.4f} ms (device {kernel['kernel_device_ms']}) against a"
         f" {kernel['bound_ms']:.4f} ms bound; plain {kernel['plain_ms']:.3f} ms")
    _log(f"  phase 26: {out['phase_s']:.1f} s on {smi}")
    print(json.dumps({"shard_summary": {
        "card": smi, "launches": launches, "phase_s": out["phase_s"],
        "vocab": {k: r0["shard_vocab"][k] for k in r0["shard_vocab"]},
        "confmat": [r["shard_confmat"] for r in ranks],
        "twobytwo": r0["shard_2x2"], "degrade": r0["degrade"], "vocab_kernel": kernel,
    }}), flush=True)
    return out



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    name = torch.cuda.get_device_name(0)
    hbm_rate = _hbm_rate(name)
    _log(f"[1/26] device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; HBM {hbm_rate / 1e12} TB/s")

    from torchmetrics_tpu_torch.native import rle_mask

    t0 = time.perf_counter()
    _build.library()
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rle_mask.library()
    native_build_s = time.perf_counter() - t0
    _log(f"[2/26] build: {nvcc_s:.1f} s -> {_build.library_path().name}; g++ {native_build_s:.1f} s"
         f" -> {rle_mask.library_path().name}")

    gen = torch.Generator().manual_seed(0)
    if sys.argv[1:] == ["--binned-update-only"]:
        print(smi, flush=True)
        print(json.dumps({"binned_update": time_binned_update(gen)}), flush=True)
        return 0
    if sys.argv[1:] == ["--engine-tier-only"]:
        acc_batches = [
            (torch.randn(ACC_BATCH, ACC_CLASSES, generator=gen).cuda(), torch.randint(0, ACC_CLASSES, (ACC_BATCH,), generator=gen).cuda())
            for _ in range(N_BATCHES)
        ]
        cifar_batches = [
            (_scores_with_edge_rows(CIFAR_BATCH, CIFAR_CLASSES, gen), torch.randint(0, CIFAR_CLASSES, (CIFAR_BATCH,), generator=gen).cuda())
            for _ in range(N_BATCHES)
        ]
        _log("[14/26] the engine tier: scan queue, async drains, riders, cached compute")
        tier = run_engine_tier(acc_batches, cifar_batches, gen)
        print(json.dumps({"engine_tier": tier, "profiler_windows": PROFILE_WINDOWS}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--tensor-metrics-only"]:
        _log("[15/26] calibration, hinge, ranking, fairness, Dice and regression's sums")
        tensor = run_tensor_metrics(_tm_imagenet_batches(gen), _multilabel_batches(gen), _binary_batches(gen), gen)
        print(json.dumps({"tensor_metrics": tensor, "profiler_windows": PROFILE_WINDOWS}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--moments-retrieval-only"]:
        _log("[16/26] regression's moments and cat states, retrieval")
        tensor2 = run_tensor2(gen, hbm_rate)
        print(json.dumps({"tensor2": tensor2, "profiler_windows": PROFILE_WINDOWS}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--nominal-pairwise-only"]:
        _log("[17/26] nominal association and pairwise distances")
        nominal = run_nominal_pairwise(_tm_imagenet_batches(gen), gen, hbm_rate)
        print(json.dumps({"nominal": nominal, "profiler_windows": PROFILE_WINDOWS}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--image-models-only"]:
        _log("[19/26] the model half of the image domain: FID, KID, IS and LPIPS")
        image_models = run_image_models(gen, smi)
        print(json.dumps({"image_models": image_models, "profiler_windows": PROFILE_WINDOWS}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--text-only"]:
        _log("[20/26] the text domain: host metrics, BERTScore, perplexity, InfoLM, the HF route")
        text = run_text(gen, hbm_rate, smi)
        print(json.dumps({"text": text, "profiler_windows": PROFILE_WINDOWS}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--audio-only"]:
        _log("[22/26] the audio and multimodal domains: SNR, SDR, PIT, C-SI-SNR, CLIPScore")
        audio = run_audio(smi, hbm_rate)
        print(json.dumps({"audio": audio, "profiler_windows": PROFILE_WINDOWS}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--detection-only"]:
        _log("[21/26] the detection domain: mAP's three routes, the C++ evaluator, the IoU family, panoptic quality")
        detection = run_detection(smi, native_build_s)
        print(json.dumps({"detection": detection, "profiler_windows": PROFILE_WINDOWS}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--image-only"]:
        _log("[18/26] the tensor half of the image domain: SSIM, PSNR, pansharpening, volumes")
        images = run_images(gen, hbm_rate)
        print(json.dumps({"image": images, "profiler_windows": PROFILE_WINDOWS}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--resilience-only"]:
        acc_batches = [
            (torch.randn(ACC_BATCH, ACC_CLASSES, generator=gen).cuda(), torch.randint(0, ACC_CLASSES, (ACC_BATCH,), generator=gen).cuda())
            for _ in range(N_BATCHES)
        ]
        cifar_batches = [
            (_scores_with_edge_rows(CIFAR_BATCH, CIFAR_CLASSES, gen), torch.randint(0, CIFAR_CLASSES, (CIFAR_BATCH,), generator=gen).cuda())
            for _ in range(N_BATCHES)
        ]
        _log("[23/26] fault-tolerant sync and elastic snapshots")
        resilience = run_resilience(acc_batches, cifar_batches, gen, smi)
        print(json.dumps({"resilience": resilience}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--diag-only"]:
        acc_batches = [
            (torch.randn(ACC_BATCH, ACC_CLASSES, generator=gen).cuda(), torch.randint(0, ACC_CLASSES, (ACC_BATCH,), generator=gen).cuda())
            for _ in range(N_BATCHES)
        ]
        cifar_batches = [
            (_scores_with_edge_rows(CIFAR_BATCH, CIFAR_CLASSES, gen), torch.randint(0, CIFAR_CLASSES, (CIFAR_BATCH,), generator=gen).cuda())
            for _ in range(N_BATCHES)
        ]
        _log("[24/26] the diagnostics plane: the strict guard, probes, sentinels, the two-rank timeline")
        diag = run_diag(acc_batches, cifar_batches, gen, smi)
        print(json.dumps({"diag": diag, "profiler_windows": PROFILE_WINDOWS}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--serve-only"]:
        acc_batches = [
            (torch.randn(ACC_BATCH, ACC_CLASSES, generator=gen).cuda(), torch.randint(0, ACC_CLASSES, (ACC_BATCH,), generator=gen).cuda())
            for _ in range(N_BATCHES)
        ]
        cifar_batches = [
            (_scores_with_edge_rows(CIFAR_BATCH, CIFAR_CLASSES, gen), torch.randint(0, CIFAR_CLASSES, (CIFAR_BATCH,), generator=gen).cuda())
            for _ in range(N_BATCHES)
        ]
        _log("[25/26] the serving plane: windows, tenants, sketches, snapshots, the sidecar, federation, the fleet")
        serve = run_serve(acc_batches, cifar_batches, gen, smi)
        print(json.dumps({"serve": serve, "profiler_windows": PROFILE_WINDOWS}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--shard-only"]:
        _log("[26/26] sharded state: Llama 3's vocabulary, a 32768-class matrix and config #2 on 4 gloo ranks")
        shard = run_shard(hbm_rate, smi)
        print(json.dumps({"shard": shard, "profiler_windows": PROFILE_WINDOWS}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--eval-loop-only"]:
        acc_batches = [
            (torch.randn(ACC_BATCH, ACC_CLASSES, generator=gen).cuda(), torch.randint(0, ACC_CLASSES, (ACC_BATCH,), generator=gen).cuda())
            for _ in range(N_BATCHES)
        ]
        _log("[13/26] the eval loop: aggregators, wrappers and checkpoints")
        inp = _EvalInputs(acc_batches, _multilabel_batches(gen), gen)
        print(json.dumps({"eval_loop": run_eval_loop(inp), "eval_loop_times": time_eval_loop(inp)}), flush=True)
        print(smi, flush=True)
        return 0
    # phases 3-10 drive the eager path, as the earlier slices did, so their numbers stay
    # comparable; phase 11 drives the same paths with the engine on (the default)
    with engine_context(False):
        _log("[3/26] kernels against their plain versions")
        errors = {"stat_counts": check_stat_counts(gen), "multi_threshold": check_multi_threshold(gen)}
        errors.update(check_multi_threshold_new_shapes(gen))

        _log("[4/26] main path")
        acc_launches, acc_batches = run_accuracy_path(gen)
        auroc_launches, auroc_batches = run_auroc_path(gen)

        _log("[5/26] collection path")
        collection_launches, collection_batches = run_collection_path(gen)

        _log("[6/26] binary path")
        binary_launches, binary_batches, binary_summary = run_binary_path(gen)

        _log("[7/26] multilabel path")
        multilabel_launches, multilabel_batches, multilabel_summary = run_multilabel_path(gen)

        _log("[8/26] task routers")
        run_routers(gen)

        _log("[9/26] sync, two ranks on one card")
        sync = run_sync_phase()

        _log("[10/26] times")
        launches = {
            "stat_counts": acc_launches,
            "multi_threshold": auroc_launches,
            "binary": binary_launches["multi_threshold"],
            "multilabel": multilabel_launches["multi_threshold"],
        }
        kernels = time_kernels(gen, hbm_rate, launches, errors)
        updates = time_updates(acc_batches, auroc_batches)
        updates["collection"] = time_collection(collection_batches)
        updates["binary"] = {**time_task_path(_binary_members, binary_batches), "path": binary_summary}
        updates["multilabel"] = {**time_task_path(_multilabel_members, multilabel_batches), "path": multilabel_summary}

    _log("[11/26] engine paths: the compiled update engine on CUDA graphs")
    to_cpu = lambda p, t: (p.cpu(), t.cpu())  # noqa: E731
    sigmoid_to_cpu = lambda p, t: (_sigmoid(p).cpu(), t.cpu())  # noqa: E731
    # validate_args=False: a validating update reads the host (torch.unique) and falls back
    engine = {
        "accuracy": run_engine_accuracy(acc_batches),
        "collection": run_engine_task(
            "collection", lambda device=None: _collection_members(device=device, validate_args=False),
            collection_batches, to_cpu, {"acc", "confmat"}, {"auroc"},
        ),
        "binary": run_engine_task(
            "binary", lambda device=None: _binary_members(device=device, validate_args=False),
            binary_batches, sigmoid_to_cpu, {"acc", "cm"}, {"ap"},
        ),
        "multilabel": run_engine_task(
            "multilabel", lambda device=None: _multilabel_members(device=device, validate_args=False),
            multilabel_batches, sigmoid_to_cpu, {"acc", "cm"}, {"auroc"},
        ),
    }
    run_engine_scenarios(acc_batches, collection_batches, binary_batches)
    engine["times"] = time_engine(acc_batches, collection_batches, binary_batches, multilabel_batches)

    _log("[12/26] the rest of the stat-scores family, eagerly and with the engine")
    family_batches = {
        "imagenet": acc_batches, "cifar": collection_batches, "binary": binary_batches, "multilabel": multilabel_batches,
    }
    family = {name: run_family_path(name, batches) for name, batches in family_batches.items()}
    family["top5"] = run_top_k(acc_batches)
    family["sigmoid"] = check_sigmoid(binary_batches, multilabel_batches)
    family["times"] = time_family(family_batches)

    _log("[13/26] the eval loop: aggregators, wrappers and checkpoints")
    inp = _EvalInputs(acc_batches, multilabel_batches, gen)
    eval_loop = run_eval_loop(inp)
    eval_loop["times"] = time_eval_loop(inp)
    del inp

    _log("[14/26] the engine tier: scan queue, async drains, riders, cached compute")
    engine_tier = run_engine_tier(acc_batches, collection_batches, gen)

    _log("[15/26] calibration, hinge, ranking, fairness, Dice and regression's sums")
    tensor = run_tensor_metrics(_tm_imagenet_batches(gen), multilabel_batches, binary_batches, gen)

    _log("[16/26] regression's moments and cat states, retrieval")
    tensor2 = run_tensor2(gen, hbm_rate)

    _log("[17/26] nominal association and pairwise distances")
    nominal = run_nominal_pairwise(_tm_imagenet_batches(gen), gen, hbm_rate)

    _log("[18/26] the tensor half of the image domain: SSIM, PSNR, pansharpening, volumes")
    images = run_images(gen, hbm_rate)

    _log("[19/26] the model half of the image domain: FID, KID, IS and LPIPS")
    image_models = run_image_models(gen, smi)

    _log("[20/26] the text domain: host metrics, BERTScore, perplexity, InfoLM, the HF route")
    text = run_text(gen, hbm_rate, smi)

    _log("[21/26] the detection domain: mAP's three routes, the C++ evaluator, the IoU family, panoptic quality")
    detection = run_detection(smi, native_build_s)

    _log("[22/26] the audio and multimodal domains: SNR, SDR, PIT, C-SI-SNR, CLIPScore")
    audio = run_audio(smi, hbm_rate)

    _log("[23/26] fault-tolerant sync and elastic snapshots")
    resilience = run_resilience(acc_batches, collection_batches, gen, smi)

    _log("[24/26] the diagnostics plane: the strict guard, probes, sentinels, the two-rank timeline")
    diag = run_diag(acc_batches, collection_batches, gen, smi)

    _log("[25/26] the serving plane: windows, tenants, sketches, snapshots, the sidecar, federation, the fleet")
    serve = run_serve(acc_batches, collection_batches, gen, smi)

    _log("[26/26] sharded state: Llama 3's vocabulary, a 32768-class matrix and config #2 on 4 gloo ranks")
    shard = run_shard(hbm_rate, smi)

    for entry in kernels:
        k = entry["name"]
        entry["launches_by_path"] = {
            "accuracy" if k == "stat_counts" else "auroc": launches[k],
            "collection": collection_launches[k],
            "binary": binary_launches[k],
            "multilabel": multilabel_launches[k],
            **{f"{path}_engine": engine[path]["launches"][k] for path in ("accuracy", "collection", "binary", "multilabel")},
            **{f"family_{path}": family[path]["launches_eager"][k] for path in family_batches},
            **{f"family_{path}_engine": family[path]["launches_engine"][k] for path in family_batches},
            "family_top5_engine": family["top5"]["launches_engine"][k],
            "eval_loop": sum(v["launches_eager"][k] for v in eval_loop.values() if isinstance(v, dict) and "launches_eager" in v),
            "eval_loop_engine": sum(v["launches_engine"][k] for v in eval_loop.values() if isinstance(v, dict) and "launches_engine" in v),
            "scan_accuracy": engine_tier["accuracy"]["scan"]["launches"][k],
            "scan_async_accuracy": engine_tier["accuracy"]["scan_async"]["launches"][k],
            "scan_collection": engine_tier["collection"]["launches"][k],
            "scan_quarantine": engine_tier["quarantine"]["launches"][k],
            **{f"tensor_{path}": tensor[path]["launches_eager"][k] for path in ("imagenet", "coco", "ctr")},
            **{f"tensor_{path}_engine": tensor[path]["launches_engine"][k] for path in ("imagenet", "coco", "ctr")},
            **{f"tensor2_{path}": tensor2[path]["launches_eager"][k] for path in TM2_PATHS},
            **{f"tensor2_{path}_engine": tensor2[path]["launches_engine"][k] for path in TM2_PATHS},
            **{f"nominal_{path}": nominal[path]["launches_eager"][k] for path in NOM_PATHS},
            **{f"nominal_{path}_engine": nominal[path]["launches_engine"][k] for path in NOM_PATHS},
            **{f"image_{path}": images[path]["launches_eager"][k] for path in IMAGE_PATHS},
            **{f"image_{path}_engine": images[path]["launches_engine"][k] for path in IMAGE_PATHS},
            "image_models_fid": image_models["fid"]["launches_eager"][k],
            "image_models_fid_engine": image_models["fid"]["launches_engine"][k],
            **{f"image_models_lpips_{net}": image_models["lpips"][net]["launches_eager"][k] for net in LPIPS_NETS},
            **{f"image_models_lpips_{net}_engine": image_models["lpips"][net]["launches_engine"][k] for net in LPIPS_NETS},
            **{f"text_{path}": text["host"][path]["launches_eager"][k] for path in TEXT_PATHS},
            **{f"text_{path}_engine": text["host"][path]["launches_engine"][k] for path in TEXT_PATHS},
            "text_bert_score": text["bert_score"]["launches"][k],
            **{f"text_perplexity_{d}": text["perplexity"][d]["launches_eager"][k] for d in ("float32", "bfloat16")},
            **{f"text_perplexity_{d}_engine": text["perplexity"][d]["launches_engine"][k] for d in ("float32", "bfloat16")},
            "text_infolm": sum(v["launches_eager"][k] for v in text["infolm"].values()),
            "text_infolm_engine": sum(v["launches"][k] for v in text["infolm"].values()),
            **{f"detection_{path}": detection[path]["launches"][k] for path in DET_PATHS if path != "coco_packed"},
            "detection_coco_packed": detection["coco_packed"]["launches_eager"][k],
            "detection_coco_packed_engine": detection["coco_packed"]["launches_engine"][k],
            **{f"audio_{path}": audio[path]["launches_eager"][k] for path in AUDIO_PATHS},
            **{f"audio_{path}_engine": audio[path]["launches_engine"][k] for path in AUDIO_PATHS},
            "resilience_2rank": resilience["launches"]["eager"][k],
            "resilience_elastic_engine": resilience["launches"]["engine"][k],
            "resilience_preempt_engine": resilience["launches"]["preempt_engine"][k],
            **{f"diag_{path}": diag["launches"][path][k] for path in diag["launches"]},
            **{f"serve_{path}": serve["launches"][path][k] for path in serve["launches"]},
            **(
                {path: shard["launches"][path] for path in ("shard_vocab_eager", "shard_vocab_engine", "shard_2x2_engine")}
                if k == "stat_counts" else {"shard_2x2": shard["launches"]["shard_2x2_k2"]}
            ),
        }
        entry["engine"] = (
            "K1 runs inside the captured graphs (kb times per K-step scan replay); the pad-row unit is computed"
            " once per signature, outside the graph"
            if k == "stat_counts"
            else "K2 runs eagerly: the binned curves fall back (their [0, 1] range check reads the host)"
        )

    # K1 at Llama 3's vocabulary (phase 26): its own row, launches from the sharded path
    kernels.append(shard["vocab_kernel"])
    results = {
        "updates": updates, "engine": engine, "family": family, "eval_loop": eval_loop, "engine_tier": engine_tier,
        "tensor_metrics": tensor, "tensor2": tensor2, "nominal": nominal, "image": images, "image_models": image_models,
        "text": text, "detection": detection, "audio": audio, "resilience": resilience, "diag": diag, "serve": serve,
        "shard": {k: v for k, v in shard.items() if k != "vocab_kernel"},
        "sync_2rank": sync,
        "profiler_windows": PROFILE_WINDOWS, "card": smi,
    }
    print(json.dumps(results), flush=True)
    if "--out" in sys.argv:
        path = sys.argv[sys.argv.index("--out") + 1]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({**results, "kernels": kernels}, f)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
