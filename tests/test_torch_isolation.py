"""The port stands alone: no JAX, nothing of the JAX package, and no silent CPU runs.

Each check runs in a fresh interpreter, since the test process itself imports both
packages.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import torchmetrics_tpu_torch
for info in pkgutil.walk_packages(torchmetrics_tpu_torch.__path__, prefix="torchmetrics_tpu_torch."):
    importlib.import_module(info.name)
leaked = sorted(k for k in sys.modules
                if k in ("jax", "jaxlib", "torchmetrics_tpu") or k.startswith(("jax.", "jaxlib.", "torchmetrics_tpu.")))
assert not leaked, leaked
assert "transformers" not in sys.modules, "a port module imported transformers at import time"
# the native copy builds at first use, never on import, and only from the port's own sources
from torchmetrics_tpu_torch.native import rle_mask
assert rle_mask._LIB is None, "importing the port built or loaded the native library"
assert all(str(s).startswith(str(rle_mask._HERE)) for s in rle_mask.SOURCES), rle_mask.SOURCES
assert rle_mask.BUILD_DIR.name == "_build" and rle_mask.BUILD_DIR.parent.name == "torchmetrics_tpu_torch"
for name in ("ops.multi_threshold", "engine.compiled", "engine.fusion", "engine.bucketing", "engine.config",
             "native.rle_mask", "detection.mean_ap", "detection.ingraph", "functional.detection._panoptic_common",
             "audio.pit", "audio.pesq", "audio.stoi", "functional.audio.sdr", "functional.audio.pesq",
             "functional.audio.stoi", "multimodal.clip_score", "functional.multimodal.clip_score",
             "diag.trace", "parallel.faults", "parallel.resilience", "parallel.elastic",
             "diag.hist", "diag.profile", "diag.transfer_guard", "diag.sentinel", "diag.timeline",
             "diag.lineage", "diag.report", "diag.slo", "diag.telemetry", "serve.stats", "serve.snapshot",
             "serve.window", "serve.sketch", "serve.quantile", "serve.tenancy", "serve.sidecar", "serve.federation",
             "serve.fleet"):
    assert "torchmetrics_tpu_torch." + name in sys.modules, name
print("isolated")
"""

_NO_CUDA_DEFAULT = """
import torch
import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.retrieval
import torchmetrics_tpu_torch.image
import torchmetrics_tpu_torch.text
import torchmetrics_tpu_torch.detection
import torchmetrics_tpu_torch.audio
import torchmetrics_tpu_torch.multimodal
from torchmetrics_tpu_torch import MetricCollection, MulticlassAccuracy, MulticlassAUROC, MulticlassConfusionMatrix
assert not torch.cuda.is_available()
routers = ("StatScores", "Accuracy", "Precision", "Recall", "FBetaScore", "F1Score", "ConfusionMatrix",
           "PrecisionRecallCurve", "ROC", "AUROC", "AveragePrecision", "Specificity", "HammingDistance",
           "ExactMatch", "JaccardIndex", "MatthewsCorrCoef", "RecallAtFixedPrecision", "PrecisionAtFixedRecall",
           "SpecificityAtSensitivity")
every_class = [n for n in tm.__all__ if n.startswith(("Binary", "Multiclass", "Multilabel"))]
assert len(every_class) == 67, every_class
REGRESSION = ("MeanSquaredError", "MeanAbsoluteError", "MeanSquaredLogError", "MeanAbsolutePercentageError",
              "SymmetricMeanAbsolutePercentageError", "WeightedMeanAbsolutePercentageError", "LogCoshError",
              "R2Score", "RelativeSquaredError", "ExplainedVariance", "TweedieDevianceScore", "PearsonCorrCoef",
              "ConcordanceCorrCoef", "SpearmanCorrCoef", "KendallRankCorrCoef", "CosineSimilarity", "KLDivergence")
RETRIEVAL = [n for n in tm.retrieval.__all__ if n != "RetrievalMetric"]
NOMINAL = ("CramersV", "TschuprowsT", "PearsonsContingencyCoefficient", "TheilsU")
IMAGE = ("ErrorRelativeGlobalDimensionlessSynthesis", "MultiScaleStructuralSimilarityIndexMeasure",
         "PeakSignalNoiseRatio", "PeakSignalNoiseRatioWithBlockedEffect", "RelativeAverageSpectralError",
         "RootMeanSquaredErrorUsingSlidingWindow", "SpectralAngleMapper", "SpectralDistortionIndex",
         "StructuralSimilarityIndexMeasure", "TotalVariation", "UniversalImageQualityIndex",
         "FrechetInceptionDistance", "KernelInceptionDistance", "InceptionScore",
         "LearnedPerceptualImagePatchSimilarity")
# the model-backed classes, each with a small callable extractor (no trunk is built)
IMAGE_ARGS = {n: {"feature": lambda x: x.float().flatten(1), "num_features": 4}
              for n in ("FrechetInceptionDistance", "KernelInceptionDistance", "InceptionScore")}
IMAGE_ARGS["LearnedPerceptualImagePatchSimilarity"] = {"net_type": lambda a, b, normalize=False: (a - b).abs().mean((1, 2, 3))}
TEXT = ("BERTScore", "BLEUScore", "CHRFScore", "CharErrorRate", "ExtendedEditDistance", "InfoLM", "MatchErrorRate",
        "Perplexity", "ROUGEScore", "SQuAD", "SacreBLEUScore", "TranslationEditRate", "WordErrorRate", "WordInfoLost",
        "WordInfoPreserved")
assert sorted(TEXT) == sorted(tm.text.__all__)
DETECTION = {n: {} for n in tm.detection.__all__}
DETECTION["PackedMeanAveragePrecision"] = {"num_classes": 3}
DETECTION["PanopticQuality"] = DETECTION["ModifiedPanopticQuality"] = {"things": {0}, "stuffs": {1}}
AUDIO = {n: {} for n in tm.audio.__all__}
AUDIO["PermutationInvariantTraining"] = {"metric_func": tm.functional.signal_noise_ratio}
assert sorted(AUDIO) == sorted(("ComplexScaleInvariantSignalNoiseRatio", "PermutationInvariantTraining",
                                "ScaleInvariantSignalDistortionRatio", "ScaleInvariantSignalNoiseRatio",
                                "SignalDistortionRatio", "SignalNoiseRatio"))
# the towers of CLIPScore are injected: no checkpoint is loaded
CLIP = {"embed_fn": lambda images, text: (torch.ones(len(images), 2), torch.ones(len(text), 2))}
AGGREGATORS = ("SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric", "RunningMean", "RunningSum")
WRAPPERS = (  # each builds its base metric with the given keyword arguments
    lambda **kw: tm.Running(tm.SumMetric(**kw), window=2),
    lambda **kw: tm.ClasswiseWrapper(tm.CatMetric(**kw)),
    lambda **kw: tm.MinMaxMetric(tm.SumMetric(**kw)),
    lambda **kw: tm.MultioutputWrapper(tm.MeanMetric(**kw), num_outputs=1),
    lambda **kw: tm.MultitaskWrapper({"task": tm.MeanMetric(**kw)}),
    lambda **kw: tm.BootStrapper(tm.SumMetric(**kw), num_bootstraps=2),
)
FLOORS = {"RecallAtFixedPrecision": "min_precision", "PrecisionAtFixedRecall": "min_recall",
          "SpecificityAtSensitivity": "min_sensitivity"}

def args(name):
    width = {"num_classes": 5} if name.startswith("Multiclass") else {"num_labels": 5} if name.startswith("Multilabel") else {}
    floor = {v: 0.5 for k, v in FLOORS.items() if name.endswith(k)}
    groups = {"num_groups": 2} if name in ("BinaryFairness", "BinaryGroupStatRates") else {}
    return {**width, **floor, **groups, **({"beta": 1.0} if "FBeta" in name else {})}

for make in (
    lambda: MulticlassAccuracy(num_classes=5),
    lambda: MulticlassAUROC(num_classes=5, thresholds=10),
    lambda: MulticlassConfusionMatrix(num_classes=5),
    lambda: MetricCollection({"cm": MulticlassConfusionMatrix(num_classes=5)}),
    *(lambda n=n: getattr(tm, n)(**args(n)) for n in every_class),
    *(lambda r=r: getattr(tm, r)(task="multilabel", num_labels=3, **args(r)) for r in routers),
    lambda: tm.CohenKappa(task="binary"),
    lambda: tm.CalibrationError(task="binary"),
    lambda: tm.HingeLoss(task="multiclass", num_classes=3),
    lambda: tm.Dice(),
    *(lambda n=n: getattr(tm, n)() for n in REGRESSION),
    *(lambda n=n: getattr(tm.retrieval, n)() for n in RETRIEVAL),
    lambda: tm.MinkowskiDistance(p=3),
    *(lambda n=n: getattr(tm, n)(num_classes=3) for n in NOMINAL),
    lambda: tm.FleissKappa(mode="probs"),
    *(lambda n=n: getattr(tm.image, n)(**IMAGE_ARGS.get(n, {})) for n in IMAGE),
    *(lambda n=n: getattr(tm.text, n)() for n in TEXT),
    *(lambda n=n: getattr(tm.detection, n)(**DETECTION[n]) for n in DETECTION),
    *(lambda n=n: getattr(tm.audio, n)(**AUDIO[n]) for n in AUDIO),
    lambda: tm.multimodal.CLIPScore(**CLIP),
    *(lambda n=n: getattr(tm, n)() for n in AGGREGATORS),
    lambda: tm.CompositionalMetric(torch.add, 1.0, 2.0),
    *WRAPPERS,
    lambda: tm.CardinalitySketch(),
    lambda: tm.HeavyHitters(),
    lambda: tm.serve.KLLSketch(),
    lambda: tm.WindowedMetric(tm.SumMetric()),
    lambda: tm.DecayedMetric(tm.SumMetric(), decay=0.5),
    lambda: tm.TenantSlices(tm.SumMetric(), capacity=8),
):
    try:
        make()
    except RuntimeError as err:
        assert "device='cpu'" in str(err), err
    else:
        raise AssertionError("a metric without `device` must not fall back to the CPU")
assert MulticlassAccuracy(num_classes=5, device="cpu").device.type == "cpu"
# a wrapper, an aggregator and a composite run where their metric lives
cpu_metrics = [getattr(tm, n)(device="cpu") for n in AGGREGATORS]
cpu_metrics += [w(device="cpu") for w in WRAPPERS]
cpu_metrics += [tm.SumMetric(device="cpu") + 1, 1 - tm.MaxMetric(device="cpu")]
# the serving wrappers live where their base metric does
cpu_metrics += [tm.WindowedMetric(tm.SumMetric(device="cpu")), tm.DecayedMetric(tm.SumMetric(device="cpu"), decay=0.5)]
for n in AUDIO:
    assert getattr(tm.audio, n)(**AUDIO[n], device="cpu").device.type == "cpu", n
clip = tm.multimodal.CLIPScore(**CLIP, device="cpu")
clip.update(torch.zeros(2, 3, 4, 4), ["a", "b"])
assert clip.compute().device.type == "cpu"
try:
    tm.functional.clip_score(torch.zeros(3, 4, 4), "a", **CLIP)
except RuntimeError as err:
    assert "device='cpu'" in str(err), err
else:
    raise AssertionError("clip_score without `device` must not fall back to the CPU")
for m in cpu_metrics:
    assert m.device.type == "cpu", m
    if isinstance(m, tm.MultitaskWrapper):
        m.update({"task": torch.ones(3)}, {"task": torch.ones(3)})
    else:
        m.update(torch.ones(3, 1), torch.ones(3, 1)) if isinstance(m, tm.MultioutputWrapper) else m.update(torch.ones(3))
    m.compute()
tracker = tm.MetricTracker(tm.SumMetric(device="cpu"))
tracker.increment()
tracker.update(torch.ones(2))
assert tracker.compute().device.type == "cpu"
print("refused")
"""


def _run(code_or_args, cwd=ROOT, **env):
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    full_env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **env}
    full_env["PYTHONPATH"] = os.pathsep.join(p for p in (cwd, full_env.get("PYTHONPATH", "")) if p)
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True, timeout=120, env=full_env)


def test_port_imports_neither_jax_nor_the_jax_package():
    res = _run(_IMPORT_ALL)
    assert res.returncode == 0 and "isolated" in res.stdout, res.stderr


def test_metrics_refuse_to_run_on_the_cpu_unless_asked():
    res = _run(_NO_CUDA_DEFAULT)
    assert res.returncode == 0 and "refused" in res.stdout, res.stderr


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    res = _run([os.path.join(ROOT, "chip_smoke.py")])
    assert res.returncode != 0 and '"ok"' not in res.stdout, res.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    res = _run(["chip_smoke.py"], cwd=str(alone), CUDA_VISIBLE_DEVICES="0")
    assert res.returncode != 0 and '"ok"' not in res.stdout, res.stdout
