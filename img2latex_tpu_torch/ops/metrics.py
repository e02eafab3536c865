"""Host-side evaluation metrics: BLEU-n, Levenshtein, token accuracy.

A pure-Python copy of the plain path of ``img2latex_tpu/ops/metrics.py``
(``levenshtein_raw`` to ``calculate_metrics``, lines 54-181), which is
numerically identical to the reference's
``img2latex/training/metrics.py``.  The JAX package's optional native
library (``_fastmetrics``) is not loaded: the port imports nothing of that
package.

* :func:`levenshtein_similarity` - ``1 - d / max_len`` with an O(min(m, n))
  memory DP whose inner loop is vectorized;
* :func:`bleu_n_score` - geometric mean of the 1..n-gram precisions, zero if
  any is zero, the brevity penalty only when the candidate is shorter;
* :func:`token_list_accuracy` - correct / total over the overlapping prefix,
  PAD positions of the target ignored;
* :func:`calculate_metrics` - mean BLEU and mean Levenshtein similarity;
* :func:`compute_all_metrics` - the enhanced-metrics report (accuracy, BLEU,
  Levenshtein, token distribution, per-sample dumps) and its file
  ``<experiment>_enhanced_metrics_epoch_<N>.json``, copies of the JAX
  package's (lines 184-351) with the same keys and values.
"""

from __future__ import annotations

import json
import math
import os
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def levenshtein_raw(a: Sequence[int], b: Sequence[int]) -> int:
    """Plain edit distance between two token sequences."""
    m, n = len(a), len(b)
    if m == 0:
        return n
    if n == 0:
        return m
    if m > n:  # keep the vectorized row (b) the longer one: the Python loop
        a, b, m, n = b, a, n, m  # then runs min(m, n) iterations
    b_arr = np.asarray(b, dtype=np.int64)
    prev = np.arange(n + 1, dtype=np.int64)
    idx = np.arange(n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        sub = prev[:-1] + (b_arr != a[i - 1])
        dele = prev[1:] + 1
        cur = np.empty(n + 1, dtype=np.int64)
        cur[0] = i
        cur[1:] = np.minimum(sub, dele)
        # Insertion (cur[j] <= cur[j-1] + 1) is a prefix-min recurrence:
        # min over k<=j of cur[k] + (j - k) == minimum.accumulate(cur - j) + j.
        cur = np.minimum.accumulate(cur - idx) + idx
        prev = cur
    return int(prev[n])


def levenshtein_similarity(a: Sequence[int], b: Sequence[int]) -> float:
    """Normalized similarity ``1 - d / max(len(a), len(b))`` in [<=0, 1]."""
    max_len = max(len(a), len(b))
    if max_len == 0:
        return 1.0
    return 1.0 - levenshtein_raw(a, b) / max_len


def bleu_n_score(generated: Sequence[int], reference: Sequence[int], n: int = 4) -> float:
    """BLEU-n for a single candidate/reference pair of token-id sequences."""
    gen = list(map(int, generated))
    ref = list(map(int, reference))
    gen_len, ref_len = len(gen), len(ref)
    if gen_len == 0 or ref_len == 0:
        return 0.0
    log_sum = 0.0
    for k in range(1, n + 1):
        if gen_len < k or ref_len < k:
            return 0.0
        gen_ngrams = Counter(tuple(gen[i : i + k]) for i in range(gen_len - k + 1))
        ref_ngrams = Counter(tuple(ref[i : i + k]) for i in range(ref_len - k + 1))
        matching = sum(min(c, ref_ngrams[g]) for g, c in gen_ngrams.items())
        total = gen_len - k + 1
        if matching == 0:
            return 0.0
        log_sum += math.log(matching / total)
    geo_mean = math.exp(log_sum / n)
    if gen_len < ref_len:
        return math.exp(1.0 - ref_len / gen_len) * geo_mean
    return geo_mean


def token_list_accuracy(predictions: Sequence[Sequence[int]], targets: Sequence[Sequence[int]],
                        pad_token_id: int) -> Tuple[int, int]:
    """(correct, total) token counts over overlapping prefixes, ignoring PAD."""
    total_correct = 0
    total_tokens = 0
    for pred, tgt in zip(predictions, targets):
        m = min(len(pred), len(tgt))
        p = np.asarray(pred[:m])
        t = np.asarray(tgt[:m])
        mask = t != pad_token_id
        total_correct += int(np.sum((p == t) & mask))
        total_tokens += int(np.sum(mask))
    return total_correct, total_tokens


def masked_accuracy_from_arrays(pred_ids: np.ndarray, targets: np.ndarray,
                                pad_token_id: int) -> Tuple[int, int]:
    """(correct, total) for dense (B, L) arrays, PAD positions of the target ignored."""
    mask = targets != pad_token_id
    return int(np.sum((pred_ids == targets) & mask)), int(np.sum(mask))


def calculate_metrics(predictions: Sequence[Sequence[int]], targets: Sequence[Sequence[int]],
                      bleu_n: int = 4) -> Dict[str, float]:
    """Mean BLEU and mean Levenshtein similarity over a batch."""
    if len(predictions) != len(targets):
        raise ValueError("predictions/targets length mismatch")
    n = len(predictions)
    if n == 0:
        return {"bleu": 0.0, "levenshtein": 0.0, "batch_size": 0}
    bleu = sum(bleu_n_score(predictions[i], targets[i], bleu_n) for i in range(n)) / n
    lev = sum(levenshtein_similarity(predictions[i], targets[i]) for i in range(n)) / n
    return {"bleu": bleu, "levenshtein": lev, "batch_size": n}


def analyze_token_distribution(predictions: Sequence[Sequence[int]], targets: Sequence[Sequence[int]],
                               tokenizer, top_k: int = 10) -> Dict[str, Any]:
    """Top-k tokens, entropy, diversity and repetition factor."""

    def _entropy(counter: Counter, total: int) -> float:
        if total == 0:
            return 0.0
        probs = np.array([c / total for c in counter.values()], dtype=np.float64)
        probs = probs[probs > 0]
        return float(-np.sum(probs * np.log(probs)))

    pred_flat = [int(t) for seq in predictions for t in seq]
    tgt_flat = [int(t) for seq in targets for t in seq]
    pred_counter, tgt_counter = Counter(pred_flat), Counter(tgt_flat)
    pred_common = pred_counter.most_common(top_k)
    tgt_common = tgt_counter.most_common(top_k)
    return {
        "predictions": {
            "top_tokens": [(tokenizer.id_to_token.get(tid, "<UNK>"), cnt) for tid, cnt in pred_common],
            "entropy": _entropy(pred_counter, len(pred_flat)),
            "diversity": len(pred_counter) / len(pred_flat) if pred_flat else 0,
            "repetition_factor": pred_common[0][1] / len(pred_flat) if pred_common else 0,
        },
        "targets": {
            "top_tokens": [(tokenizer.id_to_token.get(tid, "<UNK>"), cnt) for tid, cnt in tgt_common],
            "entropy": _entropy(tgt_counter, len(tgt_flat)),
            "diversity": len(tgt_counter) / len(tgt_flat) if tgt_flat else 0,
        },
    }


def sample_predictions_and_targets(probs_max: np.ndarray, pred_ids: np.ndarray, targets: np.ndarray,
                                   tokenizer, num_samples: int = 2,
                                   confidence_threshold: float = 0.5) -> Dict[str, List]:
    """Per-sample prediction and confidence dump, from the eval step's
    max-probabilities and argmax ids (not the (B, L, V) logits)."""
    samples = []
    for i in range(min(pred_ids.shape[0], num_samples)):
        pred_mask = pred_ids[i] != tokenizer.pad_token_id
        tgt_mask = targets[i] != tokenizer.pad_token_id
        pred_seq = pred_ids[i][pred_mask]
        tgt_seq = targets[i][tgt_mask]
        confidences = probs_max[i][pred_mask]
        low_idx = np.where(confidences < confidence_threshold)[0]
        low_tokens = [(tokenizer.id_to_token.get(int(pred_seq[j]), "<UNK>"), float(confidences[j]))
                      for j in low_idx if j < len(pred_seq)]
        samples.append({
            "prediction": tokenizer.decode(pred_seq.tolist()),
            "target": tokenizer.decode(tgt_seq.tolist()),
            "low_confidence_tokens": low_tokens,
            "token_by_token": [
                {
                    "pred_token": tokenizer.id_to_token.get(int(t), "<UNK>"),
                    "confidence": float(c),
                    "is_correct": bool(t == tgt_seq[j]) if j < len(tgt_seq) else None,
                }
                for j, (t, c) in enumerate(zip(pred_seq, confidences))
                if j < 20
            ],
        })
    return {"samples": samples}


def _to_jsonable(obj: Any) -> Any:
    if obj is None:
        return None
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.bool_, bool)):
        return bool(obj)
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def save_enhanced_metrics(metrics: Dict[str, Any], experiment_name: str, metrics_dir: str, epoch: int) -> str:
    """Write ``<experiment>_enhanced_metrics_epoch_<N>.json`` under ``metrics_dir``."""
    os.makedirs(metrics_dir, exist_ok=True)
    path = os.path.join(metrics_dir, f"{experiment_name}_enhanced_metrics_epoch_{epoch}.json")
    with open(path, "w") as f:
        json.dump(_to_jsonable(metrics), f, indent=2)
    return path


def compute_all_metrics(all_predictions: List[List[int]], all_targets: List[List[int]], tokenizer,
                        probs_max: Optional[np.ndarray] = None, pred_ids: Optional[np.ndarray] = None,
                        dense_targets: Optional[np.ndarray] = None, num_samples: int = 2,
                        confidence_threshold: float = 0.5, experiment_name: Optional[str] = None,
                        metrics_dir: Optional[str] = None, save_to_file: bool = False,
                        epoch: Optional[int] = None, bleu_n: int = 4) -> Dict[str, Any]:
    """Accuracy, BLEU, Levenshtein, token distribution and sample dumps in
    one report, written to a file with ``save_to_file`` (and a name, a
    directory and an epoch)."""
    combined: Dict[str, Any] = {}
    if pred_ids is not None and dense_targets is not None:
        correct, total = masked_accuracy_from_arrays(np.asarray(pred_ids), np.asarray(dense_targets),
                                                     tokenizer.pad_token_id)
        if probs_max is not None:
            combined["samples"] = sample_predictions_and_targets(
                np.asarray(probs_max), np.asarray(pred_ids), np.asarray(dense_targets), tokenizer,
                num_samples, confidence_threshold)
        else:
            combined["samples"] = {"samples": []}
    else:
        correct, total = token_list_accuracy(all_predictions, all_targets, tokenizer.pad_token_id)
        combined["samples"] = {"samples": []}
    combined["accuracy"] = correct / total if total > 0 else 0.0
    combined["num_tokens"] = total

    basic = calculate_metrics(all_predictions, all_targets, bleu_n)
    combined["bleu"] = basic["bleu"]
    combined["levenshtein"] = basic["levenshtein"]
    combined["batch_size"] = basic["batch_size"]
    combined["token_distribution"] = analyze_token_distribution(all_predictions, all_targets, tokenizer)
    if epoch is not None:
        combined["epoch"] = epoch
    if save_to_file and experiment_name and metrics_dir and epoch is not None:
        save_enhanced_metrics(combined, experiment_name, metrics_dir, epoch)
    return combined
