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
* :func:`calculate_metrics` - mean BLEU and mean Levenshtein similarity.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Sequence, Tuple

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
