"""Training data: event logs -> next-item training examples (the JAX
package's ``data/loader.py``, copied bit for bit).

Encodes the paper's two training regimes (§IV):

* ``cutoff="midnight"`` — the **batch-trained** model: for a label watch at
  time t, the input history is everything the daily job had materialized by
  then, i.e. events before the last midnight prior to t. This is the model
  the paper keeps untouched and injects into (control + treatment arms).

* ``cutoff="fresh"`` — the **consistent variant**: auxiliary features
  "explicitly representing recent watch behavior (e.g., items watched in the
  past few hours)" are present at training AND inference. The example input
  is ``[batch_history…, SEP, recent_items…]`` where recent = same-day events
  before t, exactly what the serving path constructs for this arm. Because
  the logs were collected under the previously-deployed model, the recent
  segment is feedback-loop-correlated with the label — the mechanism the
  paper blames for this variant's null result.

Tokenization: item i ↦ token i+1; 0 = pad; SEP = n_items+1.
Loss is applied on the LAST position only (sequence → next item).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

DAY = 86400


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    n_items: int
    feature_len: int = 64          # input sequence length (incl. SEP segment)
    recent_len: int = 16           # max recent-segment length ("fresh" mode)
    min_history: int = 2
    seed: int = 0


def sep_token(n_items: int) -> int:
    return n_items + 1


def build_examples(events: Dict[str, np.ndarray], lcfg: LoaderConfig,
                   cutoff: str) -> Dict[str, np.ndarray]:
    """events: arrays from ``events_to_arrays`` (the platform's offline log).

    Returns {"tokens" (N,K), "labels" (N,), "valid" (N,K)} — next-item
    examples, one per watch event with enough history.
    """
    k, rl = lcfg.feature_len, lcfg.recent_len
    sep = sep_token(lcfg.n_items)
    # columnar grouping: one lexsort by (user, ts, item) replaces the
    # per-event dict build; each user's slice arrives already sorted.
    u_col = np.asarray(events["user"], np.int64)
    it_col = np.asarray(events["item"], np.int64)
    ts_col = np.asarray(events["ts"], np.int64)
    order = np.lexsort((it_col, ts_col, u_col))
    uniq, starts = np.unique(u_col[order], return_index=True)
    bounds = np.append(starts, len(order))

    toks_out, labels_out = [], []
    for g in range(len(uniq)):
        idx = order[bounds[g]:bounds[g + 1]]
        evs = list(zip(ts_col[idx].tolist(), it_col[idx].tolist()))
        for j in range(len(evs)):
            ts_label, item_label = evs[j]
            midnight = (ts_label // DAY) * DAY
            hist_batch = [e for e in evs[:j] if e[0] < midnight]
            if cutoff == "midnight":
                if len(hist_batch) < lcfg.min_history:
                    continue
                seq = [it + 1 for _, it in hist_batch[-k:]]
            elif cutoff == "fresh":
                recent = [e for e in evs[:j] if e[0] >= midnight][-rl:]
                if len(hist_batch) + len(recent) < lcfg.min_history:
                    continue
                head = [it + 1 for _, it in
                        hist_batch[-(k - 1 - len(recent)):]]
                seq = head + [sep] + [it + 1 for _, it in recent]
            else:
                raise ValueError(f"unknown cutoff {cutoff!r}")
            toks_out.append(seq)
            labels_out.append(item_label + 1)

    n = len(toks_out)
    tokens = np.zeros((n, k), np.int32)
    valid = np.zeros((n, k), bool)
    for i, seq in enumerate(toks_out):
        m = min(len(seq), k)
        tokens[i, k - m:] = seq[-m:]
        valid[i, k - m:] = True
    return {"tokens": tokens, "labels": np.asarray(labels_out, np.int32),
            "valid": valid}


def batches(examples: Dict[str, np.ndarray], batch_size: int, epochs: int,
            seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled fixed-shape batches; loss mask = last position only."""
    n, k = examples["tokens"].shape
    rng = np.random.RandomState(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            idx = order[s:s + batch_size]
            toks = examples["tokens"][idx]
            lab = np.zeros((batch_size, k), np.int32)
            lab[:, -1] = examples["labels"][idx]
            lmask = np.zeros((batch_size, k), bool)
            lmask[:, -1] = True
            # ``valid`` = token validity (attention/SSM mask);
            # ``loss_mask`` = predict-next-item on the last position only.
            yield {"tokens": toks, "labels": lab,
                   "valid": examples["valid"][idx], "loss_mask": lmask}


def serve_tokens_consistent(batch_feats, recent_feats, n_items: int,
                            feature_len: int):
    """Serving-path input construction for the consistent variant:
    ``[batch…, SEP, recent…]`` — mirrors build_examples(cutoff="fresh").

    batch_feats / recent_feats: (items, ts, valid) padded arrays.
    Returns (tokens (B,K), valid (B,K)) right-aligned.
    """
    bi, _, bv = batch_feats
    ri, _, rv = recent_feats
    b = bi.shape[0]
    k = feature_len
    sep = sep_token(n_items)
    tokens = np.zeros((b, k), np.int32)
    vout = np.zeros((b, k), bool)
    for r in range(b):
        rec = [int(i) + 1 for i, v in zip(ri[r], rv[r]) if v]
        head_budget = k - 1 - len(rec)
        head = [int(i) + 1 for i, v in zip(bi[r], bv[r]) if v][-head_budget:]
        seq = head + [sep] + rec
        m = min(len(seq), k)
        tokens[r, k - m:] = seq[-m:]
        vout[r, k - m:] = True
    return tokens, vout
