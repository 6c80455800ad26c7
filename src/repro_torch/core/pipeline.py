"""Two-stage recommendation pipeline (paper §III, Fig. 1/2).

Stage 1 — candidate retrieval:
  * **primary recaller**: recency-weighted mean of the user's watch-history
    item embeddings, scored against all item embeddings. Because it reads
    the *injected* features in the treatment arm, it "is enhanced to
    incorporate the user's recent watch history" exactly as §III-B-1
    describes — with zero code changes.
  * **auxiliary popularity recaller** ("used to diversify the candidate
    pool") — unchanged across arms, as in the paper.

Stage 2 — ranking: the batch-trained sequential ranker (``models.model.
Ranker``) consumes the same feature history and scores the candidate union;
top ``slate_size`` wins. Already-watched history items are excluded from
the slate.

Item-id ↔ token mapping: item i ↦ token i+1; token 0 is padding.

Every top-k is a stable descending sort, so ties go to the lower index as
they do in ``jax.lax.top_k`` (``torch.topk`` gives no such order). Ties
are common: a cold user's similarities are all 0, and a uniform popularity
prior ties every item.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.injection import FeatureInjector
from repro_torch.models.common import resolve_device
from repro_torch.models.model import Ranker

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_items: int
    slate_size: int = 10
    n_candidates: int = 128        # retrieval fan-in to the ranker
    recall_primary: int = 96       # primary recaller quota
    recall_popular: int = 32       # popularity recaller quota
    recency_halflife: int = 8      # events; recency weight 0.5**(age/halflife)
    serve_batch: int = 256         # static request-batch shape (padded)


def items_to_tokens(items: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """item ids -> model tokens (shift by 1; pad slots -> token 0)."""
    return np.where(valid > 0, items + 1, 0).astype(np.int32)


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries per row, ties to the lower index."""
    return torch.sort(x, dim=1, descending=True, stable=True).indices[:, :k]


# ----------------------------------------------------------------------
# The serve core
# ----------------------------------------------------------------------

def _serve_core(ranker: Ranker, tokens, valid, pop_prior, *,
                pcfg: PipelineConfig):
    """tokens/valid (B,K) int; pop_prior (V_items,) log-popularity.

    Returns (slate_items (B, slate), cand_items (B, C)) as item ids.
    """
    b, k = tokens.shape
    n_items = pcfg.n_items
    tokens = tokens.long()
    table = ranker.params["embed"]["table"]  # (Vp, d)

    # ---- stage 1: retrieval ------------------------------------------
    # recency-weighted mean embedding of history tokens
    age = (k - 1 - torch.arange(k, dtype=torch.float32,
                                device=tokens.device))[None, :]
    w = torch.where(valid > 0, 0.5 ** (age / pcfg.recency_halflife), 0.0)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    hist_emb = torch.einsum("bk,bkd->bd", w.to(table.dtype), table[tokens])
    item_emb = table[1:n_items + 1]  # (V_items, d)
    sim = (hist_emb @ item_emb.T).float()

    # exclude already-watched items from retrieval & ranking
    # (+2: slot 0 = pad token, last slot absorbs the SEP token harmlessly).
    # Pad token 0 is written many times, always False, and column 0 is
    # dropped, so the scatter's order among duplicates does not matter.
    watched = torch.zeros((b, n_items + 2), dtype=torch.bool,
                          device=tokens.device)
    watched.scatter_(1, tokens, valid > 0)
    watched = watched[:, 1:n_items + 1]  # item-id indexed
    sim = torch.where(watched, NEG_INF, sim)

    prim = _top_k(sim, pcfg.recall_primary)                      # (B, M1)
    pop = torch.where(watched, NEG_INF, pop_prior[None, :])
    popc = _top_k(pop, pcfg.recall_popular)                      # (B, M2)
    cand = torch.cat([prim, popc], dim=1)                        # item idx

    # ---- stage 2: ranking --------------------------------------------
    last = ranker(tokens, valid=valid > 0, last_only=True)[:, -1]  # (B, Vp)
    cand_scores = torch.gather(last, 1, cand + 1)                # (B, C)
    # dedup candidates (popularity quota may collide with primary):
    # mask any candidate equal to an earlier candidate in the row.
    c = cand.shape[1]
    ar = torch.arange(c, device=cand.device)
    eq_earlier = (cand[:, :, None] == cand[:, None, :]) \
        & (ar[None, :, None] > ar[None, None, :])
    cand_scores = torch.where(eq_earlier.any(-1), NEG_INF, cand_scores)
    slate = torch.gather(cand, 1, _top_k(cand_scores, pcfg.slate_size))
    return slate, cand


# ----------------------------------------------------------------------
# The platform: injector + pipeline + model = one A/B arm
# ----------------------------------------------------------------------

class RecommenderPlatform:
    """Callable platform for the simulator: serve(users, tss) -> slates.

    Serves the JAX package's "plain" mode (features straight from the
    injector). ``params`` is the param tree (``models.model.init_params``
    or ``weights.params_from_numpy``); the ranker runs on ``device``."""

    def __init__(self, pcfg: PipelineConfig, model_cfg: ModelConfig, params,
                 injector: FeatureInjector, popularity: np.ndarray,
                 run_batch_jobs: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.pcfg = pcfg
        self.model_cfg = model_cfg
        self.ranker = Ranker(model_cfg, params).to(self.device)
        self.injector = injector
        self.pop_prior = torch.as_tensor(
            np.log(popularity * len(popularity) + 1e-9), dtype=torch.float32,
            device=self.device)
        self.run_batch_jobs = run_batch_jobs
        self.serve_calls = 0
        # registered observers: called with every event AFTER the stores
        # ingest it (anything with .user/.item/.ts).
        self.on_observe: list = []

    # -- event plumbing -------------------------------------------------
    def observe(self, ev) -> None:
        """Platform-side event hooks: offline log + realtime stream,
        then any registered ``on_observe`` callbacks."""
        self.injector.batch.append(ev.user, ev.item, ev.ts)
        if self.injector.realtime is not None:
            self.injector.realtime.ingest(ev.user, ev.item, ev.ts)
        for cb in self.on_observe:
            cb(ev)

    # -- serving ---------------------------------------------------------
    def serve(self, users: np.ndarray, tss: np.ndarray) -> np.ndarray:
        now = int(tss.max())
        if self.run_batch_jobs:
            self.injector.batch.maybe_run_due_snapshots(now)
        items, ts_arr, valid = self.injector.features(users, now)
        tokens = items_to_tokens(items, valid)

        n = len(users)
        bpad = self.pcfg.serve_batch
        if n < bpad:  # pad to the static batch shape
            tokens = np.pad(tokens, ((0, bpad - n), (0, 0)))
            valid = np.pad(valid, ((0, bpad - n), (0, 0)))
        with torch.inference_mode():
            slate, _ = _serve_core(
                self.ranker, torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(np.ascontiguousarray(valid)).to(self.device),
                self.pop_prior, pcfg=self.pcfg)
        self.serve_calls += 1
        return slate[:n].to(torch.int32).cpu().numpy()
