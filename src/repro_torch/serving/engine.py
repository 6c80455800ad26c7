"""Serving engine — the paper's injection as cache operations, on one device.

The batch features correspond to a cached model state (per-layer K/V)
that the daily job can materialise; injecting fresh events runs only the
suffix through the model, O(suffix) instead of O(history):

    snapshot = engine.prefill(batch_history)          # daily job, cacheable
    state    = engine.inject(snapshot, fresh_events)  # per request, cheap
    slate    = engine.decode_slate(state, first_logits, slate_len)

``prefill`` and ``inject`` return sequence-form caches (K/V grown along
the sequence); ``finalize`` turns them into the fixed-capacity ring cache
that ``decode`` and ``decode_slate`` use. The engine pads requests to
fixed shapes (``pad_tokens``). Entry points take numpy arrays or tensors
and return tensors on the engine's device; ``decode_slate`` returns numpy.

Against the JAX package's engine: no device mesh, no weight patches, no
sampled decode (``temperature > 0`` raises), and no query chunking (the
attention kernel streams keys, so ``ServingConfig`` has no ``q_chunk``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device
from repro_torch.models.model import (cache_from_prefill, decode_step, extend,
                                      prefill)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    max_batch: int = 8
    prefill_len: int = 1024        # padded batch-history length
    inject_len: int = 32           # padded fresh-suffix length
    cache_capacity: int = 2048     # ring-cache slots for decode
    temperature: float = 0.0       # 0 = greedy


class ShapeDtype(NamedTuple):
    """The shape and dtype of a tensor, without the tensor (the port's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same keys."""
    return {k: _tree_map(fn, *(t[k] for t in trees))
            if isinstance(trees[0][k], dict) else fn(*(t[k] for t in trees))
            for k in trees[0]}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


class ServingEngine:
    """The token-level serving path of one dense ranker on one device.

    ``params`` is the ranker's param tree (``models.model.init_params`` or
    ``weights.params_from_numpy``); it is moved to ``device``, which
    defaults to the CUDA device and must exist unless ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 scfg: ServingConfig, device="cuda"):
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        self.params = _tree_map(lambda x: x.to(self.device), params)
        # one device: a pane is one shard (the Gateway's per-shard bytes)
        self.data_shards = 1

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()  # torch takes no read-only numpy buffers
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def prefill_state_shapes(self) -> Tuple[ShapeDtype, Dict[str, Any]]:
        """``(logits, caches)`` of one prefill pane as :class:`ShapeDtype`
        leaves: what ``prefill`` returns for a ``(max_batch, prefill_len)``
        call, logits ``(max_batch, prefill_len, Vp)`` and every cache leaf
        layer-stacked with the batch on axis 1. The paged state pool
        (serving/pool.py) sizes its slot buffers from this.

        torch has no ``eval_shape``: one real row of prefill (last logits
        only) runs on the engine's device, so the shapes cannot drift from
        what prefill produces, and the batch and sequence sizes are put
        back in."""
        b, p = self.scfg.max_batch, self.scfg.prefill_len
        state = self.prefill(np.zeros((1, p), np.int32),
                             np.ones((1, p), bool), logits_last_only=True)
        logits = state["logits"]
        caches = _tree_map(lambda x: ShapeDtype(
            (x.shape[0], b) + tuple(x.shape[2:]), x.dtype), state["caches"])
        return (ShapeDtype((b, p, logits.shape[-1]), logits.dtype), caches)

    # ------------------------------------------------------------------
    def pad_tokens(self, seqs, length: int, align: str = "right",
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad a list of variable-length token lists into (tokens, valid)
        of shape (max_batch, length).

        Prefill buffers are right-aligned (real tokens end at the last
        buffer position, so one uniform ``next_pos`` covers the batch);
        inject suffixes are LEFT-aligned (real tokens contiguous from the
        row's ``next_pos`` — RoPE distances stay exact per row).

        Raises ``ValueError`` when more than ``max_batch`` sequences are
        passed — silently dropping requests is a serving bug; callers with
        larger waves must pane-split.
        """
        b = self.scfg.max_batch
        if len(seqs) > b:
            raise ValueError(
                f"{len(seqs)} sequences exceed max_batch={b}; split the "
                f"request wave into panes of at most {b} rows")
        toks = np.zeros((b, length), np.int32)
        valid = np.zeros((b, length), bool)
        for i, s in enumerate(seqs):
            s = list(s)[-length:]
            if not s:
                continue
            if align == "right":
                toks[i, length - len(s):] = s
                valid[i, length - len(s):] = True
            else:
                toks[i, :len(s)] = s
                valid[i, :len(s)] = True
        return toks, valid

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens, valid, logits_last_only: bool = False,
                ) -> Dict[str, Any]:
        """Materialise the batch-history state (the daily-job analogue).

        Positions index the padded buffer (real tokens right-aligned), so
        later inject and decode positions continue at the buffer length.
        ``logits`` are the full (B, S, Vp) f32 logits, as in the JAX
        package, or only the last position's (B, 1, Vp) with
        ``logits_last_only``; callers read ``[:, -1]`` either way."""
        tokens = self._tensor(tokens, torch.int32)
        valid = self._tensor(valid, torch.bool)
        logits, caches = prefill(self.params, self.cfg, tokens, valid=valid,
                                 logits_last_only=logits_last_only)
        b, s = tokens.shape
        return {"caches": caches, "valid": valid,
                # right-aligned prefill: every row's next position is S
                "next_pos": torch.full((b,), s, dtype=torch.int32,
                                       device=self.device),
                "logits": logits}

    @torch.no_grad()
    def inject(self, state: Dict[str, Any], suffix_tokens, suffix_valid,
               fallback_logits=None) -> Dict[str, Any]:
        """Incremental prefill of fresh events against a cached state — the
        paper's injection: O(suffix) compute, model untouched. The suffix
        must be LEFT-aligned (see ``pad_tokens``).

        Adds to the prefill state's keys ``n_valid`` (real suffix length
        per row) and ``last_valid_logits`` (the scores after the row's last
        real event; clamped to position 0 for an empty row, whose value is
        meaningless). With ``fallback_logits`` (B, Vp), the pre-inject
        scores, the result also carries ``first_logits``: last-valid scores
        for rows with a real suffix, the fallback for empty rows."""
        tokens = self._tensor(suffix_tokens, torch.int32)
        valid = self._tensor(suffix_valid, torch.bool)
        prefix_valid = state["valid"]
        start = state["next_pos"]
        logits, caches = extend(self.params, self.cfg, state["caches"],
                                tokens, start, valid=valid,
                                prefix_valid=prefix_valid)
        n_valid = valid.sum(-1).to(torch.int32)
        rows = torch.arange(tokens.shape[0], device=self.device)
        last_valid = logits[rows, (n_valid - 1).clamp_min(0).long()]
        out = {
            "caches": caches, "logits": logits,
            "valid": torch.cat([prefix_valid, valid], dim=1),
            "next_pos": start + n_valid,
            "n_valid": n_valid,
            "last_valid_logits": last_valid,
        }
        if fallback_logits is not None:
            fallback = self._tensor(fallback_logits, torch.float32)
            out["first_logits"] = torch.where((n_valid > 0)[:, None],
                                              last_valid, fallback)
        return out

    @torch.no_grad()
    def finalize(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Sequence-form state -> fixed-capacity ring cache for decode."""
        caches = cache_from_prefill(self.cfg, state["caches"],
                                    self.scfg.cache_capacity,
                                    valid=state["valid"])
        return {"caches": caches, "pos": state["next_pos"]}

    @torch.no_grad()
    def decode(self, dec: Dict[str, Any], tokens,
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One serve step: tokens (B,1) -> (logits (B,Vp), updated dec).
        ``dec``'s own cache is left as it was."""
        logits, caches = decode_step(self.params, self.cfg, dec["caches"],
                                     self._tensor(tokens, torch.int32),
                                     dec["pos"])
        return logits[:, 0], {"caches": caches, "pos": dec["pos"] + 1}

    @torch.no_grad()
    def decode_slate(self, state: Dict[str, Any], first_logits,
                     slate_len: int, row_lens=None) -> np.ndarray:
        """finalize + a greedy slate of ``slate_len`` distinct items.

        Each step picks the argmax of the current logits with the items
        already chosen masked out, then advances decode: ``slate_len - 1``
        decode steps in all (the last pick needs no advance). The chosen
        mask stays on the device, and the steps write into the ring cache
        that this call's ``finalize`` made. Greedy only: an engine with
        ``temperature > 0`` raises. Returns int32 (B, slate_len).

        ``row_lens`` (B,) gives per-request slate lengths in one pane: the
        pane decodes ``slate_len`` steps and a row's slots at
        ``>= row_lens[row]`` are -1. Greedy decode is prefix-stable, so a
        row's first k items are the k-slate it would get alone."""
        if self.scfg.temperature > 0:
            raise NotImplementedError(
                "decode_slate is greedy-only; sampled slate decode "
                f"(temperature={self.scfg.temperature}) is not implemented")
        dec = self.finalize(state)
        caches, pos = dec["caches"], dec["pos"]
        logits = self._tensor(first_logits, torch.float32)
        b = logits.shape[0]
        rows = torch.arange(b, device=self.device)
        mask = torch.zeros(logits.shape, dtype=torch.bool, device=self.device)

        def pick(logits):
            tok = torch.argmax(torch.where(mask, NEG_INF, logits),
                               dim=-1).to(torch.int32)
            mask[rows, tok.long()] = True
            return tok

        picks = []
        for _ in range(slate_len - 1):
            tok = pick(logits)
            picks.append(tok)
            nxt, caches = decode_step(self.params, self.cfg, caches,
                                      tok[:, None], pos, inplace=True)
            pos = pos + 1
            logits = nxt[:, 0]
        picks.append(pick(logits))
        slate = torch.stack(picks, dim=1)
        if row_lens is not None:
            lens = self._tensor(row_lens, torch.int32)
            keep = torch.arange(slate_len, dtype=torch.int32,
                                device=self.device)[None, :] < lens[:, None]
            slate = torch.where(keep, slate, -1)
        return slate.cpu().numpy()

    def sample(self, logits) -> torch.Tensor:
        """Greedy next tokens (B,) int32; sampled decode is not ported."""
        if self.scfg.temperature > 0:
            raise NotImplementedError(
                f"sampled decode (temperature={self.scfg.temperature}) is "
                "not implemented")
        return torch.argmax(logits, dim=-1).to(torch.int32)
