"""Serving engine — the paper's injection as cache operations, on one device
or on a device mesh.

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

**The slate as one program.** The JAX package runs a greedy slate as one
jitted ``lax.scan``. Here, on a CUDA engine, ``decode_slate`` replays a
``torch.cuda.CUDAGraph`` that holds the whole slate (every pick, mask
update and ``decode_step``), one graph per slate length and pane shape;
on the CPU the same body runs eagerly (``_decode_slate_loop``). The
graphs of one pane shape share one set of ring buffers, and all of an
engine's graphs share one memory pool, so a new slate length costs a
capture, not another copy of the rings. A graph reads the parameters
and the ring buffers by address, so ``apply_patch`` copies new values
into the engine's tensors instead of rebinding them, and a warm graph
serves the patched weights.

**Sharded serving.** Pass a ("data", "model") ``DeviceMesh``
(``launch/mesh.py``): the engine resolves ``serving_pspecs`` once
(raising its ``ValueError`` for a ``max_batch`` the data size does not
divide) and keeps the rank's shards of the params, cut by that layout
(TP over ``model``, replicated over ``data``; params that are already the
rank's shards are taken as they are). Every rank runs the same calls
(SPMD). Entry points take the full pane, or the rank's rows of it, and
compute the rank's ``max_batch / data`` rows; the states they return hold
the rank's rows. What leaves for the host is all-gathered over ``data``:
``decode_slate``'s slate, and through ``full_rows``/``full_pane`` the
logits and the prefill states that the host LRU and the pool keep. The
model collectives run inside the model functions (``models/model.py``).
On a mesh with more than one ``model`` rank ``decode_slate`` runs its
eager loop: that is decided here, at construction (``graph_slates``),
because a captured graph would hold the model axis's collectives.

Against the JAX package's engine: no query chunking (the attention
kernel streams keys, so ``ServingConfig`` has no ``q_chunk``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import launch_counters
from repro_torch.models.common import flatten_with_keystr, resolve_device
from repro_torch.models.common import tree_map as _tree_map
from repro_torch.models.model import (cache_from_prefill, decode_step, extend,
                                      param_shapes, prefill)
from repro_torch.sharding.local import (axis_rank, gather_rows, group_size,
                                        local_shard, shard_factor,
                                        warm_groups)
from repro_torch.weights import as_tensor

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


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _by_keystr(tree, prefix: str = "") -> Dict[str, Any]:
    """{keystr path: leaf} of a nested dict whose leaves may be tuples
    (shapes, specs): ``flatten_with_keystr``'s paths, dicts only."""
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        path = f"{prefix}[{k!r}]"
        if isinstance(tree[k], dict):
            out.update(_by_keystr(tree[k], path))
        else:
            out[path] = tree[k]
    return out


class ServingEngine:
    """The token-level serving path of one ranker, on one device or on a
    rank of a device mesh.

    ``params`` is the ranker's param tree (``models.model.init_params`` or
    ``weights.params_from_numpy``); the engine serves copies of it on
    ``device`` (``apply_patch`` writes into them, never into the caller's
    tensors), which defaults to the CUDA device and must exist unless
    ``device="cpu"``. With a ``mesh`` each leaf may be whole or already
    this rank's shard; the engine keeps the shard (module docstring)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 scfg: ServingConfig, device="cuda", mesh=None):
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is None:
            self.params = _tree_map(lambda x: x.to(self.device, copy=True),
                                    params)
            # one device: a pane is one shard (the Gateway's per-shard bytes)
            self.data_shards = 1
        else:
            from repro_torch.sharding.rules import (serving_pspecs,
                                                    slot_pool_pspecs)
            self._specs = serving_pspecs(cfg, mesh, scfg.max_batch)
            self.data_shards = self._specs.data_shards
            self._full_shapes = _by_keystr(param_shapes(cfg))
            self._spec_of = _by_keystr(self._specs.params)
            self.params = self._place(params)
            # the blocks each cache leaf is cut into over ``model``: a
            # state's bytes as one device would hold them
            self._cache_factors = {
                k: {n: shard_factor(sp, mesh) for n, sp in v.items()}
                for k, v in slot_pool_pspecs(cfg, mesh).caches.items()}
            warm_groups(mesh, self.device)
        # the slate runs as a captured CUDA graph, but not where the graph
        # would hold the model axis's collectives: there the eager loop
        self.graph_slates = (self.device.type == "cuda"
                             and group_size(mesh, "model") == 1)
        self._slate_buffers: Dict[Tuple[int, ...], _SlateBuffers] = {}
        self._slate_graphs: Dict[Tuple[int, Tuple[int, ...]],
                                 _SlateGraph] = {}
        self._graph_pool = None       # one memory pool for every graph
        self._side_stream = None      # the graphs' warm-up runs
        self._generator: Optional[torch.Generator] = None

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()  # torch takes no read-only numpy buffers
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    # The mesh: shards and the rank's rows
    # ------------------------------------------------------------------
    def _place(self, params) -> Dict[str, Any]:
        """Copies on the device of the rank's shards of ``params``, whose
        leaves are whole or already the rank's shards."""
        def place(path, x):
            spec, full = self._spec_of[path], self._full_shapes[path]
            if tuple(x.shape) == tuple(full):
                x = local_shard(x, spec, self.mesh)
            elif tuple(x.shape) != _local_shape(full, spec, self.mesh):
                raise ValueError(
                    f"param {path}: shape {tuple(x.shape)} is neither "
                    f"{tuple(full)} nor its shard "
                    f"{_local_shape(full, spec, self.mesh)}")
            return x.to(self.device, copy=True)
        return _map_keystr(place, params)

    def row_block(self) -> slice:
        """The rows of a pane that this rank computes (every row without a
        mesh)."""
        if self.data_shards == 1:
            return slice(None)
        n = self.scfg.max_batch // self.data_shards
        r = axis_rank(self.mesh, "data")
        return slice(r * n, (r + 1) * n)

    def _rows(self, x, dim: int = 0):
        """The rank's rows of ``x`` (numpy or a tensor) along ``dim``: its
        block of a full pane, or ``x`` when it holds just those rows."""
        if x is None or self.data_shards == 1:
            return x
        b = self.scfg.max_batch
        n = x.shape[dim]
        if n == b:
            return x[(slice(None),) * dim + (self.row_block(),)]
        if n == b // self.data_shards:
            return x
        raise ValueError(f"a pane of {n} rows: want {b} (the full pane) or "
                         f"{b // self.data_shards} (this rank's)")

    def full_rows(self, x, dim: int = 0):
        """``x`` with every row of the pane: the rank's rows all-gathered
        over ``data``, or ``x`` when it holds them all already."""
        if x is None or self.data_shards == 1 or \
                x.shape[dim] == self.scfg.max_batch:
            return x
        return gather_rows(self._rows(x, dim), self.mesh, dim)

    def _each_row_leaf(self, fn, state: Dict[str, Any]) -> Dict[str, Any]:
        """``fn(leaf, dim)`` over a state's per-row leaves: the cache
        leaves (rows on dim 1) and every other tensor (rows on dim 0)."""
        return {k: (_tree_map(lambda x: fn(x, 1), v) if k == "caches"
                    else v if v is None else fn(v, 0))
                for k, v in state.items()}

    def _local(self, state: Dict[str, Any]) -> Dict[str, Any]:
        if self.data_shards == 1:
            return state
        return self._each_row_leaf(self._rows, state)

    def full_pane(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """A state with every row of the pane (``full_rows`` of each
        per-row leaf): what the host LRU and the pool keep."""
        if self.data_shards == 1:
            return state
        return self._each_row_leaf(self.full_rows, state)

    def logical_nbytes(self, state: Dict[str, Any]) -> int:
        """The bytes of a state's leaves as one device would hold them:
        each cache leaf's bytes times the blocks its model dims are cut
        into, the other leaves as they are (the host LRU's and the pool's
        byte accounting, equal across meshes)."""
        total = 0
        for k, v in state.items():
            if k == "caches":
                if self.mesh is None:
                    total += sum(x.nbytes for x in _leaves(v))
                else:
                    total += sum(_leaves(_tree_map(
                        lambda x, f: x.nbytes * f, v, self._cache_factors)))
            elif hasattr(v, "nbytes"):
                total += v.nbytes
        return total

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
        state = self._prefill(self._tensor(np.zeros((1, p), np.int32)),
                              self._tensor(np.ones((1, p), bool)),
                              logits_last_only=True)
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
        ``logits_last_only``; callers read ``[:, -1]`` either way. On a
        mesh the state holds the rank's rows."""
        return self._prefill(self._tensor(self._rows(tokens), torch.int32),
                             self._tensor(self._rows(valid), torch.bool),
                             logits_last_only)

    def _prefill(self, tokens, valid, logits_last_only: bool
                 ) -> Dict[str, Any]:
        logits, caches = prefill(self.params, self.cfg, tokens, valid=valid,
                                 logits_last_only=logits_last_only,
                                 mesh=self.mesh)
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
        for rows with a real suffix, the fallback for empty rows. On a mesh
        the result holds the rank's rows."""
        state = self._local(state)
        tokens = self._tensor(self._rows(suffix_tokens), torch.int32)
        valid = self._tensor(self._rows(suffix_valid), torch.bool)
        prefix_valid = state["valid"]
        start = state["next_pos"]
        logits, caches = extend(self.params, self.cfg, state["caches"],
                                tokens, start, valid=valid,
                                prefix_valid=prefix_valid, mesh=self.mesh)
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
            fallback = self._tensor(self._rows(fallback_logits),
                                    torch.float32)
            out["first_logits"] = torch.where((n_valid > 0)[:, None],
                                              last_valid, fallback)
        return out

    @torch.no_grad()
    def finalize(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Sequence-form state -> fixed-capacity ring cache for decode."""
        state = self._local(state)
        caches = cache_from_prefill(self.cfg, state["caches"],
                                    self.scfg.cache_capacity,
                                    valid=state["valid"])
        return {"caches": caches, "pos": state["next_pos"]}

    @torch.no_grad()
    def decode(self, dec: Dict[str, Any], tokens,
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One serve step: tokens (B,1) -> (logits (B,Vp), updated dec).
        ``dec``'s own cache is left as it was. On a mesh the logits and
        ``dec`` hold the rank's rows."""
        dec = self._local(dec)
        logits, caches = decode_step(self.params, self.cfg, dec["caches"],
                                     self._tensor(self._rows(tokens),
                                                  torch.int32),
                                     dec["pos"], mesh=self.mesh)
        return logits[:, 0], {"caches": caches, "pos": dec["pos"] + 1}

    @torch.no_grad()
    def decode_slate(self, state: Dict[str, Any], first_logits,
                     slate_len: int, row_lens=None) -> np.ndarray:
        """finalize + a greedy slate of ``slate_len`` distinct items.

        Each step picks the argmax of the current logits with the items
        already chosen masked out, then advances decode: ``slate_len - 1``
        decode steps in all (the last pick needs no advance). Greedy only:
        an engine with ``temperature > 0`` raises. Returns int32
        (B, slate_len).

        On a CUDA engine the slate is one replay of a captured CUDA graph
        (captured at the first call for a slate length and pane shape;
        ``slate_graph_stats``); a capture or replay error raises, and the
        eager loop is never taken. On the CPU the same steps run eagerly.
        Both write into a ring cache of their own, never into ``state``:
        on the card, the ring buffers that every graph of the pane shape
        shares.

        ``row_lens`` (B,) gives per-request slate lengths in one pane: the
        pane decodes ``slate_len`` steps and a row's slots at
        ``>= row_lens[row]`` are -1. Greedy decode is prefix-stable, so a
        row's first k items are the k-slate it would get alone.

        On a mesh the rank decodes its rows and the slate is all-gathered
        over ``data``: every rank returns the whole pane's. The graph is
        used only where ``graph_slates`` (no model-axis collectives)."""
        self._check_greedy()
        if not self.graph_slates:
            return self._decode_slate_loop(state, first_logits, slate_len,
                                           row_lens)
        state = self._local(state)
        first = self._tensor(self._rows(first_logits), torch.float32)
        # cfg, scfg and the params fix every ring shape and dtype but the
        # batch, which is first's
        shape = tuple(first.shape)
        bufs = self._slate_buffers.get(shape)
        if bufs is None:
            bufs = self._slate_buffers[shape] = _SlateBuffers(self, state,
                                                              first)
        graph = self._slate_graphs.get((slate_len, shape))
        if graph is None:
            graph = self._slate_graphs[(slate_len, shape)] = _SlateGraph(
                self, bufs, slate_len)
        bufs.load(state, first)
        slate = self.full_rows(graph.replay())
        return _mask_tail(slate.cpu().numpy(), row_lens)

    def slate_graph_stats(self) -> Dict[Tuple[int, Tuple[int, ...]],
                                        SlateGraphStats]:
        """The captured slate graphs, by ``(slate_len, pane shape)``: the
        pane shape is ``first_logits``' ``(B, Vp)``. Empty on the CPU."""
        return {key: SlateGraphStats(
            g.capture_s * 1e3, {n: k for n, (_, k) in g.captured.items()},
            g.replays, self._slate_buffers[key[1]].nbytes)
            for key, g in self._slate_graphs.items()}

    @torch.no_grad()
    def _decode_slate_loop(self, state: Dict[str, Any], first_logits,
                           slate_len: int, row_lens=None) -> np.ndarray:
        """``decode_slate`` as an eager loop of the same steps: the CPU
        path, the path of a mesh with model-axis collectives, and on the
        card the graph's parity and timing reference."""
        self._check_greedy()
        dec = self.finalize(state)
        slate = self._slate_body(dec["caches"], dec["pos"],
                                 self._tensor(self._rows(first_logits),
                                              torch.float32),
                                 slate_len)
        return _mask_tail(self.full_rows(slate).cpu().numpy(), row_lens)

    def _check_greedy(self) -> None:
        if self.scfg.temperature > 0:
            raise NotImplementedError(
                "decode_slate is greedy-only; sampled slate decode "
                f"(temperature={self.scfg.temperature}) is not implemented "
                "— drive decode()/sample() directly for sampled serving")

    def _slate_body(self, caches, pos, logits, slate_len: int
                    ) -> torch.Tensor:
        """The greedy slate over ring ``caches``, which it advances in
        place: the JAX package's ``_slate_impl`` step for step. The
        chosen mask is updated by a one-hot compare, not an indexed
        write, and no step reads a value back to the host, so the body
        can be captured as it is."""
        iota = torch.arange(logits.shape[-1], dtype=torch.int32,
                            device=logits.device)
        mask = torch.zeros(logits.shape, dtype=torch.bool,
                           device=logits.device)

        def pick(logits, mask):
            tok = torch.argmax(torch.where(mask, NEG_INF, logits),
                               dim=-1).to(torch.int32)
            return tok, mask | (iota[None, :] == tok[:, None])

        picks = []
        for _ in range(slate_len - 1):
            tok, mask = pick(logits, mask)
            picks.append(tok)
            nxt, caches = decode_step(self.params, self.cfg, caches,
                                      tok[:, None], pos, inplace=True,
                                      mesh=self.mesh)
            pos = pos + 1
            logits = nxt[:, 0]
        picks.append(pick(logits, mask)[0])
        return torch.stack(picks, dim=1)

    def sample(self, logits, generator: Optional[torch.Generator] = None,
               noise=None) -> torch.Tensor:
        """Next tokens (B,) int32 from logits (B, Vp): the argmax at
        temperature 0, else a draw from ``softmax(logits / T)`` by the
        Gumbel-max rule ``jax.random.categorical`` uses:
        ``argmax(gumbel + logits / T)``, with ``gumbel = -log(-log(U))``
        and ``U`` uniform on [tiny, 1). ``noise`` (B, Vp) is the gumbel
        term itself (a test passes ``jax.random.gumbel``'s draw); without
        it ``U`` comes from ``generator``, by default the engine's own,
        seeded with 0 on the engine's device. On a mesh ``logits`` and
        ``noise`` may be the full pane or the rank's rows; the noise is
        drawn for the full pane on every rank from the same generator and
        the rank keeps its rows, so a draw is the same on any mesh. The
        tokens are the rank's rows."""
        logits = self._tensor(self._rows(logits))
        if self.scfg.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if noise is None:
            if generator is None:
                if self._generator is None:
                    self._generator = torch.Generator(
                        device=self.device).manual_seed(0)
                generator = self._generator
            tiny = torch.finfo(logits.dtype).tiny
            shape = logits.shape if self.data_shards == 1 else \
                (self.scfg.max_batch,) + tuple(logits.shape[1:])
            u = torch.rand(shape, generator=generator,
                           dtype=logits.dtype, device=self.device)
            u = (u * (1.0 - tiny) + tiny).clamp_min(tiny)
            noise = -torch.log(-torch.log(u))
        noise = self._tensor(self._rows(noise), logits.dtype)
        return torch.argmax(noise + logits / self.scfg.temperature,
                            dim=-1).to(torch.int32)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def apply_patch(self, leaves: Dict[str, Any]) -> int:
        """Install new values for a subset of parameter leaves.

        ``leaves`` maps ``keystr`` paths (``"['blocks']['pos0']['attn']
        ['wq']"``, what ``training/online.py`` emits) to full replacement
        values: numpy arrays or tensors (numpy's float64 and int64 are
        taken as float32 and int32, as JAX takes them). Every leaf's path,
        shape and dtype is checked before anything is written, so a bad
        patch leaves the engine untouched. The values are then copied into
        the engine's own tensors: captured slate graphs read the
        parameters by address, so they serve the new weights, and no
        caller's tensor ever becomes the engine's. The caller
        (``Gateway.install_patch``) decides when the swap is safe (between
        panes). Returns the number of leaves patched. On a mesh the values
        are whole leaves, checked against the whole shapes, and each rank
        writes its shard."""
        if not leaves:
            return 0
        by_path = dict(flatten_with_keystr(self.params))
        staged = []
        for key, val in leaves.items():
            old = by_path.get(key)
            if old is None:
                raise KeyError(
                    f"patch leaf {key!r} is not in the parameter tree")
            new = as_tensor(val)
            full = (tuple(old.shape) if self.mesh is None
                    else tuple(self._full_shapes[key]))
            if tuple(new.shape) != full:
                raise ValueError(
                    f"patch leaf {key!r}: shape {tuple(new.shape)} != "
                    f"{full}")
            if new.dtype != old.dtype:
                raise ValueError(
                    f"patch leaf {key!r}: dtype {_dtype_name(new.dtype)} != "
                    f"{_dtype_name(old.dtype)}")
            if self.mesh is not None:
                new = local_shard(new, self._spec_of[key], self.mesh)
            staged.append((old, new))
        for old, new in staged:
            old.copy_(new)
        return len(leaves)


def _local_shape(full, spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's shard of a ``full``-shaped leaf."""
    return tuple(n // shard_factor((e,), mesh) if e is not None else n
                 for n, e in zip(full, tuple(spec)
                                 + (None,) * (len(full) - len(spec))))


def _map_keystr(fn, tree, prefix: str = ""):
    """``fn(keystr path, leaf)`` over a nested dict, keeping its shape."""
    return {k: _map_keystr(fn, v, f"{prefix}[{k!r}]") if isinstance(v, dict)
            else fn(f"{prefix}[{k!r}]", v) for k, v in tree.items()}


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's and JAX's name of a torch dtype ("float32", "bfloat16")."""
    return str(dtype).removeprefix("torch.")


def _mask_tail(slate: np.ndarray, row_lens) -> np.ndarray:
    """-1 at each row's slots ``>= row_lens[row]`` (no mask without
    ``row_lens``)."""
    if row_lens is None:
        return slate
    keep = np.arange(slate.shape[1])[None, :] < \
        np.asarray(row_lens, np.int64)[:, None]
    return np.where(keep, slate, -1).astype(np.int32)


class SlateGraphStats(NamedTuple):
    """One captured slate graph (``ServingEngine.slate_graph_stats``)."""
    capture_ms: float         # the warm-up run and the capture, host clock
    launches: Dict[str, int]  # kernel launches a replay, recorded at capture
    replays: int
    ring_bytes: int           # the pane shape's ring buffers, shared by
    #                           every slate length's graph


class _SlateBuffers:
    """The static inputs of every slate graph of one pane shape: ring
    caches made by the first call's ``finalize`` (graph-owned: never a
    pool slot or a host-LRU entry), the positions and the first logits.
    ``load`` writes a pane's state straight into them before each replay.
    The graphs never run at once, so they can share one set."""

    def __init__(self, engine: ServingEngine, state, first: torch.Tensor):
        self.cfg, self.capacity = engine.cfg, engine.scfg.cache_capacity
        dec = engine.finalize(state)
        self.caches = dec["caches"]
        self.pos = dec["pos"].clone()
        self.first = first.clone()
        self.nbytes = sum(t.nbytes for t in _leaves(self.caches))

    def load(self, state, first: torch.Tensor) -> None:
        cache_from_prefill(self.cfg, state["caches"], self.capacity,
                           valid=state["valid"], out=self.caches)
        self.pos.copy_(state["next_pos"])
        self.first.copy_(first)


class _SlateGraph:
    """One captured greedy slate of an engine, for one slate length and
    pane shape, over that shape's ``_SlateBuffers``.

    The body runs once eagerly on a side stream before capture, so the
    kernels are built, loaded and their attributes set outside it (the
    run advances the buffers, which ``load`` rewrites before a replay).
    Capture uses the thread-local mode, so another thread of the process
    (the online trainer's worker) may allocate and launch while it runs.
    Every graph of the engine captures into the engine's one memory pool:
    its temporaries may lie where another graph's output lies, which is
    safe because replays never overlap and each replay's only output, the
    slate, is copied to the host before the next replay.

    A replay runs no Python of the kernel wrappers, so their launch
    counters would miss it: the launches recorded during capture are
    taken back out of the counters and added again, captured x 1, at
    every replay."""

    def __init__(self, engine: ServingEngine, bufs: _SlateBuffers,
                 slate_len: int):
        t0 = time.perf_counter()
        dev = engine.device
        if engine._graph_pool is None:
            engine._graph_pool = torch.cuda.graph_pool_handle()
            engine._side_stream = torch.cuda.Stream(dev)
        side = engine._side_stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            engine._slate_body(bufs.caches, bufs.pos, bufs.first, slate_len)
        torch.cuda.current_stream(dev).wait_stream(side)
        counters = launch_counters()
        before = {n: op.launches for n, op in counters.items()}
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=engine._graph_pool,
                              capture_error_mode="thread_local"):
            self.slate = engine._slate_body(bufs.caches, bufs.pos,
                                            bufs.first, slate_len)
        self.captured = {}
        for name, op in counters.items():
            n = op.launches - before[name]
            op.launches = before[name]
            if n:
                self.captured[name] = (op, n)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.replays = 0

    def replay(self) -> torch.Tensor:
        """Replay the slate; returns the graph's slate tensor, which the
        next replay overwrites."""
        self.graph.replay()
        for op, n in self.captured.values():
            op.launches += n
        self.replays += 1
        return self.slate


# ----------------------------------------------------------------------
# serve_step: ONE greedy token against a decode cache
# ----------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig):
    """The greedy one-token step that the decode shapes run
    (``launch/steps.py``): ``serve_step(params, caches, tokens (B,1),
    pos (B,)) -> (next_token (B,) int32, caches')``, the argmax of
    ``decode_step``'s logits (the first index on ties, as ``jnp.argmax``).
    The step owns ``caches``: it writes the new K/V and states into them
    and returns them, as the JAX dry-run donates the cache to this step."""
    def serve_step(params, caches, tokens, pos):
        logits, caches = decode_step(params, cfg, caches, tokens, pos,
                                     inplace=True)
        return torch.argmax(logits[:, 0], dim=-1).to(torch.int32), caches
    return serve_step
