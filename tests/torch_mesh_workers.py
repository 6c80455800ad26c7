"""Functions that the port's mesh tests run on every rank of a gloo mesh
(``repro_torch.launch.mesh.run_on_mesh``). They import nothing of JAX: a
spawned rank imports this module by name. Each returns rank 0's findings
as plain numbers and numpy arrays for the test to assert on."""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tools"))


def _engines(cfg, params, scfg, mesh):
    """The mesh-free engine and the engine on ``mesh``, over the same
    whole params on the CPU."""
    from repro_torch.serving.engine import ServingEngine
    return (ServingEngine(cfg, params, scfg, device="cpu"),
            ServingEngine(cfg, params, scfg, device="cpu", mesh=mesh))


def _pane(cfg, scfg, eng, seed=0):
    rng = np.random.RandomState(seed)
    b, p, s = scfg.max_batch, scfg.prefill_len, scfg.inject_len
    hists = [list(rng.randint(1, cfg.vocab_size, rng.randint(p // 2, p)))
             for _ in range(b)]
    fresh = [list(rng.randint(1, cfg.vocab_size, rng.randint(0, s + 1)))
             for _ in range(b)]
    return eng.pad_tokens(hists, p), eng.pad_tokens(fresh, s, align="left")


def _serve(eng, pane, slate_len):
    (toks, valid), (stoks, svalid) = pane
    st = eng.prefill(toks, valid, logits_last_only=True)
    last = eng.full_rows(st["logits"][:, -1])
    inj = eng.inject(st, stoks, svalid, fallback_logits=last)
    first = eng.full_rows(inj["first_logits"])
    slate = eng.decode_slate(inj, inj["first_logits"], slate_len)
    dec = eng.finalize(inj)
    logits, _ = eng.decode(dec, np.ones((eng.scfg.max_batch, 1), np.int32))
    return {"prefill": last, "inject": first, "slate": slate,
            "decode": eng.full_rows(logits)}


def engines_match(mesh, arch_cfgs, slate_len=6):
    """Each config of ``arch_cfgs`` (name -> port ``ModelConfig``) served
    one pane (prefill, inject, decode_slate, one decode step) in fp32 by
    the mesh-free engine and by the engine on ``mesh``, from one seeded
    init. Returns {name: {"max_abs": worst logit difference, "slates":
    whether the slates are equal}}."""
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingConfig

    torch.manual_seed(0)
    scfg = ServingConfig(max_batch=4, prefill_len=24, inject_len=8,
                         cache_capacity=40)
    out = {}
    for name, cfg in arch_cfgs.items():
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
        plain, sharded = _engines(cfg, params, scfg, mesh)
        pane = _pane(cfg, scfg, plain)
        want, got = _serve(plain, pane, slate_len), _serve(sharded, pane,
                                                           slate_len)
        out[name] = {
            "max_abs": max(float((want[k] - got[k]).abs().max())
                           for k in ("prefill", "inject", "decode")),
            "slates": bool(np.array_equal(want["slate"], got["slate"]))}
    return out


def mesh_1x1_bitwise(mesh, pool_slots):
    """The equivalence tool's trace on the mesh-free Gateway and on the
    Gateway of this 1x1 mesh, in one process: every response equal bit
    for bit, and every counter."""
    import torch_sharded_equiv_check as tool
    want = tool.port_record(None, pool_slots=pool_slots)
    got = tool.port_record(mesh, pool_slots=pool_slots)
    return {
        "slates": all(np.array_equal(a["slates"], b["slates"])
                      for a, b in zip(want["waves"], got["waves"])),
        "scores": all(np.array_equal(a["scores"], b["scores"])
                      for a, b in zip(want["waves"], got["waves"])),
        "counters": want["stats"] == got["stats"],
        "rollover": want["rollover"] == got["rollover"]}


def patch_on_mesh(mesh):
    """``apply_patch`` on a mesh engine against the mesh-free engine: the
    same whole leaves installed, then one pane served by both; and the
    messages of a bad shape and a bad path."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingConfig

    cfg = reduced(get_config("itfi-ranker"))
    scfg = ServingConfig(max_batch=4, prefill_len=16, inject_len=4,
                         cache_capacity=24)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    plain, sharded = _engines(cfg, params, scfg, mesh)
    rng = np.random.RandomState(3)
    leaves = {
        "['blocks']['pos0']['attn']['wq']": rng.standard_normal(
            tuple(params["blocks"]["pos0"]["attn"]["wq"].shape)) * 0.05,
        "['blocks']['pos0']['mlp']['down']": rng.standard_normal(
            tuple(params["blocks"]["pos0"]["mlp"]["down"].shape)) * 0.05,
        "['embed']['table']": rng.standard_normal(
            tuple(params["embed"]["table"].shape)) * 0.05}
    counts = (plain.apply_patch(leaves), sharded.apply_patch(leaves))
    pane = _pane(cfg, scfg, plain, seed=1)
    want, got = _serve(plain, pane, 4), _serve(sharded, pane, 4)

    def message(eng, patch):
        try:
            eng.apply_patch(patch)
        except (KeyError, ValueError) as e:
            return f"{type(e).__name__}: {e}"
        return None

    bad_shape = {"['blocks']['pos0']['attn']['wq']": np.zeros((2, 2),
                                                               np.float32)}
    bad_path = {"['blocks']['nope']": np.zeros(2, np.float32)}
    return {"counts": counts,
            "max_abs": max(float((want[k] - got[k]).abs().max())
                           for k in ("prefill", "inject", "decode")),
            "slates": bool(np.array_equal(want["slate"], got["slate"])),
            "messages": [(message(plain, p), message(sharded, p))
                         for p in (bad_shape, bad_path)]}


def sampled_on_mesh(mesh):
    """``sample`` at temperature 0.8 on the mesh engine and the mesh-free
    one, each from its own generator seeded alike: the same tokens."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingConfig

    cfg = reduced(get_config("itfi-ranker"))
    scfg = ServingConfig(max_batch=4, prefill_len=16, inject_len=4,
                         cache_capacity=24, temperature=0.8)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    plain, sharded = _engines(cfg, params, scfg, mesh)
    logits = torch.randn((4, cfg.vocab_padded),
                         generator=torch.Generator().manual_seed(5))
    return {"plain": plain.sample(logits),
            "sharded": sharded.full_rows(sharded.sample(logits))}


# ----------------------------------------------------------------------
# The step layer on a mesh (tests/test_torch_steps_mesh.py)
# ----------------------------------------------------------------------

def unshard(x, spec, mesh):
    """The whole tensor from this rank's block under ``spec``: each cut
    dim all-gathered over its axes, the last-named first (every rank
    must call it)."""
    from repro_torch.sharding.local import all_gather
    for dim, entry in enumerate(spec):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        for axis in reversed(axes):
            x = all_gather(x, mesh, axis, dim)
    return x


def unshard_tree(tree, specs, mesh):
    """:func:`unshard` over the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: unshard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return unshard(tree, specs, mesh)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().float().numpy() if tree.dtype != torch.bool \
        else tree.cpu().numpy()


def _train_cfg(mesh, microbatches, adamw):
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig
    return TrainConfig(adamw=AdamWConfig(**adamw), microbatches=microbatches,
                       remat=True, param_dtype=torch.float32, mesh=mesh)


def _rank_batch(batch, mesh):
    """This rank's rows of a numpy batch laid out by ``batch_pspec``."""
    from repro_torch.sharding.local import local_shard
    from repro_torch.sharding.rules import batch_pspec
    rows = next(iter(batch.values())).shape[0]
    spec = batch_pspec(mesh, rows)
    return {k: local_shard(torch.from_numpy(np.asarray(v)),
                           type(spec)(spec[0], *([None] * (v.ndim - 1))),
                           mesh)
            for k, v in batch.items()}


def train_on_mesh(mesh, cases):
    """One train step of each case on this mesh: ``cases`` maps a name to
    (port cfg, numpy params in the JAX tree, numpy global batch,
    microbatches, AdamW kwargs). The params are carried onto the mesh in
    the training layout (``params_from_numpy(..., mesh=, specs=)``), the
    batch cut over ``data``, the step run donating; returns, gathered,
    the metrics, the updated params and the optimizer state."""
    from repro_torch.sharding.rules import param_pspecs
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.weights import params_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, (cfg, tree, batch, nm, adamw) in cases.items():
        specs = param_pspecs(cfg, mesh)
        params = params_from_numpy(tree, cfg, "cpu", mesh=mesh, specs=specs)
        step = make_train_step(cfg, _train_cfg(mesh, nm, adamw), donate=True)
        params, opt, metrics = step(params, init_opt_state(params),
                                    _rank_batch(batch, mesh))
        out[name] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": _numpy(unshard_tree(params, specs, mesh)),
            **{f: _numpy(unshard_tree(getattr(opt, f), specs, mesh))
               for f in ("master", "m", "v")}}
    return out


def grads_on_mesh(mesh, cases):
    """Each rank's gradient of each of its shards (after the data-axis
    sums) against that block of the one-device gradient from the same
    whole params and batch: ``cases`` maps a name to (port cfg, seed,
    numpy global batch). Returns {name: the worst abs difference over
    every rank and leaf}."""
    import copy

    import torch.distributed as dist
    from repro_torch.models.common import flatten_with_keystr
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import init_params
    from repro_torch.sharding.local import shard_tree
    from repro_torch.sharding.rules import param_pspecs
    from repro_torch.training.train_loop import (TrainConfig, make_loss_fn,
                                                 sum_over_data)

    def grads(loss_fn, params, batch):
        live = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                        params)
        loss_fn(live, batch)[0].backward()
        return tree_map(lambda p: p.grad, live)

    out = {}
    for name, (cfg, seed, batch) in cases.items():
        whole = init_params(cfg, torch.Generator().manual_seed(seed),
                            torch.float32, "cpu")
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        want = grads(make_loss_fn(cfg, TrainConfig(
            param_dtype=torch.float32)), copy.deepcopy(whole), tb)
        specs = param_pspecs(cfg, mesh)
        got = grads(make_loss_fn(cfg, TrainConfig(
            param_dtype=torch.float32, mesh=mesh)),
            shard_tree(whole, specs, mesh), _rank_batch(batch, mesh))
        sum_over_data(got, specs, mesh)
        blocks = dict(flatten_with_keystr(shard_tree(want, specs, mesh)))
        err = max(float((g - blocks[p]).abs().max())
                  for p, g in flatten_with_keystr(got))
        worst = torch.tensor([err])
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        out[name] = float(worst)
    return out


class RingGathers:
    """While on, every ``all_gather`` the package makes over ``data``
    along a dim of ``capacity`` slots (a ring gathered whole), with the
    bytes of those outputs alive at once and their most."""

    def __init__(self, capacity):
        self.capacity, self.live, self.most = capacity, 0, 0

    def _freed(self, n):
        self.live -= n

    def __enter__(self):
        import weakref
        from unittest import mock

        from repro_torch.launch import steps
        from repro_torch.models import model
        from repro_torch.sharding import local
        real = local.all_gather

        def gather(x, mesh, axis, dim):
            out = real(x, mesh, axis, dim)
            if axis == "data" and out.shape[dim] == self.capacity \
                    and out is not x:
                self.live += out.nbytes
                self.most = max(self.most, self.live)
                weakref.finalize(out, self._freed, out.nbytes)
            return out

        self._patches = [mock.patch.object(m, "all_gather", gather)
                         for m in (local, model, steps)
                         if hasattr(m, "all_gather")]
        for patch in self._patches:
            patch.start()
        return self

    def __exit__(self, *exc):
        for patch in self._patches:
            patch.stop()


def _one_layer_ring(caches, specs, mesh):
    """The bytes of one layer's whole ring: each leaf that ``specs`` cuts
    over ``data``, one repeat of it, times the data axis's size."""
    from repro_torch.sharding.local import group_size
    return sum(t[0].nbytes * group_size(mesh, "data")
               for key, leaves in caches.items()
               for name, t in leaves.items() if "data" in specs[key][name])


def serve_steps_on_mesh(mesh, cases):
    """The prefill and decode steps of ``make_step_and_specs`` on this
    mesh: ``cases`` maps a name to (port cfg, kind, seq_len, numpy params
    in the JAX tree, numpy args: the batch for "prefill"; caches, tokens
    and pos for "decode"). Each arg is cut by the step's in-specs and
    each output gathered by its out-specs. Returns (the outputs, and for
    each decode case the most bytes of whole rings alive at once during
    the step beside one layer's whole ring: ``RingGathers``)."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.steps import make_step_and_specs
    from repro_torch.sharding.local import local_shard
    from repro_torch.weights import as_tensor, params_from_numpy

    def cut(x, spec):
        if isinstance(x, dict):
            return {k: cut(v, spec[k]) for k, v in x.items()}
        return local_shard(as_tensor(x), spec, mesh)

    out, rings = {}, {}
    for name, (cfg, kind, seq, tree, args) in cases.items():
        b = (args[0]["tokens"] if kind == "prefill" else args[1]).shape[0]
        step, _, ins, outs = make_step_and_specs(
            cfg, InputShape(name, seq, b, kind), mesh, device="cpu",
            dtype=torch.float32, generator=torch.Generator().manual_seed(0))
        params = params_from_numpy(tree, cfg, "cpu", mesh=mesh, specs=ins[0])
        rest = [cut(a, s) for a, s in zip(args, ins[1:])]
        with RingGathers(seq) as ring:
            res = step(params, *rest)
        if kind == "decode":
            rings[name] = (ring.most, _one_layer_ring(rest[0], ins[1], mesh))
        got = [unshard_tree(r, s, mesh) if isinstance(r, dict)
               else unshard(r, s, mesh) for r, s in zip(res, outs)]
        out[name] = [_numpy(g) if isinstance(g, dict) else g.numpy()
                     for g in got]
    return out, rings


def step_layer_on_mesh(mesh, train, grads, serve):
    """``train_on_mesh``, ``grads_on_mesh`` and ``serve_steps_on_mesh`` in
    one mesh's processes."""
    res = {"train": train_on_mesh(mesh, train),
           "grads": grads_on_mesh(mesh, grads)}
    res["serve"], res["rings"] = serve_steps_on_mesh(mesh, serve)
    return res


def analysis_on_mesh(mesh, cfg, seq, batch):
    """The train, prefill and decode steps of ``cfg`` (fp32, seed 0) at
    ``seq`` x ``batch`` through ``make_step_and_specs`` on this mesh, each
    run once under ``op_analysis.analyze``: {kind: (the rank's FLOPs, its
    collective records)}, rank 0's."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.steps import make_step_and_specs
    out = {}
    for kind, name in (("train", "train_4k"), ("prefill", "prefill_32k"),
                       ("decode", "decode_32k")):
        step, args, _, _ = make_step_and_specs(
            cfg, InputShape(name, seq, batch, kind), mesh, device="cpu",
            dtype=torch.float32, generator=torch.Generator().manual_seed(0))
        _, cost = analyze(step, args)
        out[kind] = (cost.flops, [list(c) for c in cost.collectives])
    return out
