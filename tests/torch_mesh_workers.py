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
