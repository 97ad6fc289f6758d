"""``chip_smoke.llada_cut``: LLaDA cut to its first layers, the model that
``chip_smoke.py`` phases 6, 7, 12, 14 and 15 serve.  The cut is the model
of that depth on the same weights: views of the full stacks, the SVD
proxies of those layers, the budget's peak layer scaled with the depth,
and a decode through it equal to one through a copy of the first layers.
"""
import dataclasses
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)


def test_llada_8b_cut_keeps_widths_and_scales_the_peak():
    from repro_torch.configs import get_arch
    cfg = get_arch("llada-8b")
    stack = torch.arange(cfg.n_layers)
    params = {"embed": torch.zeros(1),
              "blocks": {"attn": {"wv": stack, "ffn": {"w_up": stack}}}}
    cut, cut_params, strat, proxies = cs.llada_cut(
        cfg, params, {"attn": stack})
    assert cut.n_layers == cs.CUT_LAYERS == 8
    assert (cut.d_model, cut.n_heads, cut.d_ff, cut.vocab_size) == (
        cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size)
    assert cut.spa.layer_peak == 6 == strat.layer_peak   # 24 of 32
    assert cut.spa.rank == strat.rank == 128
    assert cut_params["embed"] is params["embed"]
    for got in (cut_params["blocks"]["attn"]["wv"],
                cut_params["blocks"]["attn"]["ffn"]["w_up"],
                proxies["attn"]):
        assert got.tolist() == list(range(8))
        assert got.data_ptr() == stack.data_ptr()          # a view


def test_cut_decodes_as_the_model_of_that_depth():
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.strategy import SPACache
    from repro_torch.dlm.session import DecodeSession
    from repro_torch.models import transformer
    cfg = reduced(get_arch("llada-8b"), n_layers=4)
    cfg = dataclasses.replace(
        cfg, spa=dataclasses.replace(cfg.spa, layer_peak=3))
    params = transformer.init_params(cfg, seed=0, device="cpu")
    proxies = SPACache.from_spec(cfg.spa).build_proxies(params, cfg)
    cut, cut_params, strat, cut_proxies = cs.llada_cut(cfg, params, proxies,
                                                       layers=2)
    assert cut.spa.layer_peak == 2 and cut.n_layers == 2

    copy = dict(params, blocks={"attn": {
        k: ({kk: vv[:2].clone() for kk, vv in v.items()}
            if isinstance(v, dict) else v[:2].clone())
        for k, v in params["blocks"]["attn"].items()}})
    rebuilt = strat.build_proxies(copy, cut)
    assert torch.equal(rebuilt["attn"], cut_proxies["attn"])

    prompt = torch.randint(0, cfg.vocab_size - 1, (2, 12),
                           generator=torch.Generator().manual_seed(3))
    toks = []
    for p, prox in ((cut_params, cut_proxies), (copy, rebuilt)):
        sess = DecodeSession(p, cut, strategy=strat, spa_proxies=prox,
                             device="cpu")
        sess.prefill(prompt, 12)
        toks.append(sess.run()[0])
    assert torch.equal(toks[0], toks[1])
    assert int((toks[0][:, 12:] == cfg.mask_id).sum()) == 0
