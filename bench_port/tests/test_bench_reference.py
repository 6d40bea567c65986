"""The plain references against the port at reduced sizes on the CPU, in
float32: the decoder (MoE and dense) and RWKV6 against the port's
prefill logits at every prefix length, the router against the port's
ExpertMatcher."""
import numpy as np
import pytest
import torch

import tiny
from bench_port import bank, fleet, synth
from bench_port.reference import decoder, router, rwkv6


def model_and_params(kind):
    from repro_torch.models import build_model
    cfg = tiny.spec("rwkv" if kind == "rwkv" else "moe").cfg
    if kind == "dense":
        cfg.update(family="dense", n_experts=0, experts_per_token=0)
    arch = fleet.arch_config(cfg)
    model = build_model(arch)
    params = fleet.draw_weights(model, cfg["init"], arch.vocab_size,
                                torch.Generator().manual_seed(3))
    return cfg, model, params


@pytest.mark.parametrize("kind", ["moe", "dense", "rwkv"])
def test_reference_logits_match_the_port(kind):
    torch.set_num_threads(2)
    cfg, model, params = model_and_params(kind)
    tok = torch.randint(0, cfg["vocab_size"], (1, 24),
                        generator=torch.Generator().manual_seed(1))
    fwd = rwkv6.forward if kind == "rwkv" else decoder.forward
    with torch.no_grad():
        ref = fwd(params, cfg, [tok[0]], [0])[0]
        for t in (1, 7, 16, 24):     # 16 and 24 take the chunked WKV path
            got = model.prefill(params, {"tokens": tok[:, :t]})[0][0]
            scale = float(ref[t - 1].abs().max())
            err = float((got - ref[t - 1]).abs().max())
            assert err <= 2e-5 * scale + 1e-6, (t, err, scale)


def test_fp8_control_moves_the_logits():
    cfg, _, params = model_and_params("moe")
    tok = torch.randint(0, cfg["vocab_size"], (12,),
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        a = decoder.forward(params, cfg, [tok], [0])[0]
        b = decoder.forward(params, cfg, [tok], [0], decoder.quantize_fp8)[0]
    assert float((a - b).abs().max()) > 1e-3 * float(a.abs().max())


def test_router_reference_matches_the_port():
    from repro_torch.core import MatcherConfig, build_matcher
    names = ["stl10", "har", "reuters", "nlos"]
    data = [synth.draw(n, 300, 5 + i) for i, n in enumerate(names)]
    aes = bank.train_bank([(n, x) for n, (x, _) in zip(names, data)], 1,
                          epochs=3, batch=128, lr=1e-2, decay_every=15,
                          device="cpu")
    m = build_matcher(aes, names, data, MatcherConfig(), device="cpu")
    x = np.concatenate([synth.draw(n, 20, 50 + i)[0]
                        for i, n in enumerate(names)])
    got = m.route(torch.from_numpy(x))
    host = [({k: v.numpy() for k, v in p.items()},
             {k: v.numpy() for k, v in s.items()}) for p, s in aes]
    cs = router.coarse_scores(host, x.astype(np.float64))
    assert np.array_equal(got["coarse"][:, 0].numpy(), cs.argmin(1))
    score = got["coarse_score"][:, 0].numpy().astype(np.float64)
    assert np.abs(score - cs.min(1)).max() <= 1e-5 * cs.min(1).max()
    err = router.route_errors(host, data, x.astype(np.float64),
                              got["coarse"][:, 0].numpy(), score,
                              got["fine"].numpy())
    assert err.max() < 1e-5
    # a wrong expert or class is caught
    bad = router.route_errors(host, data, x.astype(np.float64),
                              (got["coarse"][:, 0].numpy() + 1) % 4,
                              score, got["fine"].numpy())
    assert bad.max() > 1e-2
