"""The comparison that decides ``correct``, held to what it must catch.
A whole run of a tiny cut of each cell on the CPU (the harness's look
for a card skipped), once sound, then with the timed path broken
underneath: a token altered where it is produced, a decode step that
returns its state unchanged, a route altered where it is produced. Each
broken run comes out not correct; the controls (the reference in the
program's place one precision below) read above the cell's limits."""
import json

import pytest
import torch

import tiny

KINDS = ["moe", "rwkv"]


def limits(kind):
    return json.loads((tiny.ROOT / "bench_port" / "limits" /
                       f"{tiny.CELLS[kind]}.json").read_text())["limits"]


@pytest.mark.parametrize("kind", KINDS)
def test_sound_run_is_correct_and_the_controls_are_not(kind):
    res = tiny.run(tiny.spec(kind), control=True)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    lim = limits(kind)
    ctl = res["control"]
    assert any(ctl[k] > lim[k] for k in lim), (ctl, lim)


def alter_token(monkeypatch, kind):
    from repro_torch.models.dense import DecoderLM
    from repro_torch.models.rwkv6 import RWKV6
    if kind == "rwkv":
        orig = RWKV6.decode

        def decode(self, params, cache, batch):
            logits, cache = orig(self, params, cache, batch)
            return logits.roll(1, dims=-1), cache
        monkeypatch.setattr(RWKV6, "decode", decode)
    else:
        orig = DecoderLM.paged_decode

        def paged_decode(self, *a, **kw):
            logits, pool, pos, t = orig(self, *a, **kw)
            return logits.roll(1, dims=-1), pool, pos, t
        monkeypatch.setattr(DecoderLM, "paged_decode", paged_decode)


def state_unchanged(monkeypatch, kind):
    from repro_torch.models.dense import DecoderLM
    from repro_torch.models.rwkv6 import RWKV6
    if kind == "rwkv":
        orig = RWKV6.decode

        def decode(self, params, cache, batch):
            keep = {k: v.clone() for k, v in cache.items()}
            logits, cache = orig(self, params, cache, batch)
            for k, v in keep.items():
                cache[k].copy_(v)
            return logits, cache
        monkeypatch.setattr(RWKV6, "decode", decode)
    else:
        orig = DecoderLM.paged_decode

        def paged_decode(self, params, pool, table, pos, t, batch, *, page):
            keep = {k: v.clone() for k, v in pool.items()}
            logits, pool, _, _ = orig(self, params, pool, table, pos, t,
                                      batch, page=page)
            for k, v in keep.items():
                pool[k].copy_(v)
            return logits, pool, pos, t
        monkeypatch.setattr(DecoderLM, "paged_decode", paged_decode)


def alter_route(monkeypatch, kind):
    from repro_torch.serve.router import Router
    orig = Router.route

    def route(self, feats):
        r = orig(self, feats)
        r.coarse = (r.coarse + 1) % self.matcher.n_experts
        return r
    monkeypatch.setattr(Router, "route", route)


FAULTS = {"token_altered": alter_token, "state_unchanged": state_unchanged,
          "route_altered": alter_route}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("kind", KINDS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, kind, fault):
    FAULTS[fault](monkeypatch, kind)
    res = tiny.run(tiny.spec(kind))
    assert not res["correct"], [(r.name, r.value, r.limit)
                                for r in res["readings"]]


@pytest.mark.cuda
def test_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = tiny.spec("moe", dtype="bfloat16")
    res = tiny.harness.run_cell(s, 5, 2.0, True, "cuda",
                                tiny.time.perf_counter(), log=lambda m: None)
    assert res["failed"] == 0 and res["device"]["busy_s"] > 0
