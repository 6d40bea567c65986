"""The port's three examples (``repro_torch.examples``) on the CPU at
tiny sizes: each ``main([... "--device", "cpu"])`` runs end to end and
holds the reference example's invariants; without ``--device cpu`` on a
machine with no card each raises.

- ``quickstart`` and ``serve_routing`` against the reference's own
  ``examples/*.py``, run in this process (same data: ``load_benchmark``
  salts by the process's string hash) with their AE bank and expert
  weights carried across by ``to_torch``: the same per-dataset coarse
  predictions and printed accuracies, the same request stream, truth
  and routing accuracy, the same (expert, fine class, tokens) per uid
  and the same scheduler and engine counters.
- ``serve_routing``: the serial and overlapped executors give the same
  (expert, fine class, tokens) per request; ``--banked`` gives the
  per-engine fleet's; ``--hub --resident 2`` walks a cold request
  through park -> load -> serve; ``--long-prompt`` gives the same tokens
  chunked and storage-only, with fewer prompt tokens computed chunked.
- ``train_expert``: its checkpoint is read by the reference's
  ``repro.checkpoint.load_pytree`` bit for bit, and a checkpoint the
  reference writes is read by the port's bit for bit.

The AE bank trains for one epoch on 64 samples a dataset (routing near
chance: the invariants do not need a good route), except the hub case,
whose demo looks for a feature the matcher routes to a cold expert.
"""
import functools
import importlib.util
import pathlib
import re
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.checkpoint import load_pytree as jload
from repro.checkpoint import save_pytree as jsave
from repro.configs import get_config
from repro.data import load_benchmark
from repro.models import build_model
from repro_torch.checkpoint import load_pytree
from repro_torch.bridge import to_torch
from repro_torch.examples import quickstart, serve_routing, train_expert
from repro_torch.tree import leaves

TINY = ["--n-per-dataset", "64", "--epochs", "1", "--device", "cpu"]
EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _reference(name, monkeypatch, argv=()):
    """Import the reference's ``examples/<name>.py`` as a module (its
    ``sys.path`` insert undone after the test) with ``sys.argv`` set."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    spec = importlib.util.spec_from_file_location(f"_ref_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture_bank(monkeypatch, mod):
    """Wrap the reference module's ``train_bank`` and ``build_matcher``:
    returns a dict that gets the trained ``aes`` and the ``matcher``."""
    got = {}
    train, build = mod.train_bank, mod.build_matcher

    def train_bank(*a, **kw):
        got["aes"], names = train(*a, **kw)
        return got["aes"], names

    def build_matcher(*a, **kw):
        got["matcher"] = build(*a, **kw)
        return got["matcher"]

    monkeypatch.setattr(mod, "train_bank", train_bank)
    monkeypatch.setattr(mod, "build_matcher", build_matcher)
    return got


def _lines(text, *prefixes):
    return [ln for ln in text.splitlines() if ln.startswith(prefixes)]


@functools.lru_cache(maxsize=None)
def _serve(*flags):
    return serve_routing.main(["--requests", "8", *TINY, *flags])


def test_quickstart_routes_on_the_cpu(monkeypatch, capsys):
    """The reference's quickstart (cut to 64 samples a dataset) and the
    port's on its bank: the same coarse prediction for every client row,
    the same printed accuracies, mixed-batch experts and fine classes."""
    ref = _reference("quickstart", monkeypatch)
    load = ref.load_benchmark
    monkeypatch.setattr(ref, "load_benchmark",
                        lambda **kw: load(**{**kw, "n_per_dataset": 64}))
    bank = _capture_bank(monkeypatch, ref)
    ref.main()
    want = capsys.readouterr().out
    out = quickstart.main(["--n-per-dataset", "64", "--device", "cpu"],
                          aes=to_torch(jax.device_get(bank["aes"]),
                                       device="cpu"))
    got = capsys.readouterr().out
    assert out["names"] == ["mnist", "har", "reuters"]
    bench = load_benchmark(names=out["names"], n_per_dataset=64, seed=0)
    for client, preds in out["coarse"].items():
        for n, pred in zip(out["names"], preds):
            x = bench[n][client][0]
            assert pred == np.asarray(
                bank["matcher"].assign_coarse(x)).tolist(), (client, n)
    keys = ("client_a:", "client_b:", "mixed batch", "fine classes")
    assert _lines(got, *keys) == _lines(want, *keys)
    assert len(_lines(got, *keys)) == 4
    assert len(out["mixed_experts"]) == len(out["mixed_fine"]) == 12


def test_serve_routing_matches_the_reference_example(monkeypatch, capsys):
    """The reference's serve_routing (default mode, 64 samples a
    dataset, 8 requests) and the port's on its AE bank and expert
    weights: the same requests and truth, the same (expert, fine class,
    tokens) per uid in both waves, and the same printed accuracy,
    scheduler and per-engine prefill / decode / host-sync counters."""
    argv = ["--n-per-dataset", "64", "--requests", "8"]
    ref = _reference("serve_routing", monkeypatch, argv)
    bank = _capture_bank(monkeypatch, ref)
    params, waves = [], []
    engine, server = ref.ExpertEngine, ref.RoutedServer

    def expert_engine(model, p, **kw):
        params.append(jax.device_get(p))
        return engine(model, p, **kw)

    class Recorded(server):
        def serve(self, reqs):
            resps = super().serve(reqs)
            waves.append((list(reqs), resps))
            return resps

    monkeypatch.setattr(ref, "ExpertEngine", expert_engine)
    monkeypatch.setattr(ref, "RoutedServer", Recorded)
    ref.main()
    want = capsys.readouterr().out
    out = serve_routing.main(
        argv + ["--device", "cpu"],
        aes=to_torch(jax.device_get(bank["aes"]), device="cpu"),
        init_expert=lambda model, i: to_torch(params[i], device="cpu"))
    got = capsys.readouterr().out

    bench = load_benchmark(n_per_dataset=64, seed=0)
    reqs, truth = serve_routing.make_requests(bench, out["names"], 8)
    assert out["truth"] == dict(enumerate(truth))
    (jreqs, jresps), (_, jagain) = waves
    for r, j in zip(reqs, jreqs, strict=True):
        assert (r.uid, r.max_new_tokens) == (j.uid, j.max_new_tokens)
        np.testing.assert_array_equal(r.features, j.features)
        np.testing.assert_array_equal(r.prompt, j.prompt)
    assert all(any((r.features == row).all()
                   for row in bench[t]["client_a"][0])
               for r, t in zip(reqs, truth))
    assert out["responses"] == {
        r.uid: {"expert": r.expert, "fine_class": int(r.fine_class),
                "tokens": np.asarray(r.tokens).tolist()} for r in jresps}
    assert out["repeat"]["responses"] == {
        r.uid - 10_000: np.asarray(r.tokens).tolist() for r in jagain}
    # "routing accuracy: c/n", the scheduler's line and each engine's
    # prefills / decode ticks / host syncs (compiled-executable counts
    # differ: captured graphs against XLA executables)
    keys = ("routing accuracy", "scheduler:",
            *(f"  {n}:" for n in out["names"]))
    strip = functools.partial(re.sub, r", \d+ compiled executables", "")
    assert [strip(ln) for ln in _lines(got, *keys)] == \
        [strip(ln) for ln in _lines(want, *keys)]
    assert len(_lines(got, *keys)) == 8


def test_serve_routing_executors_agree():
    """Every request answered with 8 tokens; serial and overlapped give
    the same responses, and the repeat wave rides the route cache."""
    over, serial = _serve(), _serve("--executor", "serial")
    assert over["executor"] == "overlapped" and serial["executor"] == "serial"
    assert sorted(over["responses"]) == list(range(8))
    assert all(len(r["tokens"]) == 8 for r in over["responses"].values())
    assert over["responses"] == serial["responses"]
    assert over["repeat"]["responses"] == {
        u: r["tokens"] for u, r in over["responses"].items()}
    assert over["repeat"]["route_cache_hits"] >= 8
    # the overlapped executor blocks once a wave, the serial one a tick
    blocks = {k: sum(c["host_blocks"] for c in run["engines"].values())
              for k, run in (("over", over), ("serial", serial))}
    assert blocks["over"] < blocks["serial"]


def test_serve_routing_banked_equals_unbanked():
    """``plan_placement`` banks the two llama and the two RWKV6 experts;
    mixtral (capacity dispatch) stays solo; every response equals the
    per-engine fleet's."""
    banked = _serve("--banked")
    assert banked["placement"].count("[bank]") == 2
    assert banked["placement"].count("[solo]") == 2
    assert banked["responses"] == _serve()["responses"]


def test_serve_routing_hub_cold_start():
    out = serve_routing.main(["--requests", "8", "--n-per-dataset", "400",
                              "--epochs", "15", "--device", "cpu", "--hub",
                              "--resident", "2"])
    cold = out["cold_start"]
    states = [s for _, s in cold["states"]]
    assert states[0] != "resident" and states[-1] == "resident"
    assert cold["misses"] >= 1 and cold["loads"] >= 1      # parked, loaded
    assert cold["served_by"] == cold["expert"]             # served
    assert out["hub_stats"]["loads"] >= 3
    assert out["hub_stats"]["evictions"] >= 1
    assert len(cold["tokens"]) == 6


def test_serve_routing_long_prompt():
    lp = _serve("--long-prompt")["long_prompt"]
    chunked, plain = lp["chunked+suffix"], lp["storage-only"]
    assert chunked["tokens"] == plain["tokens"]
    assert chunked["computed"] < plain["computed"]
    assert chunked["submitted"] == plain["submitted"]


def test_train_expert_checkpoint_crosses_packages(tmp_path):
    out = train_expert.main(["--steps", "4", "--device", "cpu", "--ckpt",
                             str(tmp_path / "port")])
    hist = out["history"]
    assert [i for i, _ in hist] == [0, 3] and hist[-1][1] < hist[0][1]
    assert out["round_trip_bit_equal"]
    # the port's checkpoint, read by the reference
    got = jax.tree_util.tree_leaves(jload(str(tmp_path / "port")))
    want = leaves(out["params"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the reference's checkpoint, read by the port
    cfg = get_config("smollm-135m").reduced(n_layers=4, d_model=256,
                                            d_ff=512, vocab_size=1024)
    jp = jax.device_get(build_model(cfg).init(jax.random.PRNGKey(1)))
    jsave(jp, str(tmp_path / "ref"))
    mine = load_pytree(str(tmp_path / "ref"))
    for a, b in zip(leaves(mine), leaves(to_torch(jp, device="cpu"))):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA refusal; this machine has a card")


@pytest.mark.parametrize("example,argv", [
    (quickstart, ["--n-per-dataset", "32", "--epochs", "1"]),
    (serve_routing, ["--n-per-dataset", "32", "--epochs", "1"]),
    (train_expert, ["--steps", "1"])],
    ids=["quickstart", "serve_routing", "train_expert"])
def test_examples_refuse_without_cuda(no_cuda, example, argv):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(argv)
