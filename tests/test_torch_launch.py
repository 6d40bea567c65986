"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU
at tiny sizes: every request is answered with ``--max-new`` tokens, each
dataset's expert runs the architecture the reference launcher's rule
gives it (``ALL_ARCHS[i % 10]`` reduced, a reduced llama for the
encoder-decoder and VLM slots), ``--kv paged`` keeps the ring layout for
the recurrent families, and the hub path (``--hub-slots 2``, experts
stored cold) and ``--trace`` work."""
import json

import pytest

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.configs import ALL_ARCHS as JALL_ARCHS
from repro.configs import get_config as jget
from repro_torch.launch import serve as launch_serve

TINY = ["--requests", "6", "--n-per-dataset", "64", "--epochs", "1",
        "--max-new", "2", "--device", "cpu"]


def _reference_archs(names):
    """The reference launcher's per-dataset configs (its loop at
    ``src/repro/launch/serve.py``), by name and family."""
    out = {}
    for i, n in enumerate(names):
        arch = JALL_ARCHS[i % len(JALL_ARCHS)]
        cfg = jget(arch).reduced(name=f"{arch}@{n}")
        if cfg.family in ("encdec", "vlm"):
            cfg = jget("llama3_2_1b").reduced(name=f"llama@{n}")
        out[n] = cfg
    return out


def _check_served(out, max_new):
    resps = out["responses"]
    assert len(resps) == 6
    assert [r.uid for r in resps] == list(range(6))
    for r in resps:
        assert r.tokens.shape == (max_new,), r.uid
    assert 0.0 <= out["accuracy"] <= 1.0


@pytest.mark.parametrize("extra", [["--executor", "overlapped"],
                                   ["--executor", "serial", "--kv", "paged"]],
                         ids=["ring-overlapped", "paged-serial"])
def test_family_cycle_serves_every_request(extra):
    out = launch_serve.main(TINY + extra)
    _check_served(out, 2)
    want = _reference_archs(list(out["archs"]))
    assert out["archs"] == {n: c.name for n, c in want.items()}
    fams = [launch_serve.expert_config(i, n).family
            for i, n in enumerate(out["archs"])]
    assert fams == [c.family for c in want.values()]
    assert fams == ["rwkv", "hybrid", "dense", "dense", "dense", "dense"]
    assert out["host_blocks"] > 0


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_hub_path_and_trace(tmp_path, paged):
    trace = tmp_path / "serve.json"
    store = tmp_path / "store"
    argv = TINY + ["--hub-slots", "2", "--trace", str(trace),
                   "--store", str(store), "--max-new", "3"]
    out = launch_serve.main(argv + (["--kv", "paged"] if paged else []))
    _check_served(out, 3)
    assert set(out["archs"].values()) == {"llama-hub"}
    assert json.loads(trace.read_text())["traceEvents"]
    assert (tmp_path / "serve.jsonl").stat().st_size > 0
    assert sorted(p.name for p in store.iterdir())
