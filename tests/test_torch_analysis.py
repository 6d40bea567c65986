"""The port's contract gate (``repro_torch.analysis``), the counterpart
of ``tests/test_analysis.py``: two directions per pass. The port's tree
must be clean under its ``baseline.toml``, and a *planted* violation of
every rule (L001-L006, O001-O003 in ``tests/test_torch_obs.py``,
K001-K004, H001-H004, R001-R004, S001-S002) must be flagged, beside a
clean case — a checker that never fires is indistinguishable from one
that works. ``main([... "--device", "cpu"])`` runs the whole gate in
this process. On the card (``-m cuda``) the graph pass runs on real
captures, and a ``.item()`` planted in a decode body makes the capture
raise under sync debug mode.
"""
import textwrap

import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.analysis import (BASELINE_REL, Violation, apply_baseline,
                                  format_report, load_baseline)
from repro_torch.analysis import graph_contracts as gc
from repro_torch.analysis import kernel_check as kc
from repro_torch.analysis import lint, obs_lint, races
from repro_torch.analysis import sanitizer as S
from repro_torch.analysis.__main__ import main
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import ExpertEngine, ExpertHub

PLANTED = "src/repro_torch/serve/planted.py"


def _rules(vs, severity="error"):
    return sorted({v.rule for v in vs if v.severity == severity})


# -- the port's tree: clean under its baseline ---------------------------------


def test_port_tree_clean_under_baseline():
    """The source passes (lint, obs, races) over the port: no unbaselined
    error, and every baseline stanza still suppresses a finding (no rot).
    The engine and kernel passes run in the CLI case below."""
    found = lint.run() + obs_lint.run() + races.run()
    entries = load_baseline()
    active, suppressed = apply_baseline(found, entries)
    errors = [v for v in active if v.severity == "error"]
    assert not errors, "\n" + format_report(errors)
    assert {v.key() for v in suppressed} == {
        (e["rule"], e["file"], e["func"]) for e in entries}, \
        "stale baseline.toml stanza (suppresses nothing): delete it"


def test_cli_all_passes_with_fail_gate(capsys):
    """The whole gate, in this process: every pass, the baseline applied,
    the graph pass's engines on the CPU."""
    assert main(["--all", "--fail-on-violation", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "lint obs graphs kernels races sanitizer" in out
    assert "0 active finding(s)" in out


def test_baseline_requires_reason(tmp_path):
    p = tmp_path / "b.toml"
    p.write_text('[[baseline]]\nrule = "L004"\nfile = "f.py"\n'
                 'func = "g"\n')
    with pytest.raises(ValueError, match="justification"):
        load_baseline(str(p))
    p.write_text('[[baseline]]\nrule = "L004"\nfile = "f.py"\n'
                 'func = "g"\nreason = " "\n')
    with pytest.raises(ValueError, match="justification"):
        load_baseline(str(p))
    p.write_text('[[baseline]]\nrule = [1]\n')
    with pytest.raises(ValueError, match="unsupported"):
        load_baseline(str(p))


def test_baseline_is_keyed_not_line_based_and_report_names_the_file():
    v = Violation("L004", "f.py", 42, "Klass.fn", "msg")
    active, supp = apply_baseline(
        [v], [{"rule": "L004", "file": "f.py", "func": "Klass.fn",
               "reason": "r"}])
    assert not active and supp == [v]
    assert BASELINE_REL in format_report([v])
    assert BASELINE_REL == "src/repro_torch/analysis/baseline.toml"


# -- lint: planted violations --------------------------------------------------

_BODY = """
    import numpy as np
    import torch

    class DecodeGraph:
        def _body(self):
            self.out.copy_(self.core.step(self.tok))

    class Core:
        def step(self, tok):
            {line}
            return tok + 1
"""


def _captured(line):
    return lint.lint_source(textwrap.dedent(_BODY.format(line=line)),
                            PLANTED)


@pytest.mark.parametrize("line", [
    "n = int(tok.sum())",
    "n = tok.sum().item()",
    "host = tok.cpu()",
    "torch.cuda.synchronize()",
    "host = tok.to('cpu')",
    "host = np.asarray(tok)",
    "dev = torch.tensor([1, 2], device=tok.device)",
])
def test_lint_catches_host_sync_in_captured_body(line):
    vs = _captured(line)
    assert any(v.rule == "L001" and v.func == "Core.step" for v in vs), vs


@pytest.mark.parametrize("line", [
    "if tok.sum() > 0:\n                tok = -tok",
    "assert (tok >= 0).all()",
    "idx = torch.nonzero(tok)",
    "live = tok[tok > 0]",
    "u = tok.unique()",
])
def test_lint_catches_tensor_branch_or_dynamic_shape(line):
    vs = _captured(line)
    assert any(v.rule == "L002" for v in vs), vs


def test_lint_untaints_parameters_by_annotation_not_by_name():
    """A branch on an unannotated parameter named like configuration
    (``p``, as the params tree is named) is flagged; the same branch on
    a parameter annotated as a host type is not."""
    body = textwrap.dedent(_BODY.format(line="tok = self.mix(tok, tok)"))
    mix = """
        def mix(self, p{ann}, tok):
            if p:
                tok = -tok
            return tok
    """

    def lint_mix(ann):
        return lint.lint_source(body + textwrap.indent(
            textwrap.dedent(mix.format(ann=ann)), "    "), PLANTED)

    assert any(v.rule == "L002" and v.func == "Core.mix"
               for v in lint_mix("")), lint_mix("")
    assert not lint_mix(": Dict[str, int]")


def test_lint_clean_captured_body_and_uncaptured_sync():
    """Masked arithmetic inside the body passes; the same host sync in a
    function no step body reaches is not captured code."""
    assert not _captured("tok = torch.where(tok > 0, tok, -tok)")
    src = textwrap.dedent(_BODY.format(line="pass")) + textwrap.dedent("""
        def harvest(planes):
            return [int(p.sum()) for p in planes], planes[0].cpu()
    """)
    assert not lint.lint_source(src, PLANTED)


def test_lint_catches_graph_ladder_read():
    src = textwrap.dedent("""
        def buckets(engine):
            return sorted(engine.core._graphs)
    """)
    vs = lint.lint_source(src, "src/repro_torch/launch/planted.py")
    assert _rules(vs) == ["L003"], vs
    # ...which the ladder's home reads through EngineStats
    assert not lint.lint_source(src, "src/repro_torch/serve/core.py")


def test_lint_catches_unsynced_device_timing():
    src = textwrap.dedent("""
        import time
        import torch

        def bench(a, b):
            t0 = time.perf_counter()
            y = torch.matmul(a, b)       # enqueued, not finished
            return time.perf_counter() - t0, y
    """)
    assert _rules(lint.lint_source(src, "chip_smoke.py")) == ["L004"]
    synced = src.replace("# enqueued, not finished",
                         "\n    torch.cuda.synchronize()")
    assert not lint.lint_source(synced, "chip_smoke.py")


def test_lint_catches_lifecycle_leak():
    src = textwrap.dedent("""
        def admit(pool, local, stage):
            pages = pool.alloc(local, 4)
            stage(pages)                 # can raise: pages leak
            return pages
    """)
    path = "src/repro_torch/serve/scheduler.py"
    assert _rules(lint.lint_source(src, path)) == ["L005"]
    paired = textwrap.dedent("""
        def admit(pool, local, stage):
            pages = pool.alloc(local, 4)
            try:
                stage(pages)
            finally:
                pool.release(local, pages)
    """)
    assert not lint.lint_source(paired, path)


def test_lint_catches_unbucketed_prefill_shape():
    """L006: a token array shaped by the raw prompt, or a chunk index off
    a raw length, keys a new prefill shape per prompt."""
    src = textwrap.dedent("""
        import numpy as np

        def admit(self, prompts):
            S = max(len(p) for p in prompts)
            toks = np.zeros((self.n_experts, 2, S), np.int32)
            return self._prefill(toks)
    """)
    assert _rules(lint.lint_source(src, PLANTED)) == ["L006"]
    src = textwrap.dedent("""
        def chunk(self, toks, ptbl, stbl):
            k = toks.shape[2] // 16
            return self._paged_suffix(k, toks, ptbl, stbl)
    """)
    assert _rules(lint.lint_source(src, PLANTED)) == ["L006"]


def test_lint_ladder_derived_prefill_shapes_pass():
    src = textwrap.dedent("""
        import numpy as np

        def admit(self, rows, n):
            Bb, Sb = self.pad_shape(rows, n)
            toks = np.zeros((self.n_experts, Bb, Sb), np.int32)
            pending = []
            for k in range(Sb // self.chunk_len):
                part = np.zeros((self.n_experts, Bb, self.chunk_len))
                pending.append({"k": k, "toks": part})
            for d in pending:
                self._paged_suffix(d["k"], d["toks"], None, None)
            return self._prefill(toks)
    """)
    assert not lint.lint_source(src, PLANTED)


# -- kernels: planted launch geometry ------------------------------------------


@pytest.fixture(scope="module")
def limits():
    return kc.read_limits()


def test_kernel_limits_read_from_the_sources(limits):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import expert_score as es
    assert limits.expert["MAX_RANKS"] == es.MAX_RANKS == 16
    assert limits.expert["MAX_ROWS"] == es.MAX_ROWS
    assert limits.expert_nonportable and not limits.decode_nonportable
    assert limits.decode["MAX_SPLIT"] == da.MAX_SPLIT == 8
    assert limits.wkv_threads == {16: 64, 32: 128, 64: 256}
    assert kc.check_planner_limits(limits) == []


def _launch(entry, **args):
    base = {"expert_score_f32": dict(B=32, D=784, H=128, K=6, n_rank=16,
                                     rows=32),
            "decode_attention": dict(B=8, H=32, KV=8, S=256, dh=64,
                                     window=0, scale=0, is_bf16=1,
                                     n_split=1),
            "wkv_step": dict(B=4, H=64, P=64, is_bf16=1),
            "cosine_fine_f32": dict(R=40, K=6, M=10, h=128)}[entry]
    return kc.Launch(entry, {**base, **args})


@pytest.mark.parametrize("entry", ["expert_score_f32", "decode_attention",
                                   "wkv_step", "cosine_fine_f32"])
def test_kernel_serving_launches_are_clean(limits, entry):
    assert kc.check_launch(_launch(entry), "serving", limits) == []


@pytest.mark.parametrize("rule,launch", [
    ("K001", _launch("expert_score_f32", n_rank=17)),
    ("K001", _launch("decode_attention", n_split=16)),
    ("K002", _launch("decode_attention", H=64, KV=2)),        # G 32
    ("K002", _launch("decode_attention", B=70000)),          # grid z
    ("K002", _launch("wkv_step", P=128)),                    # no body
    ("K002", _launch("expert_score_f32", rows=33)),
    ("K003", _launch("expert_score_f32", n_rank=1)),         # 0.9 MB
    ("K003", _launch("decode_attention", S=1 << 24)),
])
def test_kernel_check_catches_planted_geometry(limits, rule, launch):
    vs = kc.check_launch(launch, "planted", limits)
    assert rule in _rules(vs), vs


def test_kernel_check_warns_off_the_16_byte_path(limits):
    vs = kc.check_launch(_launch("expert_score_f32", D=98), "d98", limits)
    assert _rules(vs) == [] and _rules(vs, "warning") == ["K004"]
    vs = kc.check_launch(_launch("cosine_fine_f32", h=30), "h30", limits)
    assert _rules(vs, "warning") == ["K004"]


def test_kernel_capture_runs_the_wrapper_and_its_planner(limits):
    """The recorder sees the real wrappers' launches on fake card
    tensors: the decode grid (n_split, KV, B), and a bank too wide for
    shared memory flagged through the real planner."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops
    before = ops.launches()
    with kc.capture_launches(limits) as launches, \
            FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty(8, 32, 64, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(8, 256, 8, 64, dtype=torch.bfloat16, device="cuda")
        ops.decode_attention(q, k, k, torch.empty((), dtype=torch.int32,
                                                  device="cuda"),
                             torch.empty(256, dtype=torch.int32,
                                         device="cuda"))
        K, D, H = 2, 784, 8192
        ops.expert_score_folded(
            {"w1": torch.empty(K, D, H, device="cuda"),
             "b1": torch.empty(K, H, device="cuda"),
             "w2": torch.empty(K, H, D, device="cuda"),
             "b2": torch.empty(K, D, device="cuda")},
            torch.empty(32, D, device="cuda"))
    da, es = launches
    assert da.entry == "decode_attention" and da.args["n_split"] == 1
    g = kc.geometry(da, limits)
    assert g.grid == (1, 8, 8) and g.block == 128 and g.cluster == 1
    assert kc.check_launch(da, "ring", limits) == []
    assert es.entry == "expert_score_f32" and es.args["n_rank"] == 16
    assert "K003" in _rules(kc.check_launch(es, "wide", limits))
    assert ops.launches() == before        # recorded launches ran nothing


# -- graphs: planted H001-H004 ---------------------------------------------------


@pytest.fixture(scope="module")
def small():
    model = build_model(get_config("smollm_135m").reduced(name="gc-t"))
    return model, model.init(0, device="cpu")


def _generate(model, params, n=4):
    eng = ExpertEngine(model, params, max_len=16, min_len_bucket=8,
                       batch_buckets=(1, 2), device="cpu")
    eng.generate(np.full((2, 8), 3, np.int32), n)
    return eng


def test_h001_catches_a_step_buffer_rebound(monkeypatch, small):
    from repro_torch.serve.graphs import DecodeGraph
    body = DecodeGraph._body

    def rebinding(self):
        body(self)
        self.out = self.out.clone()   # a replay would write the old one

    monkeypatch.setattr(DecodeGraph, "_body", rebinding)
    with gc.instrument_steps() as (log, moved):
        _generate(*small)
    vs = gc.step_findings(log, moved, kinds=("decode",))
    assert _rules(vs) == ["H001"], vs


def test_h001_h002_clean_decode(small):
    with gc.instrument_steps() as (log, moved):
        _generate(*small)
    assert gc.step_findings(log, moved, kinds=("decode",)) == []


@pytest.mark.parametrize("planted", ["item", "nonzero"])
def test_h002_catches_a_host_round_trip_in_the_decode_body(small, planted):
    model, params = small
    model = build_model(model.cfg)          # an instance of its own
    decode = model.decode

    def impure(p, cache, batch):
        tok = batch["token"]
        if planted == "item":
            tok.sum().item()
        else:
            torch.nonzero(tok)
        return decode(p, cache, batch)

    model.decode = impure
    with gc.instrument_steps() as (log, moved):
        _generate(model, params)
    vs = gc.step_findings(log, moved, kinds=("decode",))
    assert _rules(vs) == ["H002"], vs


def _hub(model, layout="ring"):
    from repro_torch.launch.mesh import ExpertMesh
    mesh = ExpertMesh(("cpu", "cpu"))
    kw = dict(kv_layout="paged", chunk_len=8) if layout == "paged" else {}
    return ExpertHub(model, n_slots=4, max_len=32, min_len_bucket=8,
                     batch_buckets=(1, 2), mesh=mesh, device="cpu",
                     **kw), mesh


def test_h003_catches_misplaced_bank_leaves(small):
    from repro_torch.tree import tree_map
    hub, mesh = _hub(small[0], "paged")
    try:
        core = hub.bank.core
        assert gc._placement(core, mesh, "bank") == []
        core.params[3] = tree_map(lambda t: t.to("meta"), core.params[3])
        core.kv_pool[1] = core.kv_pool[0]
        vs = gc._placement(core, mesh, "bank")
    finally:
        hub.close()
    assert _rules(vs) == ["H003"] and len(vs) == 2, vs


def test_h004_catches_a_ladder_short_of_its_bound(small):
    hub, _ = _hub(small[0])
    try:
        core = hub.bank.core
        hub.warmup(max_batch=1, commit=False)       # bucket 2 never runs
        short = gc._bounds(core, "ring_hub")
        hub.warmup(commit=False)
        full = gc._bounds(core, "ring_hub")
    finally:
        hub.close()
    assert _rules(short) == ["H004"] and \
        any("decode" in v.func for v in short), short
    assert full == []


# -- races: planted R001-R004 ------------------------------------------------------

CONTRACT = textwrap.dedent('''
    THREAD_CONTRACT = {
        "lock": "_lock",
        "lock_aliases": ["_lock", "_cv"],
        "threads": {
            "scheduler": ["Hub.step"],
            "stager": ["Hub._stage_loop"],
        },
        "lock_guarded": {
            "fields": ["catalog", "_wanted"],
            "entry_fields": ["state", "params", "slot"],
            "stats_fields": ["loads"],
        },
        "queue_handoffs": ["_stage_q"],
        "single_writer": {"scheduler": ["_index"]},
        "blocking_calls": ["load_expert", "join", "sleep", "wait"],
        "publish_order": {"state": {"staged": ["params"],
                                    "resident": ["slot"]}},
    }
''')

CLEAN = CONTRACT + textwrap.dedent('''
    class Hub:
        def __init__(self):
            self._wanted = {}
            self.catalog = []
            self._index = {}

        def step(self, e):
            with self._lock:
                self._wanted[e] = True
                c = self.catalog[e]
                c.slot = e
                c.state = "resident"
            self._index[e] = 1

        def _stage_loop(self):
            job = self._stage_q.get()
            p = load_expert(job)
            with self._lock:
                c = self.catalog[job]
                c.params = p
                c.state = "staged"
                self.stats.loads += 1
                self._cv.wait(1.0)
''')

RACES = {
    "R001": ("        self._index[e] = 1",
             "        self._index[e] = 1\n        self._wanted.pop(e, None)"),
    "R002": ('            c.state = "resident"',
             '            c.state = "resident"\n'
             '            with self._lock:\n                pass'),
    "R003": ("        p = load_expert(job)\n        with self._lock:",
             "        with self._lock:\n            p = load_expert(job)"),
    "R004": ('            c.params = p\n            c.state = "staged"',
             '            c.state = "staged"\n            c.params = p'),
}


def test_races_clean_unit():
    assert races.analyze_unit({"unit/hub.py": CLEAN}) == []


@pytest.mark.parametrize("rule", sorted(RACES))
def test_races_catch_planted(rule):
    old, new = RACES[rule]
    assert old in CLEAN
    vs = races.analyze_unit({"unit/hub.py": CLEAN.replace(old, new)})
    assert rule in _rules(vs), vs


# -- sanitizer: planted S001-S002 ------------------------------------------------


def test_s002_planted_lost_update_reproduces():
    got, want, trace = S.demo_lost_update(S.LOST_UPDATE_SEED, locked=False)
    assert got < want
    got, want, _ = S.demo_lost_update(S.LOST_UPDATE_SEED, locked=True)
    assert got == want


def test_s001_s002_flag_a_broken_hub_and_a_nondeterministic_replay(
        monkeypatch):
    monkeypatch.setattr(ExpertHub, "total_pins", lambda self: 1)
    assert "S001" in _rules(S.run(seeds=(0,), device="cpu"))
    monkeypatch.undo()
    fuzz, calls = S.fuzz_torch_hub, []

    def drifting(seed, **kw):
        r = fuzz(seed, **kw)
        calls.append(seed)
        if len(calls) == 2:
            r.trace = r.trace[:-1]            # the replay diverges
        return r

    monkeypatch.setattr(S, "fuzz_torch_hub", drifting)
    vs = S.run(seeds=(0,), device="cpu")
    assert any(v.rule == "S002" and "deterministic" in v.msg
               for v in vs), vs


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_graph_contracts_clean_under_real_captures(cuda):
    assert gc.run(cuda) == []


@pytest.mark.cuda
def test_cuda_sanitizer_fuzzes_a_hub_on_the_card(cuda):
    """S001-S002 with the fuzzed hubs' pools on the card: the staging
    worker's copies run while the schedule interleaves, and the replay
    stays byte-deterministic."""
    r = S.fuzz_torch_hub(0, device=cuda)
    assert r.failures == [] and r.errors == []
    assert S.run(seeds=(0,), device=cuda) == []


@pytest.mark.cuda
def test_cuda_item_in_a_decode_body_raises_at_capture(cuda, small):
    """H002 on the card: a ``.item()`` planted in the decode body makes
    the capture raise (sync debug mode "error", and the capture's own
    refusal of a host sync)."""
    model = build_model(small[0].cfg)
    decode = model.decode

    def impure(p, cache, batch):
        batch["token"].sum().item()
        return decode(p, cache, batch)

    model.decode = impure
    params = model.init(0, device=cuda)
    eng = ExpertEngine(model, params, max_len=16, min_len_bucket=8,
                       batch_buckets=(1, 2), device=cuda)
    with gc.instrument_steps():
        with pytest.raises(RuntimeError):
            eng.generate(np.full((2, 8), 3, np.int32), 4)
