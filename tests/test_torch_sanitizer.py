"""The reference's deterministic schedule fuzzer (rules S001-S002, the
``Interleaver`` and its shims in ``repro.analysis.sanitizer``) over the
port's ``ExpertHub``: the counterparts of ``tests/test_sanitizer.py``'s
determinism, staging-failure and thread-hygiene cases.

The reference's ``fuzz_hub`` builds the reference's hub (with an option
the port does not have) over a JAX stub model, so this file carries its
own harness, ``fuzz_torch_hub``: the same seeded workload (acquire /
pin / unpin / note_hit / want / service / check from the managed main
thread while the hub's staging worker interleaves, line by line in
``serve/hub.py``), a drain, and the same conservation checks, over a
torch stub model whose hub builds in milliseconds. The line tracer is
scoped to paths ending ``serve/hub.py``, which the port's hub matches.

Armed with a faulthandler hard timeout, as the reference suite is: a
real deadlock dumps every thread's stack instead of hanging the run.
"""
import dataclasses
import faulthandler
import random
import tempfile
import threading
from typing import Dict, List

import pytest
import torch

from repro.analysis import sanitizer as S
from repro_torch.checkpoint import save_expert
from repro_torch.serve import ExpertHub, NotResident

SUITE_TIMEOUT = 240.0


@pytest.fixture(autouse=True, scope="module")
def hard_timeout():
    on_main = threading.current_thread() is threading.main_thread()
    if on_main:
        faulthandler.dump_traceback_later(SUITE_TIMEOUT, exit=True)
    yield
    if on_main:
        faulthandler.cancel_dump_traceback_later()


@dataclasses.dataclass(frozen=True)
class _StubCfg:
    name: str = "stub"
    family: str = "stub"
    n_experts: int = 0
    moe_impl: str = "none"

    def replace(self, **kw) -> "_StubCfg":
        return dataclasses.replace(self, **kw)


class _StubModel:
    """What ``ExpertHub`` and its bank need at construction: tiny params
    (``embed``: the engine checks its device), paged-KV capable (so the
    fuzz hub runs the paged layout and ``PagePool.check`` is a real
    invariant). The workload never prefills or decodes: it drives the
    residency lifecycle, where the threads interleave."""

    supports_paged_kv = True
    supports_verify = False

    def __init__(self):
        self.cfg = _StubCfg()

    def param_shapes(self):
        return {"embed": torch.empty((4,), device="meta")}

    def init_paged_pool(self, n_pages, page, device=None):
        # + 1: physical page n_pages is the trash page
        return {k: torch.zeros((n_pages + 1, page, 2), device=device)
                for k in ("k", "v")}


def _stub_params():
    return {"embed": torch.zeros((4,))}


@dataclasses.dataclass
class FuzzResult:
    trace: List[str]
    failures: List[str]          # invariant violations
    errors: List[str]            # exceptions service() surfaced
    stats: Dict[str, float]


def fuzz_torch_hub(seed: int, *, n_experts: int = 4, n_slots: int = 2,
                   steps: int = 30, fail_expert: bool = False,
                   watchdog: float = 30.0) -> FuzzResult:
    """One seeded interleaving of the port's hub lifecycle, the
    reference's ``fuzz_hub`` workload: a stub-model hub (paged layout,
    host cache of 1) over a cold store, instrumented, driven from the
    managed main thread; then a drain, the conservation checks and
    ``close``. With ``fail_expert`` the last expert is never saved, so
    wanting it runs the staging-failure path mid-fuzz."""
    itl = S.Interleaver(seed, watchdog=watchdog)
    failures: List[str] = []
    errors: List[BaseException] = []
    with tempfile.TemporaryDirectory(prefix="sanitizer-hub-") as store:
        try:
            names = [f"e{i}" for i in range(n_experts)]
            for i, name in enumerate(names):
                if not (fail_expert and i == n_experts - 1):
                    save_expert(store, name, _stub_params())
            hub = ExpertHub(_StubModel(), n_slots=n_slots, max_len=16,
                            min_len_bucket=8, kv_layout="paged",
                            page_size=8, pool_pages=8, store=store,
                            host_cache=1, device="cpu")
            for name in names:
                hub.add_expert(name)
            S.instrument(hub, itl)

            def service(block: bool) -> None:
                try:
                    hub.service(block=block)
                except (AssertionError, S._AbortError):
                    raise
                except Exception as exc:    # staging failures re-raised
                    errors.append(exc)

            def workload() -> None:
                wl = random.Random(seed ^ 0x5EED5EED)
                pinned: List[int] = []
                try:
                    try:
                        for _ in range(steps):
                            op = wl.randrange(8)
                            e = wl.randrange(n_experts)
                            itl.note(f"op{op}:e{e}")
                            if op <= 1:
                                try:
                                    hub.acquire(e)
                                    hub.pin(e)
                                    pinned.append(e)
                                except NotResident:
                                    pass
                            elif op == 2 and pinned:
                                hub.unpin(pinned.pop())
                            elif op == 3:
                                hub.note_hit(e, 1 + wl.randrange(3))
                            elif op == 4:
                                hub.want(e)
                            elif op <= 6:
                                service(block=wl.random() < 0.3)
                            else:
                                hub.check()
                        while pinned:
                            hub.unpin(pinned.pop())
                        for _ in range(8 * n_experts):
                            if not hub.has_wanted:
                                break
                            service(block=True)
                        if hub.has_wanted and not errors:
                            failures.append("drain did not converge: "
                                            "experts still wanted")
                        hub.check()
                        if hub.total_pins():
                            failures.append(f"pins not back to baseline: "
                                            f"{hub.total_pins()}")
                        st = hub.stats
                        if st.stage_attempts != (st.stage_count
                                                 + st.stage_failures):
                            failures.append(
                                f"stage conservation after drain: "
                                f"{st.stage_attempts} attempts != "
                                f"{st.stage_count} + {st.stage_failures}")
                        hub.bank.core.pool.check()
                    finally:
                        hub.close()
                except AssertionError as exc:
                    failures.append(f"invariant: {exc}")
                except S._AbortError as exc:
                    failures.append(f"schedule abort: {exc}")

            itl.run(workload)
            if itl.aborted is not None:
                msg = f"schedule abort: {itl.aborted}"
                if msg not in failures:
                    failures.append(msg)
            return FuzzResult(trace=list(itl.trace), failures=failures,
                              errors=[type(e).__name__ for e in errors],
                              stats=hub.stats.as_dict())
        finally:
            itl.shutdown()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_is_byte_deterministic(seed):
    r1 = fuzz_torch_hub(seed)
    r2 = fuzz_torch_hub(seed)
    assert r1.trace == r2.trace, S._diverge(r1.trace, r2.trace)
    assert r1.failures == [] and r2.failures == []
    assert r1.errors == [] and r2.errors == []
    # the workload really ran the lifecycle, worker lines included
    assert r1.stats["loads"] >= 1
    assert any(t.startswith("hub-stage|") for t in r1.trace)


def test_different_seeds_take_different_schedules():
    assert fuzz_torch_hub(0).trace != fuzz_torch_hub(1).trace


def test_staging_failure_path_recovers():
    """The missing expert's load fails mid-fuzz: the worker's cold reset
    happens under the hub lock, the failure re-raises on the scheduler
    side, every conservation check still holds after, and the failure
    path replays deterministically."""
    r = fuzz_torch_hub(S.FAIL_SEED, fail_expert=True)
    assert r.stats["stage_failures"] >= 1, \
        "workload never wanted the broken expert: dead seed"
    assert r.failures == []
    assert r.errors and set(r.errors) == {"FileNotFoundError"}
    assert r.trace == fuzz_torch_hub(S.FAIL_SEED, fail_expert=True).trace


def test_fuzz_leaves_no_threads_behind():
    before = {t.ident for t in threading.enumerate()}
    fuzz_torch_hub(3)
    leftover = [t for t in threading.enumerate()
                if t.ident not in before and t.is_alive()]
    assert leftover == [], leftover
