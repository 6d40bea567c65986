"""The port stands alone: no jax or reference-package import anywhere in
``src/repro_torch`` or ``chip_smoke.py``, nothing heavy at import time,
and no silent CPU fallback at the entry points."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_importing_every_module_loads_no_jax_and_builds_nothing():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        .replace(".__init__", "").rstrip(".")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.rstrip('.'))\n"
        "from repro_torch.kernels import build\n"
        "print(json.dumps({'mods': sorted(sys.modules),"
        " 'lib': build._lib is not None}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    loaded = got["mods"]
    assert not [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib")]
    assert not [m for m in loaded if m == "repro" or m.startswith("repro.")]
    for m in ("repro_torch.serve.scheduler", "repro_torch.optim.adamw",
              "repro_torch.optim.schedules", "repro_torch.train.loop",
              "repro_torch.data.synthetic", "repro_torch.data.splits",
              "repro_torch.data.preprocess", "repro_torch.launch.train",
              "repro_torch.core.trainer", "repro_torch.core.mlp_baseline",
              "repro_torch.launch.serve", "repro_torch.models.zamba",
              "repro_torch.models.mamba2",
              "repro_torch.serve.hub", "repro_torch.serve.placement",
              "repro_torch.checkpoint.io", "repro_torch.models.moe",
              "repro_torch.models.encdec", "repro_torch.examples.quickstart",
              "repro_torch.examples.serve_routing",
              "repro_torch.examples.train_expert"):
        assert m in loaded, m
    assert not got["lib"], "a kernel library was built at import time"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA refusal; this machine has a card")


def test_entry_points_refuse_without_cuda(no_cuda):
    from repro_torch import core as tcore
    from repro_torch import serve as tserve
    from repro_torch.bridge import to_torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    model = build_model(get_config("smollm_135m").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.ExpertEngine(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.init_ae(0)
    aes = [tcore.init_ae(i, device="cpu") for i in range(2)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.build_matcher(aes, ["a", "b"])
    matcher = tcore.build_matcher(aes, ["a", "b"], device="cpu")
    reg = tcore.ExpertRegistry()
    for n in ("a", "b"):
        reg.add(n, tserve.ExpertEngine(model, params, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.RoutedServer(matcher, reg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_torch({"w": np.zeros(3, np.float32)})
    # the trainers, the LM Trainer and the training launcher
    from repro_torch.launch import train as launch_train
    from repro_torch.train import Trainer
    x = np.random.default_rng(0).random((8, 784), dtype=np.float32)
    y = np.arange(8) % 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.train_ae(x, epochs=1, batch_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.train_mlp(x, y, n_classes=2, epochs=1, batch_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, total_steps=2)
    launch = ["--arch", "smollm-135m", "--steps", "2", "--seq", "8",
              "--batch", "2", "--log-every", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(launch)
    # asked for explicitly, the CPU runs end to end
    p, st = tcore.train_ae(x, epochs=1, batch_size=4, device="cpu")
    assert float(st["count"]) == 2 and p["w_enc"].device.type == "cpu"
    p, st = tcore.train_mlp(x, y, n_classes=2, epochs=1, batch_size=4,
                            device="cpu")
    assert p["w_out"].shape == (128, 2)
    hist = Trainer(model, total_steps=2, device="cpu").fit(
        iter([{"tokens": np.zeros((2, 8), np.int32),
               "labels": np.ones((2, 8), np.int32)}] * 2), steps=2)
    assert [i for i, _ in hist] == [0, 1]
    hist = launch_train.main(launch + ["--device", "cpu"])
    assert [i for i, _ in hist] == [0, 1]
    # the serving launcher
    from repro_torch.launch import serve as launch_serve
    serve_args = ["--requests", "2", "--n-per-dataset", "32", "--epochs",
                  "1", "--max-new", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(serve_args)
    out = launch_serve.main(serve_args + ["--device", "cpu"])
    assert [r.tokens.shape for r in out["responses"]] == [(1,), (1,)]
    srv = tserve.RoutedServer(matcher, reg, device="cpu")
    out = srv.serve([tserve.Request(0, np.zeros(784, np.float32),
                                    np.arange(5, dtype=np.int32), 3)])
    assert out[0].tokens.shape == (3,)
    # banked placement and the expert hub: the bank and the hub refuse,
    # plan_placement builds its banks on the engines' own device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.BankedEngine(model, [params, params])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.ExpertHub(model, n_slots=2)
    plan = tserve.plan_placement(reg)
    assert plan.shards[0].bank.device.type == "cpu"
    hub = tserve.ExpertHub(model, n_slots=1, device="cpu")
    hub.add_expert("a", params)
    out = tserve.RoutedServer(None, hub.build_registry(), hub=hub,
                              device="cpu").serve([tserve.Request(
                                  0, np.zeros(784, np.float32),
                                  np.arange(5, dtype=np.int32), 3,
                                  expert=0)])
    assert out[0].tokens.shape == (3,)


def test_mixed_devices_are_refused():
    """A server on one device never quietly serves an engine or matcher
    that lives on another."""
    from repro_torch import core as tcore
    from repro_torch import serve as tserve
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    model = build_model(get_config("smollm_135m").reduced())
    params = model.init(0, device="cpu")
    params_meta = {**params, "embed": params["embed"].to("meta")}
    with pytest.raises(ValueError, match="params live on"):
        tserve.ExpertEngine(model, params_meta, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        model.init(0, device="xpu")
    # "meta" builds shapes only (BaseModel.param_shapes): no storage
    shapes = model.init(0, device="meta")
    assert shapes["embed"].is_meta and shapes["embed"].shape == \
        params["embed"].shape


def test_chip_smoke_refuses_without_cuda_and_alone(no_cuda, tmp_path):
    """No card: non-zero exit and no result line. Alone in a directory
    (without the package): non-zero exit too."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, PYTHONPATH=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
