"""The port's dry run against the reference's over many combos, each
package in its own subprocess, both at once:

    PYTHONPATH=src python tests/_dryrun_compare.py OUT.jsonl \\
        [--archs a,b,...] [--shapes s,...] [--layers 2] [--pods sp,mp]

The default combos are the seven dense, MoE and VLM configs x the four
``SHAPES`` x single- and multi-pod, at published widths cut to
``--layers`` layers (train microbatches 1). Every result line of both
packages goes to ``OUT.jsonl`` (``"package": "ref"`` or ``"port"``), and
a table is printed: each combo's two statuses, the port's flops over
the reference's, and the port's per-device peak, collective bytes and
roofline bottleneck. The reference's module sets ``XLA_FLAGS`` to 512
host devices at import, hence the subprocess.

``--parent-loss`` runs the port alone with ``softmax_xent`` as it was
before the vocab-parallel loss (the f32 logits' vocab gathered onto
every ``model`` rank, then ``logsumexp`` and ``gather``): the "before"
of that repair, for the same combos.
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["smollm_135m", "llama3_2_1b", "qwen2_5_14b", "qwen2_72b",
         "olmoe_1b_7b", "mixtral_8x22b", "internvl2_26b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

_RUN = """
import json, sys
pkg, combos = sys.argv[1], json.loads(sys.argv[2])
over = json.loads(sys.argv[3])
if pkg == "ref":
    from repro.launch.dryrun import run_one
    kw = {}
else:
    from repro_torch.launch.dryrun import run_one
    kw = {"device": "cpu"}
if pkg == "parent-loss":
    import torch
    import repro_torch.models.common as C
    import repro_torch.models.dense as D

    def gathered_xent(logits, labels, mask=None):
        logits = C.replicate_dim(logits.float(), logits.ndim - 1)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        return C.replicate_dim((lse - gold).mean())

    D.softmax_xent = gathered_xent
for arch, shape, mp in combos:
    r = run_one(arch, shape, multi_pod=mp, overrides=over, **kw)
    r.pop("trace", None)
    r["package"] = pkg
    print(json.dumps(r), flush=True)
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--pods", default="sp,mp")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--parent-loss", action="store_true")
    args = ap.parse_args(argv)
    combos = [(a, s, p == "mp") for a in args.archs.split(",")
              for s in args.shapes.split(",") for p in args.pods.split(",")]
    over = {"n_layers": args.layers, "train_microbatches": 1}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    pkgs = ("parent-loss",) if args.parent_loss else ("ref", "port")
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", _RUN, pkg, json.dumps(combos),
         json.dumps(over)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        text=True) for pkg in pkgs}
    res = {}
    with open(args.out, "w") as f:
        for pkg, p in procs.items():
            for line in p.stdout:
                if line.startswith("{"):
                    f.write(line)
                    r = json.loads(line)
                    res[(pkg, r["arch"], r["shape"], r["multi_pod"])] = r
            p.wait()
    if args.parent_loss:
        for r in res.values():
            print(json.dumps({k: r.get(k) for k in (
                "arch", "shape", "multi_pod", "status", "collectives",
                "memory", "flops_per_device")}))
        return res
    print("| combo | ref | port | port flops / ref | port peak GB | "
          "port collective GB (all-gather / all-reduce / reduce-scatter) "
          "| bottleneck |")
    print("|---|---|---|---|---|---|---|")
    for a, s, mp in combos:
        ref = res.get(("ref", a, s, mp), {"status": "missing"})
        got = res.get(("port", a, s, mp), {"status": "missing"})
        ratio = peak = coll = neck = ""
        if got["status"] == ref["status"] == "ok":
            ratio = f"{got['flops_per_device'] / ref['flops_per_device']:.4f}"
        if got["status"] == "ok":
            peak = f"{got['memory']['peak_bytes'] / 1e9:.2f}"
            c = got["collectives"]
            coll = " / ".join(f"{c.get(k, 0.0) / 1e9:.2f}" for k in (
                "all-gather", "all-reduce", "reduce-scatter"))
            neck = got["roofline"]["bottleneck"]
        print(f"| {a} {s} {'mp' if mp else 'sp'} | {ref['status']} | "
              f"{got['status']} | {ratio} | {peak} | {coll} | {neck} |")
    same = sum(res.get(("ref",) + c, {}).get("status") ==
               res.get(("port",) + c, {}).get("status") for c in combos)
    print(f"statuses equal on {same} of {len(combos)} combos")
    return res


if __name__ == "__main__":
    main()
