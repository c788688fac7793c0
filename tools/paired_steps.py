#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s step phases from two checkouts in turns on one
CUDA card.

    python3 tools/paired_steps.py PARENT_DIR [CHANGE_DIR] [--phases LIST]
                                  [--turns N]

from the repository root.  Runs phases of each checkout's own
``chip_smoke.py``, each time in a process of its own started in that
checkout (so it builds and imports that checkout's ``paddle_tpu_torch``),
in the order parent, change, change, parent (``--turns N``: that order N
times).  ``--phases`` takes a comma list of ``train``, ``gpt``, ``eager``
(GPT and Llama), ``encoder`` (the default: those four) and ``head_host``:
the host time of one ``linear_ce_fwd_cuda`` call and of one
``linear_ce_bwd_cuda`` call (enqueue only, the card idle before each; the
median of 30) on eager GPT-125M's bf16 head (T 8192, H 768, V 32768,
slabs of 2048).  Prints, per phase, each run's step ms (the encoder:
forward ms; head_host: host ms) and the flash and linear-CE kernels'
device ms in its profiled step, then the change's mean less the parent's.
CHANGE_DIR defaults to the repository root.  Writes
``chiprun_out/paired_steps.json``.  Any failed check in a phase fails the
run.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json
import statistics
import sys
import time
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
phases = sys.argv[1].split(",")
cs.phase_device()
cs.phase_build()
out = {}
if "train" in phases:
    out["train"] = cs.phase_train()[1]
if "gpt" in phases:
    out["gpt"] = cs.phase_gpt_train()[1]
if "eager" in phases:
    torch.cuda.empty_cache()
    out.update({f"eager {k}": v for k, v in cs.phase_eager()[1].items()})
if "encoder" in phases:
    torch.cuda.empty_cache()
    out.update({f"encoder {k}": v for k, v in cs.phase_encoder()[1].items()})
if "head_host" in phases:
    from paddle_tpu_torch.ops.cuda import linear_ce as lc
    T, H, V, C = 8192, 768, 32768, 2048
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    x = torch.randn(T, H, device="cuda", generator=gen).to(torch.bfloat16)
    w = (0.02 * torch.randn(V, H, device="cuda", generator=gen)).to(
        torch.bfloat16)
    lab = torch.randint(0, V, (T,), device="cuda", generator=gen)
    g = torch.ones(T, device="cuda")
    fwd, bwd = [], []
    for i in range(31):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lse = lc.linear_ce_fwd_cuda(x, w, lab)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lc.linear_ce_bwd_cuda(x, w, lab, lse, g, chunk=C)
        t3 = time.perf_counter()
        if i:
            fwd.append(t1 - t0)
            bwd.append(t3 - t2)
    torch.cuda.synchronize()
    out["head_host fwd"] = {"host_ms": 1e3 * statistics.median(fwd)}
    out["head_host bwd"] = {"host_ms": 1e3 * statistics.median(bwd)}
print("PAIRED " + json.dumps(out, default=float), flush=True)
"""


GROUPS = ("flash kernels", "linear-CE kernels")


def run(tree, phases):
    """{phase: (step, forward or host ms, {group: device ms or None})} of
    one run, the groups those of ``GROUPS``."""
    p = subprocess.run([sys.executable, "-c", CHILD, phases], cwd=tree,
                       text=True, capture_output=True)
    sys.stderr.write(p.stderr[-4000:])
    line = [x for x in p.stdout.splitlines() if x.startswith("PAIRED ")]
    if p.returncode or not line:
        print(p.stdout[-8000:])
        raise SystemExit(f"{tree}: the phases failed (exit {p.returncode})")
    out = {}
    for phase, s in json.loads(line[0][len("PAIRED "):]).items():
        ms = s.get("step_ms", s.get("forward_ms", s.get("host_ms")))
        by = s.get("device_ms_by_group", {})
        out[phase] = (ms, {g: by.get(g) for g in GROUPS})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=str(ROOT))
    ap.add_argument("--phases", default="train,gpt,eager,encoder")
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()
    trees = {"parent": Path(args.parent).resolve(),
             "change": Path(args.change).resolve()}
    runs = {"parent": [], "change": []}
    for name in ("parent", "change", "change", "parent") * args.turns:
        runs[name].append(run(trees[name], args.phases))
        print(f"{name} run {len(runs[name])}: {json.dumps(runs[name][-1])}",
              flush=True)
    report = {}
    for phase in runs["parent"][0]:
        row = {name: [r[phase] for r in rs] for name, rs in runs.items()}
        mean = {name: sum(ms for ms, _ in v) / len(v)
                for name, v in row.items()}
        report[phase] = dict(row, change_less_parent_ms=mean["change"]
                             - mean["parent"])
        groups = "; ".join(
            f"{g} ms parent {[v[1][g] for v in row['parent']]}, change "
            f"{[v[1][g] for v in row['change']]}" for g in GROUPS)
        print(f"{phase}: parent {[v[0] for v in row['parent']]} ms, change "
              f"{[v[0] for v in row['change']]} ms; {groups}; change - "
              f"parent {report[phase]['change_less_parent_ms']:+.2f} ms",
              flush=True)
    out = ROOT / "chiprun_out" / "paired_steps.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
