#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s step phases from two checkouts in turns on one
CUDA card.

    python3 tools/paired_steps.py PARENT_DIR [CHANGE_DIR]

from the repository root.  Runs the train, gpt, eager (GPT and Llama) and
encoder phases of each checkout's own ``chip_smoke.py``, each time in a
process of its own started in that checkout (so it builds and imports that
checkout's ``paddle_tpu_torch``), in the order parent, change, change,
parent.  Prints, per phase, each run's step ms (the encoder: forward ms)
and the flash kernels' device ms in its profiled step, then the change's
mean less the parent's.  CHANGE_DIR defaults to the repository root.
Writes ``chiprun_out/paired_steps.json``.  Any failed check in a phase
fails the run.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_device()
cs.phase_build()
out = {"train": cs.phase_train()[1], "gpt": cs.phase_gpt_train()[1]}
torch.cuda.empty_cache()
eager = cs.phase_eager()[1]
out.update({f"eager {k}": v for k, v in eager.items()})
torch.cuda.empty_cache()
enc = cs.phase_encoder()[1]
out.update({f"encoder {k}": v for k, v in enc.items()})
print("PAIRED " + json.dumps(out, default=float), flush=True)
"""


def run(tree):
    """{phase: (step or forward ms, flash device ms or None)} of one run."""
    p = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, text=True,
                       capture_output=True)
    sys.stderr.write(p.stderr[-4000:])
    line = [x for x in p.stdout.splitlines() if x.startswith("PAIRED ")]
    if p.returncode or not line:
        print(p.stdout[-8000:])
        raise SystemExit(f"{tree}: the phases failed (exit {p.returncode})")
    out = {}
    for phase, s in json.loads(line[0][len("PAIRED "):]).items():
        ms = s.get("step_ms", s.get("forward_ms"))
        flash = s.get("device_ms_by_group", {}).get("flash kernels")
        out[phase] = (ms, flash)
    return out


def main():
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": Path(sys.argv[1]).resolve(),
             "change": Path(sys.argv[2] if len(sys.argv) == 3 else ROOT)
             .resolve()}
    runs = {"parent": [], "change": []}
    for name in ("parent", "change", "change", "parent"):
        runs[name].append(run(trees[name]))
        print(f"{name} run {len(runs[name])}: {json.dumps(runs[name][-1])}",
              flush=True)
    report = {}
    for phase in runs["parent"][0]:
        row = {name: [r[phase] for r in rs] for name, rs in runs.items()}
        mean = {name: sum(ms for ms, _ in v) / len(v)
                for name, v in row.items()}
        report[phase] = dict(row, change_less_parent_ms=mean["change"]
                             - mean["parent"])
        print(f"{phase}: parent {[v[0] for v in row['parent']]} ms, change "
              f"{[v[0] for v in row['change']]} ms; flash ms parent "
              f"{[v[1] for v in row['parent']]}, change "
              f"{[v[1] for v in row['change']]}; change - parent "
              f"{report[phase]['change_less_parent_ms']:+.2f} ms", flush=True)
    out = ROOT / "chiprun_out" / "paired_steps.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
