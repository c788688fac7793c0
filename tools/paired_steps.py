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
(GPT and Llama), ``encoder`` (the default: those four), ``head_host``:
the host time of one ``linear_ce_fwd_cuda`` call and of one
``linear_ce_bwd_cuda`` call (enqueue only, the card idle before each; the
median of 30) on eager GPT-125M's bf16 head (T 8192, H 768, V 32768,
slabs of 2048), ``engine``: the serving engine's main path as this
tree's ``chip_smoke.py`` engine phase drives it (llama_7b bf16, 8
requests, then 8 profiled decode steps at B 4), run on each checkout's
package: decode step wall and device-busy ms, decode tokens/s, bucketed
prefill seconds and the mean time to first token, and ``layer_host``:
one bf16 ``decode_block`` call at ``chip_smoke.py``'s kernels-phase
inputs (llama_7b layer, B 4, lengths 1000/37/0/517): device ms of the
chain (profiler), ms a call of 20 back to back (CUDA events) and the host
time of one call (the median of 30, enqueue only), and ``wo_layer``: the
seven weight-only layer GEMMs of one llama_7b layer with their epilogues
(``chip_smoke.py``'s ``QUANT_MATMULS``, int8 and int4 per channel) at x
rows M 4 and 256: their device ms (profiler).  Prints, per phase,
each run's step ms (the encoder: forward ms; head_host, layer_host: host
ms; the engine's other rows their value) and the flash and linear-CE
kernels' device ms in its profiled step, then the change's mean less the
parent's.
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
import importlib.util
import json
import statistics
import sys
import time
import torch
import chip_smoke as cs
# this tree's chip_smoke.py, whose helpers run on the checkout's package
_spec = importlib.util.spec_from_file_location("smoke_root", sys.argv[2])
root = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(root)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
phases = sys.argv[1].split(",")
cs.phase_device()
cs.phase_build()
# the profiler's first session in a process sets up its tracing (~1 s a
# step of a phase's profiled window): take it here, before any phase
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CUDA]):
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
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
if "engine" in phases:
    torch.cuda.empty_cache()
    from paddle_tpu_torch.models.llama import llama_7b
    s = root.phase_engine(llama_7b(dtype="bfloat16"))[1]
    out["engine decode step wall"] = {"step_ms": s["decode_step_ms"]}
    out["engine decode step busy"] = {"step_ms": s["decode_busy_ms"]}
    out["engine decode tok/s"] = {"value": s["decode_tokens_per_s"]}
    out["engine prefill s"] = {"value": s["prefill_s"]}
    out["engine ttft mean s"] = {"value": s["ttft_mean_s"]}
    torch.cuda.empty_cache()
if "layer_host" in phases:
    from paddle_tpu_torch.models.llama import _rope_cos_sin, llama_7b
    from paddle_tpu_torch.ops import decode_block as db
    cfg = llama_7b(dtype="bfloat16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    lp = root.make_layer(cfg, gen, torch.bfloat16, "cuda")
    BS, MB = 16, cfg.max_position_embeddings // 16
    pk, pv = (torch.randn(256, BS, cfg.kv_heads, cfg.head_dim, device="cuda",
                          generator=gen).to(torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([1000, 37, 0, 517], dtype=torch.int32,
                           device="cuda")
    bt = torch.full((4, MB), -1, dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(lengths.tolist()):
        if b != 2:
            need = -(-(n + 1) // BS)
            bt[b, :need] = torch.arange(used, used + need, device="cuda")
            used += need
    cos_t, sin_t = _rope_cos_sin(cfg.max_position_embeddings, cfg.head_dim,
                                 cfg.rope_theta, torch.float32, device="cuda")
    cos, sin = (t[lengths.long()].to(torch.bfloat16).contiguous()
                for t in (cos_t, sin_t))
    x = torch.randn(4, cfg.hidden_size, device="cuda",
                    generator=gen).to(torch.bfloat16)
    spec = db.decode_block_spec(cfg, BS)

    def one():
        db.decode_block(x, lp, pk, pv, bt, lengths, cos, sin, spec=spec)
    by = {}
    _, call = cs.time_ms(one, 20, by)
    dev = sum(m * n for m, n in by.values())
    out["layer_host decode_block"] = {
        "host_ms": root.host_ms(one), "call_ms": call, "device_ms": dev}
if "wo_layer" in phases:
    from paddle_tpu_torch.models.llama import llama_7b
    from paddle_tpu_torch.ops.cuda import kernels as K
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    lp = root.make_layer(llama_7b(dtype="bfloat16"), gen, torch.float32,
                         "cuda")
    for width in ("int8", "int4"):
        ql = root.export_layer({k: v for k, v in lp.items()
                                if not k.startswith("ln")}, width, -1)
        for M in (4, 256):
            xs = {Kd: torch.randn(M, Kd, device="cuda", generator=gen).to(
                torch.bfloat16) for Kd in {lp[w].shape[0]
                                           for w, _ in root.QUANT_MATMULS}}
            ex = {(w, e): root.wo_epi_kw(e, M, lp[w].shape[1], gen, "cuda",
                                         torch.bfloat16)
                  for w, e in root.QUANT_MATMULS}

            def gemms():
                for w, e in root.QUANT_MATMULS:
                    K.wo_layer_cuda(xs[lp[w].shape[0]], ql[w + "__q"],
                                    ql[w + "__s"], width=width,
                                    **ex[(w, e)])
            by = {}
            cs.time_ms(gemms, 20, by)
            out[f"wo_layer {width} M {M}"] = {"value": sum(
                m * n for k, (m, n) in by.items() if "wo_" in k)}
print("PAIRED " + json.dumps(out, default=float), flush=True)
"""


GROUPS = ("flash kernels", "linear-CE kernels")


def run(tree, phases):
    """{phase: (step, forward or host ms or value, {group: device ms or
    None}, {the phase's other numbers})} of one run, the groups those of
    ``GROUPS``."""
    p = subprocess.run([sys.executable, "-c", CHILD, phases,
                        str(ROOT / "chip_smoke.py")], cwd=tree, text=True,
                       capture_output=True)
    sys.stderr.write(p.stderr[-4000:])
    line = [x for x in p.stdout.splitlines() if x.startswith("PAIRED ")]
    if p.returncode or not line:
        print(p.stdout[-8000:])
        raise SystemExit(f"{tree}: the phases failed (exit {p.returncode})")
    out = {}
    for phase, s in json.loads(line[0][len("PAIRED "):]).items():
        ms = s.get("step_ms", s.get("forward_ms", s.get("host_ms",
                                                         s.get("value"))))
        by = s.get("device_ms_by_group", {})
        other = {k: v for k, v in s.items() if isinstance(v, (int, float))}
        if by and "step_ms" in s:
            # the profiled step's device time over the unprofiled step's
            # wall time (the profiler slows a host-led step's wall)
            other["busy_ms"] = sum(by.values())
            other["busy_share_of_step"] = (other["busy_ms"]
                                           / s["step_ms"])
        out[phase] = (ms, {g: by.get(g) for g in GROUPS}, other)
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
        mean = {name: sum(r[0] for r in v) / len(v)
                for name, v in row.items()}
        report[phase] = dict(row, change_less_parent_ms=mean["change"]
                             - mean["parent"])
        groups = "; ".join(
            f"{g} ms parent {[v[1][g] for v in row['parent']]}, change "
            f"{[v[1][g] for v in row['change']]}" for g in GROUPS)
        print(f"{phase}: parent {[v[0] for v in row['parent']]}, change "
              f"{[v[0] for v in row['change']]}; {groups}; change - "
              f"parent {report[phase]['change_less_parent_ms']:+.4f}; other "
              f"numbers parent {[v[2] for v in row['parent']]}, change "
              f"{[v[2] for v in row['change']]}", flush=True)
    out = ROOT / "chiprun_out" / "paired_steps.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
