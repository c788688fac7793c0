#!/usr/bin/env python3
"""Time the serving chain's layer calls (``decode_block`` /
``prefill_block``) of several builds of the kernel library against each
other on one CUDA card, in turns.

    python3 tools/chain_ab.py [--tree NAME=DIR ...] [--no-pdl]
                              [--only NAME,...] [--chains NAME,...]
                              [--turns N] [--calls N]

from the repository root, on a machine with one CUDA card and ``nvcc``.
Each variant is the whole ``csrc/`` of one tree built into its own
library under ``paddle_tpu_torch/kernels/_build/ab/`` (the layer chain
spans five of its files): ``change`` is this tree's; ``--tree NAME=DIR``
adds DIR's (another checkout's, e.g. the parent commit unpacked by ``git
archive`` into the git-ignored ``archive_check/``); ``--no-pdl`` adds
this tree with ``layer.cu``'s ``GPT_NORM_PDL`` off (the GPT layer's
LayerNorms and the products after them in plain stream order).  Every
variant runs this tree's Python wrappers, so the trees must share
``LayerArgs``.  ``--only`` keeps the named variants.  All ``nvcc``
processes start together.

The script prints ptxas' registers, stack frame and spills of every
kernel of the chain's files (``CHAIN_FILES``) of each variant, then holds
each variant's GPT-125M layer (bf16, and int8 weights over int8 pools)
to ``chip_smoke.py``'s race check at decode and at a Ts 256 prefill
chunk: ``RACE_CALLS`` calls over two inputs in turns, queued back to
back, each bit-identical to the first call on its input and that one
within tolerance of the plain chain.  Then it times the chains of
``CHAINS`` (``--chains`` keeps some) in turns (a, b, ..., b, a;
``--turns N`` runs that order N times): GPT-125M and llama_7b, bf16 and
int8 weights over int8 pools, decode at B 4 (lengths 1000/37/0/517) and
a Ts 256 prefill chunk after 300 positions (200 valid rows); for each
call the device-paced ms (``chip_smoke.paced_ms``: ``--calls`` calls
queued behind a sleep, CUDA events around them, so the gaps between
kernels count and the host's enqueue does not) and the sum of the
chain's kernel times from the profiler (``chip_smoke.chain_ms``; under a
programmatic dependency a kernel's recorded time includes its wait).

Writes ``chiprun_out/chain_ab.json``.  Imports nothing of the JAX
package.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from dattn_ab import _edited, _ptxas  # noqa: E402

# the files whose kernels the layer chain runs (ptxas is printed for them)
CHAIN_FILES = ("layer.cu", "rms_norm.cu", "gemm.cu", "quant_linear.cu",
               "rope_kv.cu", "paged_attention.cu")
# the GPT chain in plain stream order (--no-pdl)
NO_PDL = [("constexpr bool GPT_NORM_PDL = true;",
           "constexpr bool GPT_NORM_PDL = false;")]
# (family, quantized) chains, each timed at decode and at Ts 256
CHAINS = {"gpt": ("gpt", False), "gpt_q8": ("gpt", True),
          "llama": ("llama", False), "llama_q8": ("llama", True)}
CALLS = 40                      # calls a paced timing
PROFILED = 20                   # calls a profiled pass (chain_ms)


def build_variants(trees):
    """{name: (ctypes library, ptxas table of CHAIN_FILES' kernels)} for
    ``trees`` {name: csrc directory}, each tree's every source."""
    from paddle_tpu_torch.kernels import build
    nvcc = build._nvcc()
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, objs = [], {}
    for name, csrc in trees.items():
        srcs = sorted(Path(csrc).glob("*.cu"))
        objs[name] = [(f.name, out_dir / f"chain_{name}_{f.stem}.o")
                      for f in srcs]
        cmds += [[nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(f),
                  "-o", str(o)] for f, (_, o) in zip(srcs, objs[name])]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode:
            raise build.KernelBuildError(f"$ {' '.join(c)}\n{log}")
    libs, i = {}, 0
    for name in trees:
        so = out_dir / f"lib_chain_{name}.so"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared",
                        *(str(o) for _, o in objs[name]), "-o", str(so)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        build._bind(lib)
        text = "\n".join(log for (f, _), log in
                         zip(objs[name], logs[i:i + len(objs[name])])
                         if f in CHAIN_FILES)
        i += len(objs[name])
        libs[name] = (lib, _ptxas(text))
    return libs


def layer_setup(fam, quant, gen):
    """One layer call's inputs: {"spec", "lp" (the layer, exported to int8
    codes when ``quant``), "pk" / "pv" (bf16 pools, int8 when ``quant``),
    "bt", "lengths", "bt_row", "NB", "x" [4, H], "xp" [1, 256, H], "blk",
    "off", "cos" / "sin" (decode), "cp" / "sp" (the chunk), "cfg"}."""
    import torch
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.models.llama import _rope_cos_sin, llama_7b
    from paddle_tpu_torch.ops import decode_block as db
    bf, dev = torch.bfloat16, "cuda"
    if fam == "gpt":
        cfg = tgpt.gpt_125m(dtype="bfloat16")
        shapes = tgpt.block_shapes(cfg)
        BS, Hkv = cs.GPT_SERVE_BS, cfg.num_heads
    else:
        cfg = llama_7b(dtype="bfloat16")
        shapes = None
        BS, Hkv = 16, cfg.kv_heads
    NB, MB = 256, cfg.max_position_embeddings // 16
    D, H = cfg.head_dim, cfg.hidden_size
    width = "int8" if quant else None
    spec = db.decode_block_spec(cfg, BS, width, -1) if quant else \
        db.decode_block_spec(cfg, BS)
    lp32 = cs.make_layer(cfg, gen, torch.float32, dev, shapes)
    lp = cs.export_layer({k: v.to(bf) for k, v in lp32.items()}, width, -1)
    pools = [torch.randn(NB, BS, Hkv, D, device=dev, generator=gen)
             for _ in range(2)]
    pk, pv = ((cs.q8_pool(p, bf) if quant else p.to(bf)) for p in pools)
    perm = torch.randperm(NB, device=dev, generator=gen).to(torch.int32)
    lengths, bt, bt_row = cs.serving_tables(perm, BS, MB)
    pos = 300 + torch.arange(256, device=dev)
    blk = bt_row.clamp(min=0)[pos // BS]
    blk[200:] = NB
    out = dict(cfg=cfg, spec=spec, lp=lp, pk=pk, pv=pv, bt=bt,
               lengths=lengths, bt_row=bt_row, NB=NB,
               x=torch.randn(4, H, device=dev, generator=gen).to(bf),
               xp=torch.randn(1, 256, H, device=dev, generator=gen).to(bf),
               blk=blk.to(torch.int32), off=(pos % BS).to(torch.int32),
               cos=None, sin=None, cp=None, sp=None)
    if fam == "llama":
        cos_t, sin_t = _rope_cos_sin(cfg.max_position_embeddings, D,
                                     cfg.rope_theta, torch.float32,
                                     device=dev)
        out.update(cos=cos_t[lengths.long()].to(bf).contiguous(),
                   sin=sin_t[lengths.long()].to(bf).contiguous(),
                   cp=cos_t[pos].to(bf).contiguous(),
                   sp=sin_t[pos].to(bf).contiguous())
    return out


def chain_calls(L):
    """{"decode": fn, "prefill Ts 256": fn} of one layer setup."""
    from paddle_tpu_torch.ops import decode_block as db
    return {
        "decode": lambda: db.decode_block(
            L["x"], L["lp"], L["pk"], L["pv"], L["bt"], L["lengths"],
            L["cos"], L["sin"], spec=L["spec"]),
        "prefill Ts 256": lambda: db.prefill_block(
            L["xp"], L["lp"], L["pk"], L["pv"], L["blk"], L["off"],
            L["bt_row"], L["cp"], L["sp"], spec=L["spec"], start=300)}


def chain_sum_ms(fam, quant, label, by):
    """The chain's kernels' profiled ms a call (chip_smoke.chain_ms /
    quant_chain_ms with the chain's kernel names)."""
    norm = "layer_norm_rows" if fam == "gpt" else "rms_norm_rows"
    gemms = cs.GPT_GEMMS if fam == "gpt" else 6
    if quant:
        return cs.quant_chain_ms(by, "wo_dec" if label == "decode"
                                 else "wo_wgmma", norm,
                                 gemms if fam == "gpt" else 7)
    gemm = ("gemm_xw_small_m_tma" if label == "decode"
            else "gemm_xw_tiled_wg")
    per = {norm: 2, gemm: gemms, "rope_kv_write": 1, "paged_attention": 1}
    return cs.chain_ms(by, gemm, per)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--no-pdl", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--chains", default=",".join(CHAINS))
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--calls", type=int, default=CALLS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import build
    card = cs.phase_device()
    trees = {}
    for item in args.tree:
        name, _, tree = item.partition("=")
        trees[name] = Path(tree).resolve() / "paddle_tpu_torch/kernels/csrc"
    trees["change"] = build.CSRC
    if args.no_pdl:
        d = trees["no_pdl"] = build.BUILD_DIR / "ab" / "src_no_pdl"
        d.mkdir(parents=True, exist_ok=True)
        for f in list(build.CSRC.glob("*.cu")) + list(
                build.CSRC.glob("*.cuh")):
            text = f.read_text()
            (d / f.name).write_text(_edited(text, NO_PDL)
                                    if f.name == "layer.cu" else text)
    if args.only:
        keep = args.only.split(",")
        trees = {k: v for k, v in trees.items() if k in keep}
    report = {"card": card, "variants": {}, "chains": {}}
    libs = build_variants(trees)
    for name, (_, table) in libs.items():
        report["variants"][name] = {"ptxas": table}
        for k, v in table.items():
            cs.info(f"ptxas {name}: {k}: {v}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 28)
    setups = {key: layer_setup(*CHAINS[key], gen)
              for key in args.chains.split(",")}
    for name, (lib, _) in list(libs.items()):
        build._lib = lib
        try:
            for key in ("gpt", "gpt_q8"):
                if key in setups:
                    L = setups[key]
                    cs.gpt_race_checks(f"{name} {key}", L["spec"], L["lp"],
                                       L["pk"], L["pv"], L["bt"],
                                       L["lengths"], L["bt_row"], L["NB"],
                                       gen, cs.TOL["bfloat16"])
        except (cs.SmokeFailure, RuntimeError, ValueError) as e:
            cs.info(f"{name}: FAILED the race check, not timed: {e}")
            report["variants"][name]["failed"] = str(e)
            del libs[name]
    order = (list(libs) + list(reversed(libs))) * args.turns
    for key, L in setups.items():
        fam, quant = CHAINS[key]
        for label, fn in chain_calls(L).items():
            row = {name: {"paced_ms": [], "sum_ms": []} for name in libs}
            for name in order:
                build._lib = libs[name][0]
                row[name]["paced_ms"].append(cs.paced_ms(fn, args.calls))
                by = {}
                cs.time_ms(fn, PROFILED, by)
                row[name]["sum_ms"].append(chain_sum_ms(fam, quant, label,
                                                        by))
            for name, r in row.items():
                r["paced_mean_ms"] = sum(r["paced_ms"]) / len(r["paced_ms"])
                r["sum_mean_ms"] = sum(r["sum_ms"]) / len(r["sum_ms"])
                cs.info(f"chain {key} {label} {name}: device-paced "
                        f"{r['paced_ms']} ms (mean {r['paced_mean_ms']:.6f})"
                        f", kernels' sum {r['sum_ms']} (mean "
                        f"{r['sum_mean_ms']:.6f})")
            report["chains"][f"{key} {label}"] = row
    out = ROOT / "chiprun_out" / "chain_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
