#!/usr/bin/env python3
"""Time builds of the decode-attention and row-norm kernels
(``decode_attention.cu``, ``rms_norm.cu``) against each other on one CUDA
card.

    python3 tools/dattn_ab.py [--tree NAME=DIR ...] [--ablate]
                              [--only NAME,...] [--turns N] [--no-time]

from the repository root, on a machine with one CUDA card and ``nvcc``.
Each variant is the two files of one tree, linked with this tree's other
sources' objects into its own library under
``paddle_tpu_torch/kernels/_build/ab/``: ``change`` is this tree's;
``--tree NAME=DIR`` adds DIR's (another checkout's, e.g. the parent commit
unpacked by ``git archive`` into the git-ignored ``archive_check/``; its
``decode_attention.cu`` must take the head stride ``sh``).
``--ablate`` adds this tree's ``decode_attention.cu`` with the choices of
``TUNINGS`` (64 rows a block; a V tile of half the rows; 64 registers),
checked and timed like a tree, and with parts cut (``ABLATIONS``: the
scores and products, leaving copies and barriers; those and the
barriers; the exchange of the 512-row max; that and the fold's
barrier), which compute something else and are timed unchecked.
``--only`` keeps the named variants.  All ``nvcc`` processes start
together.

The script prints ptxas' registers, stack frame and spills of each
variant's two kernels and, where the library has one
(``pt_decode_attention_plan``), its launch plan at the timed shape
(cluster size, rows a block, stages, shared memory, blocks an SM and
resident clusters), checks each variant on ``DATTN_CASES`` and
``NORM_CASES`` (bf16 and fp32 against the plain versions by
``chip_smoke.py``'s rule, 2e-2 / 1e-4; each call twice, bit-identical, one
launch each; no length-0 row, which the kernels before the cluster design
wrote as zeros), then, unless ``--no-time``, times the variants in turns
(a, b, ..., b, a; ``--turns N`` runs that order N times): decode attention
at the generation step's shape (q [8, 32, 128], cache [8, 256, 32, 128]
bf16, every length 256) warm (one cache, back to back) and cold (each
call on the next of 4 caches, 134 MB), and ``rms_norm_rows`` at [4, 4096]
and [256, 4096] bf16, each beside its bound and the library call
(``scaled_dot_product_attention`` warm and cold, ``F.rms_norm``).

Writes ``chiprun_out/dattn_ab.json``.  Imports nothing of the JAX package.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

FILES = ("decode_attention.cu", "rms_norm.cu")
ITERS = 48                       # timed calls a variant, shape and turn
COLD = 4                         # caches in rotation for the cold timing
# (B, Hq, Hkv, D, T, lengths): MHA at D 128, GQA at D 64, two and four
# 512-row blocks, G 8, length 1
DATTN_CASES = [(8, 32, 32, 128, 256, (1, 37, 74, 110, 147, 183, 220, 256)),
               (4, 32, 8, 64, 300, (300, 1, 99, 200)),
               (2, 16, 16, 128, 1000, (1000, 613)),
               (2, 8, 8, 128, 2048, (2048, 1500)),
               (2, 32, 4, 64, 700, (700, 3)),
               (3, 8, 8, 128, 64, (1, 1, 1))]
NORM_CASES = [(1, 4096), (4, 4096), (256, 4096), (4, 1001), (3, 11008)]
# decode_attention.cu with one choice changed or one part cut: (old, new)
# text pairs
TUNINGS = {"rows_64": [("ROWS = 128,", "ROWS = 64,")],
           # a V tile of half the rows (the rest into K's once scored)
           "v_half": [("  const int kr = rows16(c), vh = VT;",
                       "  const int kr = rows16(c), vh = rows16(kr / 2);"),
                      ("(rows16(c) + VT) * D", "(rows16(c) + rows16(rows16(c) / 2)) * D")],
           # bf16 held to 64 registers (8 blocks an SM)
           "regs_64": [("__global__ void __launch_bounds__(NT)\n",
                        "__global__ void __launch_bounds__(NT, 8)\n")]}
_EXCHANGE = [("""    cluster_arrive();
    if (more)""", """    if (more)"""),
             ("""    __syncthreads();
    cluster_wait();
""", """    __syncthreads();
"""),
             ("""          lane < S * NW
              ? ld_peer_f32(peer_u32(
                    pmax + ((j & 1) * NW + lane % NW) * GM + g, lane / NW))
              : NEG_INF;""",
              "lane < NW ? pmax[((j & 1) * NW + lane) * GM + g] : NEG_INF;")]
_FOLD = [("st_peer_f32(peer_u32(recv + r * RS + i, 0), s);",
          "recv[r * RS + i] = s;"),
         ("st_peer_f32(peer_u32(recv + r * RS + G * D + tid, 0), s);",
          "recv[r * RS + G * D + tid] = s;"),
         ("""  cluster_arrive();
  cluster_wait();
  if (r != 0) return;
""", "  __syncthreads();\n")]
ABLATIONS = {
    # copies and barriers only: no row is scored or summed
    "copies_only": [("    const int n = n_of(j);\n",
                     "    const int n = 0 * n_of(j), nc = n_of(j);\n"),
                    ("const int nn = max(n, 0);", "const int nn = max(nc, 0);")],
    # copies only, no barrier: no row is scored or summed, no cluster
    # barrier, no peer access
    "copies_no_sync": [("    const int n = n_of(j);\n",
                        "    const int n = 0 * n_of(j), nc = n_of(j);\n"),
                       ("const int nn = max(n, 0);",
                        "const int nn = max(nc, 0);")]
    + _EXCHANGE + _FOLD,
    # each block's own max: no cluster barrier or peer read in the loop
    "no_exchange": _EXCHANGE,
    # nor the fold: each block sums its own slot; no cluster barrier and
    # no peer access at all
    "no_cluster": _EXCHANGE + _FOLD}


def _ptxas(text):
    """{kernel: {regs, stack, spill_st, spill_ld}} from ptxas -v output."""
    rows, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rows.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_st=int(m.group(2)),
                spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.setdefault(name, {})["regs"] = int(m.group(1))
    try:
        dem = subprocess.run(["cu++filt"], input="\n".join(rows),
                             capture_output=True, text=True, check=True)
        names = dem.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = list(rows)
    return dict(zip(names, rows.values()))


def _edited(text, cuts):
    """``text`` with ``cuts`` applied (each old text occurs once)."""
    for old, new in cuts:
        if text.count(old) != 1:
            raise ValueError(f"variant text not found once: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(trees):
    """{name: (ctypes library, ptxas table)} for ``trees`` {name: csrc
    directory}."""
    from paddle_tpu_torch.kernels import build
    nvcc = build._nvcc()
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = build._sources()
    others = [f for f in cu if f.name not in FILES]
    cmds = [[nvcc, *build.NVCC_FLAGS, "-c", str(f), "-o",
             str(out_dir / (f.stem + ".o"))] for f in others]
    objs = {}
    for name, csrc in trees.items():
        objs[name] = []
        for f in FILES:
            o = out_dir / f"{Path(f).stem}_{name}.o"
            objs[name].append(o)
            cmds.append([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC),
                         "-Xptxas", "-v", "-c", str(csrc / f), "-o", str(o)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode:
            raise build.KernelBuildError(f"$ {' '.join(c)}\n{log}")
    libs = {}
    for i, name in enumerate(trees):
        so = out_dir / f"lib_dattn_{name}.so"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared",
                        *(str(out_dir / (f.stem + ".o")) for f in others),
                        *map(str, objs[name]), "-o", str(so)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        build._bind(lib)
        first = len(others) + len(FILES) * i
        libs[name] = (lib, _ptxas("\n".join(logs[first:first + len(FILES)])))
    return libs


PLAN_KEYS = ("splits", "rows_a_block", "stages", "smem_bytes",
             "blocks_per_sm", "resident_clusters")


def plan(lib, B, Hq, Hkv, D, T):
    """The library's launch plan of one bf16 call on a ``[B, T, Hkv, D]``
    cache, or None where it has no ``pt_decode_attention_plan`` (a tree
    before it)."""
    from paddle_tpu_torch.kernels import build
    try:
        fn = lib.pt_decode_attention_plan
    except AttributeError:
        return None
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_longlong,
                                        ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(PLAN_KEYS))()
    build.check(fn(build.PT_BF16, B, Hq, Hkv, D, T, D, out),
                "pt_decode_attention_plan")
    return dict(zip(PLAN_KEYS, out))


def _once(name, fn):
    """``fn()`` twice: one launch of ``name`` each, bit-identical."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    outs = []
    for _ in range(2):
        layer.reset_counts()
        outs.append(fn())
        torch.cuda.synchronize()
        got = {k: v for k, v in layer.launch_counts().items() if v}
        if got != {name: 1}:
            raise cs.SmokeFailure(f"{name}: launches {got}")
    if not torch.equal(outs[0], outs[1]):
        raise cs.SmokeFailure(f"{name}: two calls differ")
    return outs[0]


def check_variant(variant, gen):
    """Every case in bf16 and fp32; raises on the first miss.  Returns
    the largest |kernel - plain| of each kernel in bf16."""
    import torch
    from paddle_tpu_torch.ops import decode_attention as tda
    from paddle_tpu_torch.ops.cuda import kernels as K
    worst = {"decode_attention": 0.0, "rms_norm_rows": 0.0}
    for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for B, Hq, Hkv, D, T, lengths in DATTN_CASES:
            q = torch.randn(B, Hq, D, device="cuda", generator=gen).to(dt)
            k, v = (torch.randn(B, T, Hkv, D, device="cuda",
                                generator=gen).to(dt) for _ in range(2))
            lt = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            got = _once("decode_attention",
                        lambda: tda.decode_attention(q, k, v, lt))
            label = f"{variant} decode_attention {B}x{Hq}/{Hkv}x{D} T {T} {dtn}"
            plain = tda.decode_attention_ref(q, k, v, lt)
            if dt == torch.float32:
                e = cs.check_close(label, got, plain, cs.TOL[dtn])
            else:
                e = cs.check_layer_out(label, got, plain, tda.decode_attention_ref(
                    q.float(), k.float(), v.float(), lt), cs.TOL[dtn])
                worst["decode_attention"] = max(worst["decode_attention"], e)
        for M, H in NORM_CASES:
            x = torch.randn(M, H, device="cuda", generator=gen).to(dt)
            w = (1 + 0.1 * torch.randn(H, device="cuda", generator=gen)).to(dt)
            got = _once("rms_norm_rows", lambda: K.rms_norm_rows_cuda(
                x, w, 1e-5))
            e = cs.check_close(f"{variant} rms_norm_rows [{M}, {H}] {dtn}",
                               got, K.rms_norm_rows_ref(x, w, 1e-5),
                               cs.TOL[dtn])
            if dt == torch.bfloat16:
                worst["rms_norm_rows"] = max(worst["rms_norm_rows"], e)
    cs.info(f"{variant}: every case correct, bit-identical twice, one launch "
            f"each; max |kernel - plain| bf16 {worst}")
    return worst


def time_all(libs, order, gen, report):
    """Device ms a launch of each timed shape, the variants in ``order``;
    the library calls once a turn."""
    import torch
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.ops import decode_attention as tda
    from paddle_tpu_torch.ops.cuda import kernels as K
    bf = torch.bfloat16
    B, Hq, Hkv, D, T = 8, 32, 32, 128, 256
    q = torch.randn(B, Hq, D, device="cuda", generator=gen).to(bf)
    kvs = [tuple(torch.randn(B, T, Hkv, D, device="cuda",
                             generator=gen).to(bf) for _ in range(2))
           for _ in range(COLD)]
    lt = torch.full((B,), T, dtype=torch.int32, device="cuda")
    mask = (torch.arange(T, device="cuda")[None, :] < lt[:, None])[
        :, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    turn = [0]

    def cold(fn):
        i = turn[0] = (turn[0] + 1) % COLD
        return fn(*kvs[i])

    def kern(kk, vv):
        return tda.decode_attention(q, kk, vv, lt)

    def lib(kk, vv):
        return sdpa(q[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2),
                    attn_mask=mask)
    norms = {M: (torch.randn(M, 4096, device="cuda", generator=gen).to(bf),
                 (1 + 0.1 * torch.randn(4096, device="cuda",
                                        generator=gen)).to(bf))
             for M in (4, 256)}
    shapes = {
        "decode_attention warm": (lambda: kern(*kvs[0]), lambda: lib(
            *kvs[0]), cs.dattn_bytes_ops(B, Hq, Hkv, D, [T] * B, 2)),
        "decode_attention cold": (lambda: cold(kern), lambda: cold(lib),
                                  cs.dattn_bytes_ops(B, Hq, Hkv, D, [T] * B,
                                                     2)),
        **{f"rms_norm_rows [{M}, 4096]": (
            lambda x=x, w=w: K.rms_norm_rows_cuda(x, w, 1e-5),
            lambda x=x, w=w: torch.nn.functional.rms_norm(x, (4096,), w,
                                                          1e-5),
            ((2 * M * 4096 + 4096) * 2, 4 * M * 4096))
           for M, (x, w) in norms.items()}}
    for key, (fn, lib_fn, (nbytes, ops)) in shapes.items():
        times = {name: [] for name in libs}
        lib_times = []
        for i, name in enumerate(order):
            build._lib = libs[name][0]
            ms, call_ms = cs.time_ms(fn, ITERS, per_launch=True)
            times[name].append(call_ms if ms is None else ms)
            if i % len(libs) == 0:
                lib_times.append(cs.time_ms(lib_fn, ITERS)[0])
        bms, bby = cs.bound_ms(nbytes, ops)
        lib_mean = sum(lib_times) / len(lib_times)
        report["library"][key] = lib_times
        for name, ts in times.items():
            mean = sum(ts) / len(ts)
            report["variants"][name][key] = dict(
                ms=ts, mean_ms=mean, bound_ms=bms, bound_by=bby,
                library_ms=lib_times, of_bound=bms / mean,
                x_library=mean / lib_mean)
            cs.info(f"{key} {name}: {ts} ms (mean {mean:.6f}), bound "
                    f"{bms:.6f} ({bby}, {100 * bms / mean:.1f} %), library "
                    f"{lib_times} ({mean / lib_mean:.3f}x)")
    del kvs
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--no-time", action="store_true")
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
    for name, cuts in ({**TUNINGS, **ABLATIONS}.items() if args.ablate
                       else ()):
        d = trees[name] = build.BUILD_DIR / "ab" / f"src_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / FILES[0]).write_text(_edited(
            (build.CSRC / FILES[0]).read_text(), cuts))
        (d / FILES[1]).write_text((build.CSRC / FILES[1]).read_text())
    if args.only:
        keep = args.only.split(",")
        trees = {k: v for k, v in trees.items() if k in keep}
    libs = build_variants(trees)
    report = {"card": card, "variants": {}, "library": {}}
    for name, (lib, table) in libs.items():
        p = plan(lib, 8, 32, 32, 128, 256)
        report["variants"][name] = {"ptxas": table, "plan": p}
        cs.info(f"plan {name} (q [8, 32, 128], T 256): {p}")
        for k, v in table.items():
            cs.info(f"ptxas {name}: {k}: {v}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    for name, (lib, _) in list(libs.items()):
        if name in ABLATIONS:
            continue
        build._lib = lib
        try:
            report["variants"][name]["max_abs_err"] = check_variant(name,
                                                                    gen)
        except (cs.SmokeFailure, RuntimeError, ValueError) as e:
            cs.info(f"{name}: FAILED its checks, not timed: {e}")
            report["variants"][name]["failed"] = str(e)
            del libs[name]
    if not args.no_time:
        order = (list(libs) + list(reversed(libs))) * args.turns
        time_all(libs, order, gen, report)
    out = ROOT / "chiprun_out" / "dattn_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
