"""What the CUDA wrappers share: the launch counts, the argument checks and
the ``LayerArgs`` they fill.

One layer launches its chain from one C entry point.  A Llama layer:
``rms_norm_rows``, ``gemm_xw`` (q, k, v), ``rope_kv_write``,
``paged_attention``, ``gemm_xw`` (o + residual), ``rms_norm_rows``,
``gemm_xw`` (gate/up SwiGLU), ``gemm_xw`` (down + residual).  A GPT layer:
``layer_norm_rows``, ``gemm_xw`` (qkv + bias, stored split into q / k / v),
``rope_kv_write`` (no rotation: k / v into the pool), ``paged_attention``,
``gemm_xw`` (proj + bias + residual), ``layer_norm_rows``, ``gemm_xw``
(fc1 + bias, GELU), ``gemm_xw`` (fc2 + bias + residual).  A weight-only
quantized layer of either kind runs its matmuls on ``wo_layer_*`` with the
same epilogues (a Llama layer's seven: gate, then up with the SwiGLU in
its epilogue; a GPT layer's four), and an int8 KV pool takes
``rope_kv_write_q8`` (rotated or not) and ``paged_attention_q8``.  The
launches are counted in the kernel library itself, where each kernel is
launched:
:func:`launch_counts` reads those counters and :func:`reset_counts` sets
them to zero.  A captured CUDA graph (``aot/graphs.py``) launches nothing
through the library when it replays, and its capture counts launches that
did not run: :data:`TALLY` holds that difference, and both functions read
and zero it with the library's counters.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ...kernels import build

__all__ = ["KERNELS", "LaunchTally", "TALLY", "raw_counts",
           "launch_counts", "reset_counts", "dtype_code", "check_tensor",
           "layer_args", "layout", "stream_handle", "wo_layout", "WEIGHTS",
           "MATMULS"]

#: the library's launch counters, in the order of the ``CNT_*`` enum in
#: ``kernels/csrc/common.cuh``: the two layer entry points, then one per
#: ``__global__`` kernel (the GEMM's three kernels apart), then the three
#: flash-attention kernels and the five linear-CE head kernels of the
#: training path (the fifth splits fp32 x into bf16 halves), then the
#: generation path's decode attention and its weight-only matmuls (int8
#: and int4 apart, each in its decode and its prefill regime, and the fp32
#: lane's kernel for both widths), then the eager path's three row
#: normalisations and SwiGLU, then the incubate fused API's RoPE,
#: softmax-mask, bias-activation and dropout-add, then the quantized serving
#: chain's variants: the weight-only layer GEMMs (int8 / int4, decode and
#: prefill regimes, fp32), the RoPE / KV write into an int8 pool and the
#: attention over one, then the GPT layer's LayerNorm
KERNELS = ("decode_block", "prefill_block", "rms_norm_rows",
           "gemm_xw_small_m", "gemm_xw_tiled", "gemm_xw_f32",
           "rope_kv_write", "paged_attention", "flash_fwd", "flash_bwd_dq",
           "flash_bwd_dkv", "linear_ce_fwd", "linear_ce_dz", "linear_ce_dx",
           "linear_ce_dw", "linear_ce_split_x", "decode_attention",
           "wo_int8_small_m", "wo_int8_tiled", "wo_int4_small_m",
           "wo_int4_tiled", "wo_f32",
           "rms_norm_fwd", "layer_norm_fwd", "bias_residual_ln_fwd",
           "swiglu_fwd", "rope_fwd", "softmax_mask_fwd", "bias_act_fwd",
           "dropout_add_fwd", "wo_layer_int8_small_m", "wo_layer_int8_tiled",
           "wo_layer_int4_small_m", "wo_layer_int4_tiled", "wo_layer_f32",
           "rope_kv_write_q8", "paged_attention_q8", "layer_norm_rows")

#: a layer's weights by layout: norm gains (and LayerNorm biases), the
#: matmul weights ``[in, out]`` and their biases
WEIGHTS = {"llama": ("ln1_w", "q_w", "k_w", "v_w", "o_w", "ln2_w", "gate_w",
                     "up_w", "down_w"),
           "gpt": ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                   "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")}
MATMULS = {"llama": ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w",
                     "down_w"),
           "gpt": ("qkv_w", "proj_w", "fc1_w", "fc2_w")}
_INDEX = ("block_table", "lengths", "blk", "off")
#: LayerArgs.gs of per-channel scales
PER_CHANNEL_GS = 1 << 30


class LaunchTally:
    """The launches a graph replay makes and the library does not count.

    The library counts a launch when it returns ``cudaSuccess``, and a
    launch under stream capture returns it without running: a capture adds
    its program's launches to the counters once, a replay adds nothing.
    :meth:`captured` takes the counters before and after a capture, keeps
    the difference as the program's launches a replay and subtracts it
    once; :meth:`replayed` adds it once per replay; :meth:`read` is the
    library's counts plus what the tally holds; :meth:`reset` zeroes it
    (with the library's counters)."""

    def __init__(self):
        self.adjust: Dict[str, int] = {}

    def captured(self, before: Dict[str, int],
                 after: Dict[str, int]) -> Dict[str, int]:
        delta = {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}
        for k, n in delta.items():
            self.adjust[k] = self.adjust.get(k, 0) - n
        return delta

    def replayed(self, delta: Dict[str, int]) -> None:
        for k, n in delta.items():
            self.adjust[k] = self.adjust.get(k, 0) + n

    def read(self, raw: Dict[str, int]) -> Dict[str, int]:
        return {k: n + self.adjust.get(k, 0) for k, n in raw.items()}

    def reset(self) -> None:
        self.adjust = {}


#: the process's tally, beside the library's process-wide counters
TALLY = LaunchTally()


def raw_counts() -> Dict[str, int]:
    """The library's own counters, by name (captures included, replays
    not)."""
    buf = (ctypes.c_longlong * len(KERNELS))()
    n = build.library().pt_launch_counts(buf, len(KERNELS))
    if n != len(KERNELS):
        raise RuntimeError(f"the kernel library keeps {n} launch counters, "
                           f"KERNELS names {len(KERNELS)}")
    return dict(zip(KERNELS, map(int, buf)))


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_counts`, by name, graph
    replays included and captures not."""
    return TALLY.read(raw_counts())


def reset_counts() -> None:
    build.library().pt_reset_launch_counts()
    TALLY.reset()


def dtype_code(dt: torch.dtype) -> int:
    if dt == torch.float32:
        return build.PT_F32
    if dt == torch.bfloat16:
        return build.PT_BF16
    raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dt}")


def check_tensor(t, name: str, shape, dtype, device) -> torch.Tensor:
    """Raise unless ``t`` is a contiguous, 16-byte aligned tensor of the
    given shape and dtype on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t


def stream_handle() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _pool_parts(pool_k, pool_v):
    """``(codes or values k, v, scales k, v)`` of the pools: the scales
    None for full-width pools.  Raises unless both are of one kind."""
    from ..paged_kv import is_quantized_pool
    if is_quantized_pool(pool_k) != is_quantized_pool(pool_v):
        raise ValueError("pool_k and pool_v must both be int8 "
                         "QuantizedKVPools or both full-width tensors")
    if is_quantized_pool(pool_k):
        return pool_k.data, pool_v.data, pool_k.scale, pool_v.scale
    return pool_k, pool_v, None, None


def wo_layout(K: int, N: int, width: str, group_size: int):
    """``(codes shape, scale shape, gs)`` of one weight-only layer GEMM
    the kernels take (``gs`` as LayerArgs / WoArgs carry it).  Raises on
    what the chain's kernels refuse: N off 16, x rows off 16 bytes, and
    grouped scales whose groups do not cover whole 64-row steps of the
    codes (the `post` rule's condition, ``quant_linear.cu`` ``mode_of``)."""
    rows = K // 2 if width == "int4" else K
    if N % 16 or K % 8 or (width == "int4" and (K % 2 or rows % 8)):
        raise ValueError(
            f"weight-only layer GEMM [{K}, {N}] {width}: the kernels take N "
            "a multiple of 16 and K a multiple of 8 (int4: K / 2 too)")
    if group_size == -1:
        return (rows, N), (N,), PER_CHANNEL_GS
    if width == "int4" and rows % group_size:
        raise ValueError(
            f"weight-only layer GEMM [{K}, {N}] int4: groups of "
            f"{group_size} rows must cover whole 64-row steps of each "
            f"nibble plane ({rows} rows)")
    return (rows, N), (-(-K // group_size), N), group_size


def layout(spec) -> str:
    """"llama" or "gpt": the layer the chain runs for ``spec``."""
    if spec.llama_layout:
        return "llama"
    if (spec.norm, spec.activation, spec.rope, spec.fused_qkv,
            spec.bias) == ("ln", "gelu", False, True, True):
        return "gpt"
    raise ValueError(f"the kernel chain runs the Llama or the GPT layer, "
                     f"not a mix of their variants: {spec}")


def layer_args(pool_k, pool_v, block_table, *, M: int, lengths=None,
               blk=None, off=None, start: int = 0, scale: float = 0.0,
               spec=None, x=None, lp=None, cos=None, sin=None, q=None,
               k=None, v=None, attn=None):
    """Check every tensor one launch reads or writes and fill its
    ``LayerArgs``; return ``(LayerArgs, tensors)``, where ``tensors``
    maps each field to its tensor (keep it alive until the launch is
    queued).

    A whole layer (``decode_block`` / ``prefill_block``) passes ``spec``,
    the ``[M, H]`` residual stream ``x`` and the layer's weights ``lp``
    (:data:`WEIGHTS` of its layout; with ``spec.weight_dtype``, the
    layout's :data:`MATMULS` as ``<name>__q`` int8 codes, ``[K, N]`` or
    int4 ``[K/2, N]``, and ``<name>__s`` fp32 scales, ``[N]`` or ``[G,
    N]``, the norm gains and biases in the model dtype);
    its scratch and its output (``tensors["out"]``) are allocated here (a
    GPT layer's q / k / v scratch as the three slabs of one ``[3, M, H]``
    buffer, which its qkv product's epilogue fills).  A single kernel
    passes its own ``q``/``k``/``v``/``attn`` instead.  ``cos`` / ``sin``
    ``[M, D]`` rotate q and k; without them (a layer without RoPE) the
    RoPE / KV write only stores k and v, as they are or as int8 codes.
    The pools are ``[NB, BS, Hkv, D]`` tensors in the model dtype or int8
    ``QuantizedKVPool``s (codes and ``[NB, BS, Hkv]`` fp32 scales).  Rows are decode slots when
    ``lengths`` is given (``block_table`` [M, MB]), else one prefill chunk
    (``block_table`` [MB])."""
    pk, pv, pks, pvs = _pool_parts(pool_k, pool_v)
    if not isinstance(pk, torch.Tensor) or pk.ndim != 4:
        raise ValueError("pool_k must be a [NB, BS, Hkv, D] tensor")
    kv_quant = pks is not None
    kind = layout(spec) if spec is not None else None
    rope = spec.rope if spec is not None else cos is not None
    if rope and (cos is None or sin is None):
        raise ValueError("a layer with RoPE needs its cos / sin rows")
    dev = pk.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernels need CUDA tensors, pool is on {dev}")
    lead = x if x is not None else q
    dt = lead.dtype if kv_quant else pk.dtype
    code = dtype_code(dt)
    NB, BS, Hkv, D = pk.shape
    if D not in (32, 64, 128):
        raise ValueError(f"head_dim {D} unsupported (32, 64 or 128)")
    MB = block_table.shape[-1]
    H = F = 0
    wq, gs = build.WQ_NONE, 0
    t = {"pool_k": pk, "pool_v": pv, "pool_ks": pks, "pool_vs": pvs,
         "block_table": block_table, "lengths": lengths, "blk": blk,
         "off": off, "cos": cos if rope else None,
         "sin": sin if rope else None, "q": q, "k": k, "v": v, "attn": attn}
    matmuls = ()
    shapes = {}
    if lp is not None:
        H, Hq = x.shape[-1], spec.num_heads
        F = _ffn_width(lp, kind)
        if (H, Hkv, D) != (spec.hidden, spec.kv_heads, spec.head_dim):
            raise ValueError(f"x hidden {H} and pool heads {Hkv} x {D} do "
                             f"not match the spec {spec}")
        for n in (H, Hq * D, Hkv * D, F):
            if n % 8:
                raise ValueError(f"GEMM widths must be multiples of 8, "
                                 f"got {n}")
        QD, KD = Hq * D, Hkv * D
        dims = {"q_w": (H, QD), "k_w": (H, KD), "v_w": (H, KD),
                "o_w": (QD, H), "gate_w": (H, F), "up_w": (H, F),
                "down_w": (F, H), "qkv_w": (H, 3 * QD), "proj_w": (QD, H),
                "fc1_w": (H, F), "fc2_w": (F, H)}
        matmuls = MATMULS[kind]
        t.update({n: lp[n] for n in WEIGHTS[kind] if n not in matmuls})
        shapes.update(ln1_b=(H,), ln2_b=(H,), qkv_b=(3 * QD,), proj_b=(H,),
                      fc1_b=(F,), fc2_b=(H,))
        if spec.weight_dtype is None:
            t.update({n: lp[n] for n in matmuls})
            shapes.update(dims)
        else:
            wq = build.WQ_INT4 if spec.weight_dtype == "int4" \
                else build.WQ_INT8
            for n in matmuls:
                cshape, sshape, gs = wo_layout(*dims[n], spec.weight_dtype,
                                               spec.group_size)
                t[n], t[n[:-1] + "s"] = lp[n + "__q"], lp[n + "__s"]
                shapes[n], shapes[n[:-1] + "s"] = cshape, sshape

        def empty(*shape):
            return torch.empty(shape, dtype=dt, device=dev)
        if spec.fused_qkv:
            qs, ks, vs = empty(3, M, QD)
        else:
            qs, ks, vs = empty(M, QD), empty(M, KD), empty(M, KD)
        t.update(x=x, y=empty(M, H), q=qs, k=ks, v=vs, attn=empty(M, QD),
                 x_mid=empty(M, H), hbuf=empty(M, F), out=empty(M, H))
    else:
        Hq = q.shape[-1] // D
    if Hq % Hkv or Hq > 8 * Hkv:
        raise ValueError(f"{Hq} q heads are not a multiple of {Hkv} kv heads "
                         "up to 8 q heads a kv head")
    shapes.update({
        "pool_k": (NB, BS, Hkv, D), "pool_v": (NB, BS, Hkv, D),
        "pool_ks": (NB, BS, Hkv), "pool_vs": (NB, BS, Hkv),
        "block_table": (M, MB) if lengths is not None else (MB,),
        "lengths": (M,), "blk": (M,), "off": (M,), "cos": (M, D),
        "sin": (M, D), "q": (M, Hq * D), "k": (M, Hkv * D),
        "v": (M, Hkv * D), "attn": (M, Hq * D), "x": (M, H), "y": (M, H),
        "x_mid": (M, H), "hbuf": (M, F), "out": (M, H), "ln1_w": (H,),
        "ln2_w": (H,)})
    for n, tensor in t.items():
        if tensor is None:
            continue
        if n in _INDEX:
            want = torch.int32
        elif n in ("pool_ks", "pool_vs") or n.endswith("_s"):
            want = torch.float32
        elif (n in matmuls and wq) or (n in ("pool_k", "pool_v")
                                        and kv_quant):
            want = torch.int8
        else:
            want = dt
        check_tensor(tensor, n, shapes[n], want, dev)
    a = build.LayerArgs(
        dtype=code, M=M, H=H, Hq=Hq, Hkv=Hkv, D=D, F=F, BS=BS, NB=NB, MB=MB,
        start=int(start), wq=wq, gs=gs, kv_quant=int(kv_quant),
        norm=int(spec is not None and spec.norm == "ln"),
        ffn=int(spec is not None and spec.activation == "gelu"),
        rope=int(rope), fused_qkv=int(spec is not None and spec.fused_qkv),
        bias=int(spec is not None and spec.bias),
        eps=float(spec.eps) if spec is not None else 0.0,
        scale=float(scale),
        **{n: None if tensor is None else tensor.data_ptr()
           for n, tensor in t.items()})
    return a, t


def _ffn_width(lp, kind: str) -> int:
    """The FFN width of a layer's weights, full-width or exported."""
    name = "up_w" if kind == "llama" else "fc1_w"
    w = lp[name] if name in lp else lp[name + "__q"]
    return w.shape[1]
