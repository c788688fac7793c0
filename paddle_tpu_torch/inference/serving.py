"""Continuous-batching serving engine over the paged KV pool
(counterpart of ``paddle_tpu/inference/serving.py``).

Iteration-level scheduling: ONE decode step advances every active
sequence in a fixed-size batch; between steps the host scheduler admits
queued requests into free slots (highest priority first), maps pages
from the shared pool and retires finished sequences.  Prompts run
through chunk fills (``prefill_block`` per layer) or, cold and
unbucketed, through the dense decoder's prefill; tokens come out of the
batched paged decode step (``decode_block`` per layer).  On the card
both ops launch the hand-written CUDA kernels; the dense prefill, the
sampler and the page copies are plain torch, as their JAX counterparts
are jnp.

Where the JAX engine runs a fixed-geometry program compiled once
(``jax.jit``), the port on the card replays a CUDA graph captured once
(``aot/graphs.py``): the decode step, the fixed-width sampler and, under
``spec_config``, the draft and the K+1-step verify.  Each is captured at
its first call, or at construction when the engine warm-starts from an
``aot_dir`` written by ``aot.export_engine`` (the kernel library is then
loaded from the artifact, without ``nvcc``).  The chunk fills stay eager
launches (the prefill kernels plan by the chunk's ``start`` on the host;
ROADMAP.md queue 1 item 16).  On the CPU the engine calls the plain
functions, as the JAX reference tier does.

At the JAX engine's defaults: a cross-request prefix cache
(``serving/prefix_cache.py``) shares committed prompt pages between
sequences, with an optional host offload tier; priority preemption
spills a running request's committed pages to a CRC-checked host tier
(``serving/resilience.py``) and restores them, or replays the request
from its committed tokens when the bounded tier dropped them; sampled
requests draw on per-request Threefry streams keyed by (seed, absolute
position), so a request's tokens do not depend on its batchmates.
With ``spec_config`` (``spec_decode/``, item 12) every decode iteration
drafts K tokens a slot, verifies them through the decode step run K+1
times and commits the accepted prefix; greedy ids are those of the
baseline engine, bit for bit.

Differences from the JAX engine, by design:

* ``jax.lax.scan`` over layers is a Python loop (inside a captured
  graph on the card);
* the pools are one ``[L, NB, BS, Hkv, D]`` tensor per K and V, updated
  IN PLACE layer by layer (the JAX engine donates and replaces them);
  a spill, an offload and a restore move only the pages concerned;
* the JAX engine's ``REGISTRY`` / ``TRACER`` hooks are not kept (ROADMAP
  queue 1 item 13): the plain ``stats`` and ``resilience`` dicts carry
  the same keys and values;
* an AOT artifact holds program records and the kernel library, not
  serialized programs (a CUDA graph cannot be serialized), and a warm
  start captures at construction; ``aot_stats()`` adds ``graphs`` on
  CUDA;
* MoE configs (item 15b, a MoE draft too) raise ``NotImplementedError``;
  GPT-family configs raise as well: the JAX engine serves Llama configs
  only, and a GPT layer reaches the serving kernels through the ops
  (``ops.decode_block``).
"""

from __future__ import annotations

import collections
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..aot.artifact import AotError
from ..aot.buckets import ShapeBucketRegistry
from ..aot.graphs import CapturedProgram
from ..aot.serve import (DECODE, SAMPLER, SPEC_DRAFT, SPEC_VERIFY,
                         check_captured, load_engine_artifacts)
from ..device import resolve_device
from ..models.generation import build_llama_decoder
from ..models.llama import _rope_cos_sin, block_shapes, torch_dtype
from ..ops.decode_block import (decode_block, decode_block_spec, make_norm,
                                prefill_block)
from ..ops.paged_kv import layer_pool, zeros_kv_pool
from ..ops.threefry import gumbel, random_bits, threefry2x32
from ..quantization.serve import (ServeQuantConfig,
                                  quantize_params_for_serving,
                                  quantized_leaf_names)
from ..serving.prefix_cache import PrefixCache
from ..serving.resilience import (SpillCorruptError, SpillTier, read_pages,
                                  restore_into_slot, snapshot_slot,
                                  write_pages)
from ..spec_decode import SpecDecodeConfig, SpecDecodeRunner

__all__ = ["ContinuousBatchingEngine", "GenRequest", "build_sampler",
           "derive_sample_seed"]


def derive_sample_seed(seed: int, sample_idx: int) -> int:
    """Per-sample seed for n > 1 parallel sampling: sample 0 keeps the
    request's seed, later samples take a CRC32 of ``(seed, sample_idx)``
    as int64s, masked to 31 bits."""
    if sample_idx == 0:
        return int(seed)
    return int(zlib.crc32(
        np.asarray([seed, sample_idx], np.int64).tobytes()) & 0x7FFFFFFF)


class _RefPool:
    """Refcounted page pool: prefix-cached pages are shared read-only
    between sequences and the prefix index, freed when the last reference
    drops."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))
        self.ref: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def acquire(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self.ref[p] = 1
        return out

    def share(self, phys: List[int]) -> None:
        for p in phys:
            if p not in self.ref:
                raise RuntimeError(
                    f"KV-pool accounting bug: share() of block {p} that "
                    "holds no live reference (freed or never acquired)")
            self.ref[p] += 1

    def release(self, phys: List[int]) -> None:
        for p in phys:
            r = self.ref.get(p, 0)
            if r <= 0:
                raise RuntimeError(
                    f"KV-pool accounting bug: release() of block {p} "
                    "with no live reference (double free)")
            if r == 1:
                del self.ref[p]
                self._free.append(p)
            else:
                self.ref[p] = r - 1


@dataclass
class GenRequest:
    req_id: int
    prompt: np.ndarray                 # [T0] int32
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    temperature: float = 0.0           # <= 0: greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0
    # higher admits first; under saturation strictly-lower-priority
    # running requests are preempted (their KV spilled to host RAM)
    priority: int = 0
    out: List[int] = field(default_factory=list)
    # index of the first EOS in ``out``
    eos_pos: Optional[int] = None


_M32 = 0xFFFFFFFF


def build_sampler():
    """The engine's sampler: ``sample(logits [n, V], seeds, positions,
    temperatures, top_k, top_p) -> ids [n]`` on the logits' device; the
    per-row values are lists or tensors.  Row ``i`` is keyed by
    ``fold_in(key(seed_i), position_i)`` (Threefry of the key ``(0,
    seed_i)`` over the counters ``(0, position_i)``, in int64 ops on the
    device, so the sampler holds no host loop and captures as a graph);
    its logits are divided by the temperature,
    values under the k-th largest dropped (ties kept), then values under
    the top-p cutoff of the top-k-filtered sorted distribution (the first
    index whose cumulative probability reaches ``top_p``), and the id is
    ``argmax(x + gumbel)``, as ``jax.random.categorical`` draws it.  An
    index past the vocabulary (``top_k > V``, or a cumulative sum that
    never reaches ``top_p``) filters nothing, as ``jnp.take``'s NaN fill
    does.  Rows are independent."""

    def sample(logits, seeds, positions, temperatures, top_k, top_p):
        n, V = logits.shape
        dev = logits.device

        def col(v, dt):
            return torch.as_tensor(v, dtype=dt, device=dev)
        seeds = col(seeds, torch.int64)
        k0, k1 = threefry2x32(torch.zeros_like(seeds), seeds & _M32, 0,
                              col(positions, torch.int64) & _M32)
        noise = gumbel(random_bits(k0[:, None], k1[:, None], V, dev))
        temp = col(temperatures, torch.float32)
        kk = col(top_k, torch.int64)[:, None]
        tp = col(top_p, torch.float32)[:, None]
        x = logits.float() / temp[:, None]

        def take(srt, idx):
            return torch.where(idx < V,
                               srt.gather(1, idx.clamp(max=V - 1)),
                               float("nan"))

        srt = torch.sort(x, dim=-1, descending=True).values
        kth = take(srt, kk.clamp(min=1) - 1)
        x = torch.where((kk > 0) & (x < kth), float("-inf"), x)
        srt2 = torch.sort(x, dim=-1, descending=True).values
        e = torch.exp(srt2 - srt2[:, :1])
        cum = torch.cumsum(e / e.sum(-1, keepdim=True), dim=-1)
        cutoff = take(srt2, (cum < tp).sum(-1, keepdim=True))
        x = torch.where((tp > 0) & (x < cutoff), float("-inf"), x)
        return torch.argmax(x + noise, dim=-1)

    return sample


class ContinuousBatchingEngine:
    """Llama continuous-batching engine (greedy by default, per-request
    sampling through ``temperature`` / ``top_k`` / ``top_p`` on
    :meth:`add_request`).

    Args:
      cfg: ``models.llama.LlamaConfig`` (dense; ``cfg.dtype`` float32 or
        bfloat16).
      params: ``{"wte", "head", "lnf_w", "blocks": {name: [L, ...]}}`` —
        ``models.llama.init_params`` or ``bridge.params_from_numpy``.
      max_batch: decode-batch slots.
      block_size / num_blocks: shared KV page pool geometry.
      max_blocks_per_seq: page-table width per slot (default
        ``ceil(max_position_embeddings / block_size)``).
      enable_prefix_caching: share committed full prompt pages between
        requests (a radix tree keyed by chained block digests); a hit
        runs only the prompt's suffix.
      prefill_buckets: declared chunk lengths; when set, every prompt and
        suffix is decomposed into these fixed-size chunk fills (last chunk
        padded).  None: a cache-hit suffix (and any prompt of a quantized
        engine) runs as one chunk fill of its own length, a cold prompt
        through the dense decoder's prefill, its KV then written into the
        slot's pages.
      aot_dir: warm-start from an artifact directory written by
        ``paddle_tpu_torch.aot.export_engine`` (or a rotation root, whose
        ``latest`` pointer is followed): the declared buckets come from
        its manifest and, on CUDA, the kernel library from its copy, and
        the engine's graphs are captured here.  Any reason the artifact
        cannot be used (version or device skew, another geometry,
        corruption) falls back to a fresh build and capture at first use;
        the reason is kept on ``self.aot_error`` and ``aot_loaded`` is
        False.
      enable_preemption: priority classes with preemption; with uniform
        priorities nothing is ever preempted.
      spill_tier: the host tier of preempted requests' pages (default an
        unbounded :class:`~paddle_tpu_torch.serving.SpillTier`).
      prefix_cache_config: a :class:`~paddle_tpu_torch.serving.
        PrefixCacheConfig` (the offload tier's budget).
      quant_config: a :class:`~paddle_tpu_torch.quantization.
        ServeQuantConfig`, or None.  Weight quantization takes an exported
        tree (``<name>__q`` / ``<name>__s`` leaves, from
        ``quantize_params_for_serving``) as it is, and PTQ-exports a
        full-width one here; ``kv_dtype="int8"`` builds int8 pools with
        per-(token, head) fp32 scales.
      fused_decode_block / fused_prefill: route every decode layer /
        chunk-fill layer through the serving kernels (True, the JAX
        engine's default).  On the CPU both settings run the plain chain,
        as the JAX reference tier runs the fused op as its per-op chain,
        so greedy ids are the same either way.  False on CUDA raises: the
        port has no per-op CUDA chain to route to (its plain versions are
        a correctness lane, not a fair A/B arm; the bench's serve rows are
        ROADMAP.md queue 1 item 13).
      spec_config: a :class:`~paddle_tpu_torch.spec_decode.
        SpecDecodeConfig` (draft model and parameters on this engine's
        device, ``k``, ``window``, ``enabled``), or None.  Every decode
        iteration then drafts ``k`` tokens a slot, runs the decode step
        ``k + 1`` times and commits the accepted prefix (greedy ids equal
        the baseline's; sampled requests keep their law through
        rejection sampling); ``enabled=False`` decodes on the baseline
        path.  Works with ``quant_config``, prefix caching and
        preemption; the draft is always full width.
      device: ``None`` = CUDA (raises without it); ``"cpu"`` runs the
        plain PyTorch versions of the ops.
    """

    def __init__(self, cfg, params, *, max_batch: int = 4,
                 block_size: int = 16, num_blocks: int = 256,
                 max_blocks_per_seq: Optional[int] = None,
                 enable_prefix_caching: bool = True,
                 prefill_buckets=None, aot_dir: Optional[str] = None,
                 fused_decode_block: bool = True,
                 fused_prefill: bool = True,
                 spec_config=None, enable_preemption: bool = True,
                 spill_tier=None, prefix_cache_config=None,
                 quant_config=None, device=None):
        if quant_config is not None and \
                not isinstance(quant_config, ServeQuantConfig):
            raise TypeError(f"quant_config must be a ServeQuantConfig or "
                            f"None, got {type(quant_config).__name__}")
        if spec_config is not None:
            if not isinstance(spec_config, SpecDecodeConfig):
                raise TypeError(
                    f"spec_config must be a SpecDecodeConfig or None, got "
                    f"{type(spec_config).__name__}")
            spec_config.validate_against(cfg)
        qw = quant_config is not None and quant_config.quantized_weights
        if qw and getattr(cfg, "moe_num_experts", 0):
            raise NotImplementedError(
                "weight-quantized serving covers dense FFNs only — the "
                "MoE expert matmuls keep full-width weights (ROADMAP)")
        if getattr(cfg, "moe_num_experts", 0):
            raise NotImplementedError(
                "MoE configs are not ported yet — ROADMAP.md queue 1 item "
                "15b")
        if not hasattr(cfg, "rms_norm_eps"):
            raise NotImplementedError(
                "GPT-family configs: the JAX engine serves Llama configs only "
                "(it reads cfg.kv_heads, cfg.rope_theta and params['head']); "
                "a GPT layer reaches the serving kernels through the ops, "
                "ops.decode_block.decode_block / prefill_block with "
                "decode_block_spec(gpt_cfg, block_size)")
        self.device = resolve_device(device)
        self.fused_decode_block = bool(fused_decode_block)
        self.fused_prefill = bool(fused_prefill)
        if self.device.type == "cuda" and not (self.fused_decode_block and
                                               self.fused_prefill):
            raise NotImplementedError(
                "fused_decode_block=False / fused_prefill=False: the port "
                "has no per-op CUDA chain (its plain versions are a "
                "correctness lane, not a fair A/B arm); the serve rows of "
                "the bench are ROADMAP.md queue 1 item 13")
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.quant_config = quant_config
        self._wq = quant_config.weight_dtype if qw else None
        self._gs = quant_config.group_size if qw else -1
        self._kv_quant = quant_config is not None and \
            quant_config.quantized_kv
        if qw and not any(k.endswith("__q") for k in params["blocks"]):
            # a full-width tree handed to a weight-quantized engine: the
            # PTQ export (absmax scales) on the parameters' device
            params = quantize_params_for_serving(params, quant_config)
        self.params = self._check_params(params)
        self.B = max_batch
        self.BS = block_size
        self.MB = max_blocks_per_seq or \
            -(-cfg.max_position_embeddings // block_size)
        self.NB = num_blocks
        L, kvh, hd = cfg.num_layers, cfg.kv_heads, cfg.head_dim
        self.pool_k = zeros_kv_pool((L, num_blocks, block_size, kvh, hd),
                                    self.dtype, self.device,
                                    kv_quant=self._kv_quant)
        self.pool_v = zeros_kv_pool((L, num_blocks, block_size, kvh, hd),
                                    self.dtype, self.device,
                                    kv_quant=self._kv_quant)
        self.block_table = np.full((max_batch, self.MB), -1, np.int32)
        self.lengths = np.zeros((max_batch,), np.int32)
        self.tokens = np.zeros((max_batch,), np.int32)
        self.alloc = _RefPool(num_blocks)
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.enable_prefix_caching = bool(enable_prefix_caching)
        self.prefix_cache = PrefixCache(block_size,
                                        config=prefix_cache_config)
        self.stats = {"prefix_blocks_reused": 0,
                      "prefix_blocks_registered": 0,
                      "pages_allocated": 0,
                      "prefill_tokens_computed": 0}
        self.slots: List[Optional[GenRequest]] = [None] * max_batch
        self.queue: "collections.deque[GenRequest]" = collections.deque()
        self.finished: Dict[int, np.ndarray] = {}
        self._next_id = 0
        self.enable_preemption = bool(enable_preemption)
        self._spill = spill_tier if spill_tier is not None else SpillTier()
        self.resilience = {"preemptions": 0, "restores": 0,
                           "spill_save_secs": 0.0,
                           "spill_restore_secs": 0.0,
                           "spill_evictions": 0, "prefix_replays": 0}
        self._buckets = None if prefill_buckets is None else \
            ShapeBucketRegistry(prefill_buckets, max_batch=max_batch)
        # dense cold prefills, one decoder per prompt length, 16 kept
        self._dense_prefills: "collections.OrderedDict[int, object]" = \
            collections.OrderedDict()
        self._sampler = build_sampler()
        self.spec = decode_block_spec(cfg, block_size, self._wq, self._gs)
        self._norm = make_norm(self.spec)
        self._cos, self._sin = _rope_cos_sin(
            cfg.max_position_embeddings, hd, cfg.rope_theta, self.dtype,
            getattr(cfg, "rope_scaling", None), device=self.device)
        # the LM head runs outside any kernel, with fp32 logits as the JAX
        # engine's preferred_element_type=float32 einsum gives them
        self._head32 = self.params["head"].float()
        self._layers = [{k: self.params["blocks"][k][i]
                         for k in self._leaf_shapes()} for i in range(L)]
        self.decode_steps = 0
        self.decode_slot_steps = 0
        self.decode_tokens = 0
        self.last_logits: Optional[np.ndarray] = None        # [B, V]
        self.last_prefill_logits: Optional[np.ndarray] = None   # [V]
        self.spec_config = spec_config
        self._spec = None if spec_config is None else \
            SpecDecodeRunner(self, spec_config)
        # the captured programs (CUDA graphs) by name, captured at first
        # use into one memory pool; None on the CPU.  ``_eager`` runs the
        # plain launch chain on CUDA instead (chip_smoke.py's A/B only)
        cuda = self.device.type == "cuda"
        self._graphs: Optional[Dict[str, CapturedProgram]] = \
            {} if cuda else None
        self._graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        self._eager = not cuda
        self._inputs = None
        self.aot_loaded = False
        self.aot_error: Optional[str] = None
        if aot_dir is not None:
            try:
                records, self._buckets = load_engine_artifacts(self, aot_dir)
                if cuda:
                    self._capture_all()
                    check_captured(records, self._graphs)
                self.aot_loaded = True
            except AotError as e:
                # the reference's fallback, loudly: a fresh build and
                # capture at first use, the reason kept on the engine
                self.aot_error = str(e)

    def _leaf_shapes(self):
        """{block leaf: (per-layer shape, dtype)}: the block weights, or
        under weight quantization each matmul's codes and scales."""
        out = {}
        for k, shape in block_shapes(self.cfg).items():
            if self._wq is None or k.startswith("ln"):
                out[k] = (shape, self.dtype)
                continue
            K, N = shape
            qn, sn = quantized_leaf_names(k)
            out[qn] = ((-(-K // 2) if self._wq == "int4" else K, N),
                       torch.int8)
            out[sn] = (((N,) if self._gs == -1 else (-(-K // self._gs), N)),
                       torch.float32)
        return out

    def _check_params(self, params):
        cfg = self.cfg
        want = {"wte": ((cfg.vocab_size, cfg.hidden_size), self.dtype),
                "head": ((cfg.hidden_size, cfg.vocab_size), self.dtype),
                "lnf_w": ((cfg.hidden_size,), self.dtype)}
        want.update({f"blocks.{k}": ((cfg.num_layers,) + s, dt)
                     for k, (s, dt) in self._leaf_shapes().items()})
        for key, (shape, dt) in want.items():
            if key.startswith("blocks."):
                if key[7:] not in params["blocks"]:
                    raise ValueError(
                        f"params[{key}] is missing (a weight-quantized "
                        "engine takes a full-width tree or the export of "
                        "quantize_params_for_serving under the same "
                        "config)")
                t = params["blocks"][key[7:]]
            else:
                t = params[key]
            if tuple(t.shape) != shape:
                raise ValueError(
                    f"params[{key}] has shape {tuple(t.shape)}, expected "
                    f"{shape} (a JAX tree with [S, per, ...] blocks goes "
                    "through bridge.params_from_numpy)")
            if t.dtype != dt or t.device != self.device:
                raise ValueError(
                    f"params[{key}] is {t.dtype} on {t.device}, the engine "
                    f"serves {dt} on {self.device}")
        return params

    # ------------------------------------------------------------------
    # device programs: one decode step, one chunk fill, the dense prefill
    # ------------------------------------------------------------------
    def _logits(self, x):
        xf = self._norm(x, self.params["lnf_w"])
        return xf.float() @ self._head32

    def _program_table(self):
        """``{name: (plain function, {input: template})}`` of the
        fixed-geometry programs: the decode step, the fixed-width sampler
        and, under ``spec_config``, the draft and the verify.  The
        templates fix each input's shape and dtype and hold the idle state
        a capture runs on: every table row -1 (no page written), lengths
        0, temperature 1.  Only the templates are kept: an engine that
        held its own bound methods would be a reference cycle, freed (its
        pools, GBs on the card) only by a garbage-collector pass."""
        B, MB, dev = self.B, self.MB, self.device
        if self._inputs is None:
            def full(shape, dt=torch.int64, v=0):
                return torch.full(shape, v, dtype=dt, device=dev)
            i32, f32 = torch.int32, torch.float32
            self._inputs = {
                DECODE: dict(tokens=full((B,)), lengths=full((B,), i32),
                             bt=full((B, MB), i32, -1)),
                SAMPLER: dict(logits=full((B, self.cfg.vocab_size), f32),
                              seeds=full((B,)), positions=full((B,)),
                              temperatures=full((B,), f32, 1),
                              top_k=full((B,)), top_p=full((B,), f32))}
            if self._spec is not None:
                sc = self.spec_config
                self._inputs[SPEC_DRAFT] = dict(win=full((B, sc.window)),
                                                ctx=full((B,), i32))
                self._inputs[SPEC_VERIFY] = dict(
                    bt=full((B, MB), i32, -1), lengths=full((B,), i32),
                    tokens=full((B, sc.k + 1)))
        fns = {DECODE: self._decode_step, SAMPLER: self._sampler}
        if self._spec is not None:
            sc, run = self.spec_config, self._spec
            fns[SPEC_DRAFT] = lambda win, ctx: run.draft_program(
                sc.draft_params, win, ctx)
            fns[SPEC_VERIFY] = lambda bt, lengths, tokens: \
                run.verify_program(bt, lengths, tokens)
        return {n: (fns[n], t) for n, t in self._inputs.items()}

    def _capture(self, name: str) -> CapturedProgram:
        fn, inputs = self._program_table()[name]
        prog = CapturedProgram(name, fn, inputs, pool=self._graph_pool)
        self._graphs[name] = prog
        return prog

    def _capture_all(self) -> None:
        """Capture every program not captured yet (CUDA)."""
        for name in self._program_table():
            if name not in self._graphs:
                self._capture(name)

    def _set_eager(self, eager: bool) -> None:
        """On CUDA, run the plain launch chain of each program (True) or
        replay its graph (False, the default).  For chip_smoke.py's A/B of
        graphs against eager launches; the engine's users never call
        it."""
        if self._graphs is None:
            raise ValueError("the engine captures no graphs on the CPU")
        self._eager = bool(eager)

    def _run(self, name: str, **inputs):
        """Run program ``name`` on ``inputs`` (numpy arrays or tensors):
        a replay of its graph on CUDA (captured at this first call), the
        plain function on the CPU.  Returns its outputs on the device."""
        if self._eager:
            fn, tmpl = self._program_table()[name]
            return fn(**{k: _to_like(v, tmpl[k]) for k, v in inputs.items()})
        prog = self._graphs.get(name)
        if prog is None:
            prog = self._capture(name)
        return prog(**inputs)

    def _decode_step(self, tokens, lengths, bt) -> torch.Tensor:
        """One decode step over every slot: ``tokens`` [B] fed at
        positions ``lengths`` [B] (tokens already stored) through the
        table ``bt``, all on the device; writes their KV into the pools
        and returns fp32 logits ``[B, V]``.  The speculative verify calls
        it K+1 times with ``lengths + i``, which may run past the RoPE
        table (a row past its budget, never read): positions clamp to
        its end."""
        x = self.params["wte"][tokens]                        # [B, H]
        pos = lengths.long().clamp(max=self._cos.shape[0] - 1)
        cos, sin = self._cos[pos].contiguous(), self._sin[pos].contiguous()
        for i, lp in enumerate(self._layers):
            x, _, _ = decode_block(x, lp, layer_pool(self.pool_k, i),
                                   layer_pool(self.pool_v, i), bt, lengths,
                                   cos, sin, spec=self.spec)
        return self._logits(x)

    def _chunk_fill(self, bt_row: torch.Tensor, start: int,
                    toks: np.ndarray, valid: int) -> torch.Tensor:
        """One chunk fill: ``len(toks)`` rows at positions ``start + i``,
        the first ``valid`` real.  Padded rows write their KV to page
        ``NB`` (dropped), so stale pages stay intact; the logits come from
        row ``valid - 1``, as ``[1, V]``."""
        dev, Ts = self.device, len(toks)
        pos = start + torch.arange(Ts, device=dev)
        # padded rows may run past the tables; they are never read
        posc = pos.clamp(max=self.cfg.max_position_embeddings - 1)
        x = self.params["wte"][torch.from_numpy(toks).to(dev, torch.long)]
        x = x[None]                                          # [1, Ts, H]
        cos, sin = self._cos[posc].contiguous(), self._sin[posc].contiguous()
        page = (pos // self.BS).clamp(max=self.MB - 1)
        blk = bt_row.clamp(min=0)[page]
        blk = torch.where(torch.arange(Ts, device=dev) < valid, blk,
                          torch.full_like(blk, self.NB)).to(torch.int32)
        off = (pos % self.BS).to(torch.int32)
        for i, lp in enumerate(self._layers):
            x, _, _ = prefill_block(x, lp, layer_pool(self.pool_k, i),
                                    layer_pool(self.pool_v, i), blk, off,
                                    bt_row, cos, sin, spec=self.spec,
                                    start=start)
        return self._logits(x[:, valid - 1])

    def _fill_prompt_bucketed(self, slot: int, req: GenRequest,
                              start: int = 0) -> torch.Tensor:
        """Run the prompt from ``start`` (the cached-prefix tokens) through
        declared-bucket chunk fills; returns the logits at the prompt's
        final token as ``[1, V]``."""
        suffix = req.prompt[start:]
        bt_row = torch.from_numpy(self.block_table[slot]).to(self.device)
        pos, off = start, 0
        logits = None
        for size, valid in self._buckets.plan_chunks(len(suffix)):
            toks = np.zeros((size,), np.int32)
            toks[:valid] = suffix[off:off + valid]
            logits = self._chunk_fill(bt_row, pos, toks, valid)
            pos += valid
            off += valid
        return logits

    def _dense_prefill(self, slot: int, req: GenRequest) -> torch.Tensor:
        """A cold prompt through the dense decoder's prefill (torch
        matmuls and masked attention, no kernel of the library, as the JAX
        engine's ``use_pallas=False`` prefill), its KV then written into
        the slot's pages with one page-axis copy per pool (the padded tail
        of the last page holds zeros, masked by ``lengths``)."""
        T0 = len(req.prompt)
        prefill = self._dense_prefills.get(T0)
        if prefill is None:
            prefill, _ = build_llama_decoder(self.cfg, T0, device=self.device)
            self._dense_prefills[T0] = prefill
            if len(self._dense_prefills) > 16:
                self._dense_prefills.popitem(last=False)
        else:
            self._dense_prefills.move_to_end(T0)
        ids = torch.from_numpy(req.prompt[None]).to(self.device, torch.long)
        cache, logits = prefill(self.params, ids)
        nb = self._blocks_needed(T0)
        pages = torch.tensor(self.slot_pages[slot][:nb], dtype=torch.long,
                             device=self.device)
        for pool, kv in ((self.pool_k, cache["k"]), (self.pool_v,
                                                     cache["v"])):
            kv = F.pad(kv[:, 0], (0, 0, 0, 0, 0, nb * self.BS - T0))
            pool.index_copy_(1, pages, kv.reshape(
                kv.shape[0], nb, self.BS, *kv.shape[2:]).to(pool.dtype))
        return logits

    def _prefill_into_slot(self, slot: int, req: GenRequest,
                           L: int) -> torch.Tensor:
        """Run the prompt into the slot's (already mapped) pages past its
        ``L`` cached blocks and return next-token logits ``[1, V]``: the
        three prefill tiers admission chooses between (one seam for
        crash-mid-prefill tests)."""
        T0 = len(req.prompt)
        # tokens whose KV this admission computes (cache hits and offload
        # restores shrink it; padding never counts)
        self.stats["prefill_tokens_computed"] += T0 - L * self.BS
        if self._buckets is not None:
            # declared-bucket prefill, cold prompts and cache-hit suffixes
            return self._fill_prompt_bucketed(slot, req, L * self.BS)
        if L or self.quant_config is not None:
            # one chunk fill of the suffix at start = L * BS; quantized
            # engines take cold prompts here too, so every admission of
            # one quant config runs one prefill tier
            suffix = req.prompt[L * self.BS:]
            bt_row = torch.from_numpy(self.block_table[slot]).to(self.device)
            return self._chunk_fill(bt_row, L * self.BS, suffix, len(suffix))
        return self._dense_prefill(slot, req)

    # ------------------------------------------------------------------
    # requests and sampling
    # ------------------------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens: int,
                    eos_token_id: Optional[int] = None, *,
                    temperature: float = 0.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None, seed: int = 0,
                    priority: int = 0) -> int:
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill "
                             "argmax is already one generated token)")
        total = len(prompt) + max_new_tokens
        if total > self.MB * self.BS:
            raise ValueError(f"request needs {total} tokens, engine caps "
                             f"at {self.MB * self.BS} per sequence")
        if self._blocks_needed(total) > self.alloc.num_blocks:
            raise ValueError(
                f"request needs {self._blocks_needed(total)} pages, the "
                f"whole pool has {self.alloc.num_blocks}")
        if total > self.cfg.max_position_embeddings:
            raise ValueError("request exceeds max_position_embeddings")
        req = GenRequest(self._next_id, prompt, max_new_tokens,
                         eos_token_id, temperature=temperature,
                         top_k=top_k, top_p=top_p, seed=seed,
                         priority=int(priority))
        self._next_id += 1
        self.queue.append(req)
        return req.req_id

    def _pick_token(self, req: GenRequest, logits, position: int) -> int:
        """Greedy, or sampled on the request's own stream keyed by the
        absolute ``position``.  ``logits``: ``[V]``, numpy or a tensor."""
        lg = logits if isinstance(logits, torch.Tensor) else \
            torch.from_numpy(np.asarray(logits, np.float32))
        if req.temperature is None or req.temperature <= 0.0:
            return int(lg.argmax())
        return int(self._sample_rows([req], lg.reshape(1, -1),
                                     [position])[0])

    def _sample_rows(self, reqs: List[GenRequest], logits_rows,
                     positions) -> np.ndarray:
        """One sampled token per request (rows of ``logits_rows`` aligned
        with ``reqs``).  Rows are padded to the full decode width
        ``max_batch``, as the JAX engine pads them, so every call runs the
        one fixed-width program (a graph on CUDA); pad rows take
        temperature 1 and no filter, and every row is drawn independently
        of the others."""
        n, B = len(reqs), self.B
        lg = torch.zeros((B, logits_rows.shape[-1]), dtype=torch.float32,
                         device=self.device)
        lg[:n] = torch.as_tensor(logits_rows).to(self.device, torch.float32)
        seeds = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int64)
        temps = np.ones((B,), np.float32)
        topk = np.zeros((B,), np.int64)
        topp = np.zeros((B,), np.float32)
        pos[:n] = np.asarray(positions, np.int64)
        for i, r in enumerate(reqs):
            seeds[i] = int(r.seed) & _M32
            temps[i] = r.temperature
            topk[i] = r.top_k or 0
            topp[i] = r.top_p or 0.0
        toks = self._run(SAMPLER, logits=lg, seeds=seeds, positions=pos,
                         temperatures=temps, top_k=topk, top_p=topp)
        return toks.cpu().numpy()[:n]

    def _blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.BS)

    # ------------------------------------------------------------------
    # prefix cache
    # ------------------------------------------------------------------
    @property
    def prefix_index(self) -> "collections.OrderedDict[bytes, int]":
        """``{chained block digest: phys page}`` of the resident cache
        blocks, LRU order (the leak report reads this)."""
        return collections.OrderedDict(self.prefix_cache.resident_items())

    def _cached_prefix(self, prompt: np.ndarray):
        """Longest cached block-aligned prefix: ``(resident_blocks,
        resident_pages, offloaded_nodes)``.  A prompt that is an exact
        multiple of BS leaves its last block uncached, so the suffix
        prefill has a token to produce the next-token logits."""
        if not self.enable_prefix_caching:
            return 0, [], []
        full = len(prompt) // self.BS
        lookup = full - 1 if len(prompt) % self.BS == 0 else full
        pages, off = self.prefix_cache.walk(
            self._block_keys(prompt, lookup))
        return len(pages), pages, off

    def _block_keys(self, prompt: np.ndarray, n: int) -> List[bytes]:
        return self.prefix_cache.keys_for(prompt, n)

    def prefix_match_blocks(self, keys: List[bytes]) -> int:
        """Longest cached chain prefix for precomputed keys, without
        touching recency or refcounts."""
        if not self.enable_prefix_caching:
            return 0
        return self.prefix_cache.match_blocks(keys)

    def _acquire_with_eviction(self, n: int) -> Optional[List[int]]:
        """Acquire pages, evicting prefix-cache blocks that only the cache
        holds (LRU, leaf first) under pressure.  Callers take their own
        reference on reused pages BEFORE acquiring, so an evicted twin of
        a shared page is never handed back as private."""
        while True:
            got = self.alloc.acquire(n)
            if got is not None:
                self.stats["pages_allocated"] += n
                return got
            node = self.prefix_cache.evictable(
                lambda p: self.alloc.ref.get(p, 0))
            if node is None:
                return None
            self._evict_prefix_block(node)

    def _evict_prefix_block(self, node) -> None:
        """Evict one resident cache block, its exact page bytes (and int8
        scales) parked in the host tier when it has a budget, then release
        the cache's pool reference."""
        cache = self.prefix_cache
        if cache.wants_offload:
            k, v, ks, vs = read_pages(self, [node.phys])
            phys = cache.evict(node, k[:, 0], v[:, 0],
                               None if ks is None else ks[:, 0],
                               None if vs is None else vs[:, 0])
        else:
            phys = cache.evict(node)
        self.alloc.release([phys])

    def _restore_offloaded(self, off, priv: List[int]) -> int:
        """Write offloaded prefix blocks' exact bytes into the first
        ``len(off)`` fresh private pages, promoting each back to the
        resident tier (the cache takes a reference).  A CRC failure (or
        a block whose quantization is not the pool's) stops the restore
        there and the caller recomputes the rest.  Returns the number of
        blocks restored."""
        good = []
        for node in off:
            try:
                node.verify()
                if (node.k_scale is not None) != self._kv_quant:
                    raise SpillCorruptError(
                        f"offloaded prefix block {node.key.hex()[:12]} "
                        "quantization does not match this engine's KV "
                        "pool — demoting to suffix recompute")
            except SpillCorruptError:
                self.prefix_cache.drop_host(node)
                break
            good.append(node)
        if not good:
            return 0
        pages = priv[:len(good)]

        def stack(name):
            parts = [getattr(n, name) for n in good]
            return None if parts[0] is None else torch.stack(parts, 1)

        write_pages(self, pages, stack("k_bytes"), stack("v_bytes"),
                    stack("k_scale"), stack("v_scale"))
        for node, page in zip(good, pages):
            self.prefix_cache.promote(node, page)
            self.alloc.share([page])
        return len(good)

    def _note_prefix_lookup(self, hit_blocks: int) -> None:
        """Account one admission-time cache consultation; ``hit_blocks``
        counts resident and restored blocks the prefill skips."""
        s = self.prefix_cache.stats
        s["lookups"] += 1
        if hit_blocks:
            s["hits"] += 1
            s["hit_blocks"] += hit_blocks
            s["hit_tokens"] += hit_blocks * self.BS

    def _register_prefix(self, prompt: np.ndarray,
                         table: List[int]) -> None:
        """Insert every full prompt block into the radix tree (decode
        writes start at ``len(prompt)``, so those pages never change); the
        cache takes one pool reference per block it takes new custody
        of."""
        if not self.enable_prefix_caching:
            return
        full = len(prompt) // self.BS
        took = self.prefix_cache.insert(self._block_keys(prompt, full),
                                        table[:full])
        if took:
            self.alloc.share(took)
            self.stats["prefix_blocks_registered"] += len(took)

    # ------------------------------------------------------------------
    # priority preemption
    # ------------------------------------------------------------------
    def _best_waiting_index(self) -> Optional[int]:
        """Queue index of the next request to admit: highest priority,
        FIFO within a class (a preempted request re-enters at the front)."""
        best, best_key = None, None
        for i, r in enumerate(self.queue):
            key = (-r.priority, i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _releasable_pages(self, slot: int) -> int:
        """Pages preempting ``slot`` would free: those only the slot
        holds."""
        return sum(1 for p in self.slot_pages[slot]
                   if self.alloc.ref.get(p) == 1)

    def _preempt_for_priority(self) -> None:
        """Preempt the lowest-priority running work for a strictly
        higher-priority waiter when the batch or the pool is saturated,
        one victim a pass, and only when preemption can make the waiter
        admissible (a slot opens and the freed pages close the
        shortfall)."""
        for _ in range(self.B):
            idx = self._best_waiting_index()
            if idx is None:
                return
            cand = self.queue[idx]
            snap = self._spill.get(cand.req_id)
            if snap is not None:
                need, shared = snap.num_blocks, ()
            else:
                # admission reuses the waiter's cached prefix pages and
                # acquires only the rest (offloaded blocks still take
                # fresh pages, so they stay in ``need``)
                L, shared, _off = self._cached_prefix(cand.prompt)
                need = self._blocks_needed(
                    len(cand.prompt) + cand.max_new_tokens) - L
            shared_set = set(shared)
            evictable = sum(1 for p in self.prefix_index.values()
                            if self.alloc.ref.get(p) == 1
                            and p not in shared_set)
            have_slot = any(s is None for s in self.slots)
            if have_slot and self.alloc.free_blocks + evictable >= need:
                return                 # admissible without preemption
            victims = [s for s in range(self.B)
                       if self.slots[s] is not None
                       and self.slots[s].priority < cand.priority]
            if not victims:
                return
            releasable = sum(self._releasable_pages(s) for s in victims)
            if (self.alloc.free_blocks + evictable + releasable) < need:
                return                 # preemption could never admit cand
            # cheapest spill first: lowest priority, then fewest committed
            # positions, then slot index
            victims.sort(key=lambda s: (self.slots[s].priority,
                                        int(self.lengths[s]), s))
            self.preempt(victims[0])

    def preempt(self, slot: int) -> int:
        """Preempt the request running in ``slot``: its committed pages and
        decode cursor go to the spill tier, its page references are
        released, and it re-enters the FRONT of the queue.  Returns its
        id."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not running a request")
        t0 = time.perf_counter()
        snap = snapshot_slot(self, slot)
        self._spill_put(req.req_id, snap)
        self._free_slot(slot)
        self.queue.appendleft(req)
        self.resilience["preemptions"] += 1
        self.resilience["spill_save_secs"] += time.perf_counter() - t0
        return req.req_id

    def _spill_put(self, req_id: int, snap) -> None:
        """Insert a snapshot into the spill tier; snapshots evicted for
        its cap demote their requests to replay from their committed
        tokens."""
        self.resilience["spill_evictions"] += len(self._spill.put(req_id,
                                                                  snap))

    def spill_compatible(self, snap) -> bool:
        """Whether a snapshot from another engine can restore into this
        pool: the same page geometry and dtype, a table wide enough, and
        scales exactly when the pool is int8."""
        if (getattr(snap, "k_scale", None) is not None) != self._kv_quant:
            return False
        ref = self.pool_k.data if self._kv_quant else self.pool_k
        return (snap.k_pages.shape[0] == ref.shape[0]
                and snap.k_pages.shape[2:] == ref.shape[2:]
                and snap.k_pages.dtype == ref.dtype
                and snap.num_blocks <= self.MB)

    def adopt_preempted(self, req: GenRequest, snap) -> None:
        """Take in a preempted request (committed tokens and KV snapshot)
        from another engine of the same geometry: the snapshot enters the
        spill tier and the request the front of the queue."""
        if not self.spill_compatible(snap):
            pshape = (self.pool_k.data if self._kv_quant
                      else self.pool_k).shape
            raise ValueError(
                "KV snapshot geometry does not match this engine's pool "
                f"(snapshot pages {tuple(snap.k_pages.shape)}, pool "
                f"{tuple(pshape)})")
        if req.req_id in self._spill:
            raise ValueError(f"request {req.req_id} already spilled here")
        self.queue.appendleft(req)
        self._spill_put(req.req_id, snap)

    def _restore_preempted(self, slot: int, req: GenRequest, idx: int,
                           snap) -> bool:
        """Re-admit a preempted request: fresh pages, the spilled bytes
        written back, the decode cursor restored.  False when the pool
        cannot host it yet."""
        priv = self._acquire_with_eviction(snap.num_blocks)
        if priv is None:
            return False
        del self.queue[idx]
        self.block_table[slot, :] = -1
        self.block_table[slot, :snap.num_blocks] = priv
        self.slot_pages[slot] = priv
        t0 = time.perf_counter()
        try:
            restore_into_slot(self, slot, snap)
        except BaseException:
            # exactly-once release; the snapshot is unusable, so the
            # request is dropped from this engine
            self.alloc.release(self.slot_pages[slot])
            self.slot_pages[slot] = []
            self.block_table[slot, :] = -1
            del self._spill[req.req_id]
            raise
        del self._spill[req.req_id]
        self.slots[slot] = req
        self.lengths[slot] = snap.length
        self.tokens[slot] = snap.next_token
        self.resilience["restores"] += 1
        self.resilience["spill_restore_secs"] += time.perf_counter() - t0
        return True

    def _replay_into_slot(self, slot: int, req: GenRequest,
                          idx: int) -> bool:
        """Re-admit a preempted request whose snapshot the bounded tier
        dropped: prefill its committed tokens ``prompt + out[:-1]`` and
        resume at the pending token ``out[-1]`` (the final logits are
        discarded).  False when the pool cannot host it yet."""
        committed = np.concatenate(
            [req.prompt, np.asarray(req.out[:-1], np.int32)]) \
            if len(req.out) > 1 else req.prompt
        need = self._blocks_needed(len(req.prompt) + req.max_new_tokens)
        L, shared, off = self._cached_prefix(committed)
        self.alloc.share(shared)
        priv = self._acquire_with_eviction(need - L)
        if priv is None:
            self.alloc.release(shared)
            return False
        restored = self._restore_offloaded(off, priv)
        self._note_prefix_lookup(L + restored)
        self.stats["prefix_blocks_reused"] += L + restored
        del self.queue[idx]
        table = shared + priv
        self.block_table[slot, :] = -1
        self.block_table[slot, :need] = table
        self.slot_pages[slot] = table
        shadow = GenRequest(req.req_id, committed, 1, None)
        try:
            self._prefill_into_slot(slot, shadow, L + restored)
            self._register_prefix(req.prompt, table)
        except BaseException:
            # exactly-once release, as on the fresh path
            self.alloc.release(self.slot_pages[slot])
            self.slot_pages[slot] = []
            self.block_table[slot, :] = -1
            self.queue.appendleft(req)
            raise
        self.slots[slot] = req
        self.lengths[slot] = len(committed)
        self.tokens[slot] = req.out[-1]
        self.resilience["prefix_replays"] += 1
        return True

    # ------------------------------------------------------------------
    # host-side scheduler
    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Admit waiting requests into free slots while pages allow,
        highest priority first: preemption first, then for each free slot
        a restore (spilled request), a replay (spill dropped) or a fresh
        admission, which shares the cached prefix pages before acquiring
        (and possibly evicting) the rest."""
        if self.enable_preemption:
            self._preempt_for_priority()
        for slot in range(self.B):
            if self.slots[slot] is not None:
                continue
            idx = self._best_waiting_index()
            if idx is None:
                break
            req = self.queue[idx]
            snap = self._spill.get(req.req_id)
            if snap is not None:
                if not self._restore_preempted(slot, req, idx, snap):
                    break              # head-of-line waits for pages
                continue
            if req.out:
                # preempted, its snapshot dropped by the bounded tier
                if not self._replay_into_slot(slot, req, idx):
                    break              # head-of-line waits for pages
                continue
            T0 = len(req.prompt)
            need = self._blocks_needed(T0 + req.max_new_tokens)
            L, shared, off = self._cached_prefix(req.prompt)
            # take the slot's references FIRST: eviction must never free
            # (and hand out again) a page being reused
            self.alloc.share(shared)
            priv = self._acquire_with_eviction(need - L)
            if priv is None:
                self.alloc.release(shared)
                break                  # head-of-line waits for pages
            restored = self._restore_offloaded(off, priv)
            self._note_prefix_lookup(L + restored)
            self.stats["prefix_blocks_reused"] += L + restored
            del self.queue[idx]
            table = shared + priv
            self.block_table[slot, :] = -1
            self.block_table[slot, :need] = table
            self.slot_pages[slot] = table
            try:
                logits = self._prefill_into_slot(slot, req, L + restored)
                self._register_prefix(req.prompt, table)
                first = self._pick_token(req, logits[0], position=T0)
            except BaseException:
                # the slot never went live: release its pages exactly
                # once and keep the request waiting
                self.alloc.release(self.slot_pages[slot])
                self.slot_pages[slot] = []
                self.block_table[slot, :] = -1
                self.queue.appendleft(req)
                raise
            self.last_prefill_logits = logits[0].cpu().numpy()
            self._append_tok(req, first)
            self.slots[slot] = req
            self.lengths[slot] = T0
            self.tokens[slot] = first

    @staticmethod
    def _append_tok(req: GenRequest, tok: int) -> None:
        req.out.append(tok)
        if req.eos_token_id is not None and req.eos_pos is None \
                and tok == req.eos_token_id:
            req.eos_pos = len(req.out) - 1

    def _retire_done(self) -> None:
        for s in range(self.B):
            req = self.slots[s]
            if req is not None and (len(req.out) >= req.max_new_tokens
                                    or req.eos_pos is not None):
                if req.eos_pos is not None:
                    req.out = req.out[:req.eos_pos + 1]
                self._retire(s)

    def _free_slot(self, slot: int) -> None:
        self.alloc.release(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.block_table[slot, :] = -1
        self.lengths[slot] = 0
        self.tokens[slot] = 0
        self.slots[slot] = None

    def _retire(self, slot: int) -> None:
        req = self.slots[slot]
        self.finished[req.req_id] = np.concatenate(
            [req.prompt, np.asarray(req.out, np.int32)])
        self._free_slot(slot)

    def cancel(self, req_id: int) -> bool:
        """Abort a queued or in-flight request; its pages free at once and
        no result is reported.  False when the id is unknown or already
        finished.  A waiting request holds no page references (a
        preempted one's snapshot is dropped); a scheduled one holds one
        reference per page of its table, shared prefix pages included,
        and each is released exactly once."""
        for i, req in enumerate(self.queue):
            if req.req_id == req_id:
                del self.queue[i]
                self._spill.pop(req_id, None)
                return True
        for slot in range(self.B):
            req = self.slots[slot]
            if req is not None and req.req_id == req_id:
                self._free_slot(slot)
                return True
        return False

    def step(self) -> Dict[int, np.ndarray]:
        """One scheduler iteration: retire, admit, retire again (the
        prefill's token may already finish a request), decode every
        active slot, greedy or sampled.  Returns newly finished
        {req_id: prompt + generated ids}."""
        self._retire_done()
        self._admit()
        self._retire_done()
        active = [s for s in range(self.B) if self.slots[s] is not None]
        if not active:
            self.last_logits = None
            out, self.finished = self.finished, {}
            return out
        if self._spec is not None and self._spec.config.enabled:
            # speculative decode: draft K, verify K+1, commit the accepted
            # prefix (spec_decode/runner.py); greedy ids are the baseline
            # branch's, bit for bit
            pre = sum(len(self.slots[s].out) for s in active)
            self._spec.run_decode(active)
            self.decode_steps += 1
            self.decode_slot_steps += len(active)
            self.decode_tokens += \
                sum(len(self.slots[s].out) for s in active) - pre
            out, self.finished = self.finished, {}
            return out
        logits = self._run(DECODE, tokens=self.tokens, lengths=self.lengths,
                           bt=self.block_table)
        self.last_logits = logits.cpu().numpy()
        for s in active:
            self.lengths[s] += 1            # the fed token's KV is stored
        sampled = [s for s in active
                   if (self.slots[s].temperature or 0.0) > 0.0]
        picks: Dict[int, int] = {}
        if sampled:
            # one sampler call for the sampled sub-batch, each row keyed
            # by the position after its fed token
            toks = self._sample_rows(
                [self.slots[s] for s in sampled], logits[sampled],
                [int(self.lengths[s]) for s in sampled])
            picks = dict(zip(sampled, toks.tolist()))
        for s in active:
            tok = picks.get(s)
            if tok is None:
                tok = int(self.last_logits[s].argmax())
            self._append_tok(self.slots[s], int(tok))
            self.tokens[s] = int(tok)
        self.decode_steps += 1
        self.decode_slot_steps += len(active)
        self.decode_tokens += len(active)
        out, self.finished = self.finished, {}
        return out

    def run_to_completion(self) -> Dict[int, np.ndarray]:
        """Drive steps until queue and batch drain; returns all results.
        ``finished`` is part of the liveness condition: a step that raised
        after retiring a request leaves its result there."""
        results: Dict[int, np.ndarray] = {}
        while self.queue or self.finished \
                or any(s is not None for s in self.slots):
            results.update(self.step())
        return results

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def active_requests(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def batch_occupancy(self) -> float:
        """Fraction of decode-batch slots running a request."""
        return self.active_requests / float(self.B)

    def kv_utilization(self) -> float:
        """Fraction of pool pages holding live references (slots or the
        prefix index)."""
        return 1.0 - self.alloc.free_blocks / float(self.alloc.num_blocks)

    def kv_leak_report(self) -> Dict[str, int]:
        """Cross-check the refcount pool against the slot tables and the
        prefix index: ``leaked`` and ``unaccounted`` must be zero after
        any drain."""
        held: Dict[int, int] = {}
        for pages in self.slot_pages:
            for p in pages:
                held[p] = held.get(p, 0) + 1
        index = self.prefix_index
        for p in index.values():
            held[p] = held.get(p, 0) + 1
        leaked = sum(1 for p, r in self.alloc.ref.items()
                     if held.get(p, 0) != r)
        leaked += sum(1 for p in held if p not in self.alloc.ref)
        return {
            "free_blocks": self.alloc.free_blocks,
            "index_blocks": len(index),
            "slot_blocks": sum(len(p) for p in self.slot_pages),
            "leaked": leaked,
            "unaccounted": (self.alloc.num_blocks - self.alloc.free_blocks
                            - len(self.alloc.ref)),
        }

    @property
    def spilled_bytes(self) -> int:
        """Host-RAM bytes held by preempted requests' snapshots."""
        return sum(s.nbytes for s in self._spill.values())

    def resilience_stats(self) -> Dict[str, object]:
        """Preemption counters (the JAX engine's keys)."""
        s: Dict[str, object] = dict(self.resilience)
        s["spilled_requests"] = len(self._spill)
        s["spilled_bytes"] = self.spilled_bytes
        return s

    def prefix_stats(self) -> Dict[str, object]:
        """Prefix-cache counters and state (the JAX engine's keys)."""
        s: Dict[str, object] = dict(self.prefix_cache.stats)
        s["enabled"] = self.enable_prefix_caching
        s["cached_blocks"] = self.prefix_cache.resident_blocks
        s["offloaded_blocks"] = self.prefix_cache.offloaded_blocks
        s["offloaded_bytes"] = self.prefix_cache.host_bytes
        s["prefill_tokens_computed"] = \
            self.stats["prefill_tokens_computed"]
        lk = s["lookups"]
        s["hit_rate"] = (s["hits"] / lk) if lk else None
        return s

    def spec_stats(self) -> Optional[Dict[str, object]]:
        """Speculation counters (the JAX engine's keys), or None without
        ``spec_config``.  ``engine_steps_per_token`` counts per-slot
        decode iterations per decode token, so baseline decode measures
        exactly 1.0 at any batch size — < 1.0 is accepted speculation."""
        if self._spec is None:
            return None
        s: Dict[str, object] = dict(self._spec.stats)
        s["enabled"] = self._spec.config.enabled
        s["k"] = self._spec.config.k
        s["acceptance_rate"] = self._spec.acceptance_rate
        s["engine_steps_per_token"] = (
            self.decode_slot_steps / self.decode_tokens
            if self.decode_tokens else None)
        return s

    def bucket_stats(self) -> Dict[str, int]:
        """Declared-bucket hits, misses and padded tokens ({} without
        buckets)."""
        return {} if self._buckets is None else self._buckets.stats()

    def aot_stats(self) -> Dict[str, object]:
        """Warm-start observability (the JAX engine's keys): whether the
        artifacts loaded (and why not), the declared-bucket counts and, on
        CUDA, ``graphs``: each captured program's replays, capture ms and
        launches a replay."""
        s: Dict[str, object] = {"aot_loaded": self.aot_loaded}
        if self.aot_error is not None:
            s["aot_error"] = self.aot_error
        if self._buckets is not None:
            s.update(self._buckets.stats())
        if self._graphs is not None:
            s["graphs"] = {n: p.stats() for n, p in self._graphs.items()}
        return s


def _to_like(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a numpy array or a tensor) on ``like``'s device and dtype."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return v.to(like.device, like.dtype)
