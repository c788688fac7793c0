#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's serving (Llama through the engine, GPT
through the ops), training, generation, eager training, incubate
fused-API, incubate serving and BERT fine-tune paths on one CUDA card and
check them.

    python3 chip_smoke.py

from the repository root, with no arguments, on a machine with one CUDA
card and ``nvcc`` (``/usr/local/cuda``).  Phases:

1. device   the card's name and power limit (``nvidia-smi``);
2. build    the hand-written kernels from ``paddle_tpu_torch/kernels/csrc``;
3. kernels  ``decode_block`` and ``prefill_block`` at ``llama_7b`` layer
            shapes, each held against its plain PyTorch version in fp32
            (tolerance 1e-4) and bf16 (2e-2), layer output and pool pages,
            with the untouched pages checked unchanged; then each kernel of
            the chain on its own (``rms_norm_rows`` at M 4 and 256 beside
            ``F.rms_norm``, the GEMMs at M 4, 16, 64 and 256,
            ``rope_kv_write`` bit-equal to its plain version in fp32 and
            bf16 at the decode case and at a prefill chunk of Ts 256
            through blk / off, timed at both,
            ``paged_attention`` at the decode case and at a prefill chunk of
            Ts 256 after 300 positions, each of its calls twice,
            bit-identical, one launch each, beside one
            ``scaled_dot_product_attention`` call on the same K / V gathered
            beforehand); kernel, plain and library times in bf16, each layer
            call's device time
            from its chain's kernels (``chain_ms``, which fails when one is
            missing), device-paced back to back (``paced_ms``: the gaps
            between kernels counted, the host's enqueue not) and the host
            time of one ``decode_block`` call; then
            the quantized chain (``quant_chain``): the weight-only layer
            GEMMs ``wo_layer_*`` in int8 and int4, per channel and groups
            of 64 / 128, each epilogue (none, residual, SwiGLU on the gate),
            M 4 / 16 / 256 in bf16 and fp32 x, and one case whose fp32
            scales bf16 rounding moves (the kernel nearer the fp32-scale
            plain version); ``rope_kv_write_q8`` bit-equal to its plain
            version (fp32 and bf16, decode and Ts 256, random rows and the
            hard rows of ``q8_hard_rows``: quotients on half-integers,
            clipped absmax codes, zero and tiny rows); ``paged_attention_q8``
            at decode and prefill (bf16 rule, fp32 1e-4, GQA 32/4 and 32/16);
            whole int8 / int4 layers over int8 pools (and int8 g128 and an
            fp32 layer over full-width pools) against their plain versions
            with their exact launches; times per llama_7b layer's seven
            GEMMs beside the bound and ``torch.matmul`` on the weights
            dequantized to bf16, the SwiGLU routes (gate then up with the
            SwiGLU in its epilogue, or gate, up and ``swiglu_fwd``), the
            int8 kernels beside their bounds and SDPA on dequantized K / V,
            and the quantized ``decode_block`` / ``prefill_block`` chains;
            and ``prefill_block`` as the engine's unbucketed tier calls it,
            one chunk of Ts 1, 37 and 300 at start 0 and 512, fp32 and
            bf16 against its plain version, timed in bf16;
4. engine   ``llama_7b`` in bf16 with seeded random weights served by the
            continuous-batching engine with prefix caching and preemption
            off (bucketed prefill, paged decode):
            the prefill logits of one request against the plain chain on
            the card, then 8 requests of 20-600 prompt tokens and 32 new
            tokens each, with every request finished, no KV block leaked and
            every kernel of the path launched; then (``phase_engine_quant``)
            the same model PTQ-exported at construction with
            ``ServeQuantConfig(weight_dtype="int8", kv_dtype="int8")`` (the
            JAX bench's ``int8_weights_int8_kv`` row), the same checks and
            traffic with the launch counts exactly as predicted from the
            decode steps and chunk fills and the plain ops refused, its
            decode step's wall and busy ms, tokens/s and TTFT beside the
            bf16 engine's; then that quantized engine at the JAX defaults:
            one prefix hit against the prompt served cold, one preempt /
            restore whose snapshot carries the int8 pages' fp32 scales,
            restored byte for byte, ids as unpreempted;
4b. engine features  ``llama_7b`` bf16 at full depth through
            ``ContinuousBatchingEngine(cfg, params)`` at the JAX engine's
            defaults (prefix caching, preemption with an unbounded
            ``SpillTier``, ``prefill_buckets=None``): four requests of a
            512-token shared prefix and 64-token suffixes in two waves
            against the cache off (hits, prefill tokens computed, TTFT,
            ``prefill_block`` only for the suffixes); a full batch at
            priority 0 and a priority-1 arrival (preempt, spill, restore
            byte for byte, synchronised seconds and bytes), again with
            ``SpillTier(capacity_bytes=0)`` (replay from the prefix), both
            against prefix caching and preemption off; a sampled request
            (temperature 0.8, top_k 50, top_p 0.9) alone and in a batch,
            the card's sampler against the CPU's over its logits rows and
            its time at B 4, V 32000; a 300-token cold prompt through the
            dense tier (no kernel of the library) against the bucketed
            fills.  Ids that differ between two runs are held, at their
            first differing token, to ``check_layer_out`` with the fp32
            plain chain over the same tokens as the truth;
4c. engine spec  speculative decoding: phase engine's settings and
            weights (llama_7b bf16, full depth, B 4, buckets (16, 64, 256),
            prefix caching and preemption off) under
            ``spec_config=SpecDecodeConfig(k=3, window=16)``, with a
            self-draft and a 2-layer llama_7b-width draft of another seed,
            four prompts of 20-300 tokens and 32 new tokens each, all
            queued before the first step so the speculative and baseline
            runs see the same admissions (no prefix hit, no eviction, no
            preemption: a prefix hit runs other kernels than a cold
            prompt and moves bf16 logits); then the self-draft on prompts
            whose whole context fits the window, and the draft's logits
            against the engine's prefill logits (the bf16 rule, the fp32
            plain chain as the truth); then at 4 layers with
            ``ServeQuantConfig(weight_dtype="int8", kv_dtype="int8")``
            (the verify runs ``wo_dec``, ``rope_kv_write_q8`` and
            ``paged_attention_q8``; the drafts stay full width).  Each run
            against the same engine without ``spec_config``: greedy ids
            identical, the first verify's column-0 logits bit-equal to the
            baseline step's, ``decode_block`` launches exactly layers x
            (K+1) a spec step; decode tokens/s both ways,
            ``engine_steps_per_token``, acceptance rate, draft ms a
            proposal and verify ms;
4d. engine graphs  the engine's programs as captured CUDA graphs (the
            decode step, the fixed-width sampler, the spec draft and
            verify; phases 4-4c run through them too) against the same
            engine's eager launch chain (``engine._set_eager``): llama_7b
            bf16 and int8 + int8 KV over 8 requests of 20-600 prompt
            tokens and 32 new, ids identical and the first step's logits
            bit-equal, the launch counts the eager run's plus the
            captures' warm-up calls exactly, decode step wall and busy and
            tokens/s both ways; the sampler's ids for 1-4 rows and its ms
            a call both ways; speculation with both drafts: ids and the
            first verify's column 0 equal, the pools unchanged byte for
            byte by the warm-up and capture of every program, draft and
            verify ms both ways, capture ms and the graph pool's memory;
            then ``aot.export_engine`` into a temporary directory and a
            child process (``chip_smoke.py --warm-child``) whose PATH and
            CUDA_HOME find no ``nvcc`` warm-starting from it: the
            artifact's library loaded, no ``nvcc`` run, the graphs
            captured at construction, the parent's ids served; a copy with
            one library byte flipped falls back (CRC) and serves them;
5. gpt serve  GPT-125M (``gpt_125m``, bf16, 12 layers, V 50304) served
            through ``decode_block`` / ``prefill_block`` (the GPT layer:
            LayerNorm with bias, fused qkv stored split per head, bias and
            GELU epilogues, no RoPE) by ``gpt_paged_rollout``: first its
            kernel modes alone at GPT-125M shapes against their plain
            versions (``layer_norm_rows`` at [4, 768] and [256, 768],
            ``gemm_xw`` with each bias epilogue at M 4 and 256, the qkv
            split, the unrotated ``rope_kv_write`` bit-equal, one GPT
            ``decode_block`` and ``prefill_block``, fp32 1e-4 and bf16 2e-2
            or the ratio rule) with bf16 times beside bounds, plain versions
            and library calls, the layer calls also device-paced; the
            chain's race check (its LayerNorms and the products after them
            run under programmatic dependent launch): 200 layer calls over
            two inputs in turns, queued back to back, decode and Ts 256,
            each bit-identical to the first on its input and that one
            within tolerance of the plain chain; then four prompts of 600
            / 37 / 300 / 517 tokens chunk-filled over buckets (16, 64, 256)
            in 16-token pages and 32 greedy new tokens each, launch counts
            exactly as
            predicted with the plain ops refused; the decode step's wall and
            busy ms, tokens/s and prefill ms per prompt; then at 2 layers the
            prefill and first decode step logits of the kernel path against
            the plain path on the card, held to an fp32 plain run;
6. gpt serve quant  the same model, weights and traffic PTQ-exported to
            ``ServeQuantConfig(weight_dtype="int8", kv_dtype="int8")`` (the
            JAX bench's ``int8_weights_int8_kv`` row in its GPT form): first
            the quantized GPT layer's kernel modes alone at GPT-125M shapes
            against their plain versions (``wo_layer_*`` with the bias
            epilogue and the qkv split, the bias and residual, the bias and
            GELU, at M 4 and 256 in int8 / int4 per channel and int4 g64,
            bf16 and the fp32 lane; the unrotated ``rope_kv_write_q8``
            bit-equal on random and hard rows; ``paged_attention_q8`` at D
            64 with one q head a kv head; quantized GPT ``decode_block`` /
            ``prefill_block``, device-paced too, and the race check of the
            int8 + int8 KV chain) with bf16 times beside bounds, plain
            versions and library calls;
            then the rollout with launch counts exactly as predicted and
            the plain ops refused, its decode step's wall and busy ms,
            tokens/s and prefill ms beside the bf16 phase's; then at 2
            layers int8 weights with int8 KV, int4 g64 weights and bf16
            weights with int8 KV, the prefill and first decode step logits
            of the kernel path against the plain path, held to an fp32
            plain run;
7. flash    the three flash-attention kernels (``flash_fwd``,
            ``flash_bwd_dq``, ``flash_bwd_dkv``) against their plain
            versions at the training slice's shape (B 4, S 2048, 32 heads,
            D 128, causal) in fp32 (tolerance 1e-4) and bf16 (2e-2, or the
            fp32-distance ratio rule below), and on small cases: GQA 32/8
            at D 64, non-causal, ragged S 1000, Sq != Sk (full and
            causal), segment ids, the two bias layouts, S 200 at D 64
            and 128 (off the 64-row tiles), causal GQA 32/4 (G 8), the
            encoder phase's shape (B 32, S 128, 12 heads, D 64, full) and
            the fused multi transformer's context (B 4, S 512, 16 heads,
            D 128, causal);
            kernel, plain, bound and ``scaled_dot_product_attention``
            times in bf16 (the backward kernels against SDPA's backward
            alone, and the whole ``flash_bwd_cuda`` call with its
            ``flash_delta`` share), again at the gpt phase's shape (B 8,
            S 1024, 12 heads, D 64, causal) and the bert phase's (B 32,
            S 128, 12 heads, D 64, full), and the forward's at the fused
            multi transformer context's, each forward beside SDPA's
            forward;
8. linear_ce the four linear-CE head kernels (``linear_ce_fwd``;
            ``linear_ce_dz``, ``linear_ce_dx``, ``linear_ce_dw`` per vocab
            slab of the backward) against their plain versions at the
            Llama head's shape (T 8192, H 4096, V 32000) in bf16 and fp32,
            at the GPT head's (T 8192, H 768, V 32768, fp32 x with a bf16
            head), and on small cases: ignore_index with T off the row
            tiles, label smoothing with an uneven last slab, bf16 at odd T
            1001, V 4097 and H 520 (off every edge of the bf16 kernels'
            tiles), bf16 at T 1000, slabs of 200 and H 200 (off the
            backward products' tiles), the [H, V] layout through the op; a
            second forward, dz and backward call bit-identical to the
            first; at the two fp32-x cases (the split route: x as bf16
            halves on wgmma) the pre-pass ``linear_ce_split_x`` bit-equal
            to its plain version, nll and lse within 1e-4 absolute, dz
            (its bf16 halves' sum) within 1e-4 |g| p + 136 x 2^-24 |dz|
            of the plain fp32 version, and the plain version on
            bf16-rounded x failing those checks; dw (three bf16 products
            on the halves of dz and x) within half a bf16 ulp of the
            plain fp32 dw plus an allowance, which the one-product
            version and each version without a cross term must fail;
            each kernel's profiled route (wgmma at the Llama head; fwd,
            dz and dw split, dx wgmma at the GPT head); kernel, plain,
            bound and dense-chain (``x @ w.T`` then ``F.cross_entropy``:
            forward, backward alone, forward + backward) times, and dw's
            beside one ``torch.matmul(dz.T, x)`` a slab;
9. train    ``llama_7b(num_layers=4)`` in bf16 trained by the one-device
            train step (remat, the fused linear-CE head of the config
            default): one warm step and 5 timed steps on one seeded batch
            of 4 x 2048 tokens, with finite and falling losses and the
            flash and linear-CE kernels' launch counts as predicted; then
            one step's loss and every gradient at 2 layers through the
            flash kernels against the dense attention path, and through
            the fused head against the dense head;
10. gpt      the JAX bench's GPT row (V 32768, H 768, 12 layers, 12 heads,
            bf16, no remat) trained by the one-device GPT step at batch
            8 x 1024: flash attention at head_dim 64 and the fused head
            (fp32 x from the fp32 final LayerNorm, bf16 tied wte), one
            warm and 5 timed steps, finite falling losses and launch
            counts as predicted;
11. decode_attn  the decode-attention kernel against its plain version at
            the generation step's shape (B 8, a 256-row cache, 32 heads,
            D 128, lengths ragged from 1 to 256) in fp32 (1e-4) and bf16
            (2e-2 or the ratio rule), and at GPT-125M's heads, GQA 32/8 at
            D 64, T 1000 (two 512-row blocks), length 1, T 2048 (four
            blocks) with a length-0 row, and G 8 at D 64; each call twice,
            bit-identical; kernel, plain, bound and
            ``scaled_dot_product_attention`` times warm (one cache, mostly
            L2-resident) and cold (``DATTN_COLD`` caches in rotation); then
            on the head-major view ``cache[0].transpose(1, 2)`` of an MMHA
            cache ``[2, 4, 16, 1024, 128]`` (lengths 1000 / 37 / 0 / 517)
            in fp32 and bf16, one launch a call, and at the fused multi
            transformer phase's decode shape (every length 576) the
            head-major and ``[B, T, H, D]`` layouts timed in turns, warm
            and cold, their outputs bit-equal, beside SDPA on the
            head-major cache;
12. quant_linear the weight-only int8 and int4 kernels against their plain
            versions at M 8 (decode) and M 1024 (prefill) on the three
            llama_7b weight shapes, per channel, bf16 and fp32 x, and on
            groups of 64 and 128, an odd K, M 1, 16, 17 and 1000, each
            decode call twice and bit-identical; times per llama_7b layer
            (its seven matmuls), plain, bound and cuBLAS on the
            dequantized bf16 weight, the bf16 rows' ratio to cuBLAS and
            share of the bound;
13. generate ``llama_7b`` at full width and depth (32 layers, seeded
            ``init_params``) through ``llama_generate`` at the JAX bench's
            decode row (B 8, prompt 128 from numpy seed 0, 128 new tokens,
            greedy) in bf16 and through ``quantize_llama_params`` in int8
            and int4, and GPT-125M (V 32768) through ``gpt_generate``: one
            warm and 3 timed rollouts each, tokens/s, ms a decode step, a
            profiled step's device-busy share, launch counts as predicted;
            then at 2 layers the prefill and first decode step logits of
            the kernel path against the plain path on the card, both held
            to an fp32 plain run;
14. norms   the eager path's kernels ``rms_norm_fwd``, ``layer_norm_fwd``,
            ``bias_residual_ln_fwd`` and ``swiglu_fwd`` against their
            plain versions in fp32 (1e-4) and bf16 (2e-2 or the ratio
            rule) at the eager steps' shapes (RMSNorm [8192, 4096],
            LayerNorms [8192, 768], SwiGLU [8192, 11008]) and on 3 rows,
            H 1000 and H 1001, one launch per call and a second call
            bit-identical, outputs and fp32 row statistics; kernel, plain, bound and library (``F.rms_norm``,
            ``F.layer_norm``, ``x + bias + residual`` then
            ``F.layer_norm``, ``F.silu(x) * y``) times in bf16;
15. eager   the eager ``GPTForCausalLM`` (the gpt phase's model: V 32768,
            12 layers, bf16, dropout 0, batch 8 x 1024) and
            ``LlamaForCausalLM`` (llama_7b x 4 layers, bf16, batch
            4 x 2048) through the dygraph loop ``loss = net(ids, labels);
            loss.backward(); opt.step(); opt.clear_grad()`` with
            ``AdamW(lr 1e-4)``: one warm and 5 timed steps, finite falling
            losses, step ms, tokens/s, peak memory and launch counts
            exactly as ``EAGER_*_PER_STEP`` predicts; then at 2 layers
            one step's loss and every gradient through the kernels against
            the same model's plain path, held to an fp32 run;
16. fused   the incubate fused API's kernels ``rope_fwd`` (forward and its
            sign -1 VJP), ``softmax_mask_fwd``, ``bias_act_fwd`` (every
            act) and ``dropout_add_fwd`` against their plain versions in
            fp32 (1e-4) and bf16 (2e-2 or the ratio rule) at the shapes of
            their callers (RoPE on llama_7b's q [4, 2048, 32, 128]; BERT-
            base's logits [32, 12, 128, 128] with a [32, 1, 128, 128]
            mask; the encoder's FFN [4096, 3072] and residual [4096, 768])
            and on small cases (D 6 and 2, S 1 / 7 / 300 / 1000 / 5000,
            H 1001); dropout-add in training at p 0.1 bit-equal to its
            plain version, its keep rate within 5 sigma of 1 - p and a new
            seed a new mask; kernel, plain, bound and library times in
            bf16; then each public call once with its launches counted;
17. encoder a BERT-base encoder built from 12
            ``FusedTransformerEncoderLayer(768, 12, 3072, gelu)`` in an
            ``nn.ModuleList``, bf16, on b 32 x s 128: post-LN eval (the
            timed main path), pre-LN eval and pre-LN train (dropout 0.1),
            2 warm and 10 timed forwards each with the launches exactly as
            ``ENC_MODES`` predicts, forward ms, tokens/s, peak memory and a
            profiled forward's device-busy share; then a 2-layer forward
            of each mode through the kernels against its plain path, held
            to an fp32 run;
18. fused multi transformer  ``FusedMultiTransformer(2048, 16, 8192,
            num_layers=24, activation="gelu", normalize_before=True)``
            (``gpt_1p3b``'s width and depth, D 128) in bf16 with seeded
            random weights (2.42 GB) through ``fused_multi_transformer``:
            one context call at B 4 x 512 tokens fills the head-major
            caches ``[2, 4, 16, 1024, 128]`` per layer (24 ``flash_fwd``
            launches), then 64 decode steps at time_step 512..575 (24
            ``decode_attention`` launches a step on the caches' head-major
            views), the launch counts exactly so and the plain attention
            versions refused, the returned caches the caller's tensors;
            context ms, decode step ms (wall) and tokens/s beside the
            step's bound, one profiled step's wall and busy ms and kernel
            3's ms a call against its bound; then at 2 layers and the
            main path's shapes (B 4 x 512 into 1024-row caches) the context
            output and 4 decode steps through the kernels against the
            plain path (bf16 2e-2 or the ratio rule to an fp32 plain run)
            and, in fp32 through the kernels, each decode step against the
            context forward over the same tokens (1e-4); one
            ``masked_multihead_attention`` call on a bf16 [2, 4, 16, 1024,
            128] cache (lengths 1000/37/0/517): one ``decode_attention``
            launch, the caller's cache returned, output and cache against
            the same call on the CPU (2e-2);
19. bert    BASELINE config 3: ``BertForSequenceClassification(
            bert_base(), 2)`` (hidden 768, 12 layers, 12 heads, FFN 3072,
            V 30522, seeded random weights) on b 32 x s 128 (ids, token
            types and labels from numpy seed 0) through the dygraph loop
            with ``AdamW(1e-3, weight_decay=0)``: the bench's fp32
            fine-tune with dropout 0.1 and no pad mask, the same in bf16,
            a bf16 fine-tune with both dropouts 0 (2 warm + 5 steps each),
            a bf16 eval without and with a pad mask (the last 32 tokens of
            every other row; 2 warm + 10 forwards each); the launches
            exactly as ``BERT_MODES`` predicts (flash only without a mask
            and without dropout, the JAX routing rule); step or forward
            ms, tokens/s, peak memory, the bound and a profiled call's
            device-busy share and device time by group; then at 2 layers
            the no-dropout bf16 step through the flash kernels against the
            plain path (loss 1e-4, grads rel L2 5e-2 or the ratio rule),
            the fp32 step with dropout 0 on the card against the CPU,
            without and with the pad mask (loss and grads within 1e-4),
            5 fp32 AdamW(2e-5) steps with a falling loss, and the padded bf16
            eval against the CPU (2e-2 or the ratio rule) with other ids
            under the pad moving no unpadded output by more than 1e-5.

Prints one JSON line of per-kernel numbers and, last, one JSON line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line; without a CUDA device it exits non-zero at once.
"""

import json
import math
import subprocess
import sys
import time

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}    # rtol = atol
BF16_SLACK = 1.5
# the library's launch counters (ops/cuda/layer.py KERNELS) that the
# bf16 engine's main path must bump; gemm_xw_f32 serves the fp32 checks
MAIN_PATH = ("decode_block", "prefill_block", "rms_norm_rows",
             "gemm_xw_small_m", "gemm_xw_tiled", "rope_kv_write",
             "paged_attention")
# (Ts, start) of the unbucketed chunk fills held against the plain version
# in phase kernels: a prompt of any length cold, or a suffix after 32 pages
ODD_CHUNKS = [(Ts, start) for start in (0, 512) for Ts in (1, 37, 300)]
# the training slice: flash launches per step of a 4-layer model under
# remat (forward, recomputed forward, dq, dk/dv per layer)
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_WARM, TRAIN_STEPS = 4, 4, 2048, 1, 5
FLASH_PER_STEP = {"flash_fwd": 2 * TRAIN_LAYERS,
                  "flash_bwd_dq": TRAIN_LAYERS,
                  "flash_bwd_dkv": TRAIN_LAYERS}
# the fused head's launches per step: one forward, and one dz, dx and dw
# launch per vocab slab of default_chunk(V) = 2048 columns (16 slabs for
# V 32000 and for V 32768)
LCE_SLABS = 16
LCE_PER_STEP = {"linear_ce_fwd": 1, "linear_ce_dz": LCE_SLABS,
                "linear_ce_dx": LCE_SLABS, "linear_ce_dw": LCE_SLABS}
# the GPT row of the JAX bench (bench.py --config gpt on an accelerator);
# its head takes fp32 x (the fp32 final LayerNorm) with the bf16 wte, so
# linear_ce_fwd_cuda and linear_ce_bwd_cuda each split x once
# (linear_ce_split_x: 2 a step; every bf16-x path launches it 0 times)
GPT_LAYERS, GPT_B, GPT_S = 12, 8, 1024
GPT_PER_STEP = {"flash_fwd": GPT_LAYERS, "flash_bwd_dq": GPT_LAYERS,
                "flash_bwd_dkv": GPT_LAYERS, **LCE_PER_STEP,
                "linear_ce_split_x": 2}
# a whole bf16 step through the flash kernels against the dense attention
# path: relative L2 distance of the loss and of every gradient leaf
STEP_REL_L2 = 5e-2


class SmokeFailure(Exception):
    pass


def info(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def max_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


def check_close(name, got, ref, tol):
    """Raise unless |got - ref| <= tol + tol * |ref| everywhere."""
    import torch
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        raise SmokeFailure(f"{name}: non-finite values")
    if not torch.isfinite(r).all():
        raise SmokeFailure(f"{name}: non-finite values in the reference")
    bad = (g - r).abs() > tol + tol * r.abs()
    err = max_err(g, r)
    if bool(bad.any()):
        raise SmokeFailure(f"{name}: {int(bad.sum())} values outside "
                           f"tolerance {tol} (max |err| {err:.3e})")
    return err


def check_layer_out(name, got, plain, truth, tol, ratios=None):
    """A bf16 layer output: within ``tol`` of the plain version, or else no
    further from ``truth`` (the plain version in fp32 on the same bf16
    inputs) than the bf16 plain version itself is.  The plain prefill
    version rounds the attention logits and probabilities to bf16 as the
    JAX reference does; the kernels keep them in fp32, so near the
    tolerance the fp32 result decides: the kernel passes when its largest
    distance from it is at most ``BF16_SLACK`` times the plain version's
    (both are bf16 chains; their errors are of one size, and the factor
    absorbs the spread of a maximum over ~1e5 values).  The ratio of the
    two distances is logged for every call and appended to ``ratios``."""
    import torch
    err = max_err(got, plain)
    g, p, t = got.float(), plain.float(), truth.float()
    if not torch.isfinite(g).all():
        raise SmokeFailure(f"{name}: non-finite values")
    if not (torch.isfinite(p).all() and torch.isfinite(t).all()):
        raise SmokeFailure(f"{name}: non-finite values in the reference")
    g_t, p_t = max_err(g, t), max_err(p, t)
    ratio = g_t / p_t if p_t > 0 else (1.0 if g_t == 0 else float("inf"))
    if ratios is not None:
        ratios.append(ratio)
    within = bool(((g - p).abs() <= tol + tol * p.abs()).all())
    info(f"{name}: max |kernel - plain| {err:.3e} (tol {tol}: "
         f"{'within' if within else 'exceeded'}); max |kernel - fp32| "
         f"{g_t:.3e}, max |plain - fp32| {p_t:.3e}, ratio {ratio:.3f}")
    if within:
        return err
    if g_t > BF16_SLACK * p_t:
        raise SmokeFailure(f"{name}: kernel is further from the fp32 result "
                           f"({g_t:.3e}) than {BF16_SLACK} x the bf16 plain "
                           f"version's distance ({p_t:.3e})")
    return err


# profiled passes :func:`time_ms` makes at most while none records a kernel
PROFILE_PASSES = 6


def time_ms(fn, iters, breakdown=None, per_launch=False):
    """Per-call times of ``fn`` on the card: ``(device_ms, call_ms)``.

    ``call_ms`` is the CUDA-event time of ``iters`` back-to-back calls,
    host launch overhead included.  ``device_ms`` is the kernel time
    ``torch.profiler`` records: the sum over kernels of their recorded
    time divided by ``iters``, from the better of two profiled passes
    (a pass can miss some kernel records; the pass with more records
    wins per kernel).  A pass that records no kernel at all is made
    again, up to ``PROFILE_PASSES`` passes; past that ``device_ms`` is
    ``call_ms``, and a line says so.
    ``breakdown``, a dict, receives ``{kernel: (mean ms per launch,
    launches per call)}``.  ``per_launch``: ``fn`` launches one kernel,
    and ``device_ms`` is that kernel's mean recorded time per launch
    (unaffected by missing records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    call_ms = s.elapsed_time(e) / iters
    best = {}                                  # kernel -> (count, total us)
    for npass in range(1, PROFILE_PASSES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us > 0 and ev.count > best.get(ev.key, (0, 0.0))[0]:
                best[ev.key] = (ev.count, us)
        if npass >= 2 and best:
            break
    if not best:
        info(f"time_ms: the profiler recorded no kernel in {PROFILE_PASSES} "
             f"passes; the CUDA-event time {call_ms:.6f} ms stands in for "
             f"the device time")
        return call_ms, call_ms
    if breakdown is not None:
        breakdown.update({k: (us / n / 1e3, n / iters)
                          for k, (n, us) in best.items()})
    if per_launch:
        device = sum(us / n for n, us in best.values()) / 1e3
    else:
        device = sum(us for _, us in best.values()) / iters / 1e3
    return device, call_ms


def chain_ms(breakdown, gemm, per=None):
    """Device ms of one layer call from the per-kernel mean launch times
    and the chain's launch counts (a Llama layer: 2 norms, 6 GEMMs of the
    regime's kernel ``gemm``: ``gemm_xw_small_m_tma`` at M <= 16, else
    ``gemm_xw_tiled_wg``; 1 RoPE/KV write, 1 attention; ``per`` another
    chain's {kernel name part: launches}; :func:`layer_launches` checks
    them against the library's counters), robust to missing profiler
    records.  A kernel with several instances in the call (the GEMMs'
    tiles, which the launch plan picks per shape) weighs each by its share
    of the recorded launches.  Raises when a kernel of the chain has no
    record or another GEMM kernel has one."""
    per = per or {"rms_norm_rows": 2, gemm: 6, "rope_kv_write": 1,
                  "paged_attention": 1}
    hits = {key: [] for key in per}
    for name, (mean, n) in breakdown.items():
        if "gemm" in name and gemm not in name:
            raise SmokeFailure(f"layer call ran GEMM kernel {name}, "
                               f"expected {gemm}")
        for key in per:
            if key in name:
                hits[key].append((mean, n))
                break
    missing = sorted(k for k, v in hits.items() if not v)
    if missing:
        raise SmokeFailure(f"layer call: no profiler record of {missing} in "
                           f"{sorted(breakdown)}")
    return sum(per[k] * sum(m * n for m, n in v) / sum(n for _, n in v)
               for k, v in hits.items())


def host_ms(fn, calls=30):
    """Median host time of one call of ``fn`` (enqueue only), the card
    idle before each."""
    import statistics
    import torch
    fn()
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * statistics.median(out)


def layer_launches(name, fn, norm="rms_norm_rows", gemms=6):
    """Run one layer call and check the library's launch counters for it
    against the chain :func:`chain_ms` assumes (a GPT layer:
    ``layer_norm_rows`` and 4 GEMMs)."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    layer.reset_counts()
    fn()
    torch.cuda.synchronize()
    got = {k: n for k, n in layer.launch_counts().items() if n}
    gemm = sum(n for k, n in got.items() if k.startswith("gemm_xw"))
    if gemm != gemms or {k: n for k, n in got.items()
                         if not k.startswith("gemm_xw")} != {
            name: 1, norm: 2, "rope_kv_write": 1, "paged_attention": 1}:
        raise SmokeFailure(f"{name}: one call launched {got}")
    return got


def paced_ms(fn, calls=40, repeats=3):
    """Device-paced ms a call of ``fn``: ``calls`` calls queued back to back
    behind a ``torch.cuda._sleep`` long enough for the host to queue them
    all, timed by CUDA events from the end of the sleep to the end of the
    last call (the median of ``repeats``): the card's time for the calls,
    the gaps between their kernels included and the host's enqueue left
    out, which a kernel launched under a programmatic dependency overlaps
    with the one ahead (the profiler's per-kernel times count such a
    kernel's wait as its own).  Raises when the host could not queue the
    calls inside the sleep."""
    import statistics
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(10 ** 7)
    e.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10 ** 7 / s.elapsed_time(e)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        for _try in range(3):
            sleep = 2.0 * host + 2.0
            torch.cuda._sleep(int(sleep * cycles_per_ms))
            s.record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            queued = 1e3 * (time.perf_counter() - t0)
            e.record()
            busy = not s.query()            # the sleep still running
            torch.cuda.synchronize()
            if busy:
                break
            host = max(host, queued)
        else:
            raise SmokeFailure(f"paced_ms: the host took {queued:.2f} ms to "
                               f"queue {calls} calls, past the sleep")
        out.append(s.elapsed_time(e) / calls)
    return statistics.median(out)


# calls of a layer chain in the race check (chain_race_check)
RACE_CALLS = 200


def chain_race_check(tag, run, inputs, refs, tol):
    """``run(x)`` (one layer call, returning its output) ``RACE_CALLS``
    times, the ``inputs`` in turns and no synchronisation between calls, so
    that each call's kernels queue right behind the last one's: every
    output bit-identical to the first on the same input, and that one held
    to its ``refs`` entry ``(plain, truth)`` by :func:`check_layer_out`.  A
    kernel that read an activation (or wrote) before the kernel ahead of it
    had finished would read the other input's values, left in the reused
    scratch."""
    import torch
    outs = [run(inputs[i % len(inputs)]) for i in range(RACE_CALLS)]
    torch.cuda.synchronize()
    for j, (plain, truth) in enumerate(refs):
        check_layer_out(f"{tag} race check input {j}", outs[j], plain, truth,
                        tol)
    bad = [i for i in range(RACE_CALLS)
           if not torch.equal(outs[i], outs[i % len(inputs)])]
    if bad:
        raise SmokeFailure(f"{tag}: calls {bad[:8]} of {RACE_CALLS} differ "
                           "from the first call on the same input")
    info(f"{tag}: {RACE_CALLS} calls over {len(inputs)} inputs in turns, "
         "queued back to back, bit-identical to the first call on each "
         f"input, within tolerance of the plain chain")


def one_launch_bitwise(name, fn):
    """``fn()`` twice: exactly one launch of kernel ``name`` each (the
    library's counters), the two results bit-identical; returns the
    first."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    outs = []
    for _ in range(2):
        layer.reset_counts()
        outs.append(fn())
        torch.cuda.synchronize()
        got = {k: n for k, n in layer.launch_counts().items() if n}
        if got != {name: 1}:
            raise SmokeFailure(f"{name}: one call launched {got}")
    if not all(torch.equal(a, b) for a, b in zip(
            *(o if isinstance(o, tuple) else (o,) for o in outs))):
        raise SmokeFailure(f"{name}: a second call differs from the first")
    return outs[0]


def short(breakdown):
    """Kernel breakdown with the template arguments cut, for the log."""
    out = {}
    for name, (mean, n) in breakdown.items():
        k = name.split("(")[0].replace("void pt::", "")
        out[k] = f"{mean:.4f} ms x {n:g}"
    return out


def bound_ms(nbytes, ops, dtype="bfloat16"):
    """Least time for the work: bytes over HBM rate vs ops over peak."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


# ---------------------------------------------------------------- phases
def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build():
    from paddle_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    secs = time.perf_counter() - t0
    info(f"build: {secs:.1f} s (nvcc, sm_90a, one process per source)")
    return secs


def make_layer(cfg, gen, dtype, dev, shapes=None):
    """One layer of ``shapes`` (default a Llama layer of ``cfg``): std-0.02
    normals for the matrices and biases, norm gains near 1."""
    import torch
    from paddle_tpu_torch.models.llama import block_shapes
    lp = {}
    for name, shape in (shapes or block_shapes(cfg)).items():
        t = torch.empty(shape, device=dev).normal_(0.0, 0.02,
                                                      generator=gen)
        if name.startswith("ln") and name.endswith("_w"):
            t = 1.0 + 5.0 * t
        lp[name] = t
    return {k: v.to(dtype).contiguous() for k, v in lp.items()}


def layer_bytes_ops(cfg, itemsize):
    """(bytes of a Llama layer's parameters, its matmul weights' count)."""
    from paddle_tpu_torch.models.llama import block_shapes
    shapes = block_shapes(cfg)
    n_w = sum(math.prod(s) for s in shapes.values())
    n_mm = sum(math.prod(s) for s in shapes.values() if len(s) == 2)
    return n_w * itemsize, n_mm


def rope_kv_cases(lengths, bt, bt_row, cos_t, sin_t, BS, chunks=(256,)):
    """{label: (rows, write-target keywords, cos rows, sin rows)} of
    rope_kv_write: the decode case (its lengths and table) and prefill
    chunks of ``chunks`` rows after 300 positions over ``bt_row``'s pages,
    every row writing (through blk / off).  ``cos_t`` / ``sin_t`` None (no
    RoPE): the rows are None."""
    import torch

    def rows(t, idx):
        return None if t is None else t[idx]
    dec = lengths.long()
    out = {"decode": (len(lengths), dict(block_table=bt, lengths=lengths),
                      rows(cos_t, dec), rows(sin_t, dec))}
    for Ts in chunks:
        pos = 300 + torch.arange(Ts, device=bt_row.device)
        out[f"prefill Ts {Ts}"] = (
            Ts, dict(block_table=bt_row, blk=bt_row[pos // BS].contiguous(),
                     off=(pos % BS).to(torch.int32)), rows(cos_t, pos),
            rows(sin_t, pos))
    return out


def rope_kv_inputs(M, Hq, Hkv, D, dt, gen, dev):
    """[q, k, v] rows of one rope_kv_write call."""
    import torch
    return [torch.randn(M, n * D, device=dev, generator=gen).to(dt)
            for n in (Hq, Hkv, Hkv)]


# the int8 pool's hard rows (q8_hard_rows), in turns
Q8_HARD_KINDS = ("tie", "tie near", "clip", "zero", "tiny", "floor")


def q8_hard_rows(rows, D, seed):
    """``rows`` head rows of ``D`` values (float32 numpy; bf16 values but in
    the "tie near" rows) that probe ``quantize_kv``'s arithmetic, one kind a row in
    the turns of ``Q8_HARD_KINDS``: "tie", quotients exactly on a
    half-integer (the absmax 127 2^e, so the scale is 2^e, and values (k +
    1/2) 2^e); "tie near", a full-width absmax and values RN((k + 1/2)
    scale) (exact ties where that product is exact, else a quotient within
    an ulp of one; in fp32 only, bf16 rounds them off); "clip", the absmax
    at both signs in several places, its quotient at 127 or just past it;
    "zero", all zero (the 1e-8 floor); "tiny", values far below the floor
    (1e-12 .. 1e-9, some 1e-30 and subnormal ones); "floor", an absmax
    just past 1e-8."""
    import numpy as np
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = np.zeros((rows, D), f32)

    def bf16(a):                    # round to the nearest bf16 value
        u = np.asarray(a, f32).view(np.uint32).astype(np.uint64)
        u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
        return u.astype(np.uint32).view(f32)
    for r in range(rows):
        kind = Q8_HARD_KINDS[r % len(Q8_HARD_KINDS)]
        if kind == "tie":
            e = int(rng.integers(-20, 8))
            k = rng.integers(-127, 127, D)
            row = ((k + 0.5) * 2.0 ** e).astype(f32)
            row[rng.integers(D)] = (127 if r % 2 else -127) * 2.0 ** e
        elif kind == "tie near":
            a = bf16(rng.uniform(1e-3, 30.0))
            sc = np.float32(a) / np.float32(127)
            k = rng.integers(-127, 127, D)
            row = ((k + 0.5).astype(f32) * sc).astype(f32)
            row[rng.integers(D)] = a
        elif kind == "clip":
            a = bf16(rng.uniform(0.5, 8.0))
            row = bf16(rng.uniform(-1, 1, D).astype(f32) * a)
            idx = rng.choice(D, 4, replace=False)
            row[idx[:2]], row[idx[2:]] = a, -a
        elif kind == "zero":
            row = np.zeros(D, f32)
        elif kind == "tiny":
            row = bf16(rng.standard_normal(D).astype(f32)
                       * f32(10.0 ** rng.uniform(-12, -9)))
            row[:4] = bf16(np.array([1e-30, -3e-30, 1e-39, -2e-40], f32))
        else:
            row = bf16(rng.uniform(-1, 1, D).astype(f32) * f32(1e-8))
            row[rng.integers(D)] = bf16(f32(1.02e-8))
        out[r] = row
    return out


def rope_q8_hard_inputs(M, Hq, Hkv, D, dt, seed, dev):
    """[q, k, v, cos, sin] of one rope_kv_write call whose k and v head
    rows are :func:`q8_hard_rows` (k's and v's their own), with cos 1 and
    sin 0 so that the rotation keeps k as it is; q random."""
    import torch
    k, v = (torch.from_numpy(q8_hard_rows(M * Hkv, D, seed + i)).reshape(
        M, Hkv * D).to(dev).to(dt) for i in range(2))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn(M, Hq * D, device=dev, generator=gen).to(dt)
    return [q, k, v, torch.ones(M, D, device=dev, dtype=dt),
            torch.zeros(M, D, device=dev, dtype=dt)]


def rope_kv_writes(tgt, pool):
    """Rows of one call whose pool write is kept."""
    from paddle_tpu_torch.ops.cuda import kernels as K
    NB, BS = pool.shape[:2]
    return int(K._targets(tgt["block_table"], tgt.get("lengths"),
                          tgt.get("blk"), tgt.get("off"), BS, NB)[2].sum())


def rope_kv_bytes_ops(M, Hq, Hkv, D, writes, itemsize=2):
    """Bytes and operations of one rope_kv_write call: q, k, v and the
    cos / sin rows read once, q and k written back, the k and v rows of the
    ``writes`` rows that keep their write stored into the pools; 3
    operations (two products, a sum) for each of the 2 outputs a pair."""
    return ((M * (Hq + 2 * Hkv) * D + 2 * M * D + M * (Hq + Hkv) * D
             + 2 * writes * Hkv * D) * itemsize, 6 * M * (Hq + Hkv) * D)


def check_rope_kv_bitwise(label, args, tgt):
    """rope_kv_write on copies of ``args`` ([q, k, v, cos, sin, pool_k,
    pool_v]) twice, one launch each, bit-identical, and bit-equal to
    ``rope_kv_write_ref`` (q and k roped, both pools)."""
    import torch
    from paddle_tpu_torch.ops.cuda import kernels as K
    q, k, v, c, s, pk, pv = args
    D = pk.shape[-1]

    def flat(ts):
        return torch.cat([t.flatten() for t in ts]).view(
            torch.int16 if q.dtype == torch.bfloat16 else torch.int32)

    def run():
        qq, kk, gk, gv = q.clone(), k.clone(), pk.clone(), pv.clone()
        K.rope_kv_write_cuda(qq, kk, v, c, s, gk, gv, **tgt)
        return flat((qq, kk, gk, gv))
    got = one_launch_bitwise("rope_kv_write", run)
    rk, rv = pk.clone(), pv.clone()
    rq, rkk = K.rope_kv_write_ref(q, k, v, c, s, rk, rv, head_dim=D, **tgt)
    ref = flat((rq, rkk, rk, rv))
    if not torch.equal(got, ref):
        n = int((got != ref).sum())
        raise SmokeFailure(f"{label}: {n} values differ from the plain "
                           "version (bit-equal required)")


def check_rope_q8_bitwise(label, q, k, v, c, s, pk, pv, tgt):
    """rope_kv_write into the int8 pools ``pk`` / ``pv`` (copies) twice,
    one ``rope_kv_write_q8`` launch each, bit-identical, and bit-equal to
    ``rope_kv_write_ref`` (q, k, codes and scales); ``c`` / ``s`` None: no
    rotation."""
    import torch
    from paddle_tpu_torch.ops.cuda import kernels as K
    D = pk.data.shape[-1]

    def run():
        qq, kk, gk, gv = q.clone(), k.clone(), q8_clone(pk), q8_clone(pv)
        K.rope_kv_write_cuda(qq, kk, v, c, s, gk, gv, **tgt)
        return tuple(bits(t) for t in (qq, kk, gk.data, gk.scale, gv.data,
                                       gv.scale))
    got = one_launch_bitwise("rope_kv_write_q8", run)
    rq, rk = q.clone(), k.clone()
    rpk, rpv = q8_clone(pk), q8_clone(pv)
    rq, rk = K.rope_kv_write_ref(rq, rk, v, c, s, rpk, rpv, head_dim=D,
                                 **tgt)
    ref = tuple(bits(t) for t in (rq, rk, rpk.data, rpk.scale, rpv.data,
                                  rpv.scale))
    for part, g_, r_ in zip(("q", "k", "k codes", "k scales", "v codes",
                             "v scales"), got, ref):
        if not torch.equal(g_, r_):
            raise SmokeFailure(
                f"{label}: {part} differs from the plain version in "
                f"{int((g_ != r_).sum())} values (bit-equal required)")


def serving_tables(perm, BS, MB):
    """The kernels phase's page tables from a page permutation: 4 decode
    slots of lengths 1000 / 37 / 0 (inactive: table all -1) / 517 with
    pages for one more token, and one prefill table row with pages for
    600 tokens.  Returns ``(lengths, bt, bt_row)``."""
    import torch
    dev = perm.device
    lengths = torch.tensor([1000, 37, 0, 517], dtype=torch.int32,
                           device=dev)
    bt = torch.full((4, MB), -1, dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lengths.tolist()):
        if b == 2:
            continue
        need = -(-(n + 1) // BS)
        bt[b, :need] = perm[used:used + need]
        used += need
    bt_row = torch.full((MB,), -1, dtype=torch.int32, device=dev)
    bt_row[:38] = perm[used:used + 38]
    return lengths, bt, bt_row


def _f32(t):
    return None if t is None else t.float()


def _f32_layer(lp):
    """A layer's weights in fp32, a quantized layer's codes and scales as
    they are."""
    return {k: (v if "__" in k else v.float()) for k, v in lp.items()}


def check_decode_layer(tag, spec, lp, pk0, pv0, x, bt, lengths, cos, sin,
                       tol, ratios):
    """One ``decode_block`` call on copies of the pools against
    ``decode_block_ref`` in x's dtype, held to the plain version in fp32
    (:func:`check_layer_out` for x, :func:`check_pool` for the pools, full
    width or int8); some pool row must change and none but the appended
    tokens' (a slot whose current page is unmapped writes nothing).
    Returns the largest error."""
    import torch
    from paddle_tpu_torch.ops import decode_block as db
    BS = spec.block_size
    rk, rv = pool_clone(pk0), pool_clone(pv0)
    ref = db.decode_block_ref(x, lp, rk, rv, bt, lengths, cos, sin,
                              spec=spec)
    gk, gv = pool_clone(pk0), pool_clone(pv0)
    got = db.decode_block(x, lp, gk, gv, bt, lengths, cos, sin, spec=spec)
    torch.cuda.synchronize()
    truth = db.decode_block_ref(
        x.float(), _f32_layer(lp), truth_pool(pk0), truth_pool(pv0), bt,
        lengths, _f32(cos), _f32(sin), spec=spec)[0]
    touched = {(int(bt[b, int(n) // BS]), int(n) % BS)
               for b, n in enumerate(lengths.tolist())
               if int(bt[b, int(n) // BS]) >= 0}
    e = [check_layer_out(f"{tag} x_out", got[0], ref[0], truth, tol,
                         ratios),
         check_pool(f"{tag} pool_k", gk, rk, pk0, touched, tol),
         check_pool(f"{tag} pool_v", gv, rv, pv0, touched, tol)]
    for name, g, o in (("pool_k", gk, pk0), ("pool_v", gv, pv0)):
        if not moved_rows(g, o):
            raise SmokeFailure(f"{tag}: no {name} row written")
    info(f"{tag} B={len(lengths)} lengths={lengths.tolist()}: max |err| x "
         f"{e[0]:.2e} pool_k {e[1]:.2e} pool_v {e[2]:.2e} (tol {tol})")
    return max(e)


def check_prefill_layer(tag, spec, lp, pk0, pv0, xp, start, valid, bt_row,
                        NB, cos_t, sin_t, tol, ratios):
    """One ``prefill_block`` chunk of ``xp``'s rows at ``start`` over
    ``bt_row``'s pages, the rows past ``valid`` a padded tail (page NB,
    dropped), as :func:`check_decode_layer` checks a decode call; the pool
    rows changed must be exactly the valid rows' (``cos_t`` / ``sin_t``
    tables, or None without RoPE).  Returns the largest error."""
    import torch
    from paddle_tpu_torch.ops import decode_block as db
    BS, Ts = spec.block_size, xp.shape[1]
    pos = start + torch.arange(Ts, device=xp.device)
    c, s = ((None, None) if cos_t is None else
            (t[pos].to(xp.dtype).contiguous() for t in (cos_t, sin_t)))
    blk = bt_row.clamp(min=0)[pos // BS]
    blk[valid:] = NB
    blk, off = blk.to(torch.int32), (pos % BS).to(torch.int32)
    rk, rv = pool_clone(pk0), pool_clone(pv0)
    ref = db.prefill_block_ref(xp, lp, rk, rv, blk, off, bt_row, c, s,
                               spec=spec, start=start)
    gk, gv = pool_clone(pk0), pool_clone(pv0)
    got = db.prefill_block(xp, lp, gk, gv, blk, off, bt_row, c, s,
                           spec=spec, start=start)
    torch.cuda.synchronize()
    truth = db.prefill_block_ref(
        xp.float(), _f32_layer(lp), truth_pool(pk0), truth_pool(pv0), blk,
        off, bt_row, _f32(c), _f32(s), spec=spec, start=start)[0]
    touched = {(int(blk[i]), int(off[i])) for i in range(valid)}
    e = [check_layer_out(f"{tag} x_out", got[0][:, :valid],
                         ref[0][:, :valid], truth[:, :valid], tol, ratios),
         check_pool(f"{tag} pool_k", gk, rk, pk0, touched, tol),
         check_pool(f"{tag} pool_v", gv, rv, pv0, touched, tol)]
    for name, g, o in (("pool_k", gk, pk0), ("pool_v", gv, pv0)):
        moved = moved_rows(g, o)
        if moved != touched:
            raise SmokeFailure(
                f"{tag}: {name} rows changed {sorted(moved - touched)[:5]} "
                f"/ missing {sorted(touched - moved)[:5]}")
    info(f"{tag} start={start} valid={valid}: max |err| x {e[0]:.2e} pool_k "
         f"{e[1]:.2e} pool_v {e[2]:.2e} (tol {tol})")
    return max(e)


def phase_kernels(cfg, results, dev="cuda"):
    """decode_block / prefill_block and their chain's kernels at 7B layer
    shapes against their plain versions; bf16 timings."""
    import torch
    from paddle_tpu_torch.models.llama import _rope_cos_sin
    from paddle_tpu_torch.ops import decode_block as db
    from paddle_tpu_torch.ops.cuda import kernels as K

    spec = db.decode_block_spec(cfg, 16)
    BS, NB, MB = 16, 256, cfg.max_position_embeddings // 16
    Hkv, D, Hq, H = cfg.kv_heads, cfg.head_dim, cfg.num_heads, cfg.hidden_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    perm = torch.randperm(NB, device=dev, generator=gen).to(torch.int32)
    lp32 = make_layer(cfg, gen, torch.float32, dev)
    pool32 = [torch.randn(NB, BS, Hkv, D, device=dev, generator=gen)
              for _ in range(2)]
    cos_t, sin_t = _rope_cos_sin(cfg.max_position_embeddings, D,
                                 cfg.rope_theta, torch.float32,
                                 device=dev)

    lengths, bt, bt_row = serving_tables(perm, BS, MB)
    x32 = torch.randn(4, H, device=dev, generator=gen)
    pre_cases = [(16, 37, 16), (16, 5, 11), (64, 21, 40), (256, 300, 200)]
    xs = {Ts: torch.randn(1, Ts, H, device=dev, generator=gen)
          for Ts, _, _ in pre_cases}
    # the engine's unbucketed fills: one chunk of any length from a page
    # boundary, over pages of their own (the table's last 52 pages)
    bt_odd = torch.full((MB,), -1, dtype=torch.int32, device=dev)
    bt_odd[:52] = perm[-52:]
    xo = {Ts: torch.randn(1, Ts, H, device=dev, generator=gen)
          for Ts, _ in ODD_CHUNKS}

    kernel_err, ratios = {}, {}
    for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        lp = {k: v.to(dt) for k, v in lp32.items()}
        pk0, pv0 = (p.to(dt) for p in pool32)
        cos = cos_t[lengths.long()].to(dt).contiguous()
        sin = sin_t[lengths.long()].to(dt).contiguous()
        kernel_err[("decode_block", dtn)] = check_decode_layer(
            f"decode_block {dtn}", spec, lp, pk0, pv0, x32.to(dt), bt,
            lengths, cos, sin, TOL[dtn],
            ratios.setdefault(("decode_block", dtn), []))
        for Ts, start, valid in pre_cases:
            key = ("prefill_block", dtn)
            e = check_prefill_layer(
                f"prefill_block {dtn} Ts={Ts}", spec, lp, pk0, pv0,
                xs[Ts].to(dt), start, valid, bt_row, NB, cos_t, sin_t,
                TOL[dtn], ratios.setdefault(key, []))
            kernel_err[key] = max(kernel_err.get(key, 0.0), e)
        for Ts, start in ODD_CHUNKS:
            key = ("prefill_block", dtn)
            e = check_prefill_layer(
                f"prefill_block {dtn} unbucketed Ts={Ts}", spec, lp, pk0,
                pv0, xo[Ts].to(dt), start, Ts, bt_odd, NB, cos_t, sin_t,
                TOL[dtn], ratios.setdefault(key, []))
            kernel_err[key] = max(kernel_err.get(key, 0.0), e)

    # ---- bf16 timings of the two ops at the main path's shapes
    dt = torch.bfloat16
    lp = {k: v.to(dt) for k, v in lp32.items()}
    pk, pv = (p.to(dt) for p in pool32)
    x = x32.to(dt)
    cos = cos_t[lengths.long()].to(dt).contiguous()
    sin = sin_t[lengths.long()].to(dt).contiguous()
    wbytes, n_mm = layer_bytes_ops(cfg, 2)
    kv_row = Hkv * D * 2 * 2                      # k and v, bf16
    live = [int(n) + 1 for n in lengths.tolist()]  # positions read per row
    dec_bytes = (wbytes + sum(live) * kv_row + 3 * kv_row
                 + 2 * 4 * H * 2 + 2 * 4 * D * 2)
    dec_ops = 2 * 4 * n_mm + 4 * Hq * D * sum(live)
    dec_by = {}
    layer_launches("decode_block", lambda: db.decode_block(
        x, lp, pk, pv, bt, lengths, cos, sin, spec=spec))
    _, call = time_ms(lambda: db.decode_block(
        x, lp, pk, pv, bt, lengths, cos, sin, spec=spec), 20, dec_by)
    ms = chain_ms(dec_by, "gemm_xw_small_m_tma")
    paced = paced_ms(lambda: db.decode_block(
        x, lp, pk, pv, bt, lengths, cos, sin, spec=spec))
    host = host_ms(lambda: db.decode_block(
        x, lp, pk, pv, bt, lengths, cos, sin, spec=spec))
    plain, plain_call = time_ms(lambda: db.decode_block_ref(
        x, lp, pk, pv, bt, lengths, cos, sin, spec=spec), 5)
    bms, bby = bound_ms(dec_bytes, dec_ops)
    results.append(dict(
        name="decode_block", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/layer.cu",
        replaces="paddle_tpu/ops/pallas/decode_block.py:535",
        shape="llama_7b layer, B=4, lengths 1000/37/0(inactive)/517",
        max_abs_err=kernel_err[("decode_block", "bfloat16")], ms=ms,
        call_ms=call, paced_ms=paced, host_ms=host, plain_ms=plain,
        plain_call_ms=plain_call, bound_ms=bms, bound_by=bby,
        library_ms=None,
        bf16_vs_fp32_ratio=max(ratios[("decode_block", "bfloat16")])))
    info(f"decode_block bf16: device {ms:.4f} ms (device-paced {paced:.4f} "
         f"ms a call back to back; per call {call:.4f} ms, "
         f"call - device {call - ms:.4f} ms; host enqueue of one call, "
         f"median of 30: {host:.4f} ms), plain device {plain} ms (per call "
         f"{plain_call:.4f} ms), bound {bms:.4f} ms ({bby}); kernels "
         f"{short(dec_by)}")
    def prefill_times(xp, start, valid, row):
        """bf16 device / per-call / plain times and the bound of one
        ``prefill_block`` call of ``xp``'s rows at ``start`` over the
        table row ``row``, the rows past ``valid`` padded."""
        Ts = xp.shape[1]
        pos = start + torch.arange(Ts, device=dev)
        c, s = (t[pos].to(dt).contiguous() for t in (cos_t, sin_t))
        blk = row.clamp(min=0)[pos // BS]
        blk[valid:] = NB
        blk, off = blk.to(torch.int32), (pos % BS).to(torch.int32)
        n_read = start + Ts
        pre_bytes = (wbytes + n_read * kv_row + valid * kv_row
                     + 2 * Ts * H * 2 + 2 * Ts * D * 2)
        pre_ops = 2 * Ts * n_mm + 4 * Hq * D * sum(
            start + i + 1 for i in range(Ts))
        pre_by = {}
        layer_launches("prefill_block", lambda: db.prefill_block(
            xp, lp, pk, pv, blk, off, row, c, s, spec=spec, start=start))
        _, call = time_ms(lambda: db.prefill_block(
            xp, lp, pk, pv, blk, off, row, c, s, spec=spec,
            start=start), 10, pre_by)
        ms = chain_ms(pre_by, "gemm_xw_small_m_tma" if Ts <= 16
                      else "gemm_xw_tiled_wg")
        paced = paced_ms(lambda: db.prefill_block(
            xp, lp, pk, pv, blk, off, row, c, s, spec=spec, start=start),
            calls=20) if Ts == 256 else None
        plain, plain_call = time_ms(lambda: db.prefill_block_ref(
            xp, lp, pk, pv, blk, off, row, c, s, spec=spec,
            start=start), 3)
        bms, bby = bound_ms(pre_bytes, pre_ops)
        info(f"prefill_block bf16 Ts={Ts} start={start} valid={valid}: "
             f"device {ms:.4f} ms (device-paced {paced}; per call "
             f"{call:.4f} ms), plain device "
             f"{plain} ms (per call {plain_call:.4f} ms), bound {bms:.4f} ms "
             f"({bby}); kernels {short(pre_by)}")
        return ms, call, paced, plain, plain_call, bms, bby

    for Ts, start, valid in pre_cases:
        ms, call, paced, plain, plain_call, bms, bby = prefill_times(
            xs[Ts].to(dt), start, valid, bt_row)
        if Ts == 256:
            results.append(dict(
                name="prefill_block", route="cuda",
                source="paddle_tpu_torch/kernels/csrc/layer.cu",
                replaces="paddle_tpu/ops/pallas/prefill_block.py:435",
                shape="llama_7b layer, Ts=256, start=300, valid=200",
                max_abs_err=kernel_err[("prefill_block", "bfloat16")],
                ms=ms, call_ms=call, paced_ms=paced, plain_ms=plain,
                plain_call_ms=plain_call, bound_ms=bms, bound_by=bby,
                library_ms=None, bf16_vs_fp32_ratio=max(
                    ratios[("prefill_block", "bfloat16")])))
    unbucketed = []
    for Ts, start in ODD_CHUNKS:
        ms, call, _, plain, plain_call, bms, bby = prefill_times(
            xo[Ts].to(dt), start, Ts, bt_odd)
        unbucketed.append(dict(Ts=Ts, start=start, ms=ms, call_ms=call,
                               plain_ms=plain, bound_ms=bms, bound_by=bby))
    next(r for r in results if r["name"] == "prefill_block")[
        "unbucketed_chunks"] = unbucketed

    # ---- the chain's kernels one at a time, bf16, decode shapes (B=4)
    tol = TOL["bfloat16"]
    norm = {}
    for M in (4, 256):                  # decode rows, one prefill chunk
        xm = x if M == 4 else torch.randn(M, H, device=dev,
                                          generator=gen).to(dt)
        y = K.rms_norm_rows_ref(xm, lp["ln1_w"], spec.eps)
        err = check_close(f"rms_norm_rows M={M}", K.rms_norm_rows_cuda(
            xm, lp["ln1_w"], spec.eps), y, tol)
        ms, call = time_ms(lambda: K.rms_norm_rows_cuda(xm, lp["ln1_w"],
                                                        spec.eps), 50,
                           per_launch=True)
        plain, plain_call = time_ms(lambda: K.rms_norm_rows_ref(
            xm, lp["ln1_w"], spec.eps), 20)
        lib = None
        if hasattr(torch.nn.functional, "rms_norm"):
            lib = time_ms(lambda: torch.nn.functional.rms_norm(
                xm, (H,), lp["ln1_w"], spec.eps), 50)[0]
        bms, bby = bound_ms((2 * M * H + H) * 2, 4 * M * H)
        norm[M] = dict(max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain,
                       plain_call_ms=plain_call, bound_ms=bms, bound_by=bby,
                       library_ms=lib)
        info(f"rms_norm_rows bf16 [{M}, {H}]: device {ms} ms (per call "
             f"{call:.4f}), F.rms_norm {lib} ms, plain {plain} ms, bound "
             f"{bms:.5f} ms ({bby}); max |err| {err:.2e}")
    results.append(dict(
        name="rms_norm_rows", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/rms_norm.cu",
        replaces="paddle_tpu/ops/pallas/decode_block.py:535",
        shape="[4, 4096]", **norm[4],
        m256={"shape": "[256, 4096]", **norm[256]}))

    for M in (4, 16, 64, 256):
        xm = torch.randn(M, H, device=dev, generator=gen).to(dt)
        for wname, epi in (("q_w", "none"), ("down_w", "none"),
                           ("gate_w", "swiglu"), ("down_w", "resid")):
            w = lp[wname]
            Kd, N = w.shape
            a = xm if Kd == H else torch.randn(
                M, Kd, device=dev, generator=gen).to(dt)
            kw = {"w2": lp["up_w"]} if epi == "swiglu" else \
                {"residual": torch.randn(M, N, device=dev,
                                         generator=gen).to(dt)} \
                if epi == "resid" else {}
            err = check_close(f"gemm_xw M={M} {wname} {epi}",
                              K.gemm_xw_cuda(a, w, **kw),
                              K.gemm_xw_ref(a, w, **kw), tol)
            ms, call = time_ms(lambda: K.gemm_xw_cuda(a, w, **kw), 20,
                               per_launch=True)
            plain, plain_call = time_ms(lambda: K.gemm_xw_ref(a, w, **kw), 20)
            lib = time_ms(lambda: torch.matmul(a, w), 20,
                          per_launch=True)[0] \
                if epi == "none" else None
            nw = 2 if epi == "swiglu" else 1
            bms, bby = bound_ms((M * Kd + nw * Kd * N + M * N
                                 + (M * N if epi == "resid" else 0)) * 2,
                                2 * nw * M * Kd * N)
            info(f"gemm_xw M={M} [{Kd}x{N}] {epi}: device {ms} ms (per call "
                 f"{call:.4f}), plain {plain} ms, torch.matmul {lib} ms, "
                 f"bound {bms:.4f} ms ({bby}), max |err| {err:.2e}")
            if epi == "none" and wname == "down_w" and M in (4, 256):
                # 90 MB of weights: more than the 50 MB L2, so repeated
                # calls read them from device memory as the engine does
                results.append(dict(
                    name="gemm_xw_small_m" if M <= 16 else "gemm_xw_tiled",
                    route="cuda",
                    source="paddle_tpu_torch/kernels/csrc/gemm.cu",
                    replaces="paddle_tpu/ops/pallas/decode_block.py:535"
                    if M <= 16 else
                    "paddle_tpu/ops/pallas/prefill_block.py:435",
                    shape=f"[{M}, 11008] @ [11008, 4096] (down proj, no "
                          "epilogue)",
                    max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain,
                    plain_call_ms=plain_call, bound_ms=bms, bound_by=bby,
                    library_ms=lib))

    # the fp32 GEMM (gemm_xw_f32: the fp32 checks of the chain; no bf16
    # main path launches it) at the decode shape of the down projection
    w32 = lp["down_w"].float()
    Kd, N = w32.shape
    a32 = torch.randn(4, Kd, device=dev, generator=gen)
    err = check_close("gemm_xw fp32 M=4 down_w", K.gemm_xw_cuda(a32, w32),
                      K.gemm_xw_ref(a32, w32), TOL["float32"])
    ms, call = time_ms(lambda: K.gemm_xw_cuda(a32, w32), 20, per_launch=True)
    plain, plain_call = time_ms(lambda: K.gemm_xw_ref(a32, w32), 20)
    lib = time_ms(lambda: torch.matmul(a32, w32), 20, per_launch=True)[0]
    bms, bby = bound_ms((4 * Kd + Kd * N + 4 * N) * 4, 2 * 4 * Kd * N,
                        dtype="float32")
    results.append(dict(
        name="gemm_xw_f32", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/gemm.cu",
        replaces="paddle_tpu/ops/pallas/decode_block.py:535",
        shape="[4, 11008] @ [11008, 4096] fp32 (down proj, no epilogue)",
        max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain,
        plain_call_ms=plain_call, bound_ms=bms, bound_by=bby,
        library_ms=lib))
    info(f"gemm_xw fp32 M=4 [{Kd}x{N}]: device {ms} ms (per call "
         f"{call:.4f}), plain {plain} ms, torch.matmul {lib} ms, bound "
         f"{bms:.4f} ms ({bby}), max |err| {err:.2e}")

    q = torch.randn(4, Hq * D, device=dev, generator=gen).to(dt)
    k = torch.randn(4, Hkv * D, device=dev, generator=gen).to(dt)
    v = torch.randn(4, Hkv * D, device=dev, generator=gen).to(dt)
    rk, rv = pk.clone(), pv.clone()
    rq, _ = K.rope_kv_write_ref(q, k, v, cos, sin, rk, rv, head_dim=D,
                                block_table=bt, lengths=lengths)
    # rope_kv_write equals its plain version bit for bit (the fp32 kernel
    # never contracts a product into an FMA): the decode case and a
    # prefill chunk (Ts 256 after 300 positions, every row writing through
    # blk / off), in fp32 and bf16; inputs from a generator of their own
    rope_cases = rope_kv_cases(lengths, bt, bt_row, cos_t, sin_t, BS)
    rgen = torch.Generator(device=dev)
    rgen.manual_seed(SEED + 1)
    rope_in = {}
    for dtn in ("float32", "bfloat16"):
        rdt = getattr(torch, dtn)
        for label, (M, tgt, c, s) in rope_cases.items():
            args = rope_kv_inputs(M, Hq, Hkv, D, rdt, rgen, dev) + [
                c.to(rdt), s.to(rdt)] + [pool.to(rdt) for pool in pool32]
            check_rope_kv_bitwise(f"rope_kv_write {label} {dtn}", args, tgt)
            rope_in[(label, dtn)] = args
    info(f"rope_kv_write: {', '.join(rope_cases)} in fp32 and bf16 "
         "bit-equal to the plain version, one launch a call, calls "
         "bit-identical")
    rope = {}
    for label, (M, tgt, _, _) in rope_cases.items():
        q_, k_, v_, c_, s_, gk, gv = rope_in[(label, "bfloat16")]
        ms, call = time_ms(lambda: K.rope_kv_write_cuda(
            q_, k_, v_, c_, s_, gk, gv, **tgt), 50, per_launch=True)
        plain, plain_call = time_ms(lambda: K.rope_kv_write_ref(
            q_, k_, v_, c_, s_, gk, gv, head_dim=D, **tgt), 20)
        bms, bby = bound_ms(*rope_kv_bytes_ops(M, Hq, Hkv, D,
                                                rope_kv_writes(tgt, gk)))
        rope[label] = dict(max_abs_err=0.0, ms=ms, call_ms=call,
                           plain_ms=plain, plain_call_ms=plain_call,
                           bound_ms=bms, bound_by=bby, library_ms=None)
    results.append(dict(
        name="rope_kv_write", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/rope_kv.cu",
        replaces="paddle_tpu/ops/pallas/decode_block.py:535",
        shape="B=4, 32 q + 32 kv heads, D=128", **rope["decode"],
        prefill=dict(shape="Ts=256 after 300 positions, every row writing",
                     replaces="paddle_tpu/ops/pallas/prefill_block.py:435",
                     **rope["prefill Ts 256"])))
    rp = rope["prefill Ts 256"]
    info(f"rope_kv_write prefill Ts=256: device {rp['ms']} ms (per call "
         f"{rp['call_ms']:.4f}), plain {rp['plain_ms']} ms, bound "
         f"{rp['bound_ms']:.5f} ms ({rp['bound_by']})")

    # paged attention alone: the decode case, then one prefill chunk (Ts
    # 256 after 300 positions) over bt_row; each call once more,
    # bit-identical, one launch each; the library yardstick is one SDPA
    # call on the same K / V gathered beforehand into contiguous tensors
    # (the gather not timed), with a boolean mask of the live positions
    def attn(**kw):
        return one_launch_bitwise("paged_attention", lambda:
                                  K.paged_attention_cuda(rq, rk, rv, **kw))

    def gathered(table, n):
        """K / V of `table`'s first n positions, [rows, Hkv, n, D]."""
        idx = table.long().clamp(min=0)[:, :-(-n // BS)]
        return [pool[idx].flatten(1, 2)[:, :n].transpose(1, 2).contiguous()
                for pool in (rk, rv)]

    sdpa = torch.nn.functional.scaled_dot_product_attention
    att_ref = K.paged_attention_ref(rq, rk, rv, block_table=bt,
                                    lengths=lengths)
    err = check_close("paged_attention", attn(block_table=bt,
                                              lengths=lengths), att_ref, tol)
    ms, call = time_ms(lambda: K.paged_attention_cuda(
        rq, rk, rv, block_table=bt, lengths=lengths), 50, per_launch=True)
    plain, plain_call = time_ms(lambda: K.paged_attention_ref(
        rq, rk, rv, block_table=bt, lengths=lengths), 10)
    kd, vd = gathered(bt, max(live))
    dmask = (torch.arange(max(live), device=dev)[None]
             <= lengths.long()[:, None])[:, None, None]
    qd = rq.reshape(4, Hq, 1, D)
    lib = time_ms(lambda: sdpa(qd, kd, vd, attn_mask=dmask), 50)[0]
    bms, bby = bound_ms(sum(live) * kv_row + 2 * 4 * Hq * D * 2,
                        4 * Hq * D * sum(live))
    # prefill: every row of the chunk is computed (valid only bounds the
    # rows the engine keeps), positions start + r over one table row
    Ts, start = 256, 300
    qp = torch.randn(Ts, Hq * D, device=dev, generator=gen).to(dt)
    pre_kw = dict(block_table=bt_row, start=start)
    pre_plain = K.paged_attention_ref(qp, rk, rv, **pre_kw)
    pre_got = one_launch_bitwise("paged_attention", lambda:
                                 K.paged_attention_cuda(qp, rk, rv,
                                                        **pre_kw))
    pre_err = check_layer_out(
        "paged_attention prefill", pre_got, pre_plain,
        K.paged_attention_ref(qp.float(), rk.float(), rv.float(), **pre_kw),
        tol)
    pre_ms, pre_call = time_ms(lambda: K.paged_attention_cuda(
        qp, rk, rv, **pre_kw), 50, per_launch=True)
    pre_plain_ms, pre_plain_call = time_ms(lambda: K.paged_attention_ref(
        qp, rk, rv, **pre_kw), 10)
    kp, vp = gathered(bt_row[None], start + Ts)
    pmask = (torch.arange(start + Ts, device=dev)[None]
             <= start + torch.arange(Ts, device=dev)[:, None])
    qpp = qp.reshape(1, Ts, Hq, D).transpose(1, 2)
    pre_lib = time_ms(lambda: sdpa(qpp, kp, vp, attn_mask=pmask), 50)[0]
    pre_bms, pre_bby = bound_ms(
        (start + Ts) * kv_row + 2 * Ts * Hq * D * 2,
        4 * Hq * D * sum(start + r + 1 for r in range(Ts)))
    library_what = ("scaled_dot_product_attention on K / V gathered "
                    "beforehand into contiguous [rows, Hkv, T, D] (gather "
                    "not timed), boolean mask of the live positions")
    results.append(dict(
        name="paged_attention", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        replaces="paddle_tpu/ops/pallas/decode_block.py:535",
        shape="B=4, lengths 1000/37/0/517 (+1 appended), 32 heads, D=128",
        max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain,
        plain_call_ms=plain_call, bound_ms=bms, bound_by=bby,
        library_ms=lib, library_what=library_what,
        prefill=dict(
            shape=f"Ts={Ts}, start={start}, 32 heads, D=128 (one table "
                  "row)", replaces="paddle_tpu/ops/pallas/"
                                   "prefill_block.py:435",
            max_abs_err=pre_err, ms=pre_ms, call_ms=pre_call,
            plain_ms=pre_plain_ms, plain_call_ms=pre_plain_call,
            bound_ms=pre_bms, bound_by=pre_bby, library_ms=pre_lib)))
    info(f"paged_attention prefill Ts={Ts} start={start}: device {pre_ms} "
         f"ms (per call {pre_call:.4f}), plain {pre_plain_ms} ms, library "
         f"{pre_lib} ms, bound {pre_bms:.4f} ms ({pre_bby}), max |err| "
         f"{pre_err:.2e}")
    quant_chain(cfg, results, lp32, pool32, bt, lengths, bt_row, cos_t, sin_t,
                dev)
    for r in results[2:]:
        info(f"{r['name']} {r['shape']}: device {r['ms']} ms (per call "
             f"{r['call_ms']:.4f}), plain {r['plain_ms']} ms, library "
             f"{r['library_ms']}, bound {r['bound_ms']:.4f} ms "
             f"({r['bound_by']}), max |err| {r['max_abs_err']:.2e}")


# ------------------------------------------------ quantized serving chain
# the JAX bench's int8_weights_int8_kv serve_quant row (bench.py:731-776)
ENGINE_QUANT = dict(weight_dtype="int8", kv_dtype="int8")
# a quantized layer's seven GEMMs and their epilogues: q / k / v none, o and
# down the residual, gate none, up silu(gate) x up
QUANT_MATMULS = (("q_w", "none"), ("k_w", "none"), ("v_w", "none"),
                 ("o_w", "resid"), ("gate_w", "none"), ("up_w", "swiglu"),
                 ("down_w", "resid"))
WO_LAYER = ("wo_layer_int8_small_m", "wo_layer_int8_tiled",
            "wo_layer_int4_small_m", "wo_layer_int4_tiled", "wo_layer_f32")
QUANT_REPLACES = "paddle_tpu/ops/pallas/decode_block.py:535"
QUANT_PRE_REPLACES = "paddle_tpu/ops/pallas/prefill_block.py:435"


def export_layer(lp, width, gs):
    """One layer's weights through the engine's PTQ export (codes and fp32
    scales for the seven matmuls; the norm gains as they are)."""
    from paddle_tpu_torch.quantization import (ServeQuantConfig,
                                               quantize_params_for_serving)
    if width is None:
        return dict(lp)
    out = quantize_params_for_serving(
        {"blocks": {k: v[None] for k, v in lp.items()}},
        ServeQuantConfig(width, gs))["blocks"]
    return {k: v[0] for k, v in out.items()}


def wo_name(width, M, dt):
    import torch
    if dt == torch.float32:
        return "wo_layer_f32"
    return f"wo_layer_{width}_{'small_m' if M <= 16 else 'tiled'}"


def wo_epi_kw(epi, M, N, gen, dev, dt):
    import torch
    if epi == "none":
        return {}
    t = torch.randn(M, N, device=dev, generator=gen).to(dt)
    return {"residual": t} if epi == "resid" else {"gate": t}


def wo_plan(M, K, N, width, gs, lib=None):
    """The launch plan of a bf16 weight-only call from the library
    (``pt_wo_plan``; ``lib`` another loaded build; M <= 16, the decode
    body's, only from a build that plans it): ``{"bm": x rows a tile,
    "splits": K splits (the cluster), "row_tiles", "col_tiles", "k_steps",
    "resident": clusters of the shape the card keeps resident, "smem",
    "blocks_per_sm"}``, or None for a build without the entry point."""
    import ctypes
    from paddle_tpu_torch.kernels import build
    fn = getattr(lib or build.library(), "pt_wo_plan", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.POINTER(build.WoArgs),
                   ctypes.POINTER(ctypes.c_int)]
    half = -(-K // 2) if width == "int4" else 0
    a = build.WoArgs(int4=int(width == "int4"), x_dtype=build.PT_BF16, M=M,
                     K=K, N=N, half=half, ldx=K, xhi=half,
                     gs=(1 << 30) if gs == -1 else gs,
                     G=1 if gs == -1 else -(-K // gs), tile_dq=0)
    out = (ctypes.c_int * 8)()
    build.check(fn(ctypes.byref(a), out), "pt_wo_plan")
    return dict(zip(("bm", "splits", "row_tiles", "col_tiles", "k_steps",
                     "resident", "smem", "blocks_per_sm"), out))


def gemm_plan(M, K, N, epi, lib=None):
    """The launch plan of a bf16 ``gemm_xw`` call from the library
    (``pt_gemm_xw_plan``; ``lib`` another loaded build; ``epi`` a
    ``build.EPI_*``): ``{"nx": x rows a tile, "blocks_per_sm", "splits": K
    splits (the cluster), "row_tiles", "col_tiles", "k_steps", "resident":
    clusters of the shape the card keeps resident, "w_columns": W columns
    a tile}``."""
    import ctypes
    from paddle_tpu_torch.kernels import build
    fn = (lib or build.library()).pt_gemm_xw_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    build.check(fn(M, K, N, epi, out), "pt_gemm_xw_plan")
    return dict(zip(("nx", "blocks_per_sm", "splits", "row_tiles",
                     "col_tiles", "k_steps", "resident", "w_columns"), out))


def plan_text(p):
    """One launch plan (:func:`gemm_plan` or :func:`wo_plan`) in a line:
    the tile, blocks an SM, K splits, the grid's tiles."""
    rows = p.get("nx", p.get("bm"))
    cols = p.get("w_columns", 128)
    return (f"{rows} x rows x {cols} columns a tile, {p['blocks_per_sm']} "
            f"an SM, {p['splits']} K splits, {p['row_tiles']} x "
            f"{p['col_tiles']} tiles")


def wo_layer_bytes_ops(M, shapes, width, gs, itemsize=2):
    """One quantized layer's seven GEMMs: x read once a GEMM, y written
    once, the codes and fp32 scales read once, the residual (o, down) and
    the gate (up) read once; 2 M K N operations each."""
    nbytes = ops = 0
    for (K, N), epi in shapes:
        codes = K * N if width == "int8" else K // 2 * N
        scales = 4 * N * (1 if gs == -1 else -(-K // gs))
        extra = M * N * itemsize if epi != "none" else 0
        nbytes += M * K * itemsize + codes + scales + M * N * itemsize + extra
        ops += 2 * M * K * N
    return nbytes, ops


def q8_pool(pool, dt):
    """A full-width pool's int8 export: quantize_kv of its rows in dt."""
    from paddle_tpu_torch.ops import paged_kv as tkv
    return tkv.QuantizedKVPool(*tkv.quantize_kv(pool.to(dt)))


def q8_clone(p):
    from paddle_tpu_torch.ops import paged_kv as tkv
    return tkv.QuantizedKVPool(p.data.clone(), p.scale.clone())


def pool_clone(p):
    from paddle_tpu_torch.ops import paged_kv as tkv
    return q8_clone(p) if tkv.is_quantized_pool(p) else p.clone()


def truth_pool(p):
    """The pool of an fp32 reference run: int8 pools as they are, others
    in fp32."""
    from paddle_tpu_torch.ops import paged_kv as tkv
    return q8_clone(p) if tkv.is_quantized_pool(p) else p.float().clone()


def bits(t):
    import torch
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32,
                   torch.int8: torch.int8}[t.dtype])


def moved_rows(got, orig):
    """The (page, offset) rows of a pool that differ from ``orig``: its
    values, or an int8 pool's codes or scales."""
    from paddle_tpu_torch.ops import paged_kv as tkv
    if tkv.is_quantized_pool(got):
        moved = (got.data != orig.data).flatten(2).any(-1) | (
            got.scale != orig.scale).any(-1)
    else:
        moved = (got != orig).flatten(2).any(-1)
    return set(map(tuple, moved.nonzero().tolist()))


def check_pool(name, got, ref, orig, touched, tol):
    """A pool written by a layer's kernels against the plain version's:
    :func:`check_q8_pool` for int8 pools, else within ``tol`` and unchanged
    outside ``touched``."""
    from paddle_tpu_torch.ops import paged_kv as tkv
    if tkv.is_quantized_pool(got):
        return check_q8_pool(name, got, ref, orig, touched)
    e = check_close(name, got, ref, tol)
    rows = moved_rows(got, orig)
    if not rows <= touched:
        raise SmokeFailure(f"{name}: rows changed outside the written ones: "
                           f"{sorted(rows - touched)[:5]}")
    return e


def check_q8_pool(name, got, ref, orig, touched):
    """An int8 pool written by the kernels against the plain version's:
    codes at most one step apart (a k one ulp apart may round to the next
    code), scales within 2e-2, every (page, offset) outside ``touched``
    bit-equal to before, every touched one changed or equal to the plain.
    Returns the largest distance of the dequantized values."""
    from paddle_tpu_torch.ops import paged_kv as tkv
    dc = (got.data.int() - ref.data.int()).abs().max().item()
    if dc > 1:
        raise SmokeFailure(f"{name}: codes {dc} steps from the plain version")
    check_close(f"{name} scales", got.scale, ref.scale, 2e-2)
    rows = moved_rows(got, orig)
    if not rows <= touched:
        raise SmokeFailure(f"{name}: rows changed outside the written ones: "
                           f"{sorted(rows - touched)[:5]}")
    return max_err(tkv.dequantize_kv(got.data, got.scale),
                   tkv.dequantize_kv(ref.data, ref.scale))


def quant_layer_launches(name, fn, wo, kvq=True, norm="rms_norm_rows",
                         gemms=7):
    """One quantized layer call: the launches exactly as the chain has
    them (2 norms, 7 GEMMs of ``wo``, the RoPE / KV write and the
    attention, their int8 variants over ``kvq`` pools; a GPT layer:
    ``layer_norm_rows`` and 4 GEMMs)."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    layer.reset_counts()
    fn()
    torch.cuda.synchronize()
    got = {k: n for k, n in layer.launch_counts().items() if n}
    q8 = "_q8" if kvq else ""
    want = {name: 1, norm: 2, wo: gemms, "rope_kv_write" + q8: 1,
            "paged_attention" + q8: 1}
    if got != want:
        raise SmokeFailure(f"{name} quantized: one call launched {got}, "
                           f"expected {want}")


def quant_chain_ms(breakdown, gemm, norm="rms_norm_rows", gemms=7):
    """Device ms of one quantized layer call from its kernels' mean launch
    times and the chain's counts (2 norms, 7 weight-only GEMMs of the
    regime's body ``gemm``, the RoPE / KV write, the attention; a GPT
    layer: ``layer_norm_rows`` and 4 GEMMs).  A body with several
    instances in the call (the prefill GEMM's 128- and 256-row tiles)
    weighs each by its share of the recorded launches."""
    per = {norm: 2, gemm: gemms, "rope_kv_write": 1, "paged_attention": 1}
    hits = {key: [] for key in per}
    for name, (mean, n) in breakdown.items():
        for key in per:
            if key in name:
                hits[key].append((mean, n))
                break
    missing = sorted(k for k, v in hits.items() if not v)
    if missing:
        raise SmokeFailure(f"quantized layer: no profiler record of "
                           f"{missing} in {sorted(breakdown)}")
    return sum(per[k] * sum(m * n for m, n in v) / sum(n for _, n in v)
               for k, v in hits.items())


def quant_chain(cfg, results, lp32, pool32, bt, lengths, bt_row, cos_t,
                sin_t, dev="cuda"):
    """The quantized serving chain (kernels 1-2's weight-only and int8-KV
    branches): the weight-only layer GEMMs (K1) in int8 and int4, per
    channel and groups of 64 / 128, each epilogue, M 4 / 16 / 256, bf16,
    and an fp32 layer; one case whose fp32 scales bf16 rounding moves;
    ``rope_kv_write`` into an int8 pool (K2) bit-equal to its plain
    version; ``paged_attention`` over int8 pools (K3), decode and prefill,
    and a GQA case; whole quantized layers against their plain versions;
    times against bounds and library calls."""
    import torch
    from paddle_tpu_torch.ops import decode_block as db
    from paddle_tpu_torch.ops.cuda import fused as cf
    from paddle_tpu_torch.ops.cuda import kernels as K
    from paddle_tpu_torch.ops.quant_linear import unpack_int4
    from paddle_tpu_torch.nn.quant import pack_int4

    BS, NB = 16, pool32[0].shape[0]
    Hkv, D, Hq, H = cfg.kv_heads, cfg.head_dim, cfg.num_heads, cfg.hidden_size
    dt, tol = torch.bfloat16, TOL["bfloat16"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    err, ratios = {}, {}

    # ---- K1: each width, scale layout, epilogue and regime, bf16
    for width in ("int8", "int4"):
        for gs in (-1, 64, 128):
            for wname, epi in (("gate_w", "none"), ("down_w", "resid"),
                               ("up_w", "swiglu")):
                Kd, N = lp32[wname].shape
                ql = export_layer({wname: lp32[wname]}, width, gs)
                codes, scale = ql[wname + "__q"], ql[wname + "__s"]
                for M in (4, 16, 256):
                    x = torch.randn(M, Kd, device=dev, generator=gen).to(dt)
                    kw = wo_epi_kw(epi, M, N, gen, dev, dt)
                    name = wo_name(width, M, dt)
                    got = one_launch_bitwise(name, lambda: K.wo_layer_cuda(
                        x, codes, scale, width=width, group_size=gs, **kw))
                    plain = K.wo_layer_ref(x, codes, scale, width=width,
                                           group_size=gs, **kw)
                    truth = K.wo_layer_ref(
                        x.float(), codes, scale, width=width, group_size=gs,
                        **{k: v.float() for k, v in kw.items()})
                    e = check_layer_out(
                        f"{name} g{gs} [{M}, {Kd}] @ [{Kd}, {N}] {epi}", got,
                        plain, truth, tol, ratios.setdefault(name, []))
                    err[name] = max(err.get(name, 0.0), e)
    # fp32 x: wo_f32's arithmetic under the same epilogues
    for width, gs in (("int8", -1), ("int4", 64)):
        for wname, epi in (("q_w", "none"), ("down_w", "resid"),
                           ("up_w", "swiglu")):
            Kd, N = lp32[wname].shape
            ql = export_layer({wname: lp32[wname]}, width, gs)
            codes, scale = ql[wname + "__q"], ql[wname + "__s"]
            x = torch.randn(4, Kd, device=dev, generator=gen)
            kw = wo_epi_kw(epi, 4, N, gen, dev, torch.float32)
            got = one_launch_bitwise("wo_layer_f32", lambda: K.wo_layer_cuda(
                x, codes, scale, width=width, group_size=gs, **kw))
            e = check_close(f"wo_layer_f32 {width} g{gs} {epi}", got,
                            K.wo_layer_ref(x, codes, scale, width=width,
                                           group_size=gs, **kw),
                            TOL["float32"])
            err["wo_layer_f32"] = max(err.get("wo_layer_f32", 0.0), e)
    # past one 256-row tile: M 300 (a partial second tile) and M 1024 (the
    # 256-row tiles, unsplit), each with its plan
    for width, gs, wname, epi, M in (("int8", -1, "down_w", "resid", 300),
                                     ("int4", 128, "up_w", "swiglu", 1024)):
        Kd, N = lp32[wname].shape
        ql = export_layer({wname: lp32[wname]}, width, gs)
        codes, scale = ql[wname + "__q"], ql[wname + "__s"]
        x = torch.randn(M, Kd, device=dev, generator=gen).to(dt)
        kw = wo_epi_kw(epi, M, N, gen, dev, dt)
        name = wo_name(width, M, dt)
        got = one_launch_bitwise(name, lambda: K.wo_layer_cuda(
            x, codes, scale, width=width, group_size=gs, **kw))
        e = check_layer_out(
            f"{name} g{gs} [{M}, {Kd}] @ [{Kd}, {N}] {epi} (plan "
            f"{wo_plan(M, Kd, N, width, gs)})", got,
            K.wo_layer_ref(x, codes, scale, width=width, group_size=gs, **kw),
            K.wo_layer_ref(x.float(), codes, scale, width=width,
                           group_size=gs,
                           **{k: v.float() for k, v in kw.items()}),
            tol, ratios.setdefault(name, []))
        err[name] = max(err.get(name, 0.0), e)
    info(f"wo_layer: int8 / int4 x per channel / g64 / g128 x none / resid "
         f"/ swiglu x M 4, 16, 256 in bf16 (two calls bit-identical, one "
         f"launch each), M 300 and 1024 cases, and fp32 x within tolerance; "
         f"max |err| {err}")

    # fp32 scales that bf16 rounding moves by ~0.3 % (mantissas 0.4 of a
    # bf16 step off the grid): the kernel must stay with the fp32 scales
    for width, gs, M in (("int8", -1, 4), ("int4", 64, 256),
                         ("int8", 128, 16)):
        Kd, N = 4096, 4096
        lo, hi = (-127, 128) if width == "int8" else (-8, 8)
        q = torch.randint(lo, hi, (Kd, N), device=dev, generator=gen,
                          dtype=torch.int32).to(torch.int8)
        codes = pack_int4(q) if width == "int4" else q
        G = 1 if gs == -1 else Kd // gs
        mant = 1.0 + (torch.randint(0, 128, (G, N), device=dev,
                                    generator=gen).float() + 0.4) / 128
        scale = (mant * 2.0 ** -9).float()
        scale = scale[0] if gs == -1 else scale
        x = torch.randn(M, Kd, device=dev, generator=gen).to(dt)
        got = K.wo_layer_cuda(x, codes, scale, width=width, group_size=gs)
        t32 = K.wo_layer_ref(x.float(), codes, scale, width=width,
                             group_size=gs)
        tb = K.wo_layer_ref(x.float(), codes, scale.to(dt).float(),
                            width=width, group_size=gs)
        da = float((got.float() - t32).abs().mean())
        db_ = float((got.float() - tb).abs().mean())
        info(f"wo_layer {width} g{gs} M {M}, scales 0.4 bf16 steps off the "
             f"grid: mean |kernel - fp32-scale plain| {da:.3e}, mean "
             f"|kernel - bf16-scale plain| {db_:.3e}")
        if not da < db_:
            raise SmokeFailure(f"wo_layer {width} g{gs}: the kernel is not "
                               "nearer the fp32-scale plain version than the "
                               "bf16-scale one")
        del q, codes

    # ---- per-layer times: a llama_7b layer's seven GEMMs, int8 and int4
    # per channel, decode M 4 and prefill M 256; library: torch.matmul on
    # the weights dequantized to bf16 beforehand, epilogues left out
    timed = {}
    for width in ("int8", "int4"):
        ql = export_layer({k: v for k, v in lp32.items()
                           if not k.startswith("ln")}, width, -1)
        mats = []
        for wname, epi in QUANT_MATMULS:
            Kd, N = lp32[wname].shape
            codes, scale = ql[wname + "__q"], ql[wname + "__s"]
            wdq = ((codes if width == "int8" else unpack_int4(codes, Kd))
                   .float() * scale).to(dt)
            mats.append((wname, epi, Kd, N, codes, scale, wdq))
        for M in (4, 256):
            xs = {Kd: torch.randn(M, Kd, device=dev, generator=gen).to(dt)
                  for Kd in {m[2] for m in mats}}
            ex = {(wname, epi): wo_epi_kw(epi, M, N, gen, dev, dt)
                  for wname, epi, _, N, *_ in mats}

            def kernels():
                for wname, epi, Kd, N, codes, scale, _ in mats:
                    K.wo_layer_cuda(xs[Kd], codes, scale, width=width,
                                    **ex[(wname, epi)])

            def plains():
                for wname, epi, Kd, N, codes, scale, _ in mats:
                    K.wo_layer_ref(xs[Kd], codes, scale, width=width,
                                   **ex[(wname, epi)])

            def library():
                for wname, epi, Kd, N, codes, scale, wdq in mats:
                    torch.matmul(xs[Kd], wdq)
            name = wo_name(width, M, dt)
            by = {}
            _, call = time_ms(kernels, 10, by)
            hit = [(mean, n) for k, (mean, n) in by.items() if "wo_" in k]
            ms = sum(mean * n for mean, n in hit) if hit else None
            plain, plain_call = time_ms(plains, 3)
            lib = time_ms(library, 10)[0]
            bms, bby = bound_ms(*wo_layer_bytes_ops(
                M, [((Kd, N), epi) for _, epi, Kd, N, *_ in mats], width, -1))
            timed[name] = dict(
                ms=ms, call_ms=call, plain_ms=plain, plain_call_ms=plain_call,
                library_ms=lib, bound_ms=bms, bound_by=bby,
                launches_per_call=sum(n for _, n in hit),
                shape=f"one llama_7b layer's 7 GEMMs ({width} codes, per "
                      f"channel, their epilogues), x [{M}, K] bf16",
                **({"plans": {wname: wo_plan(M, Kd, N, width, -1) for
                              wname, _, Kd, N, *_ in mats}} if M > 16
                   else {}))
            info(f"{name} {timed[name]['shape']}: device {ms} ms per layer "
                 f"(per call {call:.4f}), bound {bms:.4f} ms ({bby}), plain "
                 f"{plain} ms, torch.matmul on the dequantized bf16 weights "
                 f"{lib} ms")
        if width == "int8":
            # SwiGLU as gate, then up with silu(gate) x up in its epilogue
            # (kept) against gate, up, then kernel 16 (swiglu_fwd)
            _, _, Kd, N, gc, gsc, _ = mats[4]
            _, _, _, _, uc, usc, _ = mats[5]
            for M in (4, 256):
                y = torch.randn(M, Kd, device=dev, generator=gen).to(dt)

                def fused_epi():
                    g = K.wo_layer_cuda(y, gc, gsc, width=width)
                    return K.wo_layer_cuda(y, uc, usc, width=width, gate=g)

                def three():
                    g = K.wo_layer_cuda(y, gc, gsc, width=width)
                    u = K.wo_layer_cuda(y, uc, usc, width=width)
                    return cf.swiglu_fwd_cuda(g, u)
                a_ms = time_ms(fused_epi, 20)[0]
                b_ms = time_ms(three, 20)[0]
                info(f"SwiGLU at M {M} int8: gate + up with the SwiGLU "
                     f"epilogue {a_ms} ms, gate + up + swiglu_fwd {b_ms} ms")
                timed.setdefault("swiglu_choice", {})[M] = dict(
                    epilogue_ms=a_ms, three_launches_ms=b_ms)
        del mats, ql
        torch.cuda.empty_cache()
    # fp32 x, int8 per channel, M 4: the layer's seven GEMMs on wo_f32
    ql = export_layer({k: v for k, v in lp32.items()
                       if not k.startswith("ln")}, "int8", -1)
    x32s = {Kd: torch.randn(4, Kd, device=dev, generator=gen)
            for Kd in (H, lp32["down_w"].shape[0])}
    ex32 = {(w, e): wo_epi_kw(e, 4, lp32[w].shape[1], gen, dev,
                              torch.float32) for w, e in QUANT_MATMULS}

    def f32_kernels():
        for wname, epi in QUANT_MATMULS:
            K.wo_layer_cuda(x32s[lp32[wname].shape[0]], ql[wname + "__q"],
                            ql[wname + "__s"], width="int8",
                            **ex32[(wname, epi)])

    def f32_plains():
        for wname, epi in QUANT_MATMULS:
            K.wo_layer_ref(x32s[lp32[wname].shape[0]], ql[wname + "__q"],
                           ql[wname + "__s"], width="int8",
                           **ex32[(wname, epi)])
    w32 = {w: (ql[w + "__q"].float() * ql[w + "__s"]) for w, _ in
           QUANT_MATMULS}

    def f32_library():
        for wname, _ in QUANT_MATMULS:
            torch.matmul(x32s[lp32[wname].shape[0]], w32[wname])
    by = {}
    _, call = time_ms(f32_kernels, 5, by)
    hit = [(mean, n) for k, (mean, n) in by.items() if "wo_" in k]
    plain, plain_call = time_ms(f32_plains, 3)
    lib32 = time_ms(f32_library, 5)[0]
    bms, bby = bound_ms(*wo_layer_bytes_ops(
        4, [(tuple(lp32[w].shape), e) for w, e in QUANT_MATMULS], "int8", -1,
        4), dtype="float32")
    timed["wo_layer_f32"] = dict(
        ms=sum(m * n for m, n in hit) if hit else None, call_ms=call,
        plain_ms=plain, plain_call_ms=plain_call, library_ms=lib32,
        bound_ms=bms, bound_by=bby, shape="one llama_7b layer's 7 GEMMs "
        "(int8 codes, per channel), x [4, K] fp32 (the fp32 checks only)")
    del ql, x32s, ex32, w32
    for name in WO_LAYER:
        results.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/kernels/csrc/quant_linear.cu",
            replaces=QUANT_REPLACES if "tiled" not in name
            else QUANT_PRE_REPLACES, max_abs_err=err[name], **timed[name],
            library_what="torch.matmul on the weights dequantized "
                         "beforehand (bf16; fp32 for wo_layer_f32), 7 calls, "
                         "no epilogue",
            bf16_vs_fp32_ratio=max(ratios.get(name, []), default=None),
            **({"swiglu_choice": timed["swiglu_choice"]}
               if name == "wo_layer_int8_small_m" else {})))

    # ---- K2: rope_kv_write into int8 pools, bit-equal to the plain version
    rgen = torch.Generator(device=dev)
    rgen.manual_seed(SEED + 3)
    rope_cases = rope_kv_cases(lengths, bt, bt_row, cos_t, sin_t, BS)
    rope_in = {}
    for dtn in ("float32", "bfloat16"):
        rdt = getattr(torch, dtn)
        for label, (M, tgt, c, s) in rope_cases.items():
            pk, pv = (q8_pool(p, rdt) for p in pool32)
            # random rows, then the hard rows (ties, clips, zero and tiny
            # rows) through an identity rotation
            for hard in (False, True):
                if hard:
                    q, k, v, c, s = rope_q8_hard_inputs(
                        M, Hq, Hkv, D, rdt, SEED + 28 + M, dev)
                else:
                    q, k, v = rope_kv_inputs(M, Hq, Hkv, D, rdt, rgen, dev)
                    c, s = c.to(rdt), s.to(rdt)
                    rope_in[(label, dtn)] = (q, k, v, c, s, pk, pv)
                check_rope_q8_bitwise(
                    f"rope_kv_write_q8 {label}{' hard rows' if hard else ''} "
                    f"{dtn}", q, k, v, c, s, pk, pv, tgt)
    info(f"rope_kv_write_q8: {', '.join(rope_cases)} in fp32 and bf16, "
         f"random rows and the hard rows ({', '.join(Q8_HARD_KINDS)}), "
         "bit-equal to the plain version (q, k, codes and scales), one "
         "launch a call, calls bit-identical")
    rope = {}
    for label, (M, tgt, _, _) in rope_cases.items():
        q, k, v, c, s, pk, pv = rope_in[(label, "bfloat16")]
        ms, call = time_ms(lambda: K.rope_kv_write_cuda(
            q, k, v, c, s, pk, pv, **tgt), 50, per_launch=True)
        plain, plain_call = time_ms(lambda: K.rope_kv_write_ref(
            q, k, v, c, s, pk, pv, head_dim=D, **tgt), 20)
        writes = rope_kv_writes(tgt, pk.data)
        nb, ops = rope_kv_bytes_ops(M, Hq, Hkv, D, 0)
        # the pool stores: a byte a code and 4 bytes a scale, k and v
        nb += writes * 2 * Hkv * (D + 4)
        ops += writes * 2 * Hkv * 3 * D          # absmax, divide, round
        bms, bby = bound_ms(nb, ops)
        rope[label] = dict(max_abs_err=0.0, ms=ms, call_ms=call,
                           plain_ms=plain, plain_call_ms=plain_call,
                           bound_ms=bms, bound_by=bby, library_ms=None)
        info(f"rope_kv_write_q8 {label}: device {ms} ms (per call "
             f"{call:.4f}), plain {plain} ms, bound {bms:.5f} ms ({bby})")
    results.append(dict(
        name="rope_kv_write_q8", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/rope_kv.cu",
        replaces=QUANT_REPLACES,
        shape="B=4, 32 q + 32 kv heads, D=128, int8 pool", **rope["decode"],
        prefill=dict(shape="Ts=256 after 300 positions, every row writing",
                     replaces=QUANT_PRE_REPLACES,
                     **rope["prefill Ts 256"])))

    # ---- K3: paged attention over int8 pools, decode and prefill
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pk8, pv8 = (q8_pool(p, dt) for p in pool32)
    live = [int(n) + 1 for n in lengths.tolist()]
    q = torch.randn(4, Hq * D, device=dev, generator=gen).to(dt)
    plain = K.paged_attention_ref(q, pk8, pv8, block_table=bt,
                                  lengths=lengths)
    truth = K.paged_attention_ref(q.float(), pk8, pv8, block_table=bt,
                                  lengths=lengths)
    got = one_launch_bitwise("paged_attention_q8", lambda:
                             K.paged_attention_cuda(q, pk8, pv8,
                                                    block_table=bt,
                                                    lengths=lengths))
    dec_err = check_layer_out("paged_attention_q8 decode", got, plain, truth,
                              tol)
    Ts, start = 256, 300
    qp = torch.randn(Ts, Hq * D, device=dev, generator=gen).to(dt)
    pre_kw = dict(block_table=bt_row, start=start)
    got = one_launch_bitwise("paged_attention_q8", lambda:
                             K.paged_attention_cuda(qp, pk8, pv8, **pre_kw))
    pre_err = check_layer_out(
        "paged_attention_q8 prefill", got,
        K.paged_attention_ref(qp, pk8, pv8, **pre_kw),
        K.paged_attention_ref(qp.float(), pk8, pv8, **pre_kw), tol)
    # fp32 q over the same codes: the rows body's fp32 instances
    for label, qq, kw in (("decode", q, dict(block_table=bt,
                                              lengths=lengths)),
                          ("prefill", qp, pre_kw)):
        q32 = qq.float()
        got = one_launch_bitwise("paged_attention_q8", lambda:
                                 K.paged_attention_cuda(q32, pk8, pv8, **kw))
        check_close(f"paged_attention_q8 fp32 {label}", got,
                    K.paged_attention_ref(q32, pk8, pv8, **kw),
                    TOL["float32"])
    # GQA 32 / 4 (G 8: the rows body's 8-code chunks) and 32 / 16, decode
    # and prefill chunks of 16 (after 37 and after 600) and 64 rows
    for hkv in (4, 16):
        gp = [torch.randn(NB, BS, hkv, D, device=dev, generator=gen)
              for _ in range(2)]
        gk, gv = (q8_pool(p, dt) for p in gp)
        for label, M, kw in (("decode", 4, dict(block_table=bt,
                                                lengths=lengths)),
                             ("prefill Ts 16 after 37", 16,
                              dict(block_table=bt_row, start=37)),
                             ("prefill Ts 16 after 580", 16,
                              dict(block_table=bt_row, start=580)),
                             ("prefill Ts 64 after 21", 64,
                              dict(block_table=bt_row, start=21))):
            qq = torch.randn(M, Hq * D, device=dev, generator=gen).to(dt)
            got = one_launch_bitwise("paged_attention_q8", lambda:
                                     K.paged_attention_cuda(qq, gk, gv, **kw))
            check_layer_out(f"paged_attention_q8 GQA {Hq}/{hkv} {label}",
                            got, K.paged_attention_ref(qq, gk, gv, **kw),
                            K.paged_attention_ref(qq.float(), gk, gv, **kw),
                            tol)
        del gp, gk, gv
    ms, call = time_ms(lambda: K.paged_attention_cuda(
        q, pk8, pv8, block_table=bt, lengths=lengths), 50, per_launch=True)
    plain_ms, plain_call = time_ms(lambda: K.paged_attention_ref(
        q, pk8, pv8, block_table=bt, lengths=lengths), 10)
    kv_row8 = Hkv * (D + 4) * 2                     # k and v codes + scales
    bms, bby = bound_ms(sum(live) * kv_row8 + 2 * 4 * Hq * D * 2,
                        4 * Hq * D * sum(live) + 2 * Hkv * D * sum(live))

    def gathered(table, n):
        """The pools' first n positions of `table` dequantized to bf16,
        [rows, Hkv, n, D]."""
        idx = table.long().clamp(min=0)[:, :-(-n // BS)]
        return [K._kv_rows(p, idx, dt).to(dt).flatten(1, 2)[:, :n]
                .transpose(1, 2).contiguous() for p in (pk8, pv8)]
    kd, vd = gathered(bt, max(live))
    dmask = (torch.arange(max(live), device=dev)[None]
             <= lengths.long()[:, None])[:, None, None]
    lib = time_ms(lambda: sdpa(q.reshape(4, Hq, 1, D), kd, vd,
                               attn_mask=dmask), 50)[0]
    pre_ms, pre_call = time_ms(lambda: K.paged_attention_cuda(
        qp, pk8, pv8, **pre_kw), 50, per_launch=True)
    pre_plain, pre_plain_call = time_ms(lambda: K.paged_attention_ref(
        qp, pk8, pv8, **pre_kw), 10)
    kp, vp = gathered(bt_row[None], start + Ts)
    pmask = (torch.arange(start + Ts, device=dev)[None]
             <= start + torch.arange(Ts, device=dev)[:, None])
    pre_lib = time_ms(lambda: sdpa(qp.reshape(1, Ts, Hq, D).transpose(1, 2),
                                   kp, vp, attn_mask=pmask), 50)[0]
    pre_bms, pre_bby = bound_ms(
        (start + Ts) * kv_row8 + 2 * Ts * Hq * D * 2,
        4 * Hq * D * sum(start + r + 1 for r in range(Ts)))
    results.append(dict(
        name="paged_attention_q8", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        replaces=QUANT_REPLACES,
        shape="B=4, lengths 1000/37/0/517 (+1 appended), 32 heads, D=128, "
              "int8 pools", max_abs_err=dec_err, ms=ms, call_ms=call,
        plain_ms=plain_ms, plain_call_ms=plain_call, bound_ms=bms,
        bound_by=bby, library_ms=lib,
        library_what="scaled_dot_product_attention on K / V dequantized to "
                     "bf16 and gathered beforehand (not timed), boolean mask",
        prefill=dict(shape=f"Ts={Ts}, start={start}, one table row",
                     replaces=QUANT_PRE_REPLACES, max_abs_err=pre_err,
                     ms=pre_ms, call_ms=pre_call, plain_ms=pre_plain,
                     plain_call_ms=pre_plain_call, bound_ms=pre_bms,
                     bound_by=pre_bby, library_ms=pre_lib)))
    info(f"paged_attention_q8 decode: device {ms} ms (per call {call:.4f}), "
         f"plain {plain_ms} ms, SDPA {lib} ms, bound {bms:.4f} ms ({bby}); "
         f"prefill Ts {Ts} after {start}: device {pre_ms} ms, plain "
         f"{pre_plain} ms, SDPA {pre_lib} ms, bound {pre_bms:.4f} ms")
    del kd, vd, kp, vp

    # ---- whole quantized layers against their plain versions
    # bf16 over int8 pools; fp32 (wo_layer_f32's layer) over fp32 pools,
    # since an fp32 k a rounding apart may take the next int8 code where
    # it lies on a half step (the int8 kernels' fp32 instances are held
    # above on given pools)
    layer_ms = {}
    for dtn, width, gs, kvq in (("bfloat16", "int8", -1, True),
                                ("bfloat16", "int4", 64, True),
                                ("bfloat16", "int8", 128, False),
                                ("float32", "int8", -1, False)):
        ldt = getattr(torch, dtn)
        ltol = TOL[dtn]
        kvn = "int8 KV" if kvq else f"{dtn} KV"
        spec = db.decode_block_spec(cfg, BS, width, gs)
        ql = export_layer({k: v.to(ldt) for k, v in lp32.items()}, width, gs)
        qf = {k: (v if "__" in k else v.float()) for k, v in ql.items()}
        pk0, pv0 = ((q8_pool(p, ldt) if kvq else p.to(ldt)) for p in pool32)
        x = torch.randn(4, H, device=dev, generator=gen).to(ldt)
        cos = cos_t[lengths.long()].to(ldt).contiguous()
        sin = sin_t[lengths.long()].to(ldt).contiguous()
        rk, rv = pool_clone(pk0), pool_clone(pv0)
        ref = db.decode_block_ref(x, ql, rk, rv, bt, lengths, cos, sin,
                                  spec=spec)
        gk, gv = pool_clone(pk0), pool_clone(pv0)
        wo = wo_name(width, 4, ldt)
        quant_layer_launches("decode_block", lambda: db.decode_block(
            x, ql, pool_clone(pk0), pool_clone(pv0), bt, lengths, cos, sin,
            spec=spec), wo, kvq)
        got = db.decode_block(x, ql, gk, gv, bt, lengths, cos, sin, spec=spec)
        torch.cuda.synchronize()
        truth = db.decode_block_ref(x.float(), qf, truth_pool(pk0),
                                    truth_pool(pv0), bt, lengths, cos.float(),
                                    sin.float(), spec=spec)[0]
        touched = {(int(bt[b, int(n) // BS]), int(n) % BS)
                   for b, n in enumerate(lengths.tolist()) if b != 2}
        e = check_layer_out(f"decode_block {dtn} {width} g{gs} {kvn}",
                            got[0], ref[0], truth, ltol)
        for nm, g_, r_, o_ in (("k", gk, rk, pk0), ("v", gv, rv, pv0)):
            check_pool(f"decode_block {dtn} {width} g{gs} pool_{nm}", g_, r_,
                       o_, touched, ltol)
        info(f"decode_block {dtn} {width} g{gs} + {kvn}: max |err| x "
             f"{e:.2e} (tol {ltol}); pools checked")
        for Ts, start, valid in ((16, 37, 16), (64, 21, 40), (256, 300, 200)):
            if dtn == "float32" and Ts != 64:
                continue
            xp = torch.randn(1, Ts, H, device=dev, generator=gen).to(ldt)
            pos = start + torch.arange(Ts, device=dev)
            c, s = (t[pos].to(ldt).contiguous() for t in (cos_t, sin_t))
            blk = bt_row.clamp(min=0)[pos // BS]
            blk[valid:] = NB
            blk, off = blk.to(torch.int32), (pos % BS).to(torch.int32)
            rk, rv = pool_clone(pk0), pool_clone(pv0)
            ref = db.prefill_block_ref(xp, ql, rk, rv, blk, off, bt_row, c, s,
                                       spec=spec, start=start)
            gk, gv = pool_clone(pk0), pool_clone(pv0)
            quant_layer_launches("prefill_block", lambda: db.prefill_block(
                xp, ql, pool_clone(pk0), pool_clone(pv0), blk, off, bt_row,
                c, s, spec=spec, start=start), wo_name(width, Ts, ldt), kvq)
            got = db.prefill_block(xp, ql, gk, gv, blk, off, bt_row, c, s,
                                   spec=spec, start=start)
            torch.cuda.synchronize()
            truth = db.prefill_block_ref(
                xp.float(), qf, truth_pool(pk0), truth_pool(pv0), blk, off,
                bt_row, c.float(), s.float(), spec=spec, start=start)[0]
            e = check_layer_out(
                f"prefill_block {dtn} {width} g{gs} {kvn} Ts={Ts}",
                got[0][:, :valid], ref[0][:, :valid], truth[:, :valid], ltol)
            touched = {(int(blk[i]), int(off[i])) for i in range(valid)}
            for nm, g_, r_, o_ in (("k", gk, rk, pk0), ("v", gv, rv, pv0)):
                check_pool(f"prefill_block {dtn} Ts={Ts} pool_{nm}", g_, r_,
                           o_, touched, ltol)
            info(f"prefill_block {dtn} {width} g{gs} + {kvn} Ts={Ts}: max "
                 f"|err| x {e:.2e} (tol {ltol})")
        if kvq:
            pk, pv = pool_clone(pk0), pool_clone(pv0)
            by = {}
            _, call = time_ms(lambda: db.decode_block(
                x, ql, pk, pv, bt, lengths, cos, sin, spec=spec), 20, by)
            dms = quant_chain_ms(by, "wo_dec")
            paced = paced_ms(lambda: db.decode_block(
                x, ql, pk, pv, bt, lengths, cos, sin, spec=spec))
            host = host_ms(lambda: db.decode_block(
                x, ql, pk, pv, bt, lengths, cos, sin, spec=spec))
            xp = torch.randn(1, 256, H, device=dev, generator=gen).to(ldt)
            pos = 300 + torch.arange(256, device=dev)
            c, s = (t[pos].to(ldt).contiguous() for t in (cos_t, sin_t))
            blk = bt_row.clamp(min=0)[pos // BS]
            blk[200:] = NB
            blk, off = blk.to(torch.int32), (pos % BS).to(torch.int32)
            pby = {}
            _, pcall = time_ms(lambda: db.prefill_block(
                xp, ql, pk, pv, blk, off, bt_row, c, s, spec=spec,
                start=300), 10, pby)
            pms = quant_chain_ms(pby, "wo_wgmma")
            ppaced = paced_ms(lambda: db.prefill_block(
                xp, ql, pk, pv, blk, off, bt_row, c, s, spec=spec,
                start=300), calls=20)
            layer_ms[f"{width} g{gs} + int8 KV"] = dict(
                decode_ms=dms, decode_call_ms=call, decode_paced_ms=paced,
                decode_host_ms=host, prefill_ts256_ms=pms,
                prefill_call_ms=pcall, prefill_paced_ms=ppaced,
                decode_kernels=short(by))
            info(f"decode_block bf16 {width} g{gs} + int8 KV: device {dms:.4f}"
                 f" ms (device-paced {paced:.4f}; per call {call:.4f}; host "
                 f"enqueue, median of 30: {host:.4f} ms); prefill_block Ts "
                 f"256: device {pms:.4f} ms (device-paced {ppaced:.4f}; per "
                 f"call {pcall:.4f}); kernels {short(by)}")
        del ql, qf, pk0, pv0
        torch.cuda.empty_cache()
    for r in results:
        if r["name"] == "decode_block":
            r["quantized_layers"] = layer_ms


class NoPlainPath:
    """While active, the plain versions of the serving ops raise: a run
    inside shows that no op of the main path fell back to them."""
    NAMES = (("paddle_tpu_torch.ops.decode_block", "decode_block_ref"),
             ("paddle_tpu_torch.ops.decode_block", "prefill_block_ref"),
             ("paddle_tpu_torch.ops.decode_block", "paged_append"),
             ("paddle_tpu_torch.ops.decode_block", "paged_decode_attention"),
             ("paddle_tpu_torch.ops.decode_block", "quantize_kv"),
             ("paddle_tpu_torch.ops.decode_block", "dequantize_kv"))

    def __enter__(self):
        import importlib
        self.saved = []
        for mod, name in self.NAMES:
            m = importlib.import_module(mod)
            self.saved.append((m, name, getattr(m, name)))

            def refuse(*a, _n=name, **k):
                raise SmokeFailure(f"the main path called the plain {_n}")
            setattr(m, name, refuse)
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def phase_engine_quant(cfg, bf16, dev="cuda"):
    """Serve llama_7b (bf16 weights from the same seed as phase_engine)
    through the engine with ``ServeQuantConfig(weight_dtype="int8",
    kv_dtype="int8")``: the PTQ export at construction, one 300-token
    prompt's prefill logits against the plain chain on the card, then
    phase_engine's traffic with the launch counts exactly as predicted and
    the plain versions refused; the decode step's wall and busy ms,
    tokens/s and TTFT beside the bf16 engine's (``bf16``)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import init_params
    from paddle_tpu_torch.ops import decode_block as db
    from paddle_tpu_torch.ops import paged_kv as tkv
    from paddle_tpu_torch.ops.cuda import layer
    from paddle_tpu_torch.quantization import ServeQuantConfig

    qc = ServeQuantConfig(**ENGINE_QUANT)
    params = init_params(cfg, make_generator(SEED, dev), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(cfg, params, max_batch=4, block_size=16,
                                   num_blocks=256,
                                   prefill_buckets=(16, 64, 256),
                                   enable_prefix_caching=False,
                                   enable_preemption=False,
                                   quant_config=qc, device=dev)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    del params                    # the engine keeps the exported blocks
    torch.cuda.empty_cache()
    info(f"engine quant: llama_7b bf16 PTQ-exported to {qc.describe()} and "
         f"the int8 pools built in {export_s:.2f} s; device memory "
         f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    rng = np.random.default_rng(SEED)

    # one request's prefill logits against the plain chain run as ONE
    # chunk on the card (and that chain in fp32 on the same codes)
    prompt = rng.integers(0, cfg.vocab_size, 300).astype(np.int32)
    eng.add_request(prompt, 1)
    eng.run_to_completion()
    got = torch.from_numpy(eng.last_prefill_logits)
    T = len(prompt)
    npg = -(-T // 16)
    shape = (npg, 16, cfg.kv_heads, cfg.head_dim)
    pk, pv = (tkv.zeros_kv_pool(shape, eng.dtype, dev, kv_quant=True)
              for _ in range(2))
    pk32, pv32 = (tkv.zeros_kv_pool(shape, torch.float32, dev, kv_quant=True)
                  for _ in range(2))
    bt_row = torch.arange(npg, dtype=torch.int32, device=dev)
    pos = torch.arange(T, device=dev)
    blk, off = (pos // 16).to(torch.int32), (pos % 16).to(torch.int32)
    x = eng.params["wte"][torch.from_numpy(prompt).to(dev).long()][None]
    cos, sin = eng._cos[pos].contiguous(), eng._sin[pos].contiguous()
    x32 = x.float()
    with torch.no_grad():
        for lp in eng._layers:
            x, _, _ = db.prefill_block_ref(x, lp, pk, pv, blk, off, bt_row,
                                           cos, sin, spec=eng.spec, start=0)
            x32, _, _ = db.prefill_block_ref(
                x32, {k: (v if "__" in k else v.float())
                      for k, v in lp.items()}, pk32, pv32, blk, off, bt_row,
                cos.float(), sin.float(), spec=eng.spec, start=0)
        ref = eng._logits(x[:, -1])[0].cpu()
        truth = eng._logits(x32[:, -1])[0].cpu()
    err = check_layer_out("engine quant prefill logits", got, ref, truth,
                          TOL["bfloat16"])
    info(f"engine quant prefill logits vs plain chain (300 tokens; engine "
         f"chunks 256+16+16+16 with 4 padded, plain one chunk): max |err| "
         f"{err:.3e}, vs fp32 chain {max_err(got, truth):.3e} (plain bf16 vs "
         f"fp32 {max_err(ref, truth):.3e}), max |logit| "
         f"{float(truth.abs().max()):.3f}, argmax {int(got.argmax())} / "
         f"{int(ref.argmax())} / {int(truth.argmax())}")
    del pk, pv, pk32, pv32, x, x32

    # the main path: phase_engine's traffic, counts from zero, every chunk
    # fill recorded and the decode step's executions read off its graph
    # (its replays, and the capture's warm-up call when it is captured in
    # this run) to predict the launches
    chunks = []
    fill = eng._chunk_fill

    def counted_fill(bt_row, start, toks, valid):
        chunks.append(len(toks))
        return fill(bt_row, start, toks, valid)
    eng._chunk_fill = counted_fill
    pre_graph = eng._graphs.get("decode")
    replays0 = 0 if pre_graph is None else pre_graph.replays
    lens = [20, 600, 137, 64, 300, 45, 512, 256]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    layer.reset_counts()
    ids = [eng.add_request(p, 32) for p in prompts]
    results, ttft = {}, {}
    dec_s, dec_tok, pre_s = 0.0, 0, 0.0
    with NoPlainPath():
        t0 = time.perf_counter()
        while eng.queue or any(s is not None for s in eng.slots):
            q0, tok0 = eng.queue_depth, eng.decode_tokens
            ts = time.perf_counter()
            results.update(eng.step())
            te = time.perf_counter()
            if eng.last_logits is not None:
                live = [s for s in range(eng.B) if eng.slots[s] is not None]
                if not np.isfinite(eng.last_logits[live]).all():
                    raise SmokeFailure("engine quant: non-finite logits")
            if eng.queue_depth < q0:
                pre_s += te - ts
                for s in eng.slots:
                    if s is not None and s.req_id not in ttft:
                        ttft[s.req_id] = te - t0
            else:
                dec_s += te - ts
                dec_tok += eng.decode_tokens - tok0
        wall = time.perf_counter() - t0
    counts = layer.launch_counts()
    L = cfg.num_layers
    steps = [eng._graphs["decode"].replays - replays0
             + (pre_graph is None)]
    want = {"decode_block": L * steps[0], "prefill_block": L * len(chunks),
            "rms_norm_rows": 2 * L * (steps[0] + len(chunks)),
            "rope_kv_write_q8": L * (steps[0] + len(chunks)),
            "paged_attention_q8": L * (steps[0] + len(chunks)),
            "wo_layer_int8_small_m": 7 * L * (steps[0] + sum(
                1 for n in chunks if n <= 16)),
            "wo_layer_int8_tiled": 7 * L * sum(1 for n in chunks if n > 16)}
    got_counts = {k: n for k, n in counts.items() if n}
    if got_counts != {k: n for k, n in want.items() if n}:
        raise SmokeFailure(f"engine quant: launches {got_counts}, predicted "
                           f"{want} ({steps[0]} decode steps, chunks "
                           f"{chunks})")
    if sorted(results) != sorted(ids):
        raise SmokeFailure(f"engine quant: finished {sorted(results)}, "
                           f"expected {sorted(ids)}")
    for rid, p in zip(ids, prompts):
        out = results[rid]
        if len(out) != len(p) + 32 or not np.array_equal(out[:len(p)], p) \
                or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise SmokeFailure(f"engine quant: request {rid} returned a bad "
                               f"sequence of length {len(out)}")
    leak = eng.kv_leak_report()
    if leak["leaked"] or leak["unaccounted"] or \
            leak["free_blocks"] != eng.alloc.num_blocks:
        raise SmokeFailure(f"engine quant: KV accounting not clean: {leak}")
    info(f"engine quant: launches exactly as predicted ({steps[0]} decode "
         f"steps: the decode graph's replays and its capture's warm-up "
         f"call; {len(chunks)} chunks {sorted(set(chunks))}): {got_counts}")
    # decode steady state: device busy share of 8 steps at B=4
    eng._chunk_fill = fill
    for p in prompts[:4]:
        eng.add_request(p[:64], 12)
    eng.step()
    by = {}
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    ts = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            eng.step()
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - ts) * 1e3 / 8
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            by[ev.key] = us / 8 / 1e3
    busy = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    eng.run_to_completion()
    ttfts = sorted(ttft.values())
    summary = dict(
        quant=qc.describe(), export_s=export_s, decode_step_ms=step_ms,
        decode_busy_ms=busy, decode_tokens_per_s=dec_tok / dec_s,
        prefill_s=pre_s, wall_s=wall, ttft_min_s=ttfts[0],
        ttft_max_s=ttfts[-1], ttft_mean_s=sum(ttfts) / len(ttfts),
        prefill_logits_max_err=err,
        bf16=dict((k, bf16[k]) for k in (
            "decode_step_ms", "decode_busy_ms", "decode_tokens_per_s",
            "ttft_mean_s", "ttft_max_s")))
    info(f"engine quant decode step (B=4, profiled, 8 steps): wall "
         f"{step_ms:.3f} ms/step (bf16 {bf16['decode_step_ms']:.3f}), device "
         f"busy {busy:.3f} ms/step (bf16 {bf16['decode_busy_ms']:.3f}); "
         f"top kernels {top}")
    info(f"engine quant: 8 requests ({sum(lens)} prompt tokens, 256 new) in "
         f"{wall:.2f} s; decode {dec_tok} tokens in {dec_s:.2f} s = "
         f"{dec_tok / dec_s:.1f} tok/s (bf16 "
         f"{bf16['decode_tokens_per_s']:.1f}); TTFT mean "
         f"{summary['ttft_mean_s']:.3f} s (bf16 {bf16['ttft_mean_s']:.3f})")
    fcounts, summary["features"] = engine_quant_features(cfg, eng, qc, rng,
                                                         dev)
    return counts, summary, fcounts


def engine_quant_features(cfg, eng, qc, rng, dev="cuda"):
    """The quantized engine (``eng``'s exported int8 weights, int8 KV
    pools) at the JAX defaults: one prefix hit (a 256-token prefix, two
    48-token suffixes) held to the second prompt served cold, and one
    explicit preempt / restore whose snapshot must carry the fp32 scales,
    restored byte for byte and finishing with the unpreempted ids.
    Returns the launch counts of its engine runs and its summary."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops.cuda import layer

    V, counts = cfg.vocab_size, {}

    def engine(**kw):
        return ContinuousBatchingEngine(cfg, eng.params, max_batch=4,
                                        block_size=16, num_blocks=256,
                                        quant_config=qc, device=dev, **kw)

    def counted(e, arrivals):
        return counted_drive(e, arrivals, counts)

    (npre, nsuf, nnew), (npr, nprnew) = QFEAT_PREFIX, QFEAT_PREEMPT
    prefix = rng.integers(0, V, npre).astype(np.int32)
    pa, pb = (np.concatenate([prefix, rng.integers(0, V, nsuf)
                              .astype(np.int32)]) for _ in range(2))
    feat = engine()
    counted(feat, [(0, pa, nnew, {})])
    hit = counted(feat, [(0, pb, nnew, {})])
    ps = feat.prefix_stats()
    if ps["hits"] != 1 or ps["hit_blocks"] != npre // 16:
        raise SmokeFailure(f"engine quant features: prefix stats {ps}")
    off = engine(enable_prefix_caching=False, enable_preemption=False)
    cold = counted(off, [(0, pb, nnew, {})])
    check_requests("engine quant features", {"hit": hit, "cold": cold},
                   [pb], [nnew], V)
    divs = same_ids("engine quant features prefix hit vs cold", off, hit,
                    cold, [pb])
    # one preempt / restore: the snapshot carries the int8 pages' scales
    pr = rng.integers(0, V, npr).astype(np.int32)
    want = counted(off, [(0, pr, nprnew, {})])
    check_restores_exact(feat)
    layer.reset_counts()
    with NoPlainPath():
        rid = feat.add_request(pr, nprnew)
        for _ in range(5):
            feat.step()
        feat.preempt(next(s for s, r in enumerate(feat.slots)
                          if r is not None and r.req_id == rid))
        snap = feat._spill[rid]
        if snap.k_scale is None or snap.k_scale.dtype != torch.float32 or \
                snap.k_pages.dtype != torch.int8 or \
                tuple(snap.k_scale.shape) != tuple(snap.k_pages.shape[:-1]):
            raise SmokeFailure("engine quant features: the snapshot lacks "
                               "its int8 codes' fp32 scales")
        nbytes = snap.nbytes
        got = feat.run_to_completion()[rid]
    for k, n in layer.launch_counts().items():
        if n:
            counts[k] = counts.get(k, 0) + n
    st = feat.resilience_stats()
    if st["preemptions"] != 1 or st["restores"] != 1:
        raise SmokeFailure(f"engine quant features: resilience {st}")
    if not np.array_equal(got, want["ids"][want["rids"][0]]):
        raise SmokeFailure("engine quant features: the restored request "
                           "changed its ids")
    leak = feat.kv_leak_report()
    if leak["leaked"] or leak["unaccounted"] or leak["slot_blocks"]:
        raise SmokeFailure(f"engine quant features: KV accounting {leak}")
    info(f"engine quant features: prefix hit {ps['hit_blocks']} blocks, "
         f"prefill tokens computed {ps['prefill_tokens_computed']}; ids vs "
         f"cold: {len(divs)} divergence(s); one preempt / restore of "
         f"{nbytes} snapshot bytes (int8 codes + fp32 scales) restored "
         f"exactly, ids identical to the unpreempted run; launches {counts}")
    del feat, off
    torch.cuda.empty_cache()
    return counts, dict(prefix_hits=ps["hits"],
                        prefill_tokens_computed=ps["prefill_tokens_computed"],
                        divergences=divs, snapshot_bytes=nbytes,
                        resilience={k: v for k, v in st.items()})


def phase_engine(cfg, dev="cuda"):
    """Serve llama_7b (bf16, seeded random weights) through the engine;
    returns the main path's launch counts and its summary (decode step
    wall and device-busy ms of 8 profiled steps at B 4, decode tokens/s,
    bucketed prefill seconds, time to first token)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import init_params
    from paddle_tpu_torch.ops import decode_block as db
    from paddle_tpu_torch.ops.cuda import layer

    t0 = time.perf_counter()
    params = init_params(cfg, make_generator(SEED, dev), device=dev)
    # prefix caching and preemption off, as this phase ran before the
    # engine took the JAX defaults (phase engine features drives them)
    eng = ContinuousBatchingEngine(cfg, params, max_batch=4, block_size=16,
                                   num_blocks=256,
                                   prefill_buckets=(16, 64, 256),
                                   enable_prefix_caching=False,
                                   enable_preemption=False, device=dev)
    torch.cuda.synchronize()
    info(f"engine: llama_7b bf16 params + pools built in "
         f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)

    # cross-check: one request's prefill logits (bucketed chunks through
    # the kernels) against the plain chain run as ONE chunk on the card
    prompt = rng.integers(0, cfg.vocab_size, 300).astype(np.int32)
    eng.add_request(prompt, 1)
    eng.run_to_completion()
    got = torch.from_numpy(eng.last_prefill_logits)
    T = len(prompt)
    npg = -(-T // 16)
    pk = torch.zeros(npg, 16, cfg.kv_heads, cfg.head_dim, device=dev,
                     dtype=eng.dtype)
    pv = torch.zeros_like(pk)
    bt_row = torch.arange(npg, dtype=torch.int32, device=dev)
    pos = torch.arange(T, device=dev)
    blk, off = (pos // 16).to(torch.int32), (pos % 16).to(torch.int32)
    x = params["wte"][torch.from_numpy(prompt).to(dev).long()][None]
    cos, sin = eng._cos[pos].contiguous(), eng._sin[pos].contiguous()
    x32 = x.float()
    pk32, pv32 = pk.float(), pv.float()
    with torch.no_grad():
        for lp in eng._layers:
            x, _, _ = db.prefill_block_ref(x, lp, pk, pv, blk, off, bt_row,
                                           cos, sin, spec=eng.spec, start=0)
            x32, _, _ = db.prefill_block_ref(
                x32, {k: v.float() for k, v in lp.items()}, pk32, pv32, blk,
                off, bt_row, cos.float(), sin.float(), spec=eng.spec,
                start=0)
        ref = eng._logits(x[:, -1])[0].cpu()
        truth = eng._logits(x32[:, -1])[0].cpu()
    err = check_layer_out("engine prefill logits", got, ref, truth,
                          TOL["bfloat16"])
    info(f"engine prefill logits vs plain chain (300 tokens; engine chunks "
         f"256+16+16+16 with 4 padded, plain one chunk): max |err| "
         f"{err:.3e}, vs fp32 chain {max_err(got, truth):.3e} (plain bf16 "
         f"vs fp32 {max_err(ref, truth):.3e}), max |logit| "
         f"{float(truth.abs().max()):.3f}, argmax {int(got.argmax())} / "
         f"{int(ref.argmax())} / {int(truth.argmax())}")
    del pk, pv, x, pk32, pv32, x32

    # the main path: counts from zero, 8 requests, 32 new tokens each
    lens = [20, 600, 137, 64, 300, 45, 512, 256]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    layer.reset_counts()
    ids = [eng.add_request(p, 32) for p in prompts]
    results, ttft = {}, {}
    dec_s, dec_tok, pre_s = 0.0, 0, 0.0
    t0 = time.perf_counter()
    while eng.queue or any(s is not None for s in eng.slots):
        q0, tok0 = eng.queue_depth, eng.decode_tokens
        ts = time.perf_counter()
        results.update(eng.step())
        te = time.perf_counter()
        if eng.last_logits is not None:
            live = [s for s in range(eng.B) if eng.slots[s] is not None]
            if not np.isfinite(eng.last_logits[live]).all():
                raise SmokeFailure("engine: non-finite decode logits")
        if eng.queue_depth < q0:
            pre_s += te - ts
            for s in eng.slots:
                if s is not None and s.req_id not in ttft:
                    ttft[s.req_id] = te - t0
        else:
            dec_s += te - ts
            dec_tok += eng.decode_tokens - tok0
    wall = time.perf_counter() - t0
    counts = layer.launch_counts()
    if sorted(results) != sorted(ids):
        raise SmokeFailure(f"engine: finished {sorted(results)}, expected "
                           f"{sorted(ids)}")
    for rid, p in zip(ids, prompts):
        out = results[rid]
        if len(out) != len(p) + 32 or not np.array_equal(out[:len(p)], p) \
                or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise SmokeFailure(f"engine: request {rid} returned a bad "
                               f"sequence of length {len(out)}")
    leak = eng.kv_leak_report()
    if leak["leaked"] or leak["unaccounted"] or \
            leak["free_blocks"] != eng.alloc.num_blocks:
        raise SmokeFailure(f"engine: KV accounting not clean: {leak}")
    for op in MAIN_PATH:
        if counts.get(op, 0) <= 0:
            raise SmokeFailure(f"engine: kernel {op} never launched on the "
                               f"main path ({counts})")
    # decode steady state: device busy share of 8 engine steps at B=4
    for p in prompts[:4]:
        eng.add_request(p[:64], 12)
    eng.step()
    by = {}
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    ts = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            eng.step()
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - ts) * 1e3 / 8
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            by[ev.key] = us / 8 / 1e3
    busy = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    norm_ms = sum(t for k, t in by.items() if "rms_norm_rows" in k)
    info(f"engine decode step (B=4, profiled, 8 steps): wall {step_ms:.3f} "
         f"ms/step, device busy {busy:.3f} ms/step "
         f"({100 * busy / step_ms:.1f}%), rms_norm_rows {norm_ms:.4f} "
         f"ms/step, top kernels {top}")
    eng.run_to_completion()
    leak = eng.kv_leak_report()
    if leak["leaked"] or leak["unaccounted"]:
        raise SmokeFailure(f"engine: KV accounting not clean: {leak}")
    ttfts = sorted(ttft.values())
    info(f"engine: 8 requests ({sum(lens)} prompt tokens, 256 new) in "
         f"{wall:.2f} s; bucketed prefill steps {pre_s:.2f} s; decode "
         f"{dec_tok} tokens in {dec_s:.2f} s = {dec_tok / dec_s:.1f} tok/s; "
         f"time to first token min {ttfts[0]:.2f} s max {ttfts[-1]:.2f} s; "
         f"buckets {eng.bucket_stats()}; leak {leak}; launches {counts}")
    return counts, dict(
        decode_step_ms=step_ms, decode_busy_ms=busy,
        decode_rms_norm_rows_ms=norm_ms,
        decode_tokens_per_s=dec_tok / dec_s, prefill_s=pre_s, wall_s=wall,
        ttft_min_s=ttfts[0], ttft_max_s=ttfts[-1],
        ttft_mean_s=sum(ttfts) / len(ttfts))


# ------------------------------------------- the engine at the JAX defaults
# llama_7b bf16 through ContinuousBatchingEngine(cfg, params) as the JAX
# engine's users call it: prefix caching on, preemption on with an
# unbounded SpillTier, prefill_buckets None (cold prompts through the dense
# decoder's prefill, cache-hit suffixes through one unbucketed chunk fill).
FEAT_PREFIX, FEAT_SUFFIX, FEAT_NEW = 512, 64, 32
FEAT_LO, FEAT_HI, FEAT_HI_STEP = (300, 200, 400, 250), 300, 6
FEAT_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)
FEAT_DENSE = 300
FEAT_SAMPLED_LENS = (100, 60, 150, 90)       # the sampled prompt, batchmates
# the quantized engine's prefix (prefix, suffix, new tokens) and preempted
# request (prompt, new tokens)
QFEAT_PREFIX, QFEAT_PREEMPT = (256, 48, 16), (200, 24)


def fp32_last_logits(eng, tokens):
    """The plain chain in fp32 over ``tokens`` as one chunk (int8 codes
    and scales as they are, int8 KV pools with fp32 scales): the logits
    at the last position, on the host — the reference a bf16 divergence
    between two engine runs is held to."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import decode_block as db
    from paddle_tpu_torch.ops import paged_kv as tkv
    dev, BS, T = eng.device, eng.BS, len(tokens)
    npg = -(-T // BS)
    shape = (npg, BS, eng.cfg.kv_heads, eng.cfg.head_dim)
    pk, pv = (tkv.zeros_kv_pool(shape, torch.float32, dev,
                                kv_quant=eng._kv_quant) for _ in range(2))
    bt_row = torch.arange(npg, dtype=torch.int32, device=dev)
    pos = torch.arange(T, device=dev)
    blk, off = (pos // BS).to(torch.int32), (pos % BS).to(torch.int32)
    ids = torch.from_numpy(np.asarray(tokens, np.int64)).to(dev)
    x = eng.params["wte"][ids][None].float()
    cos, sin = eng._cos[pos].float(), eng._sin[pos].float()
    with torch.no_grad():
        for lp in eng._layers:
            x = db.prefill_block_ref(x, _f32_layer(lp), pk, pv, blk, off,
                                     bt_row, cos, sin, spec=eng.spec,
                                     start=0)[0]
        return eng._logits(x[:, -1])[0].cpu()


def drive(eng, arrivals):
    """Serve ``arrivals`` ``[(step, prompt, new_tokens, add_request
    kwargs)]`` with the plain serving ops refused; returns ``dict(ids={rid:
    prompt + generated}, ttft={rid: s from its add_request to the end of the
    step that gave its first token}, rows={rid: {token index: fp32 logits
    row}}, wall=s, max_spilled=bytes, rids=[...])``."""
    import numpy as np
    rows, fill = {}, eng._prefill_into_slot

    def recording(slot, req, L):
        logits = fill(slot, req, L)
        # a replay's prefill (same id) gives no token: keep the first
        rows.setdefault(req.req_id, {}).setdefault(
            0, logits[0].float().cpu().numpy())
        return logits
    eng._prefill_into_slot = recording
    pending = sorted(arrivals, key=lambda a: a[0])
    ids, ttft, t_add, rids = {}, {}, {}, []
    step, spilled = 0, 0
    t0 = time.perf_counter()
    try:
        with NoPlainPath():
            while pending or eng.queue or \
                    any(s is not None for s in eng.slots):
                while pending and pending[0][0] <= step:
                    _, p, n, kw = pending.pop(0)
                    rid = eng.add_request(p, n, **kw)
                    rids.append(rid)
                    t_add[rid] = time.perf_counter()
                ids.update(eng.step())
                te = time.perf_counter()
                spilled = max(spilled, eng.spilled_bytes)
                live = [(s, r) for s, r in enumerate(eng.slots)
                        if r is not None]
                for s, r in live:
                    ttft.setdefault(r.req_id, te - t_add[r.req_id])
                    if eng.last_logits is not None:
                        if not np.isfinite(eng.last_logits[s]).all():
                            raise SmokeFailure("engine features: "
                                               "non-finite decode logits")
                        rows[r.req_id][len(r.out) - 1] = \
                            eng.last_logits[s].copy()
                step += 1
    finally:
        eng._prefill_into_slot = fill
    for rid in ids:
        ttft.setdefault(rid, time.perf_counter() - t_add[rid])
    return dict(ids=ids, ttft=ttft, rows=rows, rids=rids,
                wall=time.perf_counter() - t0, max_spilled=spilled)


def counted_drive(eng, arrivals, totals):
    """:func:`drive` with the library's launch counts set to 0 just before
    and read just after: the run gets ``counts`` (the nonzero ones), which
    are added into ``totals``."""
    from paddle_tpu_torch.ops.cuda import layer
    layer.reset_counts()
    run = drive(eng, arrivals)
    run["counts"] = {k: n for k, n in layer.launch_counts().items() if n}
    for k, n in run["counts"].items():
        totals[k] = totals.get(k, 0) + n
    return run


def check_requests(tag, runs, prompts, new_tokens, vocab):
    """Every request finished with a valid sequence of its prompt and
    ``new_tokens`` ids, in every run."""
    import numpy as np
    for name, run in runs.items():
        if sorted(run["ids"]) != sorted(run["rids"]):
            raise SmokeFailure(f"{tag} {name}: finished {sorted(run['ids'])}"
                               f", expected {sorted(run['rids'])}")
        for rid, p, n in zip(run["rids"], prompts, new_tokens):
            out = run["ids"][rid]
            if len(out) != len(p) + n or not np.array_equal(out[:len(p)], p) \
                    or out.min() < 0 or out.max() >= vocab:
                raise SmokeFailure(f"{tag} {name}: request {rid} returned a "
                                   f"bad sequence of length {len(out)}")


def same_ids(tag, eng, run, ref, prompts):
    """Hold ``run``'s ids to ``ref``'s request by request.  Where they
    differ, the first differing token's logits (computed from the same
    tokens in both runs) must agree: ``check_layer_out`` with ``run`` as the
    kernel side, ``ref`` as the plain side and the fp32 plain chain over
    those tokens as the truth.  Returns the documented divergences."""
    import torch
    divs = []
    for rid, rrid, p in zip(run["rids"], ref["rids"], prompts):
        a, b = run["ids"][rid], ref["ids"][rrid]
        if (a == b).all():
            continue
        i = int((a != b).nonzero()[0][0]) - len(p)
        truth = fp32_last_logits(eng, a[:len(p) + i])
        err = check_layer_out(
            f"{tag} request {rid} first differing token {i}",
            torch.from_numpy(run["rows"][rid][i]),
            torch.from_numpy(ref["rows"][rrid][i]), truth, TOL["bfloat16"])
        gap = float(truth.max() - truth[[int(a[len(p) + i]),
                                         int(b[len(p) + i])]].min())
        divs.append(dict(request=rid, token=i, ids=[int(a[len(p) + i]),
                                                    int(b[len(p) + i])],
                         max_err=err, fp32_gap=gap))
        info(f"{tag}: request {rid} diverges at generated token {i} "
             f"({int(a[len(p) + i])} vs {int(b[len(p) + i])}); logits max "
             f"|err| {err:.3e}; the two ids lie {gap:.3e} below the fp32 "
             f"maximum")
    return divs


def timed_methods(eng, names):
    """Wrap the engine methods ``names`` with synchronised host timers;
    returns ``{name: [seconds of each call]}``."""
    import torch
    out = {}
    for name in names:
        fn = getattr(eng, name)
        out[name] = []

        def timed(*a, _fn=fn, _t=out[name], **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = _fn(*a, **k)
            torch.cuda.synchronize()
            _t.append(time.perf_counter() - t0)
            return r
        setattr(eng, name, timed)
    return out


def check_restores_exact(eng):
    """Wrap ``_restore_preempted``: after each restore the slot's pages
    must hold the snapshot's bytes exactly (codes and scales)."""
    import torch
    fn = eng._restore_preempted

    def checked(slot, req, idx, snap):
        ok = fn(slot, req, idx, snap)
        if ok:
            used = snap.k_pages.shape[1]
            pages = eng.slot_pages[slot][:used]
            pairs = [(eng.pool_k, snap.k_pages, snap.k_scale),
                     (eng.pool_v, snap.v_pages, snap.v_scale)]
            for pool, data, scale in pairs:
                d = pool.data if scale is not None else pool
                if not torch.equal(d[:, pages].cpu(), data) or (
                        scale is not None and not torch.equal(
                            pool.scale[:, pages].cpu(), scale)):
                    raise SmokeFailure("engine features: a restore did not "
                                       "write the snapshot's bytes exactly")
        return ok
    eng._restore_preempted = checked


def phase_engine_features(cfg, dev="cuda"):
    """llama_7b bf16 (seeded random weights, full depth) through the engine
    at the JAX engine's defaults: shared-prefix traffic in two waves against
    the cache off; a full batch at priority 0 preempted by a priority-1
    arrival, spilled and restored, then the same with a zero-capacity spill
    tier (replay from the prefix), against both features off; a sampled
    request alone and in a batch, and the card's sampler against the CPU's
    over its logits rows; a 300-token cold prompt through the dense tier
    against the bucketed chunk fills.  Returns the launch counts of every
    engine run of the phase and its summary."""
    import numpy as np
    import torch
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingEngine, GenRequest, build_sampler)
    from paddle_tpu_torch.models.llama import init_params
    from paddle_tpu_torch.serving import SpillTier

    params = init_params(cfg, make_generator(SEED, dev), device=dev)
    V, L = cfg.vocab_size, cfg.num_layers
    rng = np.random.default_rng(SEED + 25)
    phase_counts, summary = {}, {}

    def engine(**kw):
        return ContinuousBatchingEngine(cfg, params, max_batch=4,
                                        block_size=16, num_blocks=256,
                                        device=dev, **kw)

    def counted(eng, arrivals):
        return counted_drive(eng, arrivals, phase_counts)

    # ---- shared-prefix traffic: two waves of two, against the cache off
    prefix = rng.integers(0, V, FEAT_PREFIX).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, V, FEAT_SUFFIX)
                               .astype(np.int32)]) for _ in range(4)]
    # one throwaway pass at the same shapes first: the first dense prefill
    # and chunk fill of a length pay one-time costs that TTFT must not see
    warm = engine()
    for w in (0, 2):
        drive(warm, [(0, p, 2, {}) for p in prompts[w:w + 2]])
    del warm
    runs = {}
    for name, kw in (("cache on", {}),
                     ("cache off", {"enable_prefix_caching": False})):
        eng = engine(**kw)
        waves = [counted(eng, [(0, p, FEAT_NEW, {}) for p in prompts[w:w + 2]])
                 for w in (0, 2)]
        run = {k: {**waves[0][k], **waves[1][k]}
               for k in ("ids", "ttft", "rows")}
        run["rids"] = waves[0]["rids"] + waves[1]["rids"]
        run["counts"] = {k: waves[0]["counts"].get(k, 0)
                         + waves[1]["counts"].get(k, 0)
                         for k in set(waves[0]["counts"])
                         | set(waves[1]["counts"])}
        run["prefix"] = eng.prefix_stats()
        leak = eng.kv_leak_report()
        if leak["leaked"] or leak["unaccounted"] or leak["slot_blocks"]:
            raise SmokeFailure(f"engine features {name}: KV accounting not "
                               f"clean: {leak}")
        runs[name] = run
        if name == "cache off":
            ref_eng = eng
        else:
            del eng
    check_requests("engine features prefix", runs, prompts, [FEAT_NEW] * 4,
                   V)
    on, off = runs["cache on"], runs["cache off"]
    hits = on["prefix"]["hits"]
    if hits < 3 or on["prefix"]["hit_blocks"] != 3 * FEAT_PREFIX // 16:
        raise SmokeFailure(f"engine features: prefix hits {on['prefix']}, "
                           "expected 3 of 32 blocks")
    # the dense tier launches nothing of the library: chunk fills only for
    # the three suffixes, none with the cache off
    if on["counts"].get("prefill_block", 0) != 3 * L or \
            off["counts"].get("prefill_block", 0):
        raise SmokeFailure(f"engine features: prefill_block launches "
                           f"{on['counts'].get('prefill_block')} (cache on) "
                           f"/ {off['counts'].get('prefill_block')} (off), "
                           f"expected {3 * L} / 0")
    divs_prefix = same_ids("engine features prefix hit vs cache off",
                           ref_eng, on, off, prompts)
    del ref_eng
    torch.cuda.empty_cache()
    summary["prefix"] = dict(
        hits=hits, hit_blocks=on["prefix"]["hit_blocks"],
        prefill_tokens_computed=on["prefix"]["prefill_tokens_computed"],
        prefill_tokens_computed_cache_off=off["prefix"][
            "prefill_tokens_computed"],
        ttft_s=[on["ttft"][r] for r in on["rids"]],
        ttft_cache_off_s=[off["ttft"][r] for r in off["rids"]],
        divergences=divs_prefix, launches=on["counts"])
    info(f"engine features prefix: {hits} hits ({on['prefix']['hit_blocks']} "
         f"blocks), prefill tokens computed {on['prefix']['prefill_tokens_computed']}"
         f" (cache off {off['prefix']['prefill_tokens_computed']}); TTFT s "
         f"{[round(t, 4) for t in summary['prefix']['ttft_s']]} (cache off "
         f"{[round(t, 4) for t in summary['prefix']['ttft_cache_off_s']]}); "
         f"ids: {len(divs_prefix)} of 4 requests diverge; launches "
         f"{on['counts']}")

    # ---- priority traffic: preempt + spill + restore, then replay
    lo = [rng.integers(0, V, n).astype(np.int32) for n in FEAT_LO]
    hi = rng.integers(0, V, FEAT_HI).astype(np.int32)
    arrivals = [(0, p, FEAT_NEW, {}) for p in lo] + \
        [(FEAT_HI_STEP, hi, FEAT_NEW, {"priority": 1})]
    pprompts = lo + [hi]
    runs, res_stats, timers = {}, {}, {}
    for name, kw in (("spill", {}),
                     ("replay", {"spill_tier": SpillTier(capacity_bytes=0)}),
                     ("features off", {"enable_prefix_caching": False,
                                       "enable_preemption": False})):
        eng = engine(**kw)
        timers[name] = timed_methods(eng, ("preempt", "_restore_preempted",
                                           "_replay_into_slot"))
        check_restores_exact(eng)
        runs[name] = counted(eng, arrivals)
        res_stats[name] = eng.resilience_stats()
        leak = eng.kv_leak_report()
        if leak["leaked"] or leak["unaccounted"] or leak["slot_blocks"]:
            raise SmokeFailure(f"engine features {name}: KV accounting not "
                               f"clean: {leak}")
        if name != "features off":
            del eng
    check_requests("engine features priority", runs, pprompts,
                   [FEAT_NEW] * 5, V)
    sp, rp = res_stats["spill"], res_stats["replay"]
    if sp["preemptions"] < 1 or sp["restores"] < 1 or \
            sp["spilled_requests"]:
        raise SmokeFailure(f"engine features: spill run {sp}")
    if rp["preemptions"] < 1 or rp["prefix_replays"] < 1 or \
            rp["restores"] or rp["spill_evictions"] < 1:
        raise SmokeFailure(f"engine features: replay run {rp}")
    divs_spill = same_ids("engine features preempt/restore vs features off",
                          eng, runs["spill"], runs["features off"], pprompts)
    divs_replay = same_ids("engine features replay vs features off", eng,
                           runs["replay"], runs["features off"], pprompts)
    if divs_spill:
        raise SmokeFailure("engine features: a spilled and restored request "
                           "changed its ids (the restore is byte-exact and "
                           "the decode rows independent)")
    del eng
    torch.cuda.empty_cache()
    summary["priority"] = dict(
        spill=dict(preemptions=sp["preemptions"], restores=sp["restores"],
                   spilled_bytes_max=runs["spill"]["max_spilled"],
                   preempt_s=timers["spill"]["preempt"],
                   restore_s=timers["spill"]["_restore_preempted"],
                   engine_spill_save_secs=sp["spill_save_secs"],
                   engine_spill_restore_secs=sp["spill_restore_secs"],
                   wall_s=runs["spill"]["wall"]),
        replay=dict(preemptions=rp["preemptions"],
                    prefix_replays=rp["prefix_replays"],
                    spill_evictions=rp["spill_evictions"],
                    preempt_s=timers["replay"]["preempt"],
                    replay_s=timers["replay"]["_replay_into_slot"],
                    wall_s=runs["replay"]["wall"],
                    divergences=divs_replay),
        features_off_wall_s=runs["features off"]["wall"],
        hi_ttft_s={k: r["ttft"][r["rids"][-1]] for k, r in runs.items()})
    info(f"engine features priority: spill run {sp['preemptions']} "
         f"preemption(s), {sp['restores']} restore(s), up to "
         f"{runs['spill']['max_spilled']} bytes spilled; preempt s "
         f"{timers['spill']['preempt']}, restore s "
         f"{timers['spill']['_restore_preempted']} (synchronised); replay "
         f"run {rp['prefix_replays']} replay(s), replay s "
         f"{timers['replay']['_replay_into_slot']}; ids: restored identical "
         f"to features off, replay diverges in {len(divs_replay)} request(s);"
         f" priority-1 TTFT s {summary['priority']['hi_ttft_s']}")

    # ---- sampled: alone and in a batch; the card's sampler vs the CPU's
    sprompt = rng.integers(0, V, FEAT_SAMPLED_LENS[0]).astype(np.int32)
    others = [rng.integers(0, V, n).astype(np.int32)
              for n in FEAT_SAMPLED_LENS[1:]]
    skw = dict(FEAT_SAMPLED, seed=1234)
    solo = counted(engine(), [(0, sprompt, FEAT_NEW, skw)])
    batch = counted(engine(), [(0, sprompt, FEAT_NEW, skw)] +
                    [(0, o, FEAT_NEW, {}) for o in others])
    check_requests("engine features sampled", {"solo": solo}, [sprompt],
                   [FEAT_NEW], V)
    check_requests("engine features sampled", {"batch": batch},
                   [sprompt] + others, [FEAT_NEW] * 4, V)
    eng = engine()
    divs_sampled = same_ids("engine features sampled batch vs solo", eng,
                            batch, solo, [sprompt])
    rid, T0 = batch["rids"][0], len(sprompt)
    rows = np.stack([batch["rows"][rid][i] for i in range(FEAT_NEW)])
    pos = [T0 + i for i in range(FEAT_NEW)]
    args = ([skw["seed"]] * FEAT_NEW, pos, [0.8] * FEAT_NEW,
            [50] * FEAT_NEW, [0.9] * FEAT_NEW)
    sampler = build_sampler()
    card = sampler(torch.from_numpy(rows).to(dev), *args).cpu().numpy()
    cpu = sampler(torch.from_numpy(rows), *args).numpy()
    served = batch["ids"][rid][T0:]
    if not (card == cpu).all() or not (card == served).all():
        raise SmokeFailure(f"engine features: sampler ids card {card.tolist()}"
                           f" / CPU {cpu.tolist()} / served {served.tolist()}")
    reqs = [GenRequest(i, sprompt, 1, seed=i, **FEAT_SAMPLED)
            for i in range(4)]
    lg4 = torch.from_numpy(rows[:4]).to(dev)
    eng._sample_rows(reqs, lg4, pos[:4])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        eng._sample_rows(reqs, lg4, pos[:4])
    sample_ms = (time.perf_counter() - t0) * 1e3 / 20
    summary["sampled"] = dict(divergences=divs_sampled,
                              sampler_ms_b4_v32000=sample_ms,
                              ids_card_eq_cpu=True)
    info(f"engine features sampled: batch vs solo "
         f"{'identical' if not divs_sampled else divs_sampled}; the card's "
         f"sampler, the CPU's and the served ids agree on {FEAT_NEW} rows; "
         f"sampler {sample_ms:.4f} ms a call at B 4, V {V} (keys, filters "
         f"and draw on the card, ids to the host)")

    # ---- dense cold tier against the bucketed chunk fills
    p300 = rng.integers(0, V, FEAT_DENSE).astype(np.int32)
    tiers, secs, engs = {}, {"dense": [], "bucketed": []}, {
        "dense": engine(enable_prefix_caching=False),
        "bucketed": engine(prefill_buckets=(16, 64, 256),
                           enable_prefix_caching=False)}
    for name in ("dense", "bucketed", "bucketed", "dense", "dense",
                 "bucketed"):            # in turns; each call cold
        run = counted(engs[name], [(0, p300, 1, {})])
        secs[name].append(run["wall"])
        tiers[name] = (run, torch.from_numpy(engs[name].last_prefill_logits))
        if name == "dense" and run["counts"]:
            raise SmokeFailure(f"engine features: the dense tier launched "
                               f"{run['counts']}")
    del engs
    truth = fp32_last_logits(eng, p300)
    err = check_layer_out("engine features bucketed vs dense tier logits",
                          tiers["bucketed"][1], tiers["dense"][1], truth,
                          TOL["bfloat16"])
    summary["dense_tier"] = dict(prefill_s=secs["dense"],
                                 bucketed_prefill_s=secs["bucketed"],
                                 max_err=err,
                                 launches_dense=tiers["dense"][0]["counts"],
                                 launches_bucketed=tiers["bucketed"][0][
                                     "counts"])
    info(f"engine features dense tier: {FEAT_DENSE}-token cold prompt in "
         f"{secs['dense']} s (bucketed {secs['bucketed']} s, each the "
         f"admission step synchronised, in turns D B B D D B); logits max "
         f"|bucketed - dense| {err:.3e}; launches dense "
         f"{tiers['dense'][0]['counts']} bucketed "
         f"{tiers['bucketed'][0]['counts']}")
    del eng, params
    torch.cuda.empty_cache()
    for op in ("decode_block", "prefill_block"):
        if phase_counts.get(op, 0) <= 0:
            raise SmokeFailure(f"engine features: {op} never launched "
                               f"({phase_counts})")
    summary["launches"] = phase_counts
    return phase_counts, summary


# ------------------------------------------- GPT layer of kernels 1-2
# GPT-125M served through the ops: the JAX package's engine serves Llama
# configs only (it reads cfg.kv_heads, cfg.rope_theta and params["head"]),
# and GPT reaches the serving megakernels through decode_block /
# prefill_block with decode_block_spec(gpt_cfg, block_size).  16-token
# pages, buckets (16, 64, 256), four prompts of these lengths from numpy
# seed 0, 32 greedy new tokens each.
GPT_SERVE_BS, GPT_SERVE_BUCKETS = 16, (16, 64, 256)
GPT_SERVE_LENS, GPT_SERVE_NEW = (600, 37, 300, 517), 32
GPT_SERVE_CHECK_LAYERS = 2
# one GPT layer call's launches besides its entry point: two LayerNorms, 4
# GEMMs (qkv, proj, fc1, fc2) of the regime's kernel, the unrotated K / V
# write and the attention
GPT_CHAIN = {"layer_norm_rows": 2, "rope_kv_write": 1, "paged_attention": 1}
GPT_GEMMS = 4
# the GPT layer's GEMMs at GPT-125M: (label, K, N, epilogue)
GPT_MATMULS = (("qkv", 768, 2304, "bias"), ("proj", 768, 768, "bias_resid"),
               ("fc1", 768, 3072, "bias_gelu"),
               ("fc2", 3072, 768, "bias_resid"))


# ------------------------------------------------- speculative decoding
# phase engine's settings (B 4, 16-token pages, buckets (16, 64, 256),
# prefix caching and preemption off) under spec_config: K proposals a step
# through a window of W tokens, the drafts the target itself and a 2-layer
# llama_7b-width model of another seed; the int8 + int8-KV run at 4 layers
SPEC_K, SPEC_W, SPEC_NEW = 3, 16, 32
SPEC_LENS = (20, 137, 64, 300)
# prompts whose whole context (prompt + SPEC_SHORT_NEW - 1 tokens) stays
# inside the draft's window, so a self-draft sees what the target sees
SPEC_SHORT_LENS, SPEC_SHORT_NEW = (4, 6, 8, 5), 8
SPEC_DRAFT_LAYERS, SPEC_QUANT_LAYERS = 2, 4


def spec_drive(eng, prompts, new, tag="engine spec"):
    """Serve ``prompts`` (all queued before the first step, so baseline and
    speculative runs see the same admissions: no prefix hit, no eviction,
    no preemption) with the plain serving ops refused and the launch
    counts set to 0 just before and read just after.  Returns ids in
    request order, the first step's ``last_logits`` (the verify's column 0
    under speculation), the decode steps' wall and tokens after the first
    step, the run's wall, its nonzero launch counts and the warm-up
    launches of the graphs captured in the run (``warm``, counted in
    ``counts``)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    torch.cuda.synchronize()
    captured = set(eng._graphs)
    layer.reset_counts()
    rids = [eng.add_request(p, new) for p in prompts]
    res, first, dec_s, dec_tok = {}, None, 0.0, 0
    t0 = time.perf_counter()
    with NoPlainPath():
        while eng.queue or any(s is not None for s in eng.slots):
            tok0 = eng.decode_tokens
            ts = time.perf_counter()
            res.update(eng.step())
            te = time.perf_counter()
            if eng.last_logits is not None:
                live = [s for s in range(eng.B) if eng.slots[s] is not None]
                if not np.isfinite(eng.last_logits[live]).all():
                    raise SmokeFailure(f"{tag}: non-finite logits")
            if first is None:
                first = np.array(eng.last_logits)
            else:
                dec_s += te - ts
                dec_tok += eng.decode_tokens - tok0
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in layer.launch_counts().items() if n}
    warm = {}
    for name, g in eng._graphs.items():
        if name not in captured:
            for k, n in g.warmup_launches.items():
                warm[k] = warm.get(k, 0) + n
    leak = eng.kv_leak_report()
    if leak["leaked"] or leak["unaccounted"] or \
            leak["free_blocks"] != eng.alloc.num_blocks:
        raise SmokeFailure(f"{tag}: KV accounting not clean: {leak}")
    return dict(ids=[res[r] for r in rids], first=first, dec_s=dec_s,
                dec_tok=dec_tok, wall=wall, counts=counts, warm=warm)


def spec_timers(eng):
    """Wrap the engine's draft and verify with synchronised host timers;
    returns ``{"draft": [s a proposal], "verify": [s a verify]}``."""
    import torch
    out = {"draft": [], "verify": []}
    runner = eng._spec

    def timed(fn, t):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
            return r
        return run
    runner.draft = timed(runner.draft, out["draft"])
    runner.verify = timed(runner.verify, out["verify"])
    return out


def spec_case(tag, engine, prompts, new, drafts, totals):
    """One configuration: the baseline engine, then the same engine
    settings under each draft of ``drafts`` ({name: (draft cfg, draft
    params)}).  Checks (a) ids identical to the baseline's, request by
    request; (b) the first step's logits (the verify's column 0) equal to
    the baseline step's bit for bit; (c) ``decode_block`` launches exactly
    layers x (K+1) a spec step (replays of the verify's graph) plus its
    capture's warm-up call, ``prefill_block`` as the baseline's, every
    kernel the baseline launched launched again.  Returns the summary."""
    import numpy as np
    from paddle_tpu_torch.spec_decode import SpecDecodeConfig
    base_eng = engine(None)
    L = base_eng.cfg.num_layers
    base = spec_drive(base_eng, prompts, new)
    del base_eng
    out = {"baseline": dict(
        tokens_per_s=base["dec_tok"] / base["dec_s"], wall_s=base["wall"],
        engine_steps_per_token=1.0, launches=base["counts"])}
    for k, n in base["counts"].items():
        totals[k] = totals.get(k, 0) + n
    for name, (dcfg, dparams) in drafts.items():
        eng = engine(SpecDecodeConfig(draft_cfg=dcfg, draft_params=dparams,
                                      k=SPEC_K, window=SPEC_W))
        timers = spec_timers(eng)
        run = spec_drive(eng, prompts, new)
        stats = eng.spec_stats()
        del eng
        for i, (a, b) in enumerate(zip(run["ids"], base["ids"])):
            if not np.array_equal(a, b):
                j = int((a != b).nonzero()[0][0]) - len(prompts[i])
                raise SmokeFailure(
                    f"{tag} {name}: request {i} differs from the baseline "
                    f"at generated token {j} ({int(a[len(prompts[i]) + j])} "
                    f"vs {int(b[len(prompts[i]) + j])})")
        if not np.array_equal(run["first"].view(np.uint32),
                              base["first"].view(np.uint32)):
            diff = float(np.abs(run["first"] - base["first"]).max())
            raise SmokeFailure(f"{tag} {name}: the first verify's column-0 "
                               f"logits differ from the baseline step's by "
                               f"up to {diff:.3e}")
        want = L * (SPEC_K + 1) * stats["spec_steps"] + \
            run["warm"].get("decode_block", 0)
        c = run["counts"]
        if c.get("decode_block") != want or \
                c.get("prefill_block") != base["counts"].get("prefill_block") \
                or set(c) != set(base["counts"]):
            raise SmokeFailure(
                f"{tag} {name}: launches {c}, expected decode_block {want} "
                f"({L} layers x {SPEC_K + 1} x {stats['spec_steps']} spec "
                f"steps + the verify capture's warm-up), prefill_block and "
                f"the kernel set as the baseline's {base['counts']}")
        for k, n in c.items():
            totals[k] = totals.get(k, 0) + n
        draft_ms = 1e3 * sum(timers["draft"]) / len(timers["draft"])
        verify_ms = 1e3 * sum(timers["verify"]) / len(timers["verify"])
        out[name] = dict(
            tokens_per_s=run["dec_tok"] / run["dec_s"], wall_s=run["wall"],
            engine_steps_per_token=stats["engine_steps_per_token"],
            acceptance_rate=stats["acceptance_rate"],
            spec_steps=stats["spec_steps"],
            rollback_pages=stats["rollback_pages"],
            draft_ms_per_proposal=draft_ms, verify_ms=verify_ms,
            launches=c)
        info(f"{tag} {name} (k {SPEC_K}, window {SPEC_W}): ids identical to "
             f"the baseline's on {len(prompts)} requests; first verify's "
             f"column-0 logits bit-equal to the baseline step's; "
             f"decode_block {c['decode_block']} = {L} x {SPEC_K + 1} x "
             f"{stats['spec_steps']} spec steps + "
             f"{run['warm'].get('decode_block', 0)} warm-up; "
             f"engine_steps_per_token "
             f"{stats['engine_steps_per_token']:.4f}, acceptance rate "
             f"{stats['acceptance_rate']:.4f}; decode tokens/s "
             f"{out[name]['tokens_per_s']:.1f} (baseline "
             f"{out['baseline']['tokens_per_s']:.1f}); draft "
             f"{draft_ms:.3f} ms a proposal, verify {verify_ms:.3f} ms "
             f"({SPEC_K + 1} decode steps); wall {run['wall']:.2f} s "
             f"(baseline {base['wall']:.2f} s)")
    return out


def phase_engine_spec(cfg, dev="cuda"):
    """Speculative decoding through ``ContinuousBatchingEngine(...,
    spec_config=SpecDecodeConfig(...))`` on phase engine's settings:
    llama_7b bf16 at full depth (weights from phase engine's seed) with a
    self-draft and a 2-layer llama_7b-width draft of another seed, then
    the same at 4 layers PTQ-exported to int8 weights and int8 KV (the
    verify runs ``wo_dec``, ``rope_kv_write_q8`` and
    ``paged_attention_q8``; the drafts stay full width).  Each held to
    the same engine without ``spec_config`` on the same requests
    (``spec_case``).  Returns the launch counts of every engine run of the
    phase and its summary."""
    import numpy as np
    import torch
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import init_params, llama_7b
    from paddle_tpu_torch.quantization import ServeQuantConfig

    rng = np.random.default_rng(SEED + 29)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SPEC_LENS]
    short = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in SPEC_SHORT_LENS]
    dcfg = llama_7b(num_layers=SPEC_DRAFT_LAYERS, dtype=cfg.dtype)
    dparams = init_params(dcfg, make_generator(SEED + 1, dev), device=dev)
    totals, summary = {}, {}
    for tag, layers, qc in (
            ("engine spec", cfg.num_layers, None),
            ("engine spec quant", SPEC_QUANT_LAYERS,
             ServeQuantConfig(**ENGINE_QUANT))):
        tcfg = llama_7b(num_layers=layers, dtype=cfg.dtype)
        params = init_params(tcfg, make_generator(SEED, dev), device=dev)

        def engine(spec):
            return ContinuousBatchingEngine(
                tcfg, params, max_batch=4, block_size=16, num_blocks=256,
                prefill_buckets=(16, 64, 256), enable_prefix_caching=False,
                enable_preemption=False, quant_config=qc, spec_config=spec,
                device=dev)
        summary[tag] = spec_case(
            tag, engine, prompts, SPEC_NEW,
            {"self-draft": (tcfg, params),
             f"{SPEC_DRAFT_LAYERS}-layer draft": (dcfg, dparams)}, totals)
        if qc is None:
            summary["draft_logits_max_err"] = check_draft_logits(
                tcfg, params, short[2], dev)
            summary["engine spec in-window"] = spec_case(
                "engine spec in-window", engine, short, SPEC_SHORT_NEW,
                {"self-draft": (tcfg, params)}, totals)
        del params
        torch.cuda.empty_cache()
    return totals, summary


def check_draft_logits(cfg, params, prompt, dev="cuda"):
    """The draft program's logits over a prompt that fits its window
    (``SpecDecodeConfig``'s draft at llama_7b, bf16: dense masked attention
    and torch products) against the engine's prefill logits over the same
    prompt (chunk fills through kernel 2), with the fp32 plain chain as the
    truth (``check_layer_out``).  Returns the max |error|."""
    import torch
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.spec_decode import build_draft_program
    from paddle_tpu_torch.spec_decode.draft import assemble_windows
    eng = ContinuousBatchingEngine(cfg, params, max_batch=1, block_size=16,
                                   num_blocks=8, prefill_buckets=(16,),
                                   enable_prefix_caching=False,
                                   enable_preemption=False, device=dev)
    eng.add_request(prompt, 1)
    eng.run_to_completion()
    plain = torch.from_numpy(eng.last_prefill_logits)
    truth = fp32_last_logits(eng, prompt)
    win, ctx = assemble_windows([prompt.tolist()], SPEC_W, 1)
    draft = build_draft_program(cfg, SPEC_W, dev)
    with torch.no_grad():
        got = draft.logits(params, torch.from_numpy(win).to(dev),
                           torch.from_numpy(ctx).to(dev))[0].cpu()
    err = check_layer_out(f"engine spec draft logits ({len(prompt)} tokens "
                          f"in a {SPEC_W}-token window)", got, plain, truth,
                          TOL["bfloat16"])
    info(f"engine spec draft logits vs the engine's prefill logits: max "
         f"|err| {err:.3e}, argmax {int(got.argmax())} / "
         f"{int(plain.argmax())} / {int(truth.argmax())} (draft / engine / "
         f"fp32)")
    return err


# ------------------------------------------- the engine's CUDA graphs
# The decode step, the fixed-width sampler and the spec draft / verify as
# captured CUDA graphs (aot/graphs.py) against the same engine's eager
# launch chain (engine._set_eager(True)), phase engine's settings; then
# the aot_dir warm start in a child process that cannot find nvcc.
GRAPH_LENS, GRAPH_NEW = (20, 600, 137, 64, 300, 45, 512, 256), 32
GRAPH_ENGINE = dict(max_batch=4, block_size=16, num_blocks=256,
                    prefill_buckets=(16, 64, 256),
                    enable_prefix_caching=False, enable_preemption=False)
GRAPH_TIMED = 20                       # sampler calls timed a mode


def graph_engine(cfg, params, dev="cuda", **kw):
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    return ContinuousBatchingEngine(cfg, params, device=dev,
                                    **GRAPH_ENGINE, **kw)


def graph_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(SEED + 30)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in GRAPH_LENS]


def decode_profile(eng, prompts, steps=8):
    """Phase engine's steady-state window: 4 requests of 64 prompt tokens
    admitted, then ``steps`` decode steps at B 4 under the profiler;
    returns (wall ms a step, device busy ms a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[:4]:
        eng.add_request(p[:64], steps + 4)
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    ts = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - ts) * 1e3 / steps
    busy = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        busy += max(us, 0.0) / steps / 1e3
    eng.run_to_completion()
    return wall, busy


def decode_host_split(eng, prompts, steps=8):
    """Unprofiled steady state at B 4: the mean wall of a synchronised
    ``engine.step()``, of the decode program alone on the batch the next
    step feeds (``engine._run("decode", ...)`` and a synchronize: its
    launches and the device; it writes each slot's next KV row, which that
    step writes again with the same values) and of its logits' copy to
    the host; the rest of a step is the scheduler's host work.  Returns
    (step ms, program ms, copy ms)."""
    import torch
    for p in prompts[:4]:
        eng.add_request(p[:64], 3 * steps + 4)
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    step = (time.perf_counter() - t0) * 1e3 / steps
    prog = copy = 0.0
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng._run("decode", tokens=eng.tokens, lengths=eng.lengths,
                       bt=eng.block_table)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out.cpu()
        prog += t1 - t0
        copy += time.perf_counter() - t1
    eng.run_to_completion()
    return step, prog * 1e3 / steps, copy * 1e3 / steps


def same_run_ids(tag, a, b, prompts):
    """Ids of two runs over the same prompts identical, request by
    request, and their first decode step's logits bit-equal."""
    import numpy as np
    for i, (x, y) in enumerate(zip(a["ids"], b["ids"])):
        if not np.array_equal(x, y):
            j = int((x != y).nonzero()[0][0]) - len(prompts[i])
            raise SmokeFailure(f"{tag}: request {i} differs at generated "
                               f"token {j}")
    if not np.array_equal(a["first"].view(np.uint32),
                          b["first"].view(np.uint32)):
        raise SmokeFailure(f"{tag}: the first decode step's logits differ "
                           f"by up to "
                           f"{float(np.abs(a['first'] - b['first']).max()):.3e}")


def graph_ab(tag, eng, prompts, totals):
    """The same engine over the same requests with its graphs, then with
    its eager launch chain: ids identical, the first step's logits
    bit-equal, the launch counts of the graph run the eager run's plus
    the warm-up calls of the graphs captured in it; decode wall against
    busy (profiled) and tokens/s both ways."""
    graphs = spec_drive(eng, prompts, GRAPH_NEW, tag)
    g_wall, g_busy = decode_profile(eng, prompts)
    g_split = decode_host_split(eng, prompts)
    eng._set_eager(True)
    eager = spec_drive(eng, prompts, GRAPH_NEW, tag)
    e_wall, e_busy = decode_profile(eng, prompts)
    e_split = decode_host_split(eng, prompts)
    eng._set_eager(False)
    same_run_ids(f"{tag} graphs vs eager", graphs, eager, prompts)
    keys = set(eager["counts"]) | set(graphs["warm"])
    want = {k: eager["counts"].get(k, 0) + graphs["warm"].get(k, 0)
            for k in keys}
    if graphs["counts"] != want:
        raise SmokeFailure(f"{tag}: graph run launches {graphs['counts']}, "
                           f"expected the eager run's {eager['counts']} plus "
                           f"the captures' warm-up {graphs['warm']}")
    for k, n in graphs["counts"].items():
        totals[k] = totals.get(k, 0) + n
    stats = eng.aot_stats()["graphs"]
    split = ("step_ms_unprofiled", "program_ms", "logits_copy_ms")
    out = dict(
        decode_step_ms=g_wall, decode_busy_ms=g_busy,
        decode_tokens_per_s=graphs["dec_tok"] / graphs["dec_s"],
        **dict(zip(split, g_split)),
        eager=dict(decode_step_ms=e_wall, decode_busy_ms=e_busy,
                   decode_tokens_per_s=eager["dec_tok"] / eager["dec_s"],
                   **dict(zip(split, e_split))),
        capture_ms={n: g["capture_ms"] for n, g in stats.items()},
        launches=graphs["counts"], warmup_launches=graphs["warm"])
    info(f"{tag}: {len(prompts)} requests x {GRAPH_NEW} new, ids identical "
         f"graphs / eager, first step's logits bit-equal; launches = eager "
         f"+ warm-up exactly ({graphs['counts']}); decode step wall "
         f"{g_wall:.3f} ms busy {g_busy:.3f} ms profiled (eager "
         f"{e_wall:.3f} / {e_busy:.3f}); unprofiled step {g_split[0]:.3f} "
         f"ms = program {g_split[1]:.3f} + logits copy {g_split[2]:.3f} + "
         f"host rest (eager {e_split[0]:.3f} = {e_split[1]:.3f} + "
         f"{e_split[2]:.3f} + rest); tokens/s "
         f"{out['decode_tokens_per_s']:.1f} (eager "
         f"{out['eager']['decode_tokens_per_s']:.1f}); capture ms "
         f"{out['capture_ms']}")
    return out, graphs["ids"]


def graph_sampler_ab(eng, dev="cuda"):
    """The fixed-width sampler's graph against its eager chain on the same
    rows: sub-batches of 1 to B rows, ids equal; ms a call at B rows."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference.serving import GenRequest
    V = eng.cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    lg = torch.randn((eng.B, V), generator=gen, device=dev) * 3
    reqs = [GenRequest(i, np.zeros(1, np.int32), 1, seed=100 + i,
                       **FEAT_SAMPLED) for i in range(eng.B)]
    pos = [17 + 9 * i for i in range(eng.B)]
    ids, ms = {}, {}
    for eager in (False, True, True, False):
        eng._set_eager(eager)
        ids[eager] = [eng._sample_rows(reqs[:n], lg[:n], pos[:n])
                      for n in range(1, eng.B + 1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_TIMED):
            eng._sample_rows(reqs, lg, pos)
        ms.setdefault(eager, []).append(
            (time.perf_counter() - t0) * 1e3 / GRAPH_TIMED)
    eng._set_eager(False)
    for n, (a, b) in enumerate(zip(ids[False], ids[True]), 1):
        if not np.array_equal(a, b):
            raise SmokeFailure(f"engine graphs sampler: {n} rows, graph ids "
                               f"{a.tolist()} vs eager {b.tolist()}")
    out = dict(sampler_ms=min(ms[False]), eager_sampler_ms=min(ms[True]),
               turns=ms)
    info(f"engine graphs sampler: ids of 1..{eng.B} rows identical graph / "
         f"eager; {out['sampler_ms']:.4f} ms a call (eager "
         f"{out['eager_sampler_ms']:.4f}; in turns G E E G, each the best "
         f"of {GRAPH_TIMED} synchronised calls' mean: "
         f"{[round(t, 4) for t in ms[False]]} / "
         f"{[round(t, 4) for t in ms[True]]})")
    return {k: v for k, v in out.items() if k != "turns"}


def pool_parts(eng):
    from paddle_tpu_torch.ops.paged_kv import is_quantized_pool
    return [p for pool in (eng.pool_k, eng.pool_v)
            for p in ((pool.data, pool.scale) if is_quantized_pool(pool)
                      else (pool,))]


def graph_spec_ab(cfg, params, dparams, dcfg, prompts, totals, dev="cuda"):
    """A speculating engine (self-draft, k 3, window 16) over phase engine
    spec's prompts with its eager chain, then its pools cloned, every
    program captured (decode, sampler, draft, verify) and the pools held
    to the clone byte for byte, then the same run through the graphs: ids
    identical, the first verify's column 0 bit-equal; draft ms a proposal
    and verify ms both ways; the same for the 2-layer draft's proposals.
    Returns the summary."""
    import torch
    from paddle_tpu_torch.spec_decode import SpecDecodeConfig
    out = {}
    for name, (dc, dp) in (("self-draft", (cfg, params)),
                           (f"{SPEC_DRAFT_LAYERS}-layer draft",
                            (dcfg, dparams))):
        eng = graph_engine(cfg, params, dev, spec_config=SpecDecodeConfig(
            draft_cfg=dc, draft_params=dp, k=SPEC_K, window=SPEC_W))
        timers = spec_timers(eng)
        eng._set_eager(True)
        eager = spec_drive(eng, prompts, SPEC_NEW, "engine graphs spec")
        e_t = {k: 1e3 * sum(v) / len(v) for k, v in timers.items()}
        for v in timers.values():
            v.clear()
        eng._set_eager(False)
        parts = pool_parts(eng)
        before = [p.clone() for p in parts]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        eng._capture_all()
        torch.cuda.synchronize()
        pool_mb = (torch.cuda.memory_reserved() - r0) / 2 ** 20
        for p, b in zip(parts, before):
            if not torch.equal(p.view(torch.uint8), b.view(torch.uint8)):
                raise SmokeFailure("engine graphs spec: warm-up or capture "
                                   "wrote the pools")
        del before
        graphs = spec_drive(eng, prompts, SPEC_NEW, "engine graphs spec")
        g_t = {k: 1e3 * sum(v) / len(v) for k, v in timers.items()}
        same_run_ids(f"engine graphs spec {name}", graphs, eager, prompts)
        if graphs["counts"] != eager["counts"]:
            raise SmokeFailure(f"engine graphs spec {name}: graph run "
                               f"launches {graphs['counts']} vs eager "
                               f"{eager['counts']} (captured before it)")
        for k, n in graphs["counts"].items():
            totals[k] = totals.get(k, 0) + n
        stats = eng.aot_stats()["graphs"]
        out[name] = dict(
            draft_ms_per_proposal=g_t["draft"], verify_ms=g_t["verify"],
            eager_draft_ms_per_proposal=e_t["draft"],
            eager_verify_ms=e_t["verify"],
            tokens_per_s=graphs["dec_tok"] / graphs["dec_s"],
            eager_tokens_per_s=eager["dec_tok"] / eager["dec_s"],
            capture_ms={n: g["capture_ms"] for n, g in stats.items()},
            graph_pool_mib=pool_mb)
        info(f"engine graphs spec {name}: ids identical graphs / eager, "
             f"first verify's column 0 bit-equal, pools unchanged by the "
             f"warm-up and capture of {sorted(stats)} (+{pool_mb:.1f} MiB "
             f"reserved); draft {g_t['draft']:.3f} ms a proposal (eager "
             f"{e_t['draft']:.3f}), verify {g_t['verify']:.3f} ms (eager "
             f"{e_t['verify']:.3f}); tokens/s "
             f"{out[name]['tokens_per_s']:.1f} (eager "
             f"{out[name]['eager_tokens_per_s']:.1f}); capture ms "
             f"{out[name]['capture_ms']}")
        del eng, parts
        torch.cuda.empty_cache()
    return out


def flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(0, 2)
        f.seek(f.tell() // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def graph_warm_start(cfg, eng, prompts, ids, dev="cuda"):
    """``export_engine`` into a temporary directory; a child process whose
    ``PATH`` and ``CUDA_HOME`` find no ``nvcc`` warm-starts from it: it
    must load the artifact's library, run no ``nvcc``, capture at
    construction and serve ``ids``.  Then a copy with one byte of the
    library flipped falls back with ``aot_error`` set and serves ``ids``
    too.  Returns the summary."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from paddle_tpu_torch.aot import export_engine
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "serve")
        t0 = time.perf_counter()
        export_engine(eng, art)
        export_s = time.perf_counter() - t0
        np.savez(os.path.join(tmp, "prompts.npz"), *prompts)
        path = os.pathsep.join(
            d for d in os.environ.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc")))
        env = dict(os.environ, PATH=path,
                   CUDA_HOME=os.path.join(tmp, "no-cuda"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--warm-child", art,
             os.path.join(tmp, "prompts.npz")], env=env, capture_output=True,
            text=True, timeout=900)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SmokeFailure(f"engine graphs warm start: the child exited "
                               f"{proc.returncode}: {proc.stderr[-3000:]}")
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        lib = os.path.join(art, "libpt_kernels.so")
        for i, (a, b) in enumerate(zip(rep["ids"], ids)):
            if not np.array_equal(np.asarray(a), b):
                raise SmokeFailure(f"engine graphs warm start: the child's "
                                   f"request {i} differs from the parent's")
        if not rep["aot_loaded"] or rep["nvcc_runs"] != 0 or \
                rep["nvcc_found"] or rep["library"] != lib or \
                set(rep["captured_at_construction"]) != {"decode",
                                                         "sampler"}:
            raise SmokeFailure(f"engine graphs warm start: {rep}")
        bad = os.path.join(tmp, "flipped")
        shutil.copytree(art, bad)
        flip_byte(os.path.join(bad, "libpt_kernels.so"))
        cold = graph_engine(cfg, eng.params, dev, aot_dir=bad)
        if cold.aot_loaded or "CRC" not in (cold.aot_error or ""):
            raise SmokeFailure(f"engine graphs: a flipped library byte "
                               f"loaded ({cold.aot_error})")
        got = spec_drive(cold, prompts, GRAPH_NEW, "engine graphs fallback")
        for i, (a, b) in enumerate(zip(got["ids"], ids)):
            if not np.array_equal(a, b):
                raise SmokeFailure(f"engine graphs fallback: request {i} "
                                   f"differs")
        del cold
        torch.cuda.empty_cache()
    out = dict(export_s=export_s, child_s=child_s,
               child_construct_s=rep["construct_s"],
               child_capture_ms=rep["capture_ms"],
               child_nvcc_runs=rep["nvcc_runs"], fallback_error="CRC")
    info(f"engine graphs warm start: exported in {export_s:.2f} s; the "
         f"child (no nvcc on PATH or CUDA_HOME) loaded the artifact's "
         f"library, ran {rep['nvcc_runs']} nvcc, captured "
         f"{sorted(rep['captured_at_construction'])} at construction "
         f"({rep['construct_s']:.2f} s, capture ms {rep['capture_ms']}) "
         f"and served the parent's ids on {len(prompts)} requests "
         f"({child_s:.1f} s in all); a copy with a library byte flipped "
         f"fell back (CRC) and served them too")
    return out


def warm_child(art, prompts_file):
    """The warm start's child: llama_7b bf16 from phase engine's seed,
    ``ContinuousBatchingEngine(..., aot_dir=art)``, the prompts served;
    prints one JSON line."""
    import shutil
    import numpy as np
    import torch
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.models.llama import init_params, llama_7b
    cfg = llama_7b(dtype="bfloat16")
    params = init_params(cfg, make_generator(SEED, "cuda"), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = graph_engine(cfg, params, aot_dir=art)
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    graphs = eng.aot_stats().get("graphs", {})
    with np.load(prompts_file) as z:
        prompts = [z[f"arr_{i}"] for i in range(len(z.files))]
    run = spec_drive(eng, prompts, GRAPH_NEW, "engine graphs child")
    print(json.dumps(dict(
        aot_loaded=eng.aot_loaded, aot_error=eng.aot_error,
        nvcc_found=shutil.which("nvcc"),
        captured_at_construction=sorted(graphs),
        capture_ms={n: g["capture_ms"] for n, g in graphs.items()},
        construct_s=construct_s, ids=[i.tolist() for i in run["ids"]],
        **build.build_stats())), flush=True)
    return 0


def phase_engine_graphs(cfg, dev="cuda"):
    """The engine's captured programs against its eager launch chain:
    llama_7b bf16 (phase engine's seed and settings) over 8 requests of
    20-600 prompt tokens and 32 new (``graph_ab``), the sampler
    (``graph_sampler_ab``), the ``aot_dir`` warm start and its fallback
    (``graph_warm_start``), the same A/B with ``ServeQuantConfig(
    weight_dtype="int8", kv_dtype="int8")``, and speculation with both
    drafts (``graph_spec_ab``, pools held byte for byte through the
    captures).  Returns the launch counts of its graph runs and its
    summary."""
    import torch
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.models.llama import init_params, llama_7b
    from paddle_tpu_torch.quantization import ServeQuantConfig
    params = init_params(cfg, make_generator(SEED, dev), device=dev)
    prompts = graph_prompts(cfg)
    totals, summary = {}, {}
    eng = graph_engine(cfg, params, dev)
    summary["bf16"], ids = graph_ab("engine graphs bf16", eng, prompts,
                                    totals)
    summary["sampler"] = graph_sampler_ab(eng, dev)
    summary["warm_start"] = graph_warm_start(cfg, eng, prompts, ids, dev)
    del eng
    torch.cuda.empty_cache()
    qeng = graph_engine(cfg, params, dev,
                        quant_config=ServeQuantConfig(**ENGINE_QUANT))
    summary["int8"], _ = graph_ab("engine graphs int8 + int8 KV", qeng,
                                  prompts, totals)
    del qeng
    torch.cuda.empty_cache()
    rng = __import__("numpy").random.default_rng(SEED + 29)
    sprompts = [rng.integers(0, cfg.vocab_size, n).astype("int32")
                for n in SPEC_LENS]
    dcfg = llama_7b(num_layers=SPEC_DRAFT_LAYERS, dtype=cfg.dtype)
    dparams = init_params(dcfg, make_generator(SEED + 1, dev), device=dev)
    summary["spec"] = graph_spec_ab(cfg, params, dparams, dcfg, sprompts,
                                    totals, dev)
    del params, dparams
    torch.cuda.empty_cache()
    return totals, summary


def gpt_paged_rollout(params, cfg, prompts, new_tokens, *, buckets,
                      block_size, device, plain=False, feed=None,
                      profile=False, quant_config=None):
    """Serve a GPT model through the ops alone: the embedding ``wte[tok] +
    wpe[pos]``; each prompt chunk-filled through ``prefill_block`` over the
    declared ``buckets`` (``aot.buckets`` plans the chunks; a chunk after
    the first starts at ``start > 0``, and a bucket's padded tail writes
    nothing: its rows' pages are set past the pool); then greedy decode
    steps of all sequences together through ``decode_block``; the head as
    the port's GPT decoder computes it (``models/generation.py``
    ``final_logits``: LayerNorm on the fp32 final gains, the tied ``wte``
    in fp32, fp32 logits).  Each prompt gets pages for its tokens and its
    new ones; the tables are ``max_position_embeddings / block_size``
    wide.  ``quant_config`` (a ``quantization.ServeQuantConfig``): the
    full-width ``params`` are PTQ-exported through
    ``quantize_params_for_serving`` (the layers' matmuls as codes and fp32
    scales) and served with ``decode_block_spec(cfg, block_size,
    weight_dtype, group_size)``, over int8 ``QuantizedKVPool`` s when its
    ``kv_dtype`` is "int8".

    ``plain``: the plain versions (``decode_block_ref`` /
    ``prefill_block_ref``) on the same tensors.  ``feed`` [B, new_tokens]:
    the new tokens to feed in place of the greedy ones.  ``profile``: one
    more decode step after the timed ones, under the profiler (CUDA).
    Returns a dict: ``ids`` (per prompt the prompt and its new tokens,
    numpy), ``new`` [B, new_tokens], ``prefill_logits`` [B, V] (each
    prompt's last position), ``step_logits`` (one [B, V] a decode step),
    ``chunks`` (the chunk lengths in order), ``steps`` (decode steps, the
    profiled one included), ``prefill_s`` (per prompt) and ``decode_s``
    (the timed steps; host clock, synchronised on CUDA) and, with
    ``profile``, ``profiled`` = (wall ms, device-busy ms, {kernel: ms})."""
    import numpy as np
    import torch
    from paddle_tpu_torch.aot.buckets import ShapeBucketRegistry
    from paddle_tpu_torch.models.gpt import layer_norm
    from paddle_tpu_torch.ops import decode_block as db

    from paddle_tpu_torch.ops.paged_kv import zeros_kv_pool
    from paddle_tpu_torch.quantization import (ServeQuantConfig,
                                               quantize_params_for_serving)

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    qc = quant_config or ServeQuantConfig()
    spec = db.decode_block_spec(cfg, block_size, qc.weight_dtype,
                                qc.group_size)
    dec = db.decode_block_ref if plain else db.decode_block
    pre = db.prefill_block_ref if plain else db.prefill_block
    blocks = quantize_params_for_serving(params, qc)["blocks"]
    L = next(iter(blocks.values())).shape[0]
    layers = [{k: v[i] for k, v in blocks.items()} for i in range(L)]
    wte, wpe = params["wte"], params["wpe"]
    head = wte.float().t()
    P, BS = cfg.max_position_embeddings, block_size
    MB = -(-P // BS)
    B = len(prompts)
    need = [-(-(len(p) + new_tokens) // BS) for p in prompts]
    NB = sum(need)
    bt = torch.full((B, MB), -1, dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.arange(sum(need[:b]), sum(need[:b]) + n)
    shape = (NB, BS, cfg.num_heads, cfg.head_dim)
    pools = [tuple(zeros_kv_pool(shape, wte.dtype, dev,
                                 kv_quant=qc.quantized_kv)
                   for _ in range(2)) for _ in range(L)]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def logits(x):
        return layer_norm(x, params["lnf_w"], params["lnf_b"],
                          cfg.layer_norm_eps).float() @ head

    out = dict(chunks=[], prefill_s=[], step_logits=[])
    registry = ShapeBucketRegistry(buckets)
    pre_logits = []
    with torch.no_grad():
        for b, prompt in enumerate(prompts):
            sync()
            t0 = time.perf_counter()
            bt_row, start = bt[b].to(dev), 0
            for size, valid in registry.plan_chunks(len(prompt)):
                toks = torch.zeros(size, dtype=torch.long)
                toks[:valid] = torch.as_tensor(
                    np.asarray(prompt[start:start + valid]), dtype=torch.long)
                pos = start + torch.arange(size)
                page = bt[b].long().clamp(min=0)[(pos // BS).clamp(max=MB - 1)]
                blk = torch.where(torch.arange(size) < valid, page,
                                  torch.full_like(page, NB))
                blk = blk.to(dev, torch.int32)
                off = (pos % BS).to(dev, torch.int32)
                x = (wte[toks.to(dev)]
                     + wpe[pos.clamp(max=P - 1).to(dev)])[None]
                for lp, (pk, pv) in zip(layers, pools):
                    x, _, _ = pre(x, lp, pk, pv, blk, off, bt_row, None,
                                  None, spec=spec, start=start)
                out["chunks"].append(size)
                last = x[0, valid - 1]
                start += valid
            pre_logits.append(logits(last[None])[0])
            sync()
            out["prefill_s"].append(time.perf_counter() - t0)
        out["prefill_logits"] = torch.stack(pre_logits)
        btd = bt.to(dev)
        lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                               device=dev)
        if feed is not None:
            feed = torch.as_tensor(feed).to(dev)
        tok = out["prefill_logits"].argmax(-1) if feed is None else feed[:, 0]
        new = [tok]

        def step(tok, lengths):
            x = wte[tok] + wpe[lengths.long()]
            for lp, (pk, pv) in zip(layers, pools):
                x, _, _ = dec(x, lp, pk, pv, btd, lengths, None, None,
                              spec=spec)
            return logits(x)
        sync()
        t0 = time.perf_counter()
        for i in range(new_tokens - 1):
            lg = step(tok, lengths)
            out["step_logits"].append(lg)
            tok = lg.argmax(-1) if feed is None else feed[:, i + 1]
            new.append(tok)
            lengths = lengths + 1
        sync()
        out["decode_s"] = time.perf_counter() - t0
        out["steps"] = new_tokens - 1
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_ctx
            sync()
            ts = time.perf_counter()
            with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
                step(tok, lengths)
                sync()
            wall = 1e3 * (time.perf_counter() - ts)
            by = {}
            for ev in prof.key_averages():
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = getattr(ev, "self_cuda_time_total", 0.0)
                if us > 0:
                    by[ev.key.split("(")[0][:60]] = us / 1e3
            out["profiled"] = (wall, sum(by.values()), by)
            out["steps"] += 1
    out["new"] = torch.stack(new, 1).cpu().numpy()
    out["ids"] = [np.concatenate([np.asarray(p, np.int64), n])
                  for p, n in zip(prompts, out["new"])]
    return out


def gpt_serve_launches(chunks, steps, L, quant_config=None):
    """The launches of a bf16 rollout of ``chunks`` chunk fills and
    ``steps`` decode steps through ``L`` GPT layers (every other kernel 0);
    ``quant_config`` as :func:`gpt_paged_rollout` takes it: the GEMMs on
    ``wo_layer_<width>_*``, the K / V write and the attention on their int8
    variants over int8 pools."""
    qc = quant_config
    small = steps + sum(1 for n in chunks if n <= 16)
    gemm = (f"wo_layer_{qc.weight_dtype}" if qc and qc.quantized_weights
            else "gemm_xw")
    want = {"decode_block": L * steps, "prefill_block": L * len(chunks),
            f"{gemm}_small_m": GPT_GEMMS * L * small,
            f"{gemm}_tiled": GPT_GEMMS * L * (len(chunks) + steps - small)}
    q8 = "_q8" if qc and qc.quantized_kv else ""
    for k, n in GPT_CHAIN.items():
        want[k if k == "layer_norm_rows" else k + q8] = \
            n * L * (len(chunks) + steps)
    return {k: n for k, n in want.items() if n}


def gpt_layer_checks(cfg, results, dev="cuda"):
    """The GPT layer's new kernel modes alone at GPT-125M shapes against
    their plain versions on the card (``layer_norm_rows`` at [4, 768] and
    [256, 768]; ``gemm_xw`` with each bias epilogue at M 4 and 256, the
    qkv product stored split; the unrotated ``rope_kv_write`` bit-equal),
    then one GPT ``decode_block`` (B 4, lengths 1000 / 37 / 0 inactive /
    517) and ``prefill_block`` (Ts 16 after 5, Ts 256 after 300) in fp32
    (1e-4) and bf16 (2e-2 or the ratio rule), with bf16 timings; the rows
    go into ``results`` (new entry ``layer_norm_rows``; ``gpt`` parts of the
    GEMM, RoPE / KV write and layer entries).  Returns the GPT decode
    layer's (ms, bound ms)."""
    import torch
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.models.gpt import block_shapes
    from paddle_tpu_torch.ops import decode_block as db
    from paddle_tpu_torch.ops.cuda import kernels as K

    by_name = {r["name"]: r for r in results}
    spec = db.decode_block_spec(cfg, GPT_SERVE_BS)
    H, Hq, D, F = cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.ffn_size
    BS, NB, MB = GPT_SERVE_BS, 256, cfg.max_position_embeddings // 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)
    shapes = block_shapes(cfg)
    lp32 = make_layer(cfg, gen, torch.float32, dev, shapes)
    pool32 = [torch.randn(NB, BS, Hq, D, device=dev, generator=gen)
              for _ in range(2)]
    dt, tol = torch.bfloat16, TOL["bfloat16"]
    lp = {k: v.to(dt) for k, v in lp32.items()}

    # ---- layer_norm_rows
    ln = {}
    for M in (4, 256):
        x32 = torch.randn(M, H, device=dev, generator=gen)
        for dtn, ldt in (("float32", torch.float32), ("bfloat16", dt)):
            xm, w, b = (t.to(ldt) for t in (x32, lp32["ln1_w"],
                                            lp32["ln1_b"]))
            err = check_close(f"layer_norm_rows {dtn} [{M}, {H}]",
                              one_launch_bitwise("layer_norm_rows", lambda:
                                                 K.layer_norm_rows_cuda(
                                                     xm, w, b, spec.eps)),
                              K.layer_norm_rows_ref(xm, w, b, spec.eps),
                              TOL[dtn])
        ms, call = time_ms(lambda: K.layer_norm_rows_cuda(xm, w, b, spec.eps),
                           50, per_launch=True)
        plain, plain_call = time_ms(lambda: K.layer_norm_rows_ref(
            xm, w, b, spec.eps), 20)
        lib = time_ms(lambda: torch.nn.functional.layer_norm(
            xm, (H,), w, b, spec.eps), 50)[0]
        bms, bby = bound_ms((2 * M * H + 2 * H) * 2, 8 * M * H)
        ln[M] = dict(max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain,
                     plain_call_ms=plain_call, bound_ms=bms, bound_by=bby,
                     library_ms=lib)
        info(f"layer_norm_rows bf16 [{M}, {H}]: device {ms} ms (per call "
             f"{call:.4f}), F.layer_norm {lib} ms, plain {plain} ms, bound "
             f"{bms:.5f} ms ({bby}); max |err| {err:.2e}")
    results.append(dict(
        name="layer_norm_rows", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/rms_norm.cu",
        replaces="paddle_tpu/ops/pallas/decode_block.py:535",
        shape=f"[4, {H}] (GPT-125M LayerNorm, bias)", library_what=
        "torch.nn.functional.layer_norm", **ln[4],
        m256={"shape": f"[256, {H}]", **ln[256]}))

    # ---- gemm_xw's bias epilogues (the qkv product stored split)
    ep = {4: {}, 256: {}}
    for M in (4, 256):
        for label, Kd, N, epi in GPT_MATMULS:
            w32 = lp32[f"{label}_w"]
            b32 = lp32[f"{label}_b"]
            x32 = torch.randn(M, Kd, device=dev, generator=gen)
            r32 = torch.randn(M, N, device=dev, generator=gen)
            for dtn, gdt in (("float32", torch.float32), ("bfloat16", dt)):
                if gdt == torch.float32 and M != 4:
                    continue
                a, w, b, r = (t.to(gdt) for t in (x32, w32, b32, r32))
                kw = dict(bias=b, gelu=epi == "bias_gelu",
                          residual=r if epi == "bias_resid" else None)
                ref = K.gemm_xw_ref(a, w, **kw)
                if label == "qkv":
                    got = one_launch_bitwise(
                        "gemm_xw_f32" if gdt == torch.float32 else
                        "gemm_xw_small_m" if M <= 16 else "gemm_xw_tiled",
                        lambda: K.gemm_xw_cuda(a, w, qkv_head_dim=D, **kw))
                    err = max(check_close(f"gemm_xw qkv split {part} {dtn} "
                                          f"M={M}", g, rr, TOL[dtn])
                              for part, g, rr in zip(
                                  "qkv", got, K.qkv_split_ref(ref, D)))
                else:
                    err = check_close(f"gemm_xw {label} {epi} {dtn} M={M}",
                                      K.gemm_xw_cuda(a, w, **kw), ref,
                                      TOL[dtn])
            split = {"qkv_head_dim": D} if label == "qkv" else {}
            ms, call = time_ms(lambda: K.gemm_xw_cuda(a, w, **split, **kw),
                               50, per_launch=True)
            plain, plain_call = time_ms(lambda: K.gemm_xw_ref(a, w, **kw), 20)

            def library():
                y = torch.matmul(a, w) + b
                if kw["gelu"]:
                    y = torch.nn.functional.gelu(y, approximate="tanh")
                return y if kw["residual"] is None else kw["residual"] + y
            lib = time_ms(library, 50)[0]
            bms, bby = bound_ms((M * Kd + Kd * N + N + M * N + (
                M * N if epi == "bias_resid" else 0)) * 2, 2 * M * Kd * N)
            plan = gemm_plan(M, Kd, N, {
                "bias": build.EPI_BIAS, "bias_resid": build.EPI_BIAS_RESID,
                "bias_gelu": build.EPI_BIAS_GELU}[epi])
            ep[M][label] = dict(
                epilogue=epi + (" + qkv split" if split else ""),
                shape=f"[{M}, {Kd}] @ [{Kd}, {N}]", max_abs_err=err, ms=ms,
                call_ms=call, plain_ms=plain, plain_call_ms=plain_call,
                bound_ms=bms, bound_by=bby, library_ms=lib, plan=plan)
            if split:                   # the same product stored row-major
                ep[M][label]["unsplit_ms"] = time_ms(
                    lambda: K.gemm_xw_cuda(a, w, **kw), 50,
                    per_launch=True)[0]
            info(f"gemm_xw GPT {label} {ep[M][label]['epilogue']} M={M} "
                 f"[{Kd}x{N}]: device {ms} ms (per call {call:.4f}; stored "
                 f"unsplit {ep[M][label].get('unsplit_ms', '-')} ms), plain "
                 f"{plain} ms, torch.matmul + epilogue ops {lib} ms, bound "
                 f"{bms:.5f} ms ({bby}), max |err| {err:.2e}; plan "
                 f"{plan_text(plan)}")
    lib_what = ("torch.matmul, then the bias, GELU and residual as torch "
                "ops, timed together")
    by_name["gemm_xw_small_m"]["gpt"] = dict(library_what=lib_what, **ep[4])
    by_name["gemm_xw_tiled"]["gpt"] = dict(library_what=lib_what, **ep[256])

    # ---- the decode and prefill cases' tables (as phase_kernels')
    perm = torch.randperm(NB, device=dev, generator=gen).to(torch.int32)
    lengths, bt, bt_row = serving_tables(perm, BS, MB)

    # ---- the unrotated rope_kv_write, bit-equal, timed
    rope = {}
    for label, (M, tgt, _, _) in rope_kv_cases(lengths, bt, bt_row, None,
                                               None, BS).items():
        for dtn in ("float32", "bfloat16"):
            rdt = getattr(torch, dtn)
            args = rope_kv_inputs(M, Hq, Hq, D, rdt, gen, dev) + [
                None, None] + [pool.to(rdt) for pool in pool32]
            check_rope_kv_bitwise(f"rope_kv_write unrotated {label} {dtn}",
                                  args, tgt)
        q_, k_, v_, _, _, gk, gv = args
        ms, call = time_ms(lambda: K.rope_kv_write_cuda(
            q_, k_, v_, None, None, gk, gv, **tgt), 50, per_launch=True)
        plain, plain_call = time_ms(lambda: K.rope_kv_write_ref(
            q_, k_, v_, None, None, gk, gv, head_dim=D, **tgt), 20)
        writes = rope_kv_writes(tgt, gk)
        bms, bby = bound_ms((2 * M + 2 * writes) * Hq * D * 2, 0)
        rope[label] = dict(max_abs_err=0.0, ms=ms, call_ms=call,
                           plain_ms=plain, plain_call_ms=plain_call,
                           bound_ms=bms, bound_by=bby, library_ms=None)
        info(f"rope_kv_write unrotated {label} (GPT-125M, 12 kv heads, D "
             f"64): device {ms} ms (per call {call:.4f}), plain {plain} ms, "
             f"bound {bms:.5f} ms ({bby}); bit-equal to the plain version")
    by_name["rope_kv_write"]["gpt"] = dict(
        shape="unrotated (no RoPE): B=4, 12 kv heads, D=64",
        **rope["decode"], prefill=dict(shape="Ts=256 after 300 positions",
                                       **rope["prefill Ts 256"]))

    # ---- one GPT decode_block and prefill_block
    kernel_err, ratios = {}, {}
    pre_cases = [(16, 5, 11), (256, 300, 200)]
    x32 = torch.randn(4, H, device=dev, generator=gen)
    xs = {Ts: torch.randn(1, Ts, H, device=dev, generator=gen)
          for Ts, _, _ in pre_cases}
    for dtn, ldt in (("float32", torch.float32), ("bfloat16", dt)):
        lpd = {k: v.to(ldt) for k, v in lp32.items()}
        pk0, pv0 = (p.to(ldt) for p in pool32)
        kernel_err[("decode_block", dtn)] = check_decode_layer(
            f"GPT decode_block {dtn}", spec, lpd, pk0, pv0, x32.to(ldt), bt,
            lengths, None, None, TOL[dtn],
            ratios.setdefault(("decode_block", dtn), []))
        for Ts, start, valid in pre_cases:
            key = ("prefill_block", dtn)
            e = check_prefill_layer(
                f"GPT prefill_block {dtn} Ts={Ts}", spec, lpd, pk0, pv0,
                xs[Ts].to(ldt), start, valid, bt_row, NB, None, None,
                TOL[dtn], ratios.setdefault(key, []))
            kernel_err[key] = max(kernel_err.get(key, 0.0), e)

    # ---- bf16 timings of the two GPT layers against their bounds
    pk, pv = (p.to(dt) for p in pool32)
    x = x32.to(dt)
    live = [int(n) + 1 for n in lengths.tolist()]
    per = dict(GPT_CHAIN)
    dec_by = {}

    def dec_call():
        return db.decode_block(x, lp, pk, pv, bt, lengths, None, None,
                               spec=spec)
    layer_launches("decode_block", dec_call, "layer_norm_rows", GPT_GEMMS)
    _, call = time_ms(dec_call, 50, dec_by)
    ms = chain_ms(dec_by, "gemm_xw_small_m_tma",
                  {**per, "gemm_xw_small_m_tma": GPT_GEMMS})
    paced = paced_ms(dec_call)
    host = host_ms(dec_call)
    plain, plain_call = time_ms(lambda: db.decode_block_ref(
        x, lp, pk, pv, bt, lengths, None, None, spec=spec), 5)
    dms, dby = bound_ms(*gpt_layer_bytes_ops(cfg, None, -1, False, 4,
                                             sum(live), 3))
    by_name["decode_block"]["gpt"] = dict(
        shape="GPT-125M layer, B=4, lengths 1000/37/0(inactive)/517",
        max_abs_err=kernel_err[("decode_block", "bfloat16")], ms=ms,
        call_ms=call, paced_ms=paced, host_ms=host, plain_ms=plain,
        plain_call_ms=plain_call, bound_ms=dms, bound_by=dby,
        library_ms=None,
        bf16_vs_fp32_ratio=max(ratios[("decode_block", "bfloat16")]))
    info(f"GPT decode_block bf16 (GPT-125M layer, B=4): device {ms:.5f} ms "
         f"(device-paced {paced:.5f} ms a call back to back; per call "
         f"{call:.4f} ms; host enqueue {host:.4f} ms), plain "
         f"device {plain} ms, bound {dms:.5f} ms ({dby}), device / bound "
         f"{ms / dms:.1f}; kernels {short(dec_by)}")
    layer_ms = (ms, dms)
    for Ts, start, valid in pre_cases:
        xp = xs[Ts].to(dt)
        pos = start + torch.arange(Ts, device=dev)
        blk = bt_row.clamp(min=0)[pos // BS]
        blk[valid:] = NB
        blk, off = blk.to(torch.int32), (pos % BS).to(torch.int32)
        pre_by = {}

        def pre_call():
            return db.prefill_block(xp, lp, pk, pv, blk, off, bt_row, None,
                                    None, spec=spec, start=start)
        layer_launches("prefill_block", pre_call, "layer_norm_rows",
                       GPT_GEMMS)
        _, call = time_ms(pre_call, 20, pre_by)
        gemm = "gemm_xw_small_m_tma" if Ts <= 16 else "gemm_xw_tiled_wg"
        ms = chain_ms(pre_by, gemm, {**per, gemm: GPT_GEMMS})
        paced = paced_ms(pre_call)
        plain, plain_call = time_ms(lambda: db.prefill_block_ref(
            xp, lp, pk, pv, blk, off, bt_row, None, None, spec=spec,
            start=start), 3)
        pms, pby = bound_ms(*gpt_layer_bytes_ops(
            cfg, None, -1, False, Ts, start + Ts, valid,
            sum(start + i + 1 for i in range(Ts))))
        info(f"GPT prefill_block bf16 Ts={Ts} start={start} valid={valid}: "
             f"device {ms:.5f} ms (device-paced {paced:.5f}; per call "
             f"{call:.4f} ms), plain device "
             f"{plain} ms, bound {pms:.5f} ms ({pby}); kernels "
             f"{short(pre_by)}")
        if Ts == 256:
            by_name["prefill_block"]["gpt"] = dict(
                shape="GPT-125M layer, Ts=256, start=300, valid=200",
                max_abs_err=kernel_err[("prefill_block", "bfloat16")],
                ms=ms, call_ms=call, paced_ms=paced, plain_ms=plain,
                plain_call_ms=plain_call, bound_ms=pms, bound_by=pby,
                library_ms=None, bf16_vs_fp32_ratio=max(
                    ratios[("prefill_block", "bfloat16")]))
    gpt_race_checks("GPT bf16", spec, lp, pk, pv, bt, lengths, bt_row, NB,
                    gen, tol, dev)
    return layer_ms


def gpt_race_checks(tag, spec, lp, pk0, pv0, bt, lengths, bt_row, NB, gen,
                    tol, dev="cuda"):
    """:func:`chain_race_check` of the GPT layer ``lp`` (its LayerNorms and
    the products after them under programmatic dependencies) at decode (B
    4 over ``bt`` / ``lengths``) and at a Ts 256 prefill chunk after 300
    positions (200 valid rows), two inputs each, over copies of the pools
    ``pk0`` / ``pv0``."""
    import torch
    from paddle_tpu_torch.ops import decode_block as db
    H, dt = spec.hidden, next(v for k, v in lp.items() if "__" not in k).dtype
    pos = 300 + torch.arange(256, device=dev)
    blk = bt_row.clamp(min=0)[pos // spec.block_size]
    blk[200:] = NB
    blk = blk.to(torch.int32)
    off = (pos % spec.block_size).to(torch.int32)
    cases = {
        "decode": ((4, H), lambda x, lq, pk, pv, fn=db.decode_block:
                   fn(x, lq, pk, pv, bt, lengths, None, None, spec=spec)[0],
                   slice(None)),
        "prefill Ts 256": ((1, 256, H), lambda x, lq, pk, pv,
                           fn=db.prefill_block: fn(
                               x, lq, pk, pv, blk, off, bt_row, None, None,
                               spec=spec, start=300)[0],
                           (slice(None), slice(0, 200)))}
    for label, (shape, call, keep) in cases.items():
        xs = [torch.randn(*shape, device=dev, generator=gen).to(dt)
              for _ in range(2)]
        refs = []
        for x in xs:
            plain = call(x, lp, pool_clone(pk0), pool_clone(pv0),
                         fn=db.decode_block_ref if label == "decode"
                         else db.prefill_block_ref)
            truth = call(x.float(), _f32_layer(lp), truth_pool(pk0),
                         truth_pool(pv0), fn=db.decode_block_ref
                         if label == "decode" else db.prefill_block_ref)
            refs.append((plain[keep], truth[keep]))
        pk, pv = pool_clone(pk0), pool_clone(pv0)
        chain_race_check(f"{tag} {label}",
                         lambda x: call(x, lp, pk, pv)[keep], xs, refs, tol)


def gpt_layer_bytes_ops(cfg, width, gs, kvq, M, live, writes, pairs=None,
                        itemsize=2):
    """(bytes, operations) of one GPT layer call over ``M`` rows with
    weight-only ``width`` matmuls (None: full width, ``itemsize`` bytes a
    weight), over an int8 pool when ``kvq``: the matmul codes and fp32
    scales (or the weights), the norm gains and the biases once, ``live``
    K / V positions read (codes and a scale a head, or values), ``writes``
    rows written, x read and the output written; 2 M K N operations a
    GEMM and 4 D a head for each of the ``pairs`` (row, position) pairs of
    attention (default ``live``, a decode call's)."""
    from paddle_tpu_torch.models.gpt import block_shapes
    nbytes = ops = 0
    for name, shape in block_shapes(cfg).items():
        if len(shape) == 1:
            nbytes += shape[0] * itemsize
            continue
        K, N = shape
        if width is None:
            nbytes += K * N * itemsize
        else:
            codes = K * N if width == "int8" else K // 2 * N
            nbytes += codes + 4 * N * (1 if gs == -1 else -(-K // gs))
        ops += 2 * M * K * N
    Hq, D = cfg.num_heads, cfg.head_dim
    kv_row = 2 * Hq * ((D + 4) if kvq else D * itemsize)   # k and v
    nbytes += (live + writes) * kv_row + 2 * M * cfg.hidden_size * itemsize
    return nbytes, ops + 4 * Hq * D * (live if pairs is None else pairs)


def gpt_step_bound_ms(cfg, cached, itemsize=2, quant_config=None):
    """Least time of one GPT decode step: every layer's parameters once (a
    quantized layer's codes and scales), the tied head once in bf16, the
    ``cached`` K / V rows once (codes and scales over int8 pools)."""
    qc = quant_config
    layer, _ = gpt_layer_bytes_ops(
        cfg, qc and qc.weight_dtype, qc.group_size if qc else -1,
        bool(qc and qc.quantized_kv), 0, cached, 0, itemsize)
    return 1e3 * (cfg.num_layers * layer
                  + cfg.vocab_size * cfg.hidden_size * itemsize) \
        / HBM_BYTES_PER_S


def phase_gpt_serve(results, dev="cuda"):
    """GPT-125M (``gpt_125m(dtype="bfloat16")``: 12 layers, H 768, 12 heads,
    D 64, F 3072, V 50304, 1024 positions; ``init_params`` seed 0) served
    through ``decode_block`` / ``prefill_block`` by
    :func:`gpt_paged_rollout`: the GPT layer's kernel modes alone first
    (:func:`gpt_layer_checks`), then four prompts of 600 / 37 / 300 / 517
    tokens (numpy seed 0) and 32 greedy new tokens each, launch counts
    exactly as predicted with the plain ops refused, finite logits, ids in
    the vocabulary; then at 2 layers (the biases and gains drawn at
    random) the prefill and first decode step logits of the kernel path
    against the plain path on the card, both held to an fp32 plain run.
    Returns the rollout's launch counts and a summary."""
    import dataclasses

    import numpy as np
    import torch
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.ops.cuda import layer

    cfg = tgpt.gpt_125m(dtype="bfloat16")
    layer_ms, layer_bound = gpt_layer_checks(cfg, results, dev)
    torch.cuda.empty_cache()
    params = tgpt.init_params(cfg, make_generator(SEED, dev), device=dev)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in GPT_SERVE_LENS]
    kw = dict(buckets=GPT_SERVE_BUCKETS, block_size=GPT_SERVE_BS,
              device=dev)
    gpt_paged_rollout(params, cfg, prompts, 4, **kw)          # warm
    layer.reset_counts()
    with NoPlainPath():
        out = gpt_paged_rollout(params, cfg, prompts, GPT_SERVE_NEW,
                                profile=True, **kw)
    counts = layer.launch_counts()
    got = {k: n for k, n in counts.items() if n}
    want = gpt_serve_launches(out["chunks"], out["steps"], cfg.num_layers)
    if got != want:
        raise SmokeFailure(f"gpt serve: launches {got}, predicted {want} "
                           f"({out['steps']} decode steps, chunks "
                           f"{out['chunks']})")
    V = cfg.vocab_size
    finite = bool(torch.isfinite(out["prefill_logits"]).all()) and all(
        bool(torch.isfinite(lg).all()) for lg in out["step_logits"])
    shapes_ok = tuple(out["prefill_logits"].shape) == (len(prompts), V) \
        and all(tuple(lg.shape) == (len(prompts), V)
                for lg in out["step_logits"])
    ids_ok = all(len(i) == len(p) + GPT_SERVE_NEW and np.array_equal(
        i[:len(p)], p) and 0 <= i.min() and i.max() < V
        for i, p in zip(out["ids"], prompts))
    if not (finite and shapes_ok and ids_ok):
        raise SmokeFailure(f"gpt serve: finite {finite}, logits shapes "
                           f"{shapes_ok}, ids {ids_ok}")
    wall, busy, by = out["profiled"]
    steps = GPT_SERVE_NEW - 1
    step_ms = 1e3 * out["decode_s"] / steps
    cached = sum(GPT_SERVE_LENS) + len(prompts) * GPT_SERVE_NEW
    bound = gpt_step_bound_ms(cfg, cached)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    summary = dict(
        decode_step_ms=step_ms, decode_tokens_per_s=len(prompts) * steps
        / out["decode_s"], profiled_step_wall_ms=wall,
        profiled_step_busy_ms=busy, step_bound_ms=bound,
        prefill_ms=[1e3 * t for t in out["prefill_s"]],
        chunks=out["chunks"], layer_ms=layer_ms, layer_bound_ms=layer_bound,
        launches=got)
    info(f"gpt serve: GPT-125M bf16 x {cfg.num_layers} layers, prompts "
         f"{list(GPT_SERVE_LENS)}, {GPT_SERVE_NEW} new tokens each; launches "
         f"exactly as predicted ({out['steps']} decode steps, chunks "
         f"{out['chunks']}): {got}")
    info(f"gpt serve: decode step {step_ms:.3f} ms ({steps} steps at B "
         f"{len(prompts)}), {summary['decode_tokens_per_s']:.1f} decode "
         f"tokens/s; step bound {bound:.4f} ms (weights, tied head, cached "
         f"K / V); profiled step wall {wall:.3f} ms, device busy "
         f"{busy:.3f} ms; top {[(k, round(v, 4)) for k, v in top]}")
    info(f"gpt serve: prefill ms per prompt "
         f"{[round(t, 3) for t in summary['prefill_ms']]}; GPT layer "
         f"(decode, B 4) {layer_ms:.5f} ms against its bound "
         f"{layer_bound:.5f} ms")
    del params
    torch.cuda.empty_cache()

    # 2 layers: the kernel path against the plain path on the card
    cfg2 = dataclasses.replace(cfg, num_layers=GPT_SERVE_CHECK_LAYERS)
    cfg32 = dataclasses.replace(cfg2, dtype="float32")
    gen = make_generator(SEED, dev)
    p2 = tgpt.init_params(cfg2, gen, device=dev)
    for name, t in p2["blocks"].items():
        if name.endswith("_b") or name.startswith("ln"):
            t.normal_(0.0, 0.02, generator=gen)
            if name.startswith("ln") and name.endswith("_w"):
                t.mul_(5.0).add_(1.0)
    p32 = {k: (v.float() if not isinstance(v, dict) else
               {n: w.float() for n, w in v.items()}) for k, v in p2.items()}
    kern = gpt_paged_rollout(p2, cfg2, prompts, 2, **kw)
    plain = gpt_paged_rollout(p2, cfg2, prompts, 2, plain=True,
                              feed=kern["new"], **kw)
    truth = gpt_paged_rollout(p32, cfg32, prompts, 2, plain=True,
                              feed=kern["new"], **kw)
    for what, key in (("prefill", "prefill_logits"),
                      ("first decode step", "step_logits")):
        g, p, t = (r[key] if key == "prefill_logits" else r[key][0]
                   for r in (kern, plain, truth))
        check_layer_out(f"gpt serve x 2 layers {what} logits", g, p, t,
                        TOL["bfloat16"])
    summary["check_argmax_equal"] = bool(torch.equal(
        kern["prefill_logits"].argmax(-1), plain["prefill_logits"].argmax(-1)))
    return counts, summary


# ------------------------------------------------- the quantized GPT layer
# the JAX bench's int8_weights_int8_kv serve_quant row (bench.py:731-776) in
# its GPT form, served at GPT-125M's 12 layers; and the three branches of
# the quantized GPT layer held against the plain path at 2 layers
GPT_QUANT = dict(weight_dtype="int8", kv_dtype="int8")
GPT_QUANT_BRANCHES = (("int8 + int8 KV", GPT_QUANT),
                      ("int4 g64", dict(weight_dtype="int4", group_size=64)),
                      ("bf16 + int8 KV", dict(kv_dtype="int8")))
# the weight-only layouts of the GPT GEMMs checked alone; the timed ones
GPT_WO = (("int8", -1), ("int4", -1), ("int4", 64))
GPT_WO_TIMED = (("int8", -1), ("int4", 64))


def gpt_quant_checks(cfg, results, dev="cuda"):
    """The quantized GPT layer's new kernel modes alone at GPT-125M shapes
    against their plain versions: ``wo_layer`` with the bias epilogue and
    the qkv split, the bias and residual, the bias and GELU, at M 4 and
    256, int8 and int4 per channel and int4 in groups of 64 (bf16, the
    ratio rule), and on the fp32 lane (``wo_f32``, 1e-4); the unrotated
    ``rope_kv_write_q8`` bit-equal (B 4 decode, Ts 256 after 300);
    ``paged_attention_q8`` at D 64 with one q head a kv head (decode at
    lengths 1000 / 37 / 0 / 517, prefill Ts 16 after 5 and Ts 256 after
    300); one quantized GPT ``decode_block`` and ``prefill_block`` (int8
    weights over int8 pools, int4 g64 over full-width pools, int8 in fp32),
    with bf16 times beside bounds, plain versions and library calls; the
    rows go into ``results`` (``gpt`` parts of the weight-only, RoPE / KV
    and attention entries, ``gpt_quant`` parts of the layer entries).
    Returns the int8 + int8 KV decode layer's (ms, bound ms)."""
    import torch
    from paddle_tpu_torch.models.gpt import block_shapes
    from paddle_tpu_torch.ops import decode_block as db
    from paddle_tpu_torch.ops.cuda import kernels as K
    from paddle_tpu_torch.quantization import (ServeQuantConfig,
                                               dequantize_block_weight)

    by_name = {r["name"]: r for r in results}
    H, Hq, D = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    BS, NB, MB = GPT_SERVE_BS, 256, cfg.max_position_embeddings // 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 22)
    shapes = block_shapes(cfg)
    lp32 = make_layer(cfg, gen, torch.float32, dev, shapes)
    pool32 = [torch.randn(NB, BS, Hq, D, device=dev, generator=gen)
              for _ in range(2)]
    dt, tol = torch.bfloat16, TOL["bfloat16"]
    mats = {k: v for k, v in lp32.items() if k.endswith("_w")
            and not k.startswith("ln")}

    # ---- wo_layer with the GPT layer's epilogues
    err, ratios, timed = {}, {}, {}
    for width, gs in GPT_WO:
        ql = export_layer(mats, width, gs)
        for label, Kd, N, epi in GPT_MATMULS:
            codes, scale = ql[f"{label}_w__q"], ql[f"{label}_w__s"]
            b32 = lp32[f"{label}_b"]
            split = {"qkv_head_dim": D} if label == "qkv" else {}
            for M in (4, 256):
                x32 = torch.randn(M, Kd, device=dev, generator=gen)
                r32 = torch.randn(M, N, device=dev, generator=gen)

                def kw_of(t):
                    return dict(width=width, group_size=gs,
                                bias=b32.to(t), gelu=epi == "bias_gelu",
                                residual=r32.to(t) if epi == "bias_resid"
                                else None)

                def parts(y):
                    return torch.stack(K.qkv_split_ref(y, D)) if split \
                        else y
                x, kw = x32.to(dt), kw_of(dt)
                name = wo_name(width, M, dt)

                def run():
                    out = K.wo_layer_cuda(x, codes, scale, **split, **kw)
                    return torch.stack(out) if split else out
                got = one_launch_bitwise(name, run)
                plain = parts(K.wo_layer_ref(x, codes, scale, **kw))
                truth = parts(K.wo_layer_ref(x32, codes, scale,
                                             **kw_of(torch.float32)))
                key = f"{label} {epi}{' + qkv split' if split else ''}"
                e = check_layer_out(f"{name} g{gs} GPT {key} [{M}, {Kd}] @ "
                                    f"[{Kd}, {N}]", got, plain, truth, tol,
                                    ratios.setdefault(name, []))
                err[name] = max(err.get(name, 0.0), e)
                if M == 4:                      # the fp32 lane
                    got = one_launch_bitwise("wo_layer_f32", lambda: (
                        lambda o: torch.stack(o) if split else o)(
                        K.wo_layer_cuda(x32, codes, scale, **split,
                                        **kw_of(torch.float32))))
                    e = check_close(f"wo_layer_f32 {width} g{gs} GPT {key}",
                                    got, truth, TOL["float32"])
                    err["wo_layer_f32"] = max(err.get("wo_layer_f32", 0.0),
                                              e)
                if (width, gs) not in GPT_WO_TIMED:
                    continue
                # the kernel's call alone (run() stacks the split parts)
                ms, call = time_ms(lambda: K.wo_layer_cuda(
                    x, codes, scale, **split, **kw), 50, per_launch=True)
                plain_ms, plain_call = time_ms(
                    lambda: K.wo_layer_ref(x, codes, scale, **kw), 20)
                wdq = dequantize_block_weight(
                    codes, scale, ServeQuantConfig(width, gs), Kd).to(dt)

                def library():
                    y = torch.matmul(x, wdq) + kw["bias"]
                    if kw["gelu"]:
                        y = torch.nn.functional.gelu(y, approximate="tanh")
                    r = kw["residual"]
                    return y if r is None else r + y
                lib = time_ms(library, 50)[0]
                nb = (M * Kd * 2 + codes.numel() + 4 * scale.numel()
                      + N * 2 + M * N * 2 * (2 if epi == "bias_resid" else 1))
                bms, bby = bound_ms(nb, 2 * M * Kd * N)
                plan = wo_plan(M, Kd, N, width, gs)
                timed.setdefault(name, {})[f"{key} g{gs}"] = dict(
                    shape=f"[{M}, {Kd}] @ [{Kd}, {N}] {width} g{gs}",
                    max_abs_err=e, ms=ms, call_ms=call, plain_ms=plain_ms,
                    plain_call_ms=plain_call, bound_ms=bms, bound_by=bby,
                    library_ms=lib, plan=plan)
                info(f"{name} GPT {key} g{gs} [{M}x{Kd}x{N}]: device {ms} ms "
                     f"(per call {call:.4f}), plain {plain_ms} ms, torch.matmul"
                     f" on the dequantized bf16 weight + epilogue ops {lib} "
                     f"ms, bound {bms:.5f} ms ({bby}); plan {plan_text(plan)}")
        del ql
    lib_what = ("torch.matmul on the weight dequantized to bf16 beforehand, "
                "then the bias, GELU and residual as torch ops")
    for name in WO_LAYER:
        gpt = dict(max_abs_err=err[name], library_what=lib_what,
                   **timed.get(name, {}))
        if name in ratios:
            gpt["bf16_vs_fp32_ratio"] = max(ratios[name])
        by_name[name]["gpt"] = gpt
    info(f"wo_layer GPT epilogues (bias + qkv split, bias + residual, bias + "
         f"GELU) x int8 / int4 / int4 g64 x M 4, 256 in bf16 and fp32 x "
         f"within tolerance; max |err| {err}")

    # ---- the decode and prefill cases' tables (as gpt_layer_checks')
    perm = torch.randperm(NB, device=dev, generator=gen).to(torch.int32)
    lengths, bt, bt_row = serving_tables(perm, BS, MB)

    # ---- the unrotated rope_kv_write into int8 pools, bit-equal, timed
    rope = {}
    for label, (M, tgt, _, _) in rope_kv_cases(lengths, bt, bt_row, None,
                                               None, BS).items():
        for dtn in ("float32", "bfloat16"):
            rdt = getattr(torch, dtn)
            pk, pv = (q8_pool(p, rdt) for p in pool32)
            hq, hk, hv, _, _ = rope_q8_hard_inputs(M, Hq, Hq, D, rdt,
                                                   SEED + 29 + M, dev)
            check_rope_q8_bitwise(f"rope_kv_write_q8 unrotated {label} hard "
                                  f"rows {dtn}", hq, hk, hv, None, None, pk,
                                  pv, tgt)
            q, k, v = rope_kv_inputs(M, Hq, Hq, D, rdt, gen, dev)
            check_rope_q8_bitwise(f"rope_kv_write_q8 unrotated {label} {dtn}",
                                  q, k, v, None, None, pk, pv, tgt)
        ms, call = time_ms(lambda: K.rope_kv_write_cuda(
            q, k, v, None, None, pk, pv, **tgt), 50, per_launch=True)
        plain, plain_call = time_ms(lambda: K.rope_kv_write_ref(
            q, k, v, None, None, pk, pv, head_dim=D, **tgt), 20)
        writes = rope_kv_writes(tgt, pk.data)
        # k and v rows read; a byte a code and 4 bytes a scale stored;
        # absmax, divide and round a value
        bms, bby = bound_ms(2 * M * Hq * D * 2 + writes * 2 * Hq * (D + 4),
                            writes * 2 * Hq * 3 * D)
        rope[label] = dict(max_abs_err=0.0, ms=ms, call_ms=call,
                           plain_ms=plain, plain_call_ms=plain_call,
                           bound_ms=bms, bound_by=bby, library_ms=None)
        info(f"rope_kv_write_q8 unrotated {label} (GPT-125M, 12 kv heads, D "
             f"64): device {ms} ms (per call {call:.4f}), plain {plain} ms, "
             f"bound {bms:.5f} ms ({bby}); bit-equal to the plain version "
             "in fp32 and bf16, random and hard rows")
    by_name["rope_kv_write_q8"]["gpt"] = dict(
        shape="unrotated (no RoPE): B=4, 12 kv heads, D=64, int8 pool",
        **rope["decode"], prefill=dict(shape="Ts=256 after 300 positions",
                                       **rope["prefill Ts 256"]))

    # ---- paged_attention_q8 at D 64, one q head a kv head
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pk8, pv8 = (q8_pool(p, dt) for p in pool32)
    cases = {"decode": (4, dict(block_table=bt, lengths=lengths)),
             "prefill Ts 16 after 5": (16, dict(block_table=bt_row,
                                                start=5)),
             "prefill Ts 256 after 300": (256, dict(block_table=bt_row,
                                                    start=300))}
    attn = {}
    for label, (M, kw) in cases.items():
        q = torch.randn(M, Hq * D, device=dev, generator=gen).to(dt)
        got = one_launch_bitwise("paged_attention_q8", lambda:
                                 K.paged_attention_cuda(q, pk8, pv8, **kw))
        e = check_layer_out(f"paged_attention_q8 GPT {label}", got,
                            K.paged_attention_ref(q, pk8, pv8, **kw),
                            K.paged_attention_ref(q.float(), pk8, pv8, **kw),
                            tol)
        q32 = q.float()
        check_close(f"paged_attention_q8 GPT fp32 {label}",
                    one_launch_bitwise("paged_attention_q8", lambda:
                                       K.paged_attention_cuda(q32, pk8, pv8,
                                                              **kw)),
                    K.paged_attention_ref(q32, pk8, pv8, **kw),
                    TOL["float32"])
        if label == "prefill Ts 16 after 5":
            continue
        ms, call = time_ms(lambda: K.paged_attention_cuda(q, pk8, pv8, **kw),
                           50, per_launch=True)
        plain, plain_call = time_ms(lambda: K.paged_attention_ref(
            q, pk8, pv8, **kw), 10)
        if label == "decode":
            live = [int(n) + 1 for n in lengths.tolist()]
            table, n = bt, max(live)
            mask = (torch.arange(n, device=dev)[None]
                    <= lengths.long()[:, None])[:, None, None]
            qs = q.reshape(M, Hq, 1, D)
            pairs = sum(live)
        else:
            start = kw["start"]
            live = [start + M]
            table, n = bt_row[None], start + M
            mask = (torch.arange(n, device=dev)[None]
                    <= start + torch.arange(M, device=dev)[:, None])
            qs = q.reshape(1, M, Hq, D).transpose(1, 2)
            pairs = sum(start + r + 1 for r in range(M))
        idx = table.long().clamp(min=0)[:, :-(-n // BS)]
        kd, vd = (K._kv_rows(p, idx, dt).to(dt).flatten(1, 2)[:, :n]
                  .transpose(1, 2).contiguous() for p in (pk8, pv8))
        lib = time_ms(lambda: sdpa(qs, kd, vd, attn_mask=mask), 50)[0]
        bms, bby = bound_ms(sum(live) * 2 * Hq * (D + 4) + 2 * M * Hq * D * 2,
                            4 * Hq * D * pairs)
        attn[label] = dict(max_abs_err=e, ms=ms, call_ms=call, plain_ms=plain,
                           plain_call_ms=plain_call, bound_ms=bms,
                           bound_by=bby, library_ms=lib)
        info(f"paged_attention_q8 GPT {label} (12 heads, D 64, G 1): device "
             f"{ms} ms (per call {call:.4f}), plain {plain} ms, SDPA on K / V "
             f"dequantized beforehand {lib} ms, bound {bms:.5f} ms ({bby})")
        del kd, vd
    by_name["paged_attention_q8"]["gpt"] = dict(
        shape="GPT-125M: B=4, lengths 1000/37/0/517 (+1), 12 heads, D=64, "
              "G 1, int8 pools", **attn["decode"],
        prefill=dict(shape="Ts=256, start=300, one table row",
                     **attn["prefill Ts 256 after 300"]))

    # ---- whole quantized GPT layers against their plain versions
    layer_ms, live = {}, [int(n) + 1 for n in lengths.tolist()]
    x32 = torch.randn(4, H, device=dev, generator=gen)
    pre_cases = [(16, 5, 11), (256, 300, 200)]
    xs = {Ts: torch.randn(1, Ts, H, device=dev, generator=gen)
          for Ts, _, _ in pre_cases}
    for dtn, width, gs, kvq in (("bfloat16", "int8", -1, True),
                                ("bfloat16", "int4", 64, False),
                                ("float32", "int8", -1, False)):
        ldt = getattr(torch, dtn)
        kvn = "int8 KV" if kvq else f"{dtn} KV"
        spec = db.decode_block_spec(cfg, BS, width, gs)
        ql = export_layer({k: v.to(ldt) for k, v in lp32.items()}, width, gs)
        pk0, pv0 = ((q8_pool(p, ldt) if kvq else p.to(ldt)) for p in pool32)
        x = x32.to(ldt)
        tag = f"GPT {dtn} {width} g{gs} + {kvn}"

        def dec(pk, pv, fn=db.decode_block):
            return fn(x, ql, pk, pv, bt, lengths, None, None, spec=spec)
        quant_layer_launches("decode_block", lambda: dec(
            pool_clone(pk0), pool_clone(pv0)), wo_name(width, 4, ldt), kvq,
            "layer_norm_rows", GPT_GEMMS)
        layer_err = check_decode_layer(
            f"{tag} decode_block", spec, ql, pk0, pv0, x, bt, lengths, None,
            None, TOL[dtn], ratios.setdefault(tag, []))
        for Ts, start, valid in pre_cases:
            if dtn == "float32" and Ts != 16:
                continue
            xp = xs[Ts].to(ldt)
            pos = start + torch.arange(Ts, device=dev)
            blk = bt_row.clamp(min=0)[pos // BS]
            blk[valid:] = NB
            blk, off = blk.to(torch.int32), (pos % BS).to(torch.int32)
            quant_layer_launches("prefill_block", lambda: db.prefill_block(
                xp, ql, pool_clone(pk0), pool_clone(pv0), blk, off, bt_row,
                None, None, spec=spec, start=start),
                wo_name(width, Ts, ldt), kvq, "layer_norm_rows", GPT_GEMMS)
            layer_err = max(layer_err, check_prefill_layer(
                f"{tag} prefill_block Ts={Ts}", spec, ql, pk0, pv0, xp, start,
                valid, bt_row, NB, None, None, TOL[dtn],
                ratios.setdefault(tag, [])))
        if dtn == "float32":
            continue
        pk, pv = pool_clone(pk0), pool_clone(pv0)
        by = {}
        _, call = time_ms(lambda: dec(pk, pv), 50, by)
        dms = quant_chain_ms(by, "wo_dec", "layer_norm_rows", GPT_GEMMS)
        paced = paced_ms(lambda: dec(pk, pv))
        host = host_ms(lambda: dec(pk, pv))
        plain, _ = time_ms(lambda: dec(pk, pv, db.decode_block_ref), 5)
        bms, bby = bound_ms(*gpt_layer_bytes_ops(
            cfg, width, gs, kvq, 4, sum(live), 3))
        xp = xs[256].to(dt)
        pos = 300 + torch.arange(256, device=dev)
        blk = bt_row.clamp(min=0)[pos // BS]
        blk[200:] = NB
        blk, off = blk.to(torch.int32), (pos % BS).to(torch.int32)
        pby = {}
        _, pcall = time_ms(lambda: db.prefill_block(
            xp, ql, pk, pv, blk, off, bt_row, None, None, spec=spec,
            start=300), 20, pby)
        pms = quant_chain_ms(pby, "wo_wgmma", "layer_norm_rows", GPT_GEMMS)
        ppaced = paced_ms(lambda: db.prefill_block(
            xp, ql, pk, pv, blk, off, bt_row, None, None, spec=spec,
            start=300))
        pbms, pbby = bound_ms(*gpt_layer_bytes_ops(
            cfg, width, gs, kvq, 256, 556, 200,
            sum(300 + i + 1 for i in range(256))))
        key = f"{width} g{gs} + {kvn}"
        layer_ms[key] = dict(
            ms=dms, call_ms=call, paced_ms=paced, host_ms=host,
            plain_ms=plain, bound_ms=bms, bound_by=bby, library_ms=None,
            prefill_ts256_ms=pms, prefill_call_ms=pcall,
            prefill_paced_ms=ppaced,
            prefill_bound_ms=pbms, prefill_bound_by=pbby,
            max_abs_err=layer_err,
            bf16_vs_fp32_ratio=max(ratios[tag]), decode_kernels=short(by))
        info(f"GPT decode_block bf16 {key} (GPT-125M layer, B 4): device "
             f"{dms:.5f} ms (device-paced {paced:.5f}; per call {call:.4f}; "
             f"host enqueue {host:.4f} ms), plain {plain} ms, bound "
             f"{bms:.5f} ms ({bby}), device / bound {dms / bms:.1f}; "
             f"prefill_block Ts 256 after 300: device {pms:.5f} ms "
             f"(device-paced {ppaced:.5f}; per call {pcall:.4f}), bound "
             f"{pbms:.5f} ms ({pbby}); kernels {short(by)}")
        if kvq:
            gpt_race_checks(f"GPT {key}", spec, ql, pk0, pv0, bt, lengths,
                            bt_row, NB, gen, TOL[dtn], dev)
        del pk, pv
    del pool32
    torch.cuda.empty_cache()
    by_name["decode_block"]["gpt_quant"] = dict(
        shape="GPT-125M layer, B=4, lengths 1000/37/0(inactive)/517",
        **layer_ms)
    best = layer_ms["int8 g-1 + int8 KV"]
    return best["ms"], best["bound_ms"]


def phase_gpt_serve_quant(results, bf16, dev="cuda"):
    """GPT-125M (the ``gpt serve`` phase's model, weights and traffic)
    exported to ``ServeQuantConfig(weight_dtype="int8", kv_dtype="int8")``
    (the JAX bench's ``int8_weights_int8_kv`` row in its GPT form) and
    served through ``decode_block`` / ``prefill_block`` by
    :func:`gpt_paged_rollout`: the quantized layer's kernel modes alone
    first (:func:`gpt_quant_checks`), then the four prompts and 32 greedy
    new tokens each, launch counts exactly as predicted with the plain ops
    refused, finite logits, ids in the vocabulary, the decode step's wall
    and busy ms, tokens/s and prefill ms per prompt beside the bf16
    phase's (``bf16``: its summary); then at 2 layers each branch (int8
    weights with int8 KV, int4 g64 weights with a full-width pool, bf16
    weights with an int8 pool): the prefill and first decode step logits
    of the kernel path against the plain path on the card, both held to an
    fp32 plain run.  Returns the rollout's launch counts and a summary."""
    import dataclasses

    import numpy as np
    import torch
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.ops.cuda import layer
    from paddle_tpu_torch.quantization import ServeQuantConfig

    cfg = tgpt.gpt_125m(dtype="bfloat16")
    layer_ms, layer_bound = gpt_quant_checks(cfg, results, dev)
    torch.cuda.empty_cache()
    params = tgpt.init_params(cfg, make_generator(SEED, dev), device=dev)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in GPT_SERVE_LENS]
    qc = ServeQuantConfig(**GPT_QUANT)
    kw = dict(buckets=GPT_SERVE_BUCKETS, block_size=GPT_SERVE_BS,
              device=dev)
    gpt_paged_rollout(params, cfg, prompts, 4, quant_config=qc, **kw)
    layer.reset_counts()
    with NoPlainPath():
        out = gpt_paged_rollout(params, cfg, prompts, GPT_SERVE_NEW,
                                profile=True, quant_config=qc, **kw)
    counts = layer.launch_counts()
    got = {k: n for k, n in counts.items() if n}
    want = gpt_serve_launches(out["chunks"], out["steps"], cfg.num_layers,
                              qc)
    if got != want:
        raise SmokeFailure(f"gpt serve quant: launches {got}, predicted "
                           f"{want} ({out['steps']} decode steps, chunks "
                           f"{out['chunks']})")
    V = cfg.vocab_size
    finite = bool(torch.isfinite(out["prefill_logits"]).all()) and all(
        bool(torch.isfinite(lg).all()) for lg in out["step_logits"])
    shapes_ok = tuple(out["prefill_logits"].shape) == (len(prompts), V) \
        and all(tuple(lg.shape) == (len(prompts), V)
                for lg in out["step_logits"])
    ids_ok = all(len(i) == len(p) + GPT_SERVE_NEW and np.array_equal(
        i[:len(p)], p) and 0 <= i.min() and i.max() < V
        for i, p in zip(out["ids"], prompts))
    if not (finite and shapes_ok and ids_ok):
        raise SmokeFailure(f"gpt serve quant: finite {finite}, logits shapes "
                           f"{shapes_ok}, ids {ids_ok}")
    wall, busy, by = out["profiled"]
    steps = GPT_SERVE_NEW - 1
    step_ms = 1e3 * out["decode_s"] / steps
    bound = gpt_step_bound_ms(cfg, sum(GPT_SERVE_LENS) + len(prompts)
                              * GPT_SERVE_NEW, quant_config=qc)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    summary = dict(
        quant_config=qc.describe(), decode_step_ms=step_ms,
        decode_tokens_per_s=len(prompts) * steps / out["decode_s"],
        profiled_step_wall_ms=wall, profiled_step_busy_ms=busy,
        step_bound_ms=bound,
        prefill_ms=[1e3 * t for t in out["prefill_s"]],
        chunks=out["chunks"], layer_ms=layer_ms, layer_bound_ms=layer_bound,
        launches=got, bf16={k: bf16[k] for k in (
            "decode_step_ms", "decode_tokens_per_s", "profiled_step_wall_ms",
            "profiled_step_busy_ms", "step_bound_ms", "prefill_ms",
            "layer_ms")})
    info(f"gpt serve quant: GPT-125M {qc.describe()} x {cfg.num_layers} "
         f"layers, prompts {list(GPT_SERVE_LENS)}, {GPT_SERVE_NEW} new tokens "
         f"each; launches exactly as predicted ({out['steps']} decode steps, "
         f"chunks {out['chunks']}): {got}")
    info(f"gpt serve quant: decode step {step_ms:.3f} ms (bf16 "
         f"{bf16['decode_step_ms']:.3f}), {summary['decode_tokens_per_s']:.1f}"
         f" decode tokens/s (bf16 {bf16['decode_tokens_per_s']:.1f}); "
         f"step bound {bound:.4f} ms (bf16 {bf16['step_bound_ms']:.4f}); "
         f"profiled step wall {wall:.3f} ms, device busy {busy:.3f} ms (bf16 "
         f"{bf16['profiled_step_wall_ms']:.3f} / "
         f"{bf16['profiled_step_busy_ms']:.3f}); top "
         f"{[(k, round(v, 4)) for k, v in top]}")
    info(f"gpt serve quant: prefill ms per prompt "
         f"{[round(t, 3) for t in summary['prefill_ms']]} (bf16 "
         f"{[round(t, 3) for t in bf16['prefill_ms']]}); quantized GPT layer "
         f"(decode, B 4) {layer_ms:.5f} ms against its bound "
         f"{layer_bound:.5f} ms (bf16 layer {bf16['layer_ms']:.5f} ms)")
    del params
    torch.cuda.empty_cache()

    # 2 layers: each branch's kernel path against its plain path
    cfg2 = dataclasses.replace(cfg, num_layers=GPT_SERVE_CHECK_LAYERS)
    cfg32 = dataclasses.replace(cfg2, dtype="float32")
    gen = make_generator(SEED, dev)
    p2 = tgpt.init_params(cfg2, gen, device=dev)
    for name, t in p2["blocks"].items():
        if name.endswith("_b") or name.startswith("ln"):
            t.normal_(0.0, 0.02, generator=gen)
            if name.startswith("ln") and name.endswith("_w"):
                t.mul_(5.0).add_(1.0)
    p32 = {k: (v.float() if not isinstance(v, dict) else
               {n: w.float() for n, w in v.items()}) for k, v in p2.items()}
    summary["check"] = {}
    for label, q in GPT_QUANT_BRANCHES:
        bq = ServeQuantConfig(**q)
        kern = gpt_paged_rollout(p2, cfg2, prompts, 2, quant_config=bq, **kw)
        plain = gpt_paged_rollout(p2, cfg2, prompts, 2, plain=True,
                                  feed=kern["new"], quant_config=bq, **kw)
        truth = gpt_paged_rollout(p32, cfg32, prompts, 2, plain=True,
                                  feed=kern["new"], quant_config=bq, **kw)
        errs = {}
        for what, key in (("prefill", "prefill_logits"),
                          ("first decode step", "step_logits")):
            g, p, t = (r[key] if key == "prefill_logits" else r[key][0]
                       for r in (kern, plain, truth))
            errs[what] = check_layer_out(
                f"gpt serve quant {label} x 2 layers {what} logits", g, p, t,
                TOL["bfloat16"])
        summary["check"][label] = dict(errs, argmax_equal=bool(torch.equal(
            kern["prefill_logits"].argmax(-1),
            plain["prefill_logits"].argmax(-1))))
    return counts, summary


def flash_bytes_ops(B, Sq, Sk, Hq, Hkv, D, causal, itemsize):
    """(bytes, operations) of flash_fwd, flash_bwd_dq and flash_bwd_dkv:
    each input read once, each output written once; the products over the
    (q, k) pairs the mask leaves (a causal row i sees min(i + 1, Sk))."""
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    prod = 2 * B * Hq * D * pairs
    qb, kb, rows = (B * Sq * Hq * D * itemsize, B * Sk * Hkv * D * itemsize,
                    B * Hq * Sq * 4)
    return {"flash_fwd": (2 * qb + 2 * kb + rows, 2 * prod),
            "flash_bwd_dq": (3 * qb + 2 * kb + 2 * rows, 3 * prod),
            "flash_bwd_dkv": (2 * qb + 4 * kb + 2 * rows, 4 * prod)}


# the gpt phase's attention (12 heads of 64, causal) and the bert and
# encoder phases' (BERT-base: b 32 x s 128, 12 heads of 64, full; the
# bert phase's no-dropout fine-tune runs the backward there), timed beside
# the slice's shape
FLASH_GPT = ("gpt", GPT_B, GPT_S, GPT_S, 12, 12, 64, True, False, None)
FLASH_ENC = ("bert", 32, 128, 128, 12, 12, 64, False, False, None)
# the fused multi transformer phase's context call (gpt_1p3b: B 4 x 512
# tokens, 16 heads of 128, causal), checked and its forward timed
FLASH_FMT = ("fmt context", 4, 512, 512, 16, 16, 128, True, False, None)
# (label, B, Sq, Sk, Hq, Hkv, D, causal, segment ids, bias batch/head dims)
FLASH_CASES = [
    ("slice", TRAIN_B, TRAIN_S, TRAIN_S, 32, 32, 128, True, False, None),
    ("gqa 32/8 D64", 2, 512, 512, 32, 8, 64, True, False, None),
    ("non-causal", 2, 512, 512, 8, 8, 128, False, False, None),
    ("ragged S 1000", 1, 1000, 1000, 8, 8, 128, True, False, None),
    ("Sq 300 != Sk 1000", 2, 300, 1000, 8, 4, 128, False, False, None),
    ("causal Sq 1000 != Sk 300", 1, 1000, 300, 8, 4, 128, True, False,
     None),
    ("segment ids", 2, 1024, 1024, 8, 8, 128, True, True, None),
    ("bias [1,Hq,S,S]", 2, 512, 512, 8, 8, 128, False, False, (1, 8)),
    ("bias [B,1,S,S]", 2, 512, 512, 8, 8, 128, True, False, (2, 1)),
    ("S 200 D64", 2, 200, 200, 8, 8, 64, True, False, None),
    ("S 200 D128", 2, 200, 200, 8, 8, 128, True, False, None),
    ("gqa 32/4 causal", 2, 512, 512, 32, 4, 128, True, False, None),
    FLASH_ENC,
    FLASH_FMT,
]


def flash_inputs(case, gen, dev):
    import torch
    _, B, Sq, Sk, Hq, Hkv, D, causal, seg, bias = case
    t = {n: torch.randn(shape, device=dev, generator=gen) for n, shape in (
        ("q", (B, Sq, Hq, D)), ("k", (B, Sk, Hkv, D)), ("v", (B, Sk, Hkv, D)),
        ("do", (B, Sq, Hq, D)))}
    extra = [None, None, None]
    if seg:       # sorted runs, Sq == Sk, causal: every row sees itself
        ids = torch.randint(0, 4, (B, Sq), device=dev, generator=gen)
        extra[0] = extra[1] = ids.sort(dim=1).values.to(torch.int32)
    if bias is not None:
        extra[2] = torch.randn(bias + (Sq, Sk), device=dev, generator=gen)
    return t, dict(scale=D ** -0.5, causal=causal), extra


def phase_flash(results, dev="cuda"):
    """The three flash kernels against their plain versions; bf16 times at
    the training slice's, the gpt phase's and the bert phase's shapes, and
    the forward's at the fused multi transformer context's."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_attention as fc
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    err, ratios = {}, {n: [] for n in names}
    for case in FLASH_CASES:
        t32, kw, extra = flash_inputs(case, gen, dev)
        for dtn, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
            q, k, v, do = (t32[n].to(dt) for n in ("q", "k", "v", "do"))
            args = (kw["scale"], kw["causal"], *extra)
            out_p, lse_p = fa.flash_fwd_ref(q, k, v, *args)
            out, lse = fc.flash_fwd_cuda(q, k, v, *args)
            delta = fa.flash_delta(out_p, do)
            dq = fc.flash_bwd_dq_cuda(q, k, v, do, lse_p, delta, *args)
            dk, dv = fc.flash_bwd_dkv_cuda(q, k, v, do, lse_p, delta, *args)
            torch.cuda.synchronize()
            plain = fa.flash_bwd_ref(q, k, v, out_p, lse_p, do, *args)
            got = {"flash_fwd": [("out", out, out_p)],
                   "flash_bwd_dq": [("dq", dq, plain[0])],
                   "flash_bwd_dkv": [("dk", dk, plain[1]),
                                     ("dv", dv, plain[2])]}
            e_lse = check_close(f"flash {case[0]} {dtn} lse", lse, lse_p,
                                TOL["float32"])
            if dtn == "bfloat16":
                q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
                o32, l32 = fa.flash_fwd_ref(q32, k32, v32, *args)
                truth = {"out": o32, **dict(zip(("dq", "dk", "dv"),
                         fa.flash_bwd_ref(q32, k32, v32, o32, l32, do32,
                                          *args)))}
            line = [f"lse {e_lse:.1e}"]
            for kname, outs in got.items():
                for what, g, p in outs:
                    label = f"flash {case[0]} {dtn} {what}"
                    if dtn == "float32":
                        e = check_close(label, g, p, TOL[dtn])
                    else:
                        e = check_layer_out(label, g, p, truth[what],
                                            TOL[dtn], ratios[kname])
                    err[kname, dtn] = max(err.get((kname, dtn), 0.0), e)
                    line.append(f"{what} {e:.1e}")
            info(f"flash {case[0]} {dtn}: max |kernel - plain| "
                 f"{', '.join(line)}")
            del plain, got
            torch.cuda.empty_cache()

    # ---- bf16 timings at the slice's shape, the gpt phase's and the bert
    # phase's, and the forward's at the fused multi transformer context's
    timed = {case[0]: flash_times(case, gen, dev)
             for case in (FLASH_CASES[0], FLASH_GPT, FLASH_ENC)}
    timed[FLASH_FMT[0]] = flash_times(FLASH_FMT, gen, dev, backward=False)
    main = timed[FLASH_CASES[0][0]]
    other = {"gpt": f"B {GPT_B}, S {GPT_S}, 12 heads, D 64, causal",
             "bert": "B 32, S 128, 12 heads, D 64, full (bert and encoder "
                     "phases)",
             "fmt context": "B 4, S 512, 16 heads, D 128, causal"}
    for name in names:
        t = main[name]
        fwd = name == "flash_fwd"
        results.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            replaces="paddle_tpu/ops/pallas/flash_attention.py:"
            + {"flash_fwd": "269", "flash_bwd_dq": "540",
               "flash_bwd_dkv": "588"}[name],
            shape=f"B {TRAIN_B}, S {TRAIN_S}, 32 q / 32 kv heads, D 128, "
                  "causal",
            max_abs_err=err[name, "bfloat16"],
            max_abs_err_fp32=err[name, "float32"], **t,
            plain_what="flash_fwd_ref" if fwd else
            "flash_bwd_ref (dq, dk and dv together)",
            library_what="scaled_dot_product_attention forward" if fwd else
            "scaled_dot_product_attention backward alone (autograd.grad "
            "after one forward; dq, dk and dv together)",
            bf16_vs_fp32_ratio=max(ratios[name], default=None)))
        for label, shape in other.items():
            if name in timed[label]:
                results[-1][label] = dict(shape=shape, **timed[label][name])
        r = results[-1]
        info(f"{name} bf16 {r['shape']}: device {r['ms']} ms (per call "
             f"{r['call_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
             f"({r['bound_by']}), plain {r['plain_ms']} ms, library "
             f"{r['library_ms']} ms ({r['library_what']}); max |err| bf16 "
             f"{r['max_abs_err']:.2e} fp32 {r['max_abs_err_fp32']:.2e}")
    for label, t in timed.items():
        f = t["flash_fwd"]
        ms = f["ms"] or f["call_ms"]
        info(f"flash forward bf16 at {label}: {ms:.4f} ms, bound "
             f"{f['bound_ms']:.4f} ms ({f['bound_by']}, "
             f"{100 * f['bound_ms'] / ms:.1f} %), {ms / f['library_ms']:.2f} x "
             f"SDPA's forward ({f['library_ms']:.4f} ms)")
        if "flash_bwd_dq" not in t:
            continue
        dq, dkv = t["flash_bwd_dq"], t["flash_bwd_dkv"]
        pair = (dq["ms"] or dq["call_ms"]) + (dkv["ms"] or dkv["call_ms"])
        lib = dq["library_ms"] or dq["library_call_ms"]
        info(f"flash backward bf16 at {label}: dq {dq['ms']} + dkv "
             f"{dkv['ms']} = {pair:.4f} ms (bounds {dq['bound_ms']:.4f} + "
             f"{dkv['bound_ms']:.4f}), {pair / lib:.2f} x SDPA's backward "
             f"alone ({lib:.4f} ms; fwd + bwd "
             f"{dq['library_fwd_bwd_ms']} ms); the whole flash_bwd_cuda "
             f"call {dq['bwd_ms']} ms device ({dq['bwd_call_ms']:.4f} per "
             f"call), of it flash_delta {dq['delta_ms']} ms")


def flash_times(case, gen, dev, backward=True):
    """bf16 times of the flash kernels on ``case``'s inputs: per kernel
    ``ms`` / ``call_ms`` (profiler / CUDA events), ``bound_ms``,
    ``bound_by``, ``plain_ms`` / ``plain_call_ms`` and ``library_ms``; the
    backward kernels also carry SDPA's forward + backward
    (``library_fwd_bwd_ms``), the whole ``flash_bwd_cuda`` call (delta,
    dq, dk/dv: ``bwd_ms``, ``bwd_call_ms``) and its ``flash_delta``
    reduction (``delta_ms``).  The library yardsticks: SDPA on [B, H, S, D]
    views, the backward alone as ``torch.autograd.grad`` after one
    forward.  ``backward`` False: the forward alone."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_attention as fc
    t32, kw, extra = flash_inputs(case, gen, dev)
    q, k, v, do = (t32[n].to(torch.bfloat16) for n in ("q", "k", "v", "do"))
    del t32
    args = (kw["scale"], kw["causal"], *extra)
    bo = flash_bytes_ops(*case[1:8], 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    lib_fwd = time_ms(lambda: sdpa(qt, kt, vt, is_causal=kw["causal"]), 20)[0]
    plain, plain_call = time_ms(lambda: fa.flash_fwd_ref(q, k, v, *args), 3)
    ms, call = time_ms(lambda: fc.flash_fwd_cuda(q, k, v, *args), 20,
                       per_launch=True)
    bms, bby = bound_ms(*bo["flash_fwd"])
    times = {"flash_fwd": dict(ms=ms, call_ms=call, bound_ms=bms, bound_by=bby,
                               plain_ms=plain, plain_call_ms=plain_call,
                               library_ms=lib_fwd)}
    if not backward:
        return times
    out, lse = fc.flash_fwd_cuda(q, k, v, *args)
    delta = fa.flash_delta(out, do)
    plain, plain_call = time_ms(
        lambda: fa.flash_bwd_ref(q, k, v, out, lse, do, *args), 2)
    dot = do.transpose(1, 2)
    lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=kw["causal"]), (qt, kt, vt), dot), 10)[0]
    o = sdpa(qt, kt, vt, is_causal=kw["causal"])
    lib_bwd, lib_bwd_call = time_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), dot, retain_graph=True), 10)
    bwd, bwd_call = time_ms(lambda: fc.flash_bwd_cuda(
        q, k, v, out, lse, do, *args), 10)
    delta_ms = time_ms(lambda: fa.flash_delta(out, do), 20)[0]
    calls = {"flash_bwd_dq": lambda: fc.flash_bwd_dq_cuda(
                 q, k, v, do, lse, delta, *args),
             "flash_bwd_dkv": lambda: fc.flash_bwd_dkv_cuda(
                 q, k, v, do, lse, delta, *args)}
    for name, fn in calls.items():
        ms, call = time_ms(fn, 20, per_launch=True)
        bms, bby = bound_ms(*bo[name])
        times[name] = dict(
            ms=ms, call_ms=call, bound_ms=bms, bound_by=bby, plain_ms=plain,
            plain_call_ms=plain_call, library_ms=lib_bwd,
            library_call_ms=lib_bwd_call, library_fwd_bwd_ms=lib_fwd_bwd,
            bwd_ms=bwd, bwd_call_ms=bwd_call, delta_ms=delta_ms)
    return times


# ------------------------------------------------------------ linear-CE
# (label, T, H, V, chunk, x dtype, w dtype, ignore_index, label smoothing):
# the Llama and GPT heads of the train phases (V 32000 in 16 slabs of 2048,
# the last 1280 wide), then small cases
LCE_CASES = [
    ("llama head bf16", 8192, 4096, 32000, 2048, "bfloat16", "bfloat16",
     None, 0.0),
    ("llama head fp32", 8192, 4096, 32000, 2048, "float32", "float32", None,
     0.0),
    ("gpt head fp32 x bf16 w", 8192, 768, 32768, 2048, "float32",
     "bfloat16", None, 0.0),
    ("ignore_index T 1000", 1000, 1024, 5000, 2048, "bfloat16", "bfloat16",
     -100, 0.0),
    ("smoothing 0.1 last slab 903", 515, 768, 4999, 1024, "float32",
     "bfloat16", None, 0.1),
    ("bf16 odd T 1001 V 4097 H 520", 1001, 520, 4097, 1024, "bfloat16",
     "bfloat16", -100, 0.1),
    # T, the slab width and H all off the wgmma tiles (128 x 256, K 64):
    # slabs of 200 (the last 100 wide), H 200
    ("bf16 off tiles T 1000 chunk 200 H 200", 1000, 200, 1100, 200,
     "bfloat16", "bfloat16", None, 0.0),
]
LCE_TIMED = {"llama head bf16": "main", "gpt head fp32 x bf16 w": "gpt"}
LCE_NAMES = ("linear_ce_fwd", "linear_ce_dz", "linear_ce_dx",
             "linear_ce_dw")
LCE_REPLACES = {"linear_ce_fwd": "paddle_tpu/ops/pallas/linear_ce.py:152",
                "linear_ce_dz": "paddle_tpu/ops/pallas/linear_ce.py:253",
                "linear_ce_dx": "paddle_tpu/ops/pallas/linear_ce.py:253",
                "linear_ce_dw": "paddle_tpu/ops/pallas/linear_ce.py:270",
                # the fp32 x of those kernels' dot with bf16 w
                "linear_ce_split_x": "paddle_tpu/ops/pallas/linear_ce.py:152"}
# the split route's checks (fp32 x, bf16 w): nll and lse within LCE_ABS of
# the plain fp32 version, absolute, and dz (its bf16 halves' sum, dz_hi +
# dz_lo) within DZ_P_REL |g| p of it elementwise, p = exp(z - lse) being
# the part of dz that an error in z moves, plus DZ_ULPS x 2^-24 |dz|: the
# pair holds dz to 2^-17 = 128 x 2^-24 of its value, and the fp32 dz it
# splits to 8 x 2^-24 (half to one fp32 ulp of dz: at the label, dz = g
# (p - 1) is formed by a few fp32 roundings at |g|, whatever z's error;
# elsewhere the term is under 1e-6 |g| p).  A relative L2 on dz is
# dominated by the label entries and cannot tell the split from x rounded
# to bf16; these checks can: the plain version on bf16-rounded x (what a
# kernel that dropped x_lo would give) must fail the nll and the dz check.
LCE_ABS, DZ_P_REL, DZ_ULPS = 1e-4, 1e-4, 128 + 8
# ... and dw (three bf16 products on the halves of dz and x) within half a
# bf16 ulp of the plain fp32 dw (dz^T x before its rounding to w's dtype)
# plus (DZ_P_REL |g| p + dw_rel(T) |dz|)^T |x| elementwise: dz's own error
# as the dz check allows it (DZ_P_REL |g| p + DZ_ULPS 2^-24 |dz|, which
# also holds the pair's 2^-17), x's halves (2^-17 |x|), the dropped dz_lo
# x_lo (up to 2^-16 |dz x|), and the fp32 sums of the 3 T products on the
# card and of the T on the plain side, DW_ACC sqrt(3 T) 2^-24 |dz x|: a
# random walk's size (the worst case, 3 T 2^-24, is 1.5e-3 at T 8192 and
# would hide a dropped term).  At a label's column one product dominates
# dw, so dropping a cross term (an error up to 2^-8 of it) moves the bf16
# rounding of many elements by more than the allowance: the one-product
# version and each version without one cross term must fail.
DW_ACC = 8


def dw_rel(T):
    """The split dw check's allowance per unit of |dz|^T |x|."""
    return (DZ_ULPS * 2.0 ** -24 + 2.0 ** -17 + 2.0 ** -16
            + DW_ACC * (3 * T) ** 0.5 * 2.0 ** -24)


def half_ulp_bf16(v):
    """Half a bf16 ulp of each element of fp32 ``v`` (|v| in [2^(e-1),
    2^e): 2^(e-9))."""
    import torch
    _, e = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), e - 9)


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def lce_bytes_ops(T, H, V, chunk, xs, ws):
    """(bytes, operations, peak-rate dtype) of each linear-CE kernel over
    one call (all its slabs of ``chunk``): each input read once, each
    output written once, the product 2 T H V; a product with an fp32
    operand runs at the fp32 rate, except with fp32 x and bf16 w (the
    split route), where fwd and dz do the same work as two bf16 products
    (4 T H V at the bf16 rate, x read as its two bf16 halves, 4 bytes an
    element either way), dz is written as its two bf16 halves (T V (2 +
    2) bytes), and dw as three (6 T H V at the bf16 rate, dz and x read as
    their halves).  dx also moves its fp32 [T, H] accumulator between the
    slabs: the first writes it, each later one reads it and each but the
    last writes it back (2 x slabs - 2 passes over T x H fp32 in all), and
    the last writes dx in x's dtype.  The split pre-pass reads x and
    writes its halves (4 + 4 bytes an element; one subtraction and two
    conversions an element, fp32)."""
    ops = 2 * T * H * V
    dt = {2: "bfloat16", 4: "float32"}
    split = xs == 4 and ws == 2
    both = "bfloat16" if xs == ws == 2 or split else "float32"
    z_ops = 2 * ops if split else ops
    dz_out = T * V * (2 + 2) if split else T * V * ws + (
        T * V * xs if xs != ws else 0)
    slabs = -(-V // chunk)
    acc = T * H * 4 * (2 * slabs - 2)
    return {"linear_ce_fwd": (T * H * xs + V * H * ws + 3 * T * 4, z_ops,
                              both),
            "linear_ce_dz": (T * H * xs + V * H * ws + 3 * T * 4 + dz_out,
                             z_ops, both),
            "linear_ce_dx": (T * V * ws + V * H * ws + acc + T * H * xs, ops,
                             dt[ws]),
            "linear_ce_dw": (T * V * xs + T * H * xs + V * H * ws,
                             3 * ops if split else ops,
                             "bfloat16" if split else dt[xs]),
            "linear_ce_split_x": (8 * T * H, 3 * T * H, "float32")}


def dz_p_excess(dz, dz_p, p, g):
    """The largest |dz - dz_p| over its bound DZ_P_REL |g| p + DZ_ULPS
    2^-24 |dz_p|, elementwise: above 1 fails."""
    lim = (DZ_P_REL * g.abs()[:, None] * p
           + DZ_ULPS * 2.0 ** -24 * dz_p.abs())
    return float(((dz.float() - dz_p).abs() / lim.clamp_min(1e-38)).max())


def check_split(label, case, x, w, lab, lse, g, c0, got, plain):
    """The split route's checks (LCE_ABS, DZ_P_REL, DZ_ULPS) on the
    kernels' ``got = (nll, lse, dz)`` (dz: the sum of the kernel's bf16
    halves, in fp32) against ``plain`` (the plain fp32 version's, on the
    same lse for dz), then on the plain version run on bf16-rounded x,
    which must fail them; prints both distances.  Returns the kernels'
    ``(nll, lse, dz)`` distances."""
    from paddle_tpu_torch.ops import fused_cross_entropy as fce
    _, _, _, V, chunk, _, _, ignore, eps = case
    xb = x.bfloat16().float()
    proxy = fce.lce_fwd_ref(xb, w, lab, chunk=chunk, ignore_index=ignore,
                            label_smoothing=eps) + (
        fce.lce_dz_ref(xb, w[c0:], lab, lse, g, c0, V, eps),)
    p = (x.float() @ w[c0:].float().t() - lse[:, None]).exp()
    dist = {}
    for who, (nll, lse_k, dz) in (("kernels", got), ("bf16-x proxy", proxy)):
        dist[who] = (max_err(nll, plain[0]), max_err(lse_k, plain[1]),
                     dz_p_excess(dz, plain[2], p, g))
        info(f"lce {label} split checks, {who}: max |nll - plain| "
             f"{dist[who][0]:.3e}, max |lse - plain| {dist[who][1]:.3e} "
             f"(bound {LCE_ABS}); dz at {dist[who][2]:.3e} x its bound "
             f"{DZ_P_REL} |g| p + {DZ_ULPS} x 2^-24 |dz|")
    n, l, d = dist["kernels"]
    if n > LCE_ABS or l > LCE_ABS or d > 1.0:
        raise SmokeFailure(f"lce {label}: the split route misses its checks "
                           f"(nll {n:.3e}, lse {l:.3e}, dz {d:.3e} x bound)")
    n, _, d = dist["bf16-x proxy"]
    if n <= LCE_ABS or d <= 1.0:
        raise SmokeFailure(f"lce {label}: the plain version on bf16-rounded "
                           f"x passes a split check (nll {n:.3e}, dz "
                           f"{d:.3e} x bound): the checks cannot tell")
    return dist["kernels"]


def split_dw_allowance(xf, ws, lse, g, dz):
    """(DZ_P_REL |g| p + dw_rel(T) |dz|)^T |x| for the slab ``ws = w[c0:c0
    + width]`` (fp32) and its plain dz, x fp32 ``[T, H]``: ``[width, H]``."""
    p = (xf @ ws.t() - lse[:, None]).exp()
    u = DZ_P_REL * g.abs()[:, None] * p + dw_rel(xf.shape[0]) * dz.abs()
    return u.t() @ xf.abs()


def split_dw_excess(case, x, w, lab, lse, g, dw, dw_t):
    """The split route's dw check on the kernels' ``dw`` (or on each of
    ``{name: dw}``, under its name) against ``dw_t``, the plain fp32 dw
    before its rounding, slab by slab, and on the plain three products
    (``lce_dw_split_ref`` on the plain dz's and x's halves), the
    one-product version (dz_hi^T x_hi) and each version without one cross
    term: ``{who: largest distance past half an ulp over the allowance}``
    (above 1 fails; 0 or below: within the rounding)."""
    import torch
    from paddle_tpu_torch.ops import fused_cross_entropy as fce
    _, T, _, V, chunk, _, _, _, eps = case
    dws = dw if isinstance(dw, dict) else {"kernels": dw}
    dt = next(iter(dws.values())).dtype            # the dw's storage type
    xf = x.float()
    xs = fce.lce_split_x_ref(xf)
    hi, lo = xs[0].float(), xs[1].float()
    worst = dict.fromkeys((*dws, "three products", "dz_hi x_hi",
                           "without dz_lo x_hi", "without dz_hi x_lo"),
                          -float("inf"))
    for c0 in range(0, V, chunk):
        ws = w[c0:c0 + chunk].float()
        dz = fce.lce_dz_ref(xf, ws, lab, lse, g, c0, V, eps)
        t = dw_t[c0:c0 + chunk]
        lim = split_dw_allowance(xf, ws, lse, g, dz)
        dzs = fce.lce_split_dz_ref(dz)
        d_hi, d_lo = dzs[0].float().t(), dzs[1].float().t()
        t1, t2, t3 = d_hi @ hi, d_hi @ lo, d_lo @ hi
        for who, v in (*((k, d[c0:c0 + chunk]) for k, d in dws.items()),
                       ("three products", fce.lce_dw_split_ref(dzs, xs)),
                       ("dz_hi x_hi", t1), ("without dz_lo x_hi", t1 + t2),
                       ("without dz_hi x_lo", t1 + t3)):
            v = v.to(dt).float()
            # past the rounding: half an ulp of the larger of the two (a
            # value rounded up across a power of two has the larger ulp)
            out = (v - t).abs() - half_ulp_bf16(torch.maximum(v.abs(),
                                                              t.abs()))
            worst[who] = max(worst[who], float((out / lim).max()))
        del dz, dzs, d_hi, d_lo, t1, t2, t3, lim
    return worst


def check_split_dw(label, case, x, w, lab, lse, g, dw, dw_t):
    """:func:`split_dw_excess`, judged by :func:`judge_split_dw`.  Returns
    the kernels' distance."""
    return judge_split_dw(label, case[1],
                          split_dw_excess(case, x, w, lab, lse, g, dw, dw_t))


def judge_split_dw(label, T, worst):
    """:func:`split_dw_excess`'s distances printed and judged: the kernels
    and the plain three products must pass, the versions with fewer
    products fail.  Returns the kernels' distance."""
    info(f"lce {label} split dw check (half a bf16 ulp + ({DZ_P_REL} |g| p "
         f"+ {dw_rel(T):.3e} |dz|)^T |x|): " + ", ".join(
             f"{k} {v:.3e} x the allowance past half an ulp"
             for k, v in worst.items()))
    for who in ("kernels", "three products"):
        if worst[who] > 1.0:
            raise SmokeFailure(f"lce {label}: the split route's dw ({who}) "
                               f"misses its bound ({worst[who]:.3e} x the "
                               f"allowance past half an ulp)")
    for who, v in worst.items():
        if who not in ("kernels", "three products") and v <= 1.0:
            raise SmokeFailure(f"lce {label}: {who} passes the split dw "
                               f"check ({v:.3e} x the allowance past half "
                               f"an ulp): it cannot tell")
    return worst["kernels"]


def lce_inputs(case, gen, dev):
    """x ~ N(0, 1) (a normalised activation), w ~ N(0, 0.02) (the init
    std), random labels (every 7th ignored where the case has
    ignore_index) and an N(0, 1) nll cotangent, zero at ignored labels."""
    import torch
    _, T, H, V, _, xdn, wdn, ignore, _ = case
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    x = torch.randn(T, H, device=dev, generator=gen).to(dts[xdn])
    w = (0.02 * torch.randn(V, H, device=dev, generator=gen)).to(dts[wdn])
    lab = torch.randint(0, V, (T,), device=dev, generator=gen)
    g = torch.randn(T, device=dev, generator=gen)
    if ignore is not None:
        lab[::7] = ignore
        g = torch.where(lab != ignore, g, 0.0)
    return x, w, lab, g


def check_lce(name, got, plain, truth, bf16, ratios):
    """fp32 inputs: within 1e-4 of the plain version, elementwise and in
    relative L2.  A bf16 operand: the ratio rule of :func:`check_layer_out`
    against ``truth`` (the plain version with dz kept in fp32), and a
    relative L2 distance from the plain version within 2e-2, or no more
    than BF16_SLACK x the plain version's own from the truth."""
    if not bf16:
        err = check_close(name, got, plain, TOL["float32"])
        r = rel_l2(got, plain)
        if r > TOL["float32"]:
            raise SmokeFailure(f"{name}: rel L2 {r:.3e} > {TOL['float32']}")
        return err
    err = check_layer_out(name, got, plain, truth, TOL["bfloat16"], ratios)
    r = rel_l2(got, plain)
    if r > TOL["bfloat16"] and \
            rel_l2(got, truth) > BF16_SLACK * rel_l2(plain, truth):
        raise SmokeFailure(f"{name}: rel L2 {r:.3e} from the plain version "
                           f"and further from fp32 than it")
    return err


# a linear-CE kernel's instances by their profiled names: name<...> the
# first version's FMA kernels, name_wg(...) the bf16 wgmma ones,
# name_split(...) fwd / dz / dw with fp32 x and bf16 w on wgmma; name(...)
# a kernel of one instance (linear_ce_split_x)
LCE_ROUTES = (("<", "mma"), ("_wg(", "wg"), ("_split(", "split"),
              ("(", "kernel"))


def lce_route(key, name):
    """The route of the profiled kernel ``key`` if it is an instance of
    ``name``, else None."""
    import re
    for tag, route in LCE_ROUTES:
        if re.search(r"(?:^|[\s:])" + re.escape(name + tag), key):
            return route
    return None


def lce_launches(fn):
    """Launches of each linear-CE kernel in one call of ``fn``, read from
    the kernel library's counters (the profiler can miss records, so its
    counts are not launch counts)."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    torch.cuda.synchronize()
    layer.reset_counts()
    fn()
    torch.cuda.synchronize()
    counts = layer.launch_counts()
    return {name: counts[name] for name in (*LCE_NAMES, "linear_ce_split_x")}


def lce_kernel(by, name, call_ms, launches):
    """Device ms a call of kernel ``name``: the mean recorded time of its
    launches in the breakdown ``by`` of one call (instances weighed by
    their share of the records) times ``launches``, its launches a call
    from the library's counters; with its routes."""
    hit = {k: (mean, n) for k, (mean, n) in by.items()
           if lce_route(k, name)}
    recorded = sum(n for _, n in hit.values())
    return dict(ms=sum(mean * n for mean, n in hit.values()) / recorded
                * launches if hit else None, launches_per_call=launches,
                call_ms=call_ms, routes=lce_routes(by, name))


def lce_routes(by, name):
    """The routes of kernel ``name``'s records in the breakdown ``by``."""
    return sorted({r for r in (lce_route(k, name) for k in by) if r})


def lce_times(case, x, w, lab, lse, g):
    """Device ms per call of each kernel (its launches over one forward or
    backward call; the split pre-pass from the forward call), the plain
    versions' and the dense chain's, and the bounds.  The dense chain's
    yardstick for the backward kernels is its backward alone
    (``torch.autograd.grad`` of one saved forward); its forward + backward
    rides along as ``library_fwd_bwd_ms``.  dw's own yardstick
    (``library_ms``; the backward alone as ``library_bwd_ms``) is one
    ``torch.matmul(dz.T, x)`` a slab in x's dtype, summed over the slabs
    (fp32 with TF32 off at the GPT head, bf16 at the Llama head)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import fused_cross_entropy as fce
    from paddle_tpu_torch.ops.cuda import linear_ce as lc
    _, T, H, V, chunk, _, _, ignore, eps = case
    kw = dict(label_smoothing=eps)
    out, by = {}, {}

    def fwd():
        return lc.linear_ce_fwd_cuda(x, w, lab, ignore_index=ignore, **kw)

    def bwd():
        return lc.linear_ce_bwd_cuda(x, w, lab, lse, g, chunk=chunk, **kw)
    _, call = time_ms(fwd, 5, by)
    n = lce_launches(fwd)
    out["linear_ce_fwd"] = lce_kernel(by, "linear_ce_fwd", call,
                                      n["linear_ce_fwd"])
    out["linear_ce_split_x"] = lce_kernel(by, "linear_ce_split_x", call,
                                          n["linear_ce_split_x"])
    by = {}
    _, call = time_ms(bwd, 3, by)
    n = lce_launches(bwd)
    for name in LCE_NAMES[1:]:
        out[name] = lce_kernel(by, name, call, n[name])
    out["bwd_split_x_launches"] = n["linear_ce_split_x"]
    plain_fwd = time_ms(lambda: fce.lce_fwd_ref(
        x, w, lab, chunk=chunk, ignore_index=ignore, **kw), 2)
    plain_bwd = time_ms(lambda: fce.lce_bwd_ref(
        x, w, lab, lse, g, chunk=chunk, **kw), 1)

    def dense(xx, ww):
        return F.cross_entropy((xx @ ww.to(xx.dtype).t()).float(), lab,
                               reduction="none")
    lib_fwd = time_ms(lambda: dense(x, w), 5)[0]
    xr, wr = (t.detach().requires_grad_(True) for t in (x, w))
    lib_fb = time_ms(lambda: torch.autograd.grad(
        (dense(xr, wr) * g).sum(), (xr, wr)), 3)[0]
    saved = (dense(xr, wr) * g).sum()
    lib_b = time_ms(lambda: torch.autograd.grad(saved, (xr, wr),
                                                retain_graph=True), 3)[0]
    del saved
    dz = torch.randn(T, chunk, device=x.device).to(x.dtype)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        widths = [min(chunk, V - c0) for c0 in range(0, V, chunk)]
        per = {c: time_ms(lambda: torch.matmul(dz[:, :c].t(), x), 5)[0]
               for c in set(widths)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    lib_dw = sum(per[c] for c in widths)
    del dz
    bo = lce_bytes_ops(T, H, V, chunk, x.element_size(), w.element_size())
    if out["linear_ce_split_x"]["ms"] is not None:
        nbytes, ops, dtn = bo["linear_ce_split_x"]
        bms, bby = bound_ms(nbytes, ops, dtn)
        plain = time_ms(lambda: fce.lce_split_x_ref(x), 20)
        out["linear_ce_split_x"].update(
            plain_ms=plain[0], plain_call_ms=plain[1], bound_ms=bms,
            bound_by=bby, library_ms=None)
    for name in LCE_NAMES:
        fwd = name == "linear_ce_fwd"
        nbytes, ops, dtn = bo[name]
        bms, bby = bound_ms(nbytes, ops, dtn)
        out[name].update(
            plain_ms=(plain_fwd if fwd else plain_bwd)[0],
            plain_call_ms=(plain_fwd if fwd else plain_bwd)[1],
            bound_ms=bms, bound_by=bby,
            library_ms=lib_fwd if fwd else lib_b,
            library_fwd_bwd_ms=None if fwd else lib_fb)
    out["linear_ce_dw"].update(library_ms=lib_dw, library_bwd_ms=lib_b)
    return out


def phase_linear_ce(results, dev="cuda"):
    """The four linear-CE kernels against their plain versions; times at
    the Llama (main path) and GPT heads' shapes."""
    import torch
    from paddle_tpu_torch.ops import fused_cross_entropy as fce
    from paddle_tpu_torch.ops.cuda import linear_ce as lc
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    err, ratios, timed = {}, {n: [] for n in LCE_NAMES}, {}
    split_dist = {}
    for case in LCE_CASES:
        label, T, H, V, chunk, xdn, wdn, ignore, eps = case
        x, w, lab, g = lce_inputs(case, gen, dev)
        bf16 = "bfloat16" in (xdn, wdn)
        dtn = "bfloat16" if bf16 else "float32"
        kw = dict(label_smoothing=eps)
        nll, lse = lc.linear_ce_fwd_cuda(x, w, lab, ignore_index=ignore, **kw)
        c0 = (V - 1) // chunk * chunk          # the last, narrowest slab
        dz_w, dz_x = lc.linear_ce_dz_cuda(x, w, lab, lse, g, c0, V - c0,
                                          **kw)
        again = lc.linear_ce_fwd_cuda(x, w, lab, ignore_index=ignore, **kw) \
            + lc.linear_ce_dz_cuda(x, w, lab, lse, g, c0, V - c0, **kw)
        if not all(torch.equal(a, b) for a, b in zip(
                (nll, lse, dz_w, dz_x), again)):
            raise SmokeFailure(f"lce {label}: a second forward or dz call "
                               f"differs from the first")
        del again
        dx, dw = lc.linear_ce_bwd_cuda(x, w, lab, lse, g, chunk=chunk, **kw)
        again = lc.linear_ce_bwd_cuda(x, w, lab, lse, g, chunk=chunk, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(dx, again[0]) and torch.equal(dw, again[1])):
            raise SmokeFailure(f"lce {label}: a second backward call differs "
                               f"from the first")
        del again
        nll_p, lse_p = fce.lce_fwd_ref(x, w, lab, chunk=chunk,
                                       ignore_index=ignore, **kw)
        # nll and lse are fp32 sums of products of the same operands on both
        # sides, whatever their dtype: held at the fp32 tolerance
        e = {"linear_ce_fwd": max(
            check_close(f"lce {label} nll", nll, nll_p, TOL["float32"]),
            check_close(f"lce {label} lse", lse, lse_p, TOL["float32"]))}
        dz_t = fce.lce_dz_ref(x, w[c0:], lab, lse, g, c0, V, eps)
        split = (xdn, wdn) == ("float32", "bfloat16")
        if split:                     # dz_x: the halves, held by their sum
            dz_x = dz_x[0].float() + dz_x[1].float()
        e["linear_ce_dz"] = max(check_lce(
            f"lce {label} dz ({dz.dtype}, slab {c0}:{V})", dz,
            dz_t.to(dz.dtype), dz_t, dz.dtype == torch.bfloat16,
            ratios["linear_ce_dz"]) for dz in (dz_w, dz_x))
        if split:
            xs = lc.linear_ce_split_x_cuda(x)
            xs_p = fce.lce_split_x_ref(x)
            if not torch.equal(xs, xs_p):
                raise SmokeFailure(f"lce {label}: linear_ce_split_x differs "
                                   f"from its plain version")
            err["linear_ce_split_x", dtn] = max_err(xs, xs_p)
            info(f"lce {label}: linear_ce_split_x bit-equal to its plain "
                 f"version on x [{T}, {H}]")
            del xs, xs_p
            split_dist[label] = check_split(label, case, x, w, lab, lse, g,
                                            c0, (nll, lse, dz_x),
                                            (nll_p, lse_p, dz_t))
        dx_p, dw_p = fce.lce_bwd_ref(x, w, lab, lse, g, chunk=chunk, **kw)
        dx_t = dw_t = None
        if bf16:                  # dz kept in fp32, the grads unrounded
            dx_t, dw_t = fce.lce_bwd_ref(x.float(), w.float(), lab, lse, g,
                                         chunk=chunk, **kw)
        e["linear_ce_dx"] = check_lce(f"lce {label} dx", dx, dx_p, dx_t,
                                      bf16, ratios["linear_ce_dx"])
        e["linear_ce_dw"] = check_lce(f"lce {label} dw", dw, dw_p, dw_t,
                                      bf16, ratios["linear_ce_dw"])
        if split:
            split_dist[label] += (check_split_dw(label, case, x, w, lab, lse,
                                                 g, dw, dw_t),)
            if label not in LCE_TIMED:        # the timed cases' come below
                by = {}
                time_ms(lambda: lc.linear_ce_bwd_cuda(
                    x, w, lab, lse, g, chunk=chunk, **kw), 1, by)
                routes = {n: lce_routes(by, n)
                          for n in LCE_NAMES[1:]}
                if routes != {"linear_ce_dz": ["split"],
                              "linear_ce_dx": ["wg"],
                              "linear_ce_dw": ["split"]}:
                    raise SmokeFailure(f"lce {label}: the backward's "
                                       f"profiled routes {routes}")
                info(f"lce {label}: backward routes {routes}")
        for name, v in e.items():
            err[name, dtn] = max(err.get((name, dtn), 0.0), v)
        info(f"lce {label} (T {T}, H {H}, V {V}, chunk {chunk}, x {xdn}, "
             f"w {wdn}): max |kernel - plain| " + ", ".join(
                 f"{k[10:]} {v:.2e}" for k, v in e.items()))
        del nll_p, lse_p, dz_t, dx_p, dw_p, dx_t, dw_t, dx, dw, dz_w, dz_x
        torch.cuda.empty_cache()
        if label in LCE_TIMED:
            timed[LCE_TIMED[label]] = (label, lce_times(case, x, w, lab,
                                                        lse, g))
        del x, w, lab, g, nll, lse
        torch.cuda.empty_cache()

    # the [H, V] Llama layout through the op, fwd + bwd, against the plain
    # versions on the transposed head
    x = torch.randn(2, 300, 512, device=dev, generator=gen).to(
        torch.bfloat16).requires_grad_(True)
    head = (0.02 * torch.randn(512, 3000, device=dev, generator=gen)).to(
        torch.bfloat16).requires_grad_(True)
    lab = torch.randint(0, 3000, (2, 300), device=dev, generator=gen)
    g = torch.randn(2, 300, device=dev, generator=gen)
    (fce.linear_cross_entropy(x, head, lab, w_layout="hv", chunk=1024)
     * g).sum().backward()
    torch.cuda.synchronize()
    x2, w2, lab2 = x.detach().reshape(600, 512), head.detach().t(), \
        lab.reshape(-1)
    _, lse = fce.lce_fwd_ref(x2, w2, lab2, chunk=1024)
    dx_p, dw_p = fce.lce_bwd_ref(x2, w2, lab2, lse, g.reshape(-1),
                                 chunk=1024)
    dx_t, dw_t = fce.lce_bwd_ref(x2.float(), w2.float(), lab2, lse,
                                 g.reshape(-1), chunk=1024)
    e_dx = check_lce("lce hv layout dx", x.grad.reshape(600, 512), dx_p,
                     dx_t, True, ratios["linear_ce_dx"])
    e_dw = check_lce("lce hv layout dw", head.grad, dw_p.t(), dw_t.t(), True,
                     ratios["linear_ce_dw"])
    info(f"lce [H, V] layout through the op (T 600, H 512, V 3000, chunk "
         f"1024, bf16): max |kernel - plain| dx {e_dx:.2e}, dw {e_dw:.2e}")

    label, main = timed["main"]
    gpt_label, gpt = timed["gpt"]
    # each kernel's profiled route: wgmma wherever w (fwd, dz, dx) or x
    # (dw) is bf16, fwd, dz and dw on the bf16 halves of x (and dz) with
    # fp32 x (the GPT head); the split pre-pass once a forward and once a
    # backward call there, never with bf16 x
    want = {"main": {"linear_ce_fwd": "wg", "linear_ce_dz": "wg",
                     "linear_ce_dx": "wg", "linear_ce_dw": "wg"},
            "gpt": {"linear_ce_fwd": "split", "linear_ce_dz": "split",
                    "linear_ce_dx": "wg", "linear_ce_dw": "split",
                    "linear_ce_split_x": "kernel"}}
    for key, names in want.items():
        got = timed[key][1]
        for name, route in names.items():
            if got[name]["routes"] != [route]:
                raise SmokeFailure(
                    f"lce {timed[key][0]}: {name}'s profiled kernels ran "
                    f"{got[name]['routes']}, expected {route}")
        n_split = (got["linear_ce_split_x"]["launches_per_call"],
                   got["bwd_split_x_launches"])
        if n_split != ((1, 1) if key == "gpt" else (0, 0)):
            raise SmokeFailure(f"lce {timed[key][0]}: linear_ce_split_x "
                               f"launched {n_split} times a forward / "
                               f"backward call")
    for name in LCE_NAMES:
        r, q = main[name], gpt[name]
        fwd = name == "linear_ce_fwd"
        results.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/kernels/csrc/linear_ce.cu",
            replaces=LCE_REPLACES[name],
            shape="x [8192, 4096] bf16, w [32000, 4096] bf16" + (
                "" if fwd else ", 16 slabs of 2048 vocab rows"),
            max_abs_err=err[name, "bfloat16"],
            max_abs_err_fp32=err[name, "float32"],
            ms=r["ms"], call_ms=r["call_ms"],
            launches_per_call=1 if fwd else r["launches_per_call"],
            plain_ms=r["plain_ms"], plain_call_ms=r["plain_call_ms"],
            plain_what="lce_fwd_ref" if fwd else
            "lce_bwd_ref (dz, dx and dw together)",
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            library_fwd_bwd_ms=r["library_fwd_bwd_ms"],
            library_what="x @ w.T then F.cross_entropy, forward (two calls)"
            if fwd else "torch.matmul(dz.T, x) a slab, summed over the "
            "slabs (library_bwd_ms: the backward alone of x @ w.T then "
            "F.cross_entropy)" if name == "linear_ce_dw" else "the backward "
            "alone of x @ w.T then F.cross_entropy (torch.autograd.grad of "
            "one saved forward; library_fwd_bwd_ms: forward + backward)",
            bf16_vs_fp32_ratio=max(ratios[name], default=None),
            gpt={k: q[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "library_fwd_bwd_ms",
                                   "library_bwd_ms", "routes") if k in q},
            **({"library_bwd_ms": r["library_bwd_ms"]}
               if "library_bwd_ms" in r else {})))
        lib = "fp32 library dz^T x a slab" if name == "linear_ce_dw" \
            else "dense chain"
        info(f"{name} {label}: device {r['ms']} ms per call, bound "
             f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
             f"{r['plain_ms']} ms, {lib.replace('fp32', 'bf16')} "
             f"{r['library_ms']} ms (fwd + bwd {r['library_fwd_bwd_ms']}); "
             f"{gpt_label}: device {q['ms']} ms, bound {q['bound_ms']:.4f} "
             f"ms ({q['bound_by']}), plain {q['plain_ms']} ms, {lib} "
             f"{q['library_ms']} ms (fwd + bwd {q['library_fwd_bwd_ms']})")
    s = gpt["linear_ce_split_x"]
    results.append(dict(
        name="linear_ce_split_x", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/linear_ce.cu",
        replaces=LCE_REPLACES["linear_ce_split_x"],
        shape="x [8192, 768] fp32 -> [2, 8192, 768] bf16 (the GPT head)",
        max_abs_err=err["linear_ce_split_x", "bfloat16"], ms=s["ms"],
        call_ms=s["call_ms"], launches_per_call=1, plain_ms=s["plain_ms"],
        plain_call_ms=s["plain_call_ms"], plain_what="lce_split_x_ref",
        bound_ms=s["bound_ms"],
        bound_by=s["bound_by"], library_ms=s["library_ms"],
        split_checks={k: dict(zip(("nll", "lse", "dz_of_bound",
                                   "dw_of_bound"), v))
                      for k, v in split_dist.items()}))
    info(f"linear_ce_split_x {gpt_label}: device {s['ms']} ms per launch, "
         f"bound {s['bound_ms']:.4f} ms ({s['bound_by']}), plain "
         f"{s['plain_ms']} ms; fwd + split {gpt['linear_ce_fwd']['ms']} + "
         f"{s['ms']} ms against the dense chain's forward "
         f"{gpt['linear_ce_fwd']['library_ms']} ms")


def tree_leaves(tree):
    """A train state's leaves, or an eager model's ``{name: grad}``."""
    return [(k, v) for k, v in tree.items() if k != "blocks"] + [
        (f"blocks.{k}", v) for k, v in sorted(tree.get("blocks",
                                                       {}).items())]


def profile_once(fn):
    """One profiled call of ``fn``: ``(wall ms, device-busy ms, {kernel:
    (ms, launches)})``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    ts = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - ts) * 1e3
    by = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            by[ev.key] = (us / 1e3, ev.count)
    return wall, sum(ms for ms, _ in by.values()), by


def device_groups(by):
    """Device ms by kernel group of a profiled call's ``{kernel: (ms,
    launches)}``."""
    groups = {}
    for k, (ms, _) in by.items():
        g = ("flash kernels" if "pt::flash" in k else
             "linear-CE kernels" if "pt::lce" in k else
             "fp32 GEMMs (cuBLAS)" if "f32f32" in k or "sgemm" in k else
             "bf16 GEMMs (cuBLAS)" if "gemm" in k or "nvjet" in k else
             "other torch kernels")
        groups[g] = groups.get(g, 0.0) + ms
    return groups


def run_steps(tag, step, state, ids_t, labels_t, per_step):
    """One warm and TRAIN_STEPS timed steps on one batch, the launch
    counts zeroed before and read after (they must be ``per_step`` per
    step, every other kernel 0), finite falling losses; then one profiled
    step.  Returns ``(counts, summary)``; the summary's ``busy_share`` is
    the profiled step's device time over its own wall time, which the
    profiler stretches where the host leads, and ``busy_share_of_step``
    that device time over the unprofiled step's."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    torch.cuda.reset_peak_memory_stats()
    layer.reset_counts()
    losses, times = [], []
    for i in range(TRAIN_WARM + TRAIN_STEPS):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        state, loss = step(state, ids_t, labels_t)
        losses.append(float(loss))
        if i >= TRAIN_WARM:
            times.append(time.perf_counter() - ts)
    counts = layer.launch_counts()
    mem = torch.cuda.max_memory_allocated()
    n = TRAIN_WARM + TRAIN_STEPS
    want = {k: c * n for k, c in per_step.items()}
    got = {k: c for k, c in counts.items() if c}
    if got != want:
        raise SmokeFailure(f"{tag}: launch counts {got}, predicted {want} "
                           f"(every other kernel 0)")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise SmokeFailure(f"{tag}: losses {losses} not finite and falling")
    step_ms = 1e3 * sum(times) / len(times)
    tok_s = ids_t.numel() / (step_ms / 1e3)

    prof_ms, busy, by = profile_once(lambda: step(state, ids_t, labels_t))
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:12]
    groups = device_groups(by)
    info(f"{tag}: losses {[round(x, 5) for x in losses]}; step "
         f"{step_ms:.1f} ms (times {[round(1e3 * t, 1) for t in times]}), "
         f"{tok_s:.0f} tokens/s, max memory allocated {mem / 2**30:.2f} GiB; "
         f"launches over {n} steps {got}")
    info(f"{tag}: profiled step {prof_ms:.1f} ms wall, device busy "
         f"{busy:.1f} ms ({100 * busy / prof_ms:.1f}% of it, "
         f"{100 * busy / step_ms:.1f}% of the unprofiled step); by kernel "
         f"(ms, launches): " + "; ".join(
             f"{k.split('(')[0][:60]} {ms:.2f} x{c}" for k, (ms, c) in top))
    info(f"{tag}: device time by group (ms, share of busy): " + "; ".join(
        f"{g} {ms:.2f} ({100 * ms / busy:.1f}%)" for g, ms in sorted(
            groups.items(), key=lambda kv: -kv[1])))
    return counts, dict(step_ms=step_ms, tokens_per_s=tok_s,
                        max_memory_bytes=mem, busy_share=busy / prof_ms,
                        device_busy_ms=busy,
                        busy_share_of_step=busy / step_ms,
                        device_ms_by_group=groups, losses=losses,
                        launches_per_step=per_step)


def check_steps(tag, runs, truth, pairs):
    """Relative L2 distance of the loss and of every gradient leaf between
    two bf16 configurations of one step: within STEP_REL_L2, or the first
    no further from the fp32 step ``truth`` than BF16_SLACK x the second.
    A pair ``(what, a_key, b_key, loss_tol)`` also holds the two losses
    within ``loss_tol`` of each other, relative."""
    import torch
    for what, a_key, b_key, *loss_tol in pairs:
        a, b = runs[a_key], runs[b_key]
        r = rel_l2(a[0], b[0])
        if loss_tol and r > loss_tol[0]:
            raise SmokeFailure(f"{tag} step check loss: {what} rel L2 "
                               f"{r:.3e} > {loss_tol[0]}")
        rows = [("loss", a[0], b[0], truth[0])] + [
            (n, x, y, t) for (n, x), (_, y), (_, t) in zip(
                tree_leaves(a[1]), tree_leaves(b[1]), tree_leaves(truth[1]))]
        worst = 0.0
        for name, x, y, t in rows:
            r = rel_l2(x, y)
            worst = max(worst, r)
            if not torch.isfinite(x).all():
                raise SmokeFailure(f"{tag} step check {name}: non-finite")
            if r > STEP_REL_L2 and rel_l2(x, t) > BF16_SLACK * rel_l2(y, t):
                raise SmokeFailure(
                    f"{tag} step check {name}: {what} rel L2 {r:.3e} > "
                    f"{STEP_REL_L2}, and {a_key} is further from fp32 "
                    f"({rel_l2(x, t):.3e}) than {BF16_SLACK} x {b_key} "
                    f"({rel_l2(y, t):.3e})")
            info(f"{tag} step check {name}: {what}: rel L2 {r:.3e}; vs fp32 "
                 f"{rel_l2(x, t):.3e} ({a_key}) / {rel_l2(y, t):.3e} "
                 f"({b_key})")
        info(f"{tag} step check, {what}: worst rel L2 {worst:.3e} (bound "
             f"{STEP_REL_L2})")


def fp32_state(state):
    return {"params": {k: (v.float() if not isinstance(v, dict) else
                           {n: w.float() for n, w in v.items()})
                       for k, v in state["params"].items()},
            "opt": state["opt"]}


def phase_train(dev="cuda"):
    """llama_7b(num_layers=4) bf16 through the one-device train step, with
    the fused head of the config default."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import llama_7b
    from paddle_tpu_torch.parallel.train_step import build_llama_train_step

    cfg = llama_7b(num_layers=TRAIN_LAYERS, dtype="bfloat16")
    t0 = time.perf_counter()
    step, init = build_llama_train_step(cfg, remat=True)
    state = init(SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in tree_leaves(state["params"]))
    info(f"train: llama_7b x {TRAIN_LAYERS} layers bf16, fused head, "
         f"{n_params} params, state built in {time.perf_counter() - t0:.1f} "
         f"s")
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S))
    ids_t = torch.from_numpy(ids).to(dev)
    labels_t = torch.from_numpy(np.roll(ids, -1, axis=1)).to(dev)
    counts, summary = run_steps("train", step, state, ids_t, labels_t,
                                {**FLASH_PER_STEP, **LCE_PER_STEP})
    del state
    torch.cuda.empty_cache()

    # one step's loss and gradients at 2 layers: the flash kernels against
    # the dense attention path, and the fused head against the dense head
    runs = {"flash + dense head": dict(use_flash=True, fused_head=False),
            "dense attention + dense head": dict(use_flash=False,
                                                 fused_head=False),
            "flash + fused head": dict(use_flash=True, fused_head=True)}
    res = {}
    for key, kw in runs.items():
        s2, i2 = build_llama_train_step(
            llama_7b(num_layers=2, dtype="bfloat16"), remat=True, **kw)
        st = i2(SEED)
        res[key] = s2.loss_and_grads(st, ids_t, labels_t)
        if kw["fused_head"]:
            st32 = fp32_state(st)
        del st
    s32, _ = build_llama_train_step(llama_7b(num_layers=2), remat=True,
                                    use_flash=False, fused_head=False)
    truth = s32.loss_and_grads(st32, ids_t, labels_t)
    del st32
    check_steps(f"train (llama_7b x 2 layers, bf16, {TRAIN_B} x {TRAIN_S})",
                res, truth,
                (("flash vs dense attention", "flash + dense head",
                  "dense attention + dense head"),
                 ("fused vs dense head", "flash + fused head",
                  "flash + dense head", TOL["float32"])))
    del res, truth
    torch.cuda.empty_cache()
    return counts, summary


def phase_gpt_train(dev="cuda"):
    """The JAX bench's GPT row through the one-device GPT step: flash at
    head_dim 64, the fused head on fp32 x and the bf16 tied wte."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.parallel.train_step import build_gpt_train_step

    def config(**kw):
        return GPTConfig(vocab_size=32768, hidden_size=768, num_heads=12,
                         max_position_embeddings=GPT_S, **kw)
    cfg = config(num_layers=GPT_LAYERS, dtype="bfloat16")
    t0 = time.perf_counter()
    step, init = build_gpt_train_step(cfg, remat=False)
    state = init(SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in tree_leaves(state["params"]))
    info(f"gpt: V 32768, H 768, {GPT_LAYERS} layers, 12 heads, bf16, fused "
         f"head, no remat, {n_params} params, state built in "
         f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, (GPT_B, GPT_S))
    ids_t = torch.from_numpy(ids).to(dev)
    labels_t = torch.from_numpy(np.roll(ids, -1, axis=1)).to(dev)
    counts, summary = run_steps("gpt", step, state, ids_t, labels_t,
                                GPT_PER_STEP)
    del state
    torch.cuda.empty_cache()

    # one step at 2 layers: the fused head against the dense head
    res = {}
    for fused in (True, False):
        s2, i2 = build_gpt_train_step(config(num_layers=2, dtype="bfloat16"),
                                      remat=False, fused_head=fused)
        st = i2(SEED)
        res[fused] = s2.loss_and_grads(st, ids_t, labels_t)
        if fused:
            st32 = fp32_state(st)
        del st
    s32, _ = build_gpt_train_step(config(num_layers=2), remat=False,
                                  use_flash=False, fused_head=False)
    truth = s32.loss_and_grads(st32, ids_t, labels_t)
    del st32
    check_steps(f"gpt (2 layers, bf16, {GPT_B} x {GPT_S})",
                {"fused head": res[True], "dense head": res[False]}, truth,
                (("fused vs dense head", "fused head", "dense head",
                  TOL["float32"]),))
    del res, truth
    torch.cuda.empty_cache()
    return counts, summary


# ------------------------------------------------------ decode attention
# (label, B, Hq, Hkv, D, T, lengths): the generation step's shape at
# llama_7b width (B 8, a 256-row cache, MHA, D 128) with ragged lengths,
# then GPT-125M's heads and the small cases
DATTN_CASES = [
    ("llama_7b B 8 T 256 ragged", 8, 32, 32, 128, 256,
     (1, 37, 74, 110, 147, 183, 220, 256)),
    ("gpt_125m B 8 T 256, 12 heads D 64", 8, 12, 12, 64, 256,
     (256, 1, 129, 200, 64, 255, 17, 130)),
    ("gqa 32/8 D 64", 4, 32, 8, 64, 300, (300, 1, 99, 200)),
    ("T 1000 (two 512-row blocks)", 2, 16, 16, 128, 1000, (1000, 613)),
    ("length 1", 3, 8, 8, 128, 64, (1, 1, 1)),
    ("T 2048 (four 512-row blocks) and length 0", 2, 8, 8, 128, 2048,
     (2048, 0)),
    ("gqa 32/4 (G 8) D 64", 2, 32, 4, 64, 700, (700, 3)),
]
# the cold timing's caches, in rotation: 4 x 33.5 MB, more than the L2
DATTN_COLD = 4
# Paddle's MMHA cache [2, B, H, T_max, D] read through the head-major view
# cache[0].transpose(1, 2) (head stride T D): the check case (lengths
# with a zero row and rows past one 512-row block), and the layouts'
# timing shape, the fused multi transformer phase's decode step at its
# last cached length (FMT_CTX + FMT_STEPS rows)
DATTN_HEADS_MAJOR = ("mmha B 4 T 1024, 16 heads D 128, head-major", 4, 16,
                     16, 128, 1024, (1000, 37, 0, 517))


def dattn_bytes_ops(B, Hq, Hkv, D, lengths, itemsize):
    """Each valid K and V row read once, q read and out written once;
    q.k and p.v over the valid rows."""
    rows = sum(lengths)
    return (2 * rows * Hkv * D * itemsize + 2 * B * Hq * D * itemsize
            + 4 * B, 4 * rows * Hq * D)


def dattn_plan(B, Hq, Hkv, D, T, heads_major=False):
    """The kernel library's launch plan of one bf16 call
    (``pt_decode_attention_plan``) on a ``[B, T, Hkv, D]`` cache, or with
    ``heads_major`` a ``[B, Hkv, T, D]`` one: cluster size, rows a block,
    stages, shared memory, blocks an SM, clusters the card keeps
    resident."""
    import ctypes
    from paddle_tpu_torch.kernels import build
    fn = build.library().pt_decode_attention_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_longlong,
                                        ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    build.check(fn(build.PT_BF16, B, Hq, Hkv, D, T,
                   T * D if heads_major else D, out),
                "pt_decode_attention_plan")
    return dict(zip(("splits", "rows_a_block", "stages", "smem_bytes",
                     "blocks_per_sm", "resident_clusters"), out))


def dattn_heads_major(gen, dev, ratios):
    """Kernel 3 on the head-major view of an MMHA cache: the check case in
    fp32 and bf16 against the plain version on the same view (one launch,
    a second call bit-identical); then at the fused multi transformer
    phase's decode shape the head-major and the ``[B, T, H, D]`` layouts of
    the same values timed in turns (bth, heads, heads, bth; warm: one
    cache; cold: ``DATTN_COLD`` caches in rotation), their outputs
    bit-equal, beside SDPA on the head-major cache and the bound."""
    import torch
    from paddle_tpu_torch.ops import decode_attention as tda
    label, B, Hq, Hkv, D, T, lengths = DATTN_HEADS_MAJOR
    c32 = torch.randn(2, B, Hkv, T, D, device=dev, generator=gen)
    q32 = torch.randn(B, Hq, D, device=dev, generator=gen)
    lt = torch.tensor(lengths, dtype=torch.int32, device=dev)
    err = {}
    for dtn, dt in (("float32", torch.float32),
                    ("bfloat16", torch.bfloat16)):
        cache, q = c32.to(dt), q32.to(dt)
        k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
        name = f"decode_attention {label} {dtn}"
        got = one_launch_bitwise("decode_attention",
                                 lambda: tda.decode_attention(q, k, v, lt))
        plain = tda.decode_attention_ref(q, k, v, lt)
        if dtn == "float32":
            err[dtn] = check_close(name, got, plain, TOL[dtn])
            info(f"{name}: max |kernel - plain| {err[dtn]:.2e}")
        else:
            truth = tda.decode_attention_ref(q.float(), k.float(), v.float(),
                                             lt)
            err[dtn] = check_layer_out(name, got, plain, truth, TOL[dtn],
                                       ratios)
    del c32
    rows = FMT_CTX + FMT_STEPS
    bf = torch.bfloat16
    q = torch.randn(B, Hq, D, device=dev, generator=gen).to(bf)
    caches = [torch.randn(2, B, Hkv, T, D, device=dev, generator=gen).to(bf)
              for _ in range(DATTN_COLD)]
    views = {"heads": [(c[0].transpose(1, 2), c[1].transpose(1, 2))
                       for c in caches],
             "bthd": [(c[0].transpose(1, 2).contiguous(),
                       c[1].transpose(1, 2).contiguous()) for c in caches]}
    lt = torch.full((B,), rows, dtype=torch.int32, device=dev)
    a = tda.decode_attention(q, *views["heads"][0], lt)
    b = tda.decode_attention(q, *views["bthd"][0], lt)
    if not torch.equal(a, b):
        raise SmokeFailure("decode_attention: the head-major and [B, T, H, "
                           "D] layouts of one cache give different bits")
    turn = [0]

    def cold(kvs):
        i = turn[0] = (turn[0] + 1) % DATTN_COLD
        return tda.decode_attention(q, *kvs[i], lt)
    times = {f"{w} {lay}": [] for w in ("warm", "cold")
             for lay in ("bthd", "heads")}
    for lay in ("bthd", "heads", "heads", "bthd"):
        kvs = views[lay]
        times[f"warm {lay}"].append(time_ms(
            lambda: tda.decode_attention(q, *kvs[0], lt), 50,
            per_launch=True)[0])
        times[f"cold {lay}"].append(time_ms(lambda: cold(kvs), 48,
                                            per_launch=True)[0])
    mask = (torch.arange(T, device=dev)[None, :] < lt[:, None])[:, None,
                                                                 None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = time_ms(lambda: sdpa(q[:, :, None], caches[0][0], caches[0][1],
                               attn_mask=mask), 50)[0]
    bms, bby = bound_ms(*dattn_bytes_ops(B, Hq, Hkv, D, [rows] * B, 2))
    mean = {k: sum(t) / len(t) for k, t in times.items()}
    out = dict(
        shape=f"q [{B}, {Hq}, {D}], cache [2, {B}, {Hkv}, {T}, {D}] bf16 "
              f"read as cache[0].transpose(1, 2), every length {rows}",
        check_case=label, max_abs_err=err["bfloat16"],
        max_abs_err_fp32=err["float32"], times_ms=times, mean_ms=mean,
        ms=mean["warm heads"], bound_ms=bms, bound_by=bby, library_ms=lib,
        library_what="scaled_dot_product_attention on the head-major cache, "
                     "q [B, H, 1, D], boolean length mask",
        plan=dattn_plan(B, Hq, Hkv, D, T, heads_major=True),
        plan_bthd=dattn_plan(B, Hq, Hkv, D, T))
    info(f"decode_attention head-major {out['shape']}: in turns (bthd, "
         f"heads, heads, bthd) device ms {times}; means {mean}; SDPA {lib} "
         f"ms; bound {bms:.5f} ms ({bby}); plan {out['plan']} (bthd "
         f"{out['plan_bthd']}); max |err| bf16 {err['bfloat16']:.2e} fp32 "
         f"{err['float32']:.2e}")
    return out


def phase_decode_attn(results, dev="cuda"):
    """Kernel 3 against its plain version; times at the main path's
    shape with every row at the longest step's 256 cached rows."""
    import torch
    from paddle_tpu_torch.ops import decode_attention as tda
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    err, ratios = {}, []
    for label, B, Hq, Hkv, D, T, lengths in DATTN_CASES:
        q32 = torch.randn(B, Hq, D, device=dev, generator=gen)
        k32, v32 = (torch.randn(B, T, Hkv, D, device=dev, generator=gen)
                    for _ in range(2))
        lt = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for dtn, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
            q, k, v = (t.to(dt) for t in (q32, k32, v32))
            got = tda.decode_attention(q, k, v, lt)
            again = tda.decode_attention(q, k, v, lt)
            torch.cuda.synchronize()
            plain = tda.decode_attention_ref(q, k, v, lt)
            name = f"decode_attention {label} {dtn}"
            if not torch.equal(got, again):
                raise SmokeFailure(f"{name}: two calls differ")
            if dtn == "float32":
                e = check_close(name, got, plain, TOL[dtn])
                info(f"{name}: max |kernel - plain| {e:.2e}")
            else:
                truth = tda.decode_attention_ref(q.float(), k.float(),
                                                 v.float(), lt)
                e = check_layer_out(name, got, plain, truth, TOL[dtn], ratios)
            err[dtn] = max(err.get(dtn, 0.0), e)
    heads_major = dattn_heads_major(gen, dev, ratios)

    _, B, Hq, Hkv, D, T, _ = DATTN_CASES[0]
    q = torch.randn(B, Hq, D, device=dev, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(B, T, Hkv, D, device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(2))
    lt = torch.full((B,), T, dtype=torch.int32, device=dev)
    ms, call = time_ms(lambda: tda.decode_attention(q, k, v, lt), 50,
                       per_launch=True)
    plain, plain_call = time_ms(lambda: tda.decode_attention_ref(q, k, v, lt),
                                10)
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(T, device=dev)[None, :] < lt[:, None])[:, None,
                                                                 None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = time_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask), 50)[0]
    bms, bby = bound_ms(*dattn_bytes_ops(B, Hq, Hkv, D, [T] * B, 2))
    plan = dattn_plan(B, Hq, Hkv, D, T)
    # cold: each call on the next of DATTN_COLD caches, so the rows come
    # from HBM as in a rollout, where each layer reads its own cache
    kvs = [(k, v)] + [tuple(torch.randn(B, T, Hkv, D, device=dev,
                                        generator=gen).to(torch.bfloat16)
                            for _ in range(2))
                      for _ in range(DATTN_COLD - 1)]
    turn = [0]

    def cold(fn):
        i = turn[0] = (turn[0] + 1) % DATTN_COLD
        return fn(*kvs[i])
    cold_ms, cold_call = time_ms(lambda: cold(
        lambda kk, vv: tda.decode_attention(q, kk, vv, lt)), 48,
        per_launch=True)
    lib_cold = time_ms(lambda: cold(lambda kk, vv: sdpa(
        qs, kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask)), 48)[0]
    del kvs
    results.append(dict(
        name="decode_attention", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/decode_attention.cu",
        replaces="paddle_tpu/ops/pallas/decode_attention.py:106",
        shape=f"q [{B}, {Hq}, {D}], cache [{B}, {T}, {Hkv}, {D}] bf16, "
              f"every length {T}",
        max_abs_err=err["bfloat16"], max_abs_err_fp32=err["float32"], ms=ms,
        call_ms=call, plain_ms=plain, plain_call_ms=plain_call, bound_ms=bms,
        bound_by=bby, library_ms=lib,
        library_what="scaled_dot_product_attention, q [B, H, 1, D], "
                     "boolean length mask",
        cold_ms=cold_ms, cold_call_ms=cold_call, library_cold_ms=lib_cold,
        plan=plan,
        cold_what=f"each call on the next of {DATTN_COLD} caches of this "
                  f"shape ({DATTN_COLD * 2 * k.numel() * 2 / 1e6:.1f} MB)",
        bf16_vs_fp32_ratio=max(ratios, default=None),
        heads_major=heads_major))
    r = results[-1]

    def share(t):
        return f"{100 * bms / t:.1f} % of bound" if t else "not measured"
    info(f"decode_attention bf16 {r['shape']}: warm (one cache) device {ms} "
         f"ms ({share(ms)}; per call {call:.4f}), SDPA {lib} ms "
         f"({share(lib)}); cold ({r['cold_what']}) device {cold_ms} ms "
         f"({share(cold_ms)}; per call {cold_call:.4f}), SDPA {lib_cold} ms "
         f"({share(lib_cold)}); bound {bms:.5f} ms ({bby}), plain {plain} "
         f"ms; max |err| bf16 {err['bfloat16']:.2e} fp32 "
         f"{err['float32']:.2e}; plan {plan}")


# -------------------------------------------------- weight-only matmuls
# one llama_7b layer's seven block matmuls, [K, N]
LAYER_MATMULS = (("q_w", 4096, 4096), ("k_w", 4096, 4096),
                 ("v_w", 4096, 4096), ("o_w", 4096, 4096),
                 ("gate_w", 4096, 11008), ("up_w", 4096, 11008),
                 ("down_w", 11008, 4096))
WO_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
WO_ROWS = {"small_m": 8, "tiled": 1024}          # decode B 8, prefill 8 x 128
# (width, M, K, N, group_size): grouped scales, an odd K, the prefill
# kernel's smallest M and an M off its 256-row tiles, and the decode
# kernel's 16- and 1-row calls, per channel
WO_SMALL = [("int8", 8, 4096, 4096, 64), ("int8", 8, 4096, 4096, 128),
            ("int8", 300, 4096, 1024, 64), ("int8", 300, 4096, 1024, 128),
            ("int4", 8, 4096, 4096, 64), ("int4", 8, 11008, 4096, 128),
            ("int4", 300, 4096, 1024, 64), ("int4", 300, 4096, 1024, 128),
            ("int4", 8, 4095, 1024, -1), ("int4", 300, 4095, 1024, 64),
            ("int8", 17, 4096, 1024, -1), ("int4", 1000, 4096, 1024, -1),
            ("int8", 16, 4096, 11008, -1), ("int4", 1, 11008, 4096, -1)]
WO_REPLACES = {"int8": "paddle_tpu/ops/pallas/quant_linear.py:150",
               "int4": "paddle_tpu/ops/pallas/quant_linear.py:264"}


def wo_fns(width):
    from paddle_tpu_torch.ops import quant_linear as tql
    if width == "int4":
        return tql.weight_only_matmul_int4, tql.weight_only_matmul_int4_ref
    return tql.weight_only_matmul, tql.weight_only_matmul_ref


def wo_bytes_ops(M, K, N, width, itemsize=2):
    """x read and y written once, the codes and the per-channel scale
    read once; the product 2 M K N."""
    codes = K * N if width == "int8" else -(-K // 2) * N
    return M * K * itemsize + codes + 4 * N + M * N * itemsize, 2 * M * K * N


def phase_quant_linear(results, dev="cuda"):
    """Kernels 4 and 5 against their plain versions at the main path's
    shapes and on the small cases; per-layer times (the seven matmuls of
    one llama_7b layer, 202 MB of int8 codes: more than the L2, so each
    weight is read from device memory, as in a rollout)."""
    import torch
    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops.quant_linear import unpack_int4
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    err, ratios = {}, {}

    def check(label, width, x, codes, scale, gs, key):
        fn, ref = wo_fns(width)
        got = fn(x, codes, scale, group_size=gs)
        torch.cuda.synchronize()
        plain = ref(x, codes, scale, group_size=gs)
        name = f"wo {width} {label}"
        if key.endswith("small_m"):
            # the K splits fold in a fixed order: a second call, same bits
            if not torch.equal(got, fn(x, codes, scale, group_size=gs)):
                raise SmokeFailure(f"{name}: two decode calls differ")
        if x.dtype == torch.float32:
            e = check_close(name, got, plain, TOL["float32"])
            info(f"{name}: max |kernel - plain| {e:.2e}")
        else:
            truth = ref(x.float(), codes, scale, group_size=gs)
            e = check_layer_out(name, got, plain, truth, TOL["bfloat16"],
                                ratios.setdefault(key, []))
        err[key] = max(err.get(key, 0.0), e)

    for width in ("int8", "int4"):
        for K, N in WO_SHAPES:
            w = 0.02 * torch.randn(K, N, device=dev, generator=gen)
            codes, scale = weight_quantize(w, f"weight_only_{width}")
            for regime, M in WO_ROWS.items():
                x32 = torch.randn(M, K, device=dev, generator=gen)
                check(f"M {M} [{K}, {N}] bf16", width, x32.to(torch.bfloat16),
                      codes, scale, -1, f"wo_{width}_{regime}")
                check(f"M {M} [{K}, {N}] fp32", width, x32, codes, scale, -1,
                      "wo_f32")
        for _, M, K, N, gs in (c for c in WO_SMALL if c[0] == width):
            w = 0.02 * torch.randn(K, N, device=dev, generator=gen)
            codes, scale = weight_quantize(w, f"weight_only_{width}",
                                           group_size=gs)
            x32 = torch.randn(M, K, device=dev, generator=gen)
            regime = "small_m" if M <= 16 else "tiled"
            check(f"M {M} [{K}, {N}] group {gs} bf16", width,
                  x32.to(torch.bfloat16), codes, scale, gs,
                  f"wo_{width}_{regime}")
            check(f"M {M} [{K}, {N}] group {gs} fp32", width, x32, codes,
                  scale, gs, "wo_f32")
        torch.cuda.empty_cache()

    # ---- per-layer times: seven distinct weights, one call each
    timed = {}
    for width in ("int8", "int4"):
        fn, ref = wo_fns(width)
        layer_w = []
        for _, K, N in LAYER_MATMULS:
            codes, scale = weight_quantize(
                0.02 * torch.randn(K, N, device=dev, generator=gen),
                f"weight_only_{width}")
            wdq = (codes if width == "int8" else unpack_int4(codes, K)).to(
                torch.bfloat16)
            layer_w.append((K, N, codes, scale, wdq))
        for regime, M in WO_ROWS.items():
            xs = {K: torch.randn(M, K, device=dev, generator=gen)
                  for K in sorted({K for _, K, _ in LAYER_MATMULS})}
            for xdt in (torch.bfloat16, torch.float32):
                # wo_f32 is timed once: int8 codes, decode rows
                if xdt == torch.float32 and (regime, width) != ("small_m",
                                                                "int8"):
                    continue
                xd = {K: x.to(xdt) for K, x in xs.items()}
                name = "wo_f32" if xdt == torch.float32 else \
                    f"wo_{width}_{regime}"

                def kernels():
                    for K, N, codes, scale, _ in layer_w:
                        fn(xd[K], codes, scale)

                def plains():
                    for K, N, codes, scale, _ in layer_w:
                        ref(xd[K], codes, scale)

                def library():
                    for K, N, codes, scale, wdq in layer_w:
                        torch.matmul(xd[K], wdq.to(xdt)) * scale
                by = {}
                _, call = time_ms(kernels, 10, by)
                hit = [(mean, n) for k, (mean, n) in by.items()
                       if "wo_" in k]
                ms = sum(mean * n for mean, n in hit) if hit else None
                plain, plain_call = time_ms(plains, 3)
                lib = time_ms(library, 10)[0]
                nbytes = ops = 0
                for K, N, *_ in layer_w:
                    b, o = wo_bytes_ops(M, K, N, width, xdt.itemsize)
                    nbytes, ops = nbytes + b, ops + o
                bms, bby = bound_ms(nbytes, ops, "bfloat16"
                                    if xdt == torch.bfloat16 else "float32")
                timed[name] = dict(ms=ms, call_ms=call, plain_ms=plain,
                                   plain_call_ms=plain_call, library_ms=lib,
                                   bound_ms=bms, bound_by=bby,
                                   launches_per_call=sum(n for _, n in hit),
                                   shape=f"one llama_7b layer's 7 matmuls "
                                         f"({width} codes, per channel), x "
                                         f"[{M}, K] {str(xdt)[6:]}")
                info(f"{name} {timed[name]['shape']}: device {ms} ms per "
                     f"layer (per call {call:.4f}), bound {bms:.4f} ms "
                     f"({bby}), plain {plain} ms, cuBLAS on the dequantized "
                     f"bf16 weight x scale {lib} ms")
                if ms and lib and xdt == torch.bfloat16:
                    timed[name].update(x_library=ms / lib, of_bound=bms / ms)
                    info(f"{name}: {ms / lib:.2f}x cuBLAS on the dequantized "
                         f"weight, {100 * bms / ms:.1f} % of its bound")
        del layer_w
        torch.cuda.empty_cache()
    for name in ("wo_int8_small_m", "wo_int8_tiled", "wo_int4_small_m",
                 "wo_int4_tiled", "wo_f32"):
        width = "int4" if "int4" in name else "int8"
        t = timed[name]
        results.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/kernels/csrc/quant_linear.cu",
            replaces=WO_REPLACES[width] if name != "wo_f32" else
            f"{WO_REPLACES['int8']} and :264 (fp32 x)",
            max_abs_err=err[name], **t,
            library_what="torch.matmul on the codes dequantized to bf16 "
                         "beforehand (2x the int8 / 4x the int4 weight "
                         "bytes), times the scale",
            bf16_vs_fp32_ratio=max(ratios.get(name, []), default=None)))


# ----------------------------------------------------------- generation
# the JAX bench's decode row (bench.py:1428-1463): llama_7b width, bf16,
# batch 8, prompt 128 (numpy seed 0), 128 new tokens, greedy; here at full
# depth, also in int8 and int4 weight-only, and GPT-125M (V 32768)
GEN_B, GEN_PROMPT, GEN_NEW, GEN_TIMED = 8, 128, 128, 3
GEN_LAYERS, GEN_GPT_LAYERS = 32, 12
# launches per rollout, predicted before the run: decode_attention once per
# layer per decode step; every block matmul of a quantized model (7 a
# layer) through the weight-only kernels in the prefill (M = 8 x 128: the
# tiled kernel) and in each of the 127 decode steps (M = 8: small-M)
GEN_PER_ROLLOUT = {
    "bf16": {"decode_attention": GEN_LAYERS * (GEN_NEW - 1)},
    "int8": {"decode_attention": GEN_LAYERS * (GEN_NEW - 1),
             "wo_int8_tiled": 7 * GEN_LAYERS,
             "wo_int8_small_m": 7 * GEN_LAYERS * (GEN_NEW - 1)},
    "int4": {"decode_attention": GEN_LAYERS * (GEN_NEW - 1),
             "wo_int4_tiled": 7 * GEN_LAYERS,
             "wo_int4_small_m": 7 * GEN_LAYERS * (GEN_NEW - 1)},
    "gpt bf16": {"decode_attention": GEN_GPT_LAYERS * (GEN_NEW - 1)},
}
GEN_KERNELS = ("decode_attention", "wo_int8_small_m", "wo_int8_tiled",
               "wo_int4_small_m", "wo_int4_tiled", "wo_f32")
GEN_CHECK_LAYERS, GEN_CHECK_NEW = 2, 32
QUANT = {"bf16": None, "int8": "weight_only_int8",
         "int4": "weight_only_int4"}


def gen_step_bound_ms(cfg, quant, itemsize=2):
    """Least time of one decode step at GEN_B: every block weight once
    (codes and per-channel scales when quantized), the fp32 head once, the
    cache rows of the last step (GEN_PROMPT + GEN_NEW) once."""
    from paddle_tpu_torch.models.llama import block_shapes
    shapes = block_shapes(cfg)
    L, h, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    nbytes = 0
    for name, s in shapes.items():
        n = math.prod(s)
        if name.startswith("ln") or quant is None:
            nbytes += n * itemsize
        else:
            nbytes += (n if quant == "weight_only_int8" else n // 2) \
                + 4 * s[-1]
    kv = 2 * GEN_B * (GEN_PROMPT + GEN_NEW) * cfg.kv_heads * cfg.head_dim \
        * itemsize
    return 1e3 * (L * (nbytes + kv) + h * V * 4) / HBM_BYTES_PER_S


def profile_step(step, params, cache, tok, pos):
    """One decode step under the profiler: ``(wall ms, device busy ms,
    top kernels, decode_attention ms)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    ts = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, cache, tok, pos)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - ts)
    by = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            by[ev.key.split("(")[0][:50]] = (us / 1e3, ev.count)
    attn = sum(ms for k, (ms, _) in by.items() if "decode_attention" in k)
    return wall, sum(ms for ms, _ in by.values()), sorted(
        by.items(), key=lambda kv: -kv[1][0])[:8], attn


def run_rollouts(tag, generate, params, cfg, ids_t, per_rollout, decoder):
    """One warm and GEN_TIMED timed rollouts through ``generate``, the
    launch counts zeroed before and read after (``per_rollout`` each, every
    other kernel 0); then the prefill alone and one profiled decode step.
    Returns ``(counts, summary, ids)``."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    layer.reset_counts()
    times = []
    for i in range(1 + GEN_TIMED):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = generate(params, cfg, ids_t, GEN_NEW)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - ts)
    counts = layer.launch_counts()
    want = {k: n * (1 + GEN_TIMED) for k, n in per_rollout.items()}
    got = {k: n for k, n in counts.items() if n}
    if got != want:
        raise SmokeFailure(f"{tag}: launch counts {got}, predicted {want} "
                           f"(every other kernel 0)")
    if tuple(out.shape) != (GEN_B, GEN_PROMPT + GEN_NEW) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()) or not torch.equal(
            out[:, :GEN_PROMPT], ids_t):
        raise SmokeFailure(f"{tag}: rollout ids malformed, shape "
                           f"{tuple(out.shape)}")
    prefill, step = decoder
    with torch.inference_mode():
        torch.cuda.synchronize()
        ts = time.perf_counter()
        cache, logits = prefill(params, ids_t)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - ts)
        tok = logits.argmax(-1)
        step(params, cache, tok, GEN_PROMPT)               # warm
        wall, busy, top, attn = profile_step(step, params, cache, tok,
                                             GEN_PROMPT + 1)
    roll_ms = 1e3 * sum(times) / len(times)
    step_ms = (roll_ms - prefill_ms) / (GEN_NEW - 1)
    s = dict(rollout_ms=roll_ms, rollout_ms_all=[1e3 * t for t in times],
             prefill_ms=prefill_ms, decode_step_ms=step_ms,
             tokens_per_s=GEN_B * GEN_NEW / (roll_ms / 1e3),
             decode_tokens_per_s=GEN_B / (step_ms / 1e3),
             profiled_step_wall_ms=wall, profiled_step_busy_ms=busy,
             profiled_step_decode_attention_ms=attn,
             busy_share_of_profiled=busy / wall,
             busy_share_of_step=busy / step_ms, launches=got)
    info(f"generate {tag}: rollout {roll_ms:.1f} ms (runs "
         f"{[round(x, 1) for x in s['rollout_ms_all']]}), prefill "
         f"{prefill_ms:.1f} ms, decode step {step_ms:.2f} ms, "
         f"{s['tokens_per_s']:.1f} tokens/s ({s['decode_tokens_per_s']:.1f} "
         f"in the decode steps); profiled step {wall:.2f} ms wall, device "
         f"busy {busy:.2f} ms ({100 * busy / wall:.1f}% of it, "
         f"{100 * busy / step_ms:.1f}% of the unprofiled step), "
         f"decode_attention {attn:.4f} ms; top "
         + "; ".join(f"{k} {ms:.3f} x{c}" for k, (ms, c) in top))
    return counts, s, out


def phase_generate(dev="cuda"):
    """llama_7b at full width and depth through llama_generate in bf16,
    int8 and int4 weight-only, and GPT-125M through gpt_generate; then the
    2-layer logits checks."""
    import numpy as np
    import torch
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.models import generation as tgen
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.models import llama as tllama
    rng = np.random.default_rng(SEED)
    cfg = tllama.llama_7b(num_layers=GEN_LAYERS, dtype="bfloat16")
    ids_t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        GEN_B, GEN_PROMPT))).to(dev)
    t0 = time.perf_counter()
    params = tllama.init_params(cfg, make_generator(SEED, dev), device=dev)
    torch.cuda.synchronize()
    info(f"generate: llama_7b x {GEN_LAYERS} layers bf16 built in "
         f"{time.perf_counter() - t0:.1f} s; B {GEN_B}, prompt {GEN_PROMPT}, "
         f"{GEN_NEW} new tokens, greedy")
    counts, summary, outs = {}, {}, {}
    for tag, quant in QUANT.items():
        p = params if quant is None else tgen.quantize_llama_params(params,
                                                                   quant)
        torch.cuda.synchronize()

        def generate(pp, c, ids, n, quant=quant):
            return tgen.llama_generate(pp, c, ids, n, quant=quant)
        dec = tgen.build_llama_decoder(cfg, GEN_PROMPT + GEN_NEW, quant=quant)
        c, s, out = run_rollouts(f"llama_7b {tag}", generate, p, cfg, ids_t,
                                 GEN_PER_ROLLOUT[tag], dec)
        bound = gen_step_bound_ms(cfg, quant)
        s.update(step_bound_ms=bound, tokens_per_s_ceiling=GEN_B / (
            bound / 1e3))
        info(f"generate llama_7b {tag}: decode-step bound {bound:.3f} ms, "
             f"ceiling {s['tokens_per_s_ceiling']:.0f} tokens/s")
        counts[tag], summary[tag], outs[tag] = c, s, out
        del p, dec
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()

    gcfg = tgpt.GPTConfig(vocab_size=32768, hidden_size=768,
                          num_layers=GEN_GPT_LAYERS, num_heads=12,
                          dtype="bfloat16")
    gparams = tgpt.init_params(gcfg, make_generator(SEED, dev), device=dev)
    gids = torch.from_numpy(rng.integers(0, gcfg.vocab_size, (
        GEN_B, GEN_PROMPT))).to(dev)
    c, s, _ = run_rollouts("gpt_125m bf16", tgen.gpt_generate, gparams, gcfg,
                           gids, GEN_PER_ROLLOUT["gpt bf16"],
                           tgen.build_gpt_decoder(gcfg, GEN_PROMPT + GEN_NEW))
    counts["gpt bf16"], summary["gpt bf16"] = c, s
    del gparams
    torch.cuda.empty_cache()
    check_generation(dev)
    return counts, summary


def check_generation(dev="cuda"):
    """llama_7b at 2 layers: the prefill and first decode step logits of
    the kernel path against the plain path on the card, both held to an
    fp32 plain run (check_layer_out's rule); the int8 / int4 logits'
    distance from bf16 and the first greedy divergence reported."""
    import numpy as np
    import torch
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.models import generation as tgen
    from paddle_tpu_torch.models import llama as tllama
    cfg = tllama.llama_7b(num_layers=GEN_CHECK_LAYERS, dtype="bfloat16")
    cfg32 = tllama.llama_7b(num_layers=GEN_CHECK_LAYERS)
    params = tllama.init_params(cfg, make_generator(SEED, dev), device=dev)
    p32 = {k: (v.float() if not isinstance(v, dict) else
               {n: w.float() for n, w in v.items()})
           for k, v in params.items()}
    ids = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (GEN_B, GEN_PROMPT))).to(dev)
    max_len = GEN_PROMPT + GEN_NEW
    logits = {}
    with torch.inference_mode():
        for tag, quant in QUANT.items():
            pq = params if quant is None else tgen.quantize_llama_params(
                params, quant)
            pq32 = p32 if quant is None else tgen.quantize_llama_params(
                p32, quant)

            tok = []                     # the kernel path's first token

            def two(c, p):
                pre, step = tgen.build_llama_decoder(c, max_len, quant=quant)
                cache, lg0 = pre(p, ids)
                if not tok:
                    tok.append(lg0.argmax(-1))
                return lg0, step(p, cache, tok[0], GEN_PROMPT)[1]
            kern = two(cfg, pq)
            with plain_path():
                plain = two(cfg, pq)
                truth = two(cfg32, pq32)
            for i, what in enumerate(("prefill", "first decode step")):
                check_layer_out(f"generate check llama_7b x 2 {tag} {what} "
                                f"logits", kern[i], plain[i], truth[i],
                                TOL["bfloat16"])
            logits[tag] = kern[0]
            # the first position where greedy kernel and plain rollouts part
            a = tgen.llama_generate(pq, cfg, ids, GEN_CHECK_NEW, quant=quant)
            with plain_path():
                b = tgen.llama_generate(pq, cfg, ids, GEN_CHECK_NEW,
                                        quant=quant)
            diff = (a != b)[:, GEN_PROMPT:].any(0).nonzero()
            info(f"generate check {tag}: greedy kernel vs plain rollouts "
                 f"({GEN_CHECK_NEW} new tokens) first differ at new token "
                 f"{int(diff[0]) if len(diff) else 'none'}")
            del pq, pq32
    for tag in ("int8", "int4"):
        info(f"generate check: {tag} prefill logits rel L2 from bf16 "
             f"{rel_l2(logits[tag], logits['bf16']):.4f} (JAX test bound for "
             f"int8: 0.1)")


# ------------------------------------------------------ eager-path kernels
# (label, rows, H): the eager steps' shapes first (Llama's RMSNorm rows,
# GPT's LayerNorm rows, Llama's SwiGLU [8192, 11008]), then the odd cases:
# 3 rows, H 1000 (a ragged last warp), H 1001 (not a multiple of the
# 16-byte chunk: the scalar path)
NORM_CASES = {
    "rms_norm_fwd": [("llama [8192, 4096]", 8192, 4096), ("3 rows", 3, 4096),
                     ("H 1000", 64, 1000), ("H 1001", 64, 1001)],
    "layer_norm_fwd": [("gpt [8192, 768]", 8192, 768), ("3 rows", 3, 768),
                       ("H 1000", 64, 1000), ("H 1001", 64, 1001)],
    "bias_residual_ln_fwd": [("gpt [8192, 768]", 8192, 768),
                             ("3 rows", 3, 768), ("H 1000", 64, 1000),
                             ("H 1001", 64, 1001)],
    "swiglu_fwd": [("llama [8192, 11008]", 8192, 11008), ("3 rows", 3, 11008),
                   ("H 1001", 64, 1001)],
}
NORM_SOURCES = {"rms_norm_fwd": "norms.cu", "layer_norm_fwd": "norms.cu",
                "bias_residual_ln_fwd": "norms.cu", "swiglu_fwd": "swiglu.cu"}
NORM_REPLACES = {
    "rms_norm_fwd": "paddle_tpu/ops/pallas/norms.py:52",
    "layer_norm_fwd": "paddle_tpu/ops/pallas/norms.py:121",
    "bias_residual_ln_fwd": "paddle_tpu/ops/pallas/norms.py:274",
    "swiglu_fwd": "paddle_tpu/ops/pallas/fused.py:47"}
NORM_EPS = 1e-5


def norm_inputs(name, R, H, dt, gen, dev):
    """Seeded inputs of one case: rows ``x`` (and ``y``: the residual, or
    SwiGLU's second operand) ``[R, H]`` and ``[H]`` vectors in ``dt``; the
    bias-residual LayerNorm's gains and bias fp32 (the incubate op's
    defaults are fp32)."""
    import torch

    def t(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale
                + shift).to(dt)
    inp = dict(x=t(R, H, shift=0.3), y=t(R, H), w=t(H, scale=0.1, shift=1.0),
               b=t(H, scale=0.1), bias=t(H, scale=0.1))
    # the library's LayerNorm takes gains in x's dtype
    inp["w_lib"], inp["b_lib"] = inp["w"], inp["b"]
    if name == "bias_residual_ln_fwd":
        inp["w"], inp["b"] = inp["w"].float(), inp["b"].float()
    return inp


def norm_call(name, which, inp):
    """One call of kernel ``name``'s wrapper (``"kernel"``), its plain
    version (``"plain"``) or the PyTorch library call that computes the
    same function (``"library"``); a tuple of outputs."""
    import torch.nn.functional as tF
    from paddle_tpu_torch.ops import fused as tfu
    from paddle_tpu_torch.ops import norms as tno
    from paddle_tpu_torch.ops.cuda import fused as cfu
    from paddle_tpu_torch.ops.cuda import norms as cno
    x, y, w, b, bias = (inp[k] for k in ("x", "y", "w", "b", "bias"))
    H, eps = x.shape[-1], NORM_EPS
    fns = {
        "rms_norm_fwd": (lambda: cno.rms_norm_fwd_cuda(x, w, eps),
                         lambda: tno.rms_norm_ref(x, w, eps),
                         lambda: tF.rms_norm(x, (H,), w, eps)),
        "layer_norm_fwd": (lambda: cno.layer_norm_fwd_cuda(x, w, b, eps),
                           lambda: tno.layer_norm_ref(x, w, b, eps),
                           lambda: tF.layer_norm(x, (H,), w, b, eps)),
        "bias_residual_ln_fwd": (
            lambda: cno.bias_residual_ln_fwd_cuda(x, y, bias, w, b, eps),
            lambda: tno.bias_residual_ln_ref(x, y, bias, w, b, eps),
            lambda: tF.layer_norm(x + bias + y, (H,), inp["w_lib"],
                                  inp["b_lib"], eps)),
        "swiglu_fwd": (lambda: cfu.swiglu_fwd_cuda(x, y),
                       lambda: tfu.swiglu_ref(x, y),
                       lambda: tF.silu(x) * y)}
    out = fns[name][("kernel", "plain", "library").index(which)]()
    return out if isinstance(out, tuple) else (out,)


# the library call each kernel is timed against
NORM_LIBRARY = {"rms_norm_fwd": "F.rms_norm", "layer_norm_fwd": "F.layer_norm",
                "bias_residual_ln_fwd": "x + bias + residual, then "
                                        "F.layer_norm",
                "swiglu_fwd": "F.silu(x) * y"}


def norm_bytes_ops(name, R, H, itemsize):
    """Each input read once and each output written once (the fp32 row
    statistics included); fp32 operations per element: square-sum and
    scale (4), centred sums and affine (7), plus bias and residual (9),
    sigmoid, two products (5)."""
    n = R * H
    return {"rms_norm_fwd": (2 * n * itemsize + H * itemsize + 4 * R, 4 * n),
            "layer_norm_fwd": (2 * n * itemsize + 2 * H * itemsize + 8 * R,
                               7 * n),
            "bias_residual_ln_fwd": (4 * n * itemsize + H * (itemsize + 8)
                                     + 8 * R, 9 * n),
            "swiglu_fwd": (3 * n * itemsize, 5 * n)}[name]


def phase_norms(results, dev="cuda"):
    """Kernels 12, 13, 14 and 16 against their plain versions in fp32
    (TOL) and bf16 (TOL, or the ratio rule against the plain version on
    the inputs upcast to fp32) at the eager steps' shapes and the odd
    cases, one launch per call and a second call bit-identical; bf16
    kernel, plain and library times at the eager steps' shapes."""
    import torch
    gen = torch.Generator(device=dev)
    for name, cases in NORM_CASES.items():
        err, ratios = {}, []
        for label, R, H in cases:
            for dtn, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
                gen.manual_seed(SEED)
                inp = norm_inputs(name, R, H, dt, gen, dev)
                got = one_launch_bitwise(
                    name, lambda: norm_call(name, "kernel", inp))
                ref = norm_call(name, "plain", inp)
                truth = norm_call(name, "plain",
                                  {k: v.float() for k, v in inp.items()})
                for i, (g, r, tr) in enumerate(zip(got, ref, truth)):
                    what = f"{name} {label} {dtn} output {i}"
                    if g.dtype != r.dtype or g.shape != r.shape:
                        raise SmokeFailure(
                            f"{what}: {g.dtype} {tuple(g.shape)}, plain "
                            f"{r.dtype} {tuple(r.shape)}")
                    # fp32 outputs and the fp32 row statistics: fp32 sums
                    # of the same values on both sides
                    e = check_close(what, g, r, TOL["float32"]) \
                        if r.dtype == torch.float32 else \
                        check_layer_out(what, g, r, tr, TOL[dtn], ratios)
                    err[dtn] = max(err.get(dtn, 0.0), e)
            info(f"{name} {label}: max |kernel - plain| fp32 "
                 f"{err['float32']:.2e}, bf16 {err['bfloat16']:.2e}")
        label, R, H = cases[0]
        gen.manual_seed(SEED)
        inp = norm_inputs(name, R, H, torch.bfloat16, gen, dev)
        ms, call = time_ms(lambda: norm_call(name, "kernel", inp), 50,
                           per_launch=True)
        plain_ms, plain_call = time_ms(lambda: norm_call(name, "plain", inp),
                                       10)
        lib_ms = time_ms(lambda: norm_call(name, "library", inp), 50)[0]
        bms, bby = bound_ms(*norm_bytes_ops(name, R, H, 2), dtype="float32")
        results.append(dict(
            name=name, route="cuda",
            source=f"paddle_tpu_torch/kernels/csrc/{NORM_SOURCES[name]}",
            replaces=NORM_REPLACES[name], shape=f"{label} bf16",
            max_abs_err=err["bfloat16"], max_abs_err_fp32=err["float32"],
            ms=ms, call_ms=call, plain_ms=plain_ms,
            plain_call_ms=plain_call, bound_ms=bms, bound_by=bby,
            library_ms=lib_ms, library_what=NORM_LIBRARY[name],
            bf16_vs_fp32_ratio=max(ratios, default=None)))
        info(f"{name} bf16 {label}: device {ms} ms (per call {call:.4f}), "
             f"bound {bms:.4f} ms ({bby}), plain {plain_ms} ms, library "
             f"({NORM_LIBRARY[name]}) {lib_ms} ms")


# -------------------------------------------------------------- eager
# the eager models' dygraph loop (loss = net(ids, labels); loss.backward();
# opt.step(); opt.clear_grad()) at the gpt and train phases' models and
# batches: GPT-125M (V 32768, 12 layers, bf16, dropout 0) at 8 x 1024 and
# llama_7b x 4 layers bf16 at 4 x 2048, AdamW(lr 1e-4)
EAGER_GPT_LAYERS, EAGER_GPT_B, EAGER_GPT_S = 12, 8, 1024
EAGER_LLAMA_LAYERS, EAGER_LLAMA_B, EAGER_LLAMA_S = 4, 4, 2048
EAGER_CHECK_LAYERS, EAGER_LR, EAGER_LOSS_TOL = 2, 1e-4, 1e-4
# launches per eager step, predicted before the first run: GPT's ln1 is the
# fused LayerNorm (ln_f is the plain chain) and its attention epilogue the
# fused bias-residual LayerNorm, one each a block; flash forward and
# backward once a block (no remat); Llama's two RMSNorms a block and the
# final one, SwiGLU once a block, dense attention (no flash); the fused
# head on both
EAGER_GPT_PER_STEP = {"layer_norm_fwd": EAGER_GPT_LAYERS,
                      "bias_residual_ln_fwd": EAGER_GPT_LAYERS,
                      "flash_fwd": EAGER_GPT_LAYERS,
                      "flash_bwd_dq": EAGER_GPT_LAYERS,
                      "flash_bwd_dkv": EAGER_GPT_LAYERS, **LCE_PER_STEP}
EAGER_LLAMA_PER_STEP = {"rms_norm_fwd": 2 * EAGER_LLAMA_LAYERS + 1,
                        "swiglu_fwd": EAGER_LLAMA_LAYERS, **LCE_PER_STEP}


def eager_model(kind, layers, dev, dtype):
    """A seeded eager model (``make_generator(SEED)``) cast to ``dtype``."""
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.models import llama as tllama
    gen = make_generator(SEED, dev)
    if kind == "gpt":
        cfg = tgpt.GPTConfig(vocab_size=32768, hidden_size=768,
                             num_layers=layers, num_heads=12)
        net = tgpt.GPTForCausalLM(cfg, generator=gen, device=dev)
    else:
        name = "bfloat16" if dtype is not None else "float32"
        cfg = tllama.llama_7b(num_layers=layers, dtype=name)
        net = tllama.LlamaForCausalLM(cfg, generator=gen, device=dev)
    return (net if dtype is None else net.to(dtype)), cfg


def eager_batch(vocab, B, S, dev):
    import numpy as np
    import torch
    ids = np.random.default_rng(SEED).integers(0, vocab, (B, S))
    return (torch.from_numpy(ids).to(dev),
            torch.from_numpy(np.roll(ids, -1, axis=1)).to(dev))


def eager_loss_and_grads(net, ids, labels):
    """One step's loss and every parameter's gradient, ``(loss, {name:
    grad})`` (the tree ``check_steps`` reads)."""
    loss = net(ids, labels)
    loss.backward()
    grads = {k: p.grad for k, p in net.named_parameters()}
    for p in net.parameters():
        p.grad = None
    return loss.detach(), grads


class plain_path:
    """Within the block the ops run the plain versions of kernels 3-19 but
    the serving ones on CUDA tensors (the port never does: its ops launch
    the kernels for CUDA tensors)."""

    def __enter__(self):
        from paddle_tpu_torch.ops import decode_attention as tda
        from paddle_tpu_torch.ops import flash_attention as tfa
        from paddle_tpu_torch.ops import fused as tfu
        from paddle_tpu_torch.ops import fused_cross_entropy as tce
        from paddle_tpu_torch.ops import norms as tno
        from paddle_tpu_torch.ops import quant_linear as tql
        from paddle_tpu_torch.ops import rope as tro
        from paddle_tpu_torch.ops.cuda import decode_attention as cda
        from paddle_tpu_torch.ops.cuda import flash_attention as cfa
        from paddle_tpu_torch.ops.cuda import fused as cfu
        from paddle_tpu_torch.ops.cuda import linear_ce as cce
        from paddle_tpu_torch.ops.cuda import norms as cno
        from paddle_tpu_torch.ops.cuda import rope as cro

        def lce_fwd(x2, w, labels, **kw):
            return tce.lce_fwd_ref(x2, w, labels,
                                   chunk=tce.default_chunk(w.shape[0]), **kw)
        swaps = [(cda, "decode_attention_cuda", tda.decode_attention_ref),
                 (tql, "weight_only_matmul", tql.weight_only_matmul_ref),
                 (tql, "weight_only_matmul_int4",
                  tql.weight_only_matmul_int4_ref),
                 (cno, "rms_norm_fwd_cuda", tno.rms_norm_ref),
                 (cno, "layer_norm_fwd_cuda", tno.layer_norm_ref),
                 (cno, "bias_residual_ln_fwd_cuda", tno.bias_residual_ln_ref),
                 (cfu, "swiglu_fwd_cuda", tfu.swiglu_ref),
                 (cfa, "flash_fwd_cuda", tfa.flash_fwd_ref),
                 (cfa, "flash_bwd_cuda", tfa.flash_bwd_ref),
                 (cce, "linear_ce_fwd_cuda", lce_fwd),
                 (cce, "linear_ce_bwd_cuda", tce.lce_bwd_ref),
                 (cro, "rope_fwd_cuda", tro.rope_ref),
                 (cfu, "softmax_mask_fwd_cuda", tfu.softmax_mask_ref),
                 (cfu, "bias_act_fwd_cuda", tfu.bias_act_ref),
                 (cfu, "dropout_add_fwd_cuda", tfu.dropout_add_ref)]
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
        for m, n, fn in swaps:
            setattr(m, n, fn)

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def check_eager(kind, B, S, dev="cuda"):
    """A 2-layer bf16 model's loss and gradients through the kernels
    against the same model's plain path (loss within EAGER_LOSS_TOL
    relative; each gradient within STEP_REL_L2 or no further from an fp32
    run of the plain path than BF16_SLACK x the plain bf16 path), with no
    launch on the plain path."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    net, cfg = eager_model(kind, EAGER_CHECK_LAYERS, dev, torch.bfloat16)
    ids, labels = eager_batch(cfg.vocab_size, B, S, dev)
    runs = {"kernels": eager_loss_and_grads(net, ids, labels)}
    layer.reset_counts()
    with plain_path():
        runs["plain"] = eager_loss_and_grads(net, ids, labels)
        del net
        net32, _ = eager_model(kind, EAGER_CHECK_LAYERS, dev, None)
        truth = eager_loss_and_grads(net32, ids, labels)
        del net32
    torch.cuda.synchronize()
    n = {k: c for k, c in layer.launch_counts().items() if c}
    if n:
        raise SmokeFailure(f"eager {kind} plain path launched {n}")
    check_steps(f"eager {kind} ({EAGER_CHECK_LAYERS} layers, bf16, {B} x "
                f"{S})", runs, truth,
                (("kernels vs plain path", "kernels", "plain",
                  EAGER_LOSS_TOL),))
    del runs, truth
    torch.cuda.empty_cache()


def phase_eager(dev="cuda"):
    """The eager GPT-125M and llama_7b x 4 models through their dygraph
    loop (1 warm and TRAIN_STEPS timed steps, launch counts as predicted),
    then the 2-layer checks."""
    import torch
    from paddle_tpu_torch.optimizer import AdamW
    counts, summary = {}, {}
    for kind, layers, B, S, per_step in (
            ("gpt", EAGER_GPT_LAYERS, EAGER_GPT_B, EAGER_GPT_S,
             EAGER_GPT_PER_STEP),
            ("llama", EAGER_LLAMA_LAYERS, EAGER_LLAMA_B, EAGER_LLAMA_S,
             EAGER_LLAMA_PER_STEP)):
        t0 = time.perf_counter()
        net, cfg = eager_model(kind, layers, dev, torch.bfloat16)
        opt = AdamW(learning_rate=EAGER_LR,
                    parameters=net.named_parameters())
        torch.cuda.synchronize()
        info(f"eager {kind}: {layers} layers, bf16, "
             f"{sum(p.numel() for p in net.parameters())} params, built in "
             f"{time.perf_counter() - t0:.1f} s; batch {B} x {S}")
        ids, labels = eager_batch(cfg.vocab_size, B, S, dev)

        def step(state, ids_t, labels_t, net=net, opt=opt):
            loss = net(ids_t, labels_t)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return state, loss.detach()
        c, s = run_steps(f"eager {kind}", step, None, ids, labels, per_step)
        counts[f"eager {kind}"], summary[kind] = c, s
        del net, opt
        torch.cuda.empty_cache()
        check_eager(kind, B, S, dev)
    return counts, summary


# ------------------------------------------------------- incubate fused
# kernels 15, 17, 18 and 19 (fused_ops.cu) at the shapes of the models
# that call them: RoPE on q (and k) of the llama_7b train batch
# [4, 2048, 32, 128]; softmax(x + mask) on the BERT-base attention logits
# of BASELINE config 3's batch (b 32 x s 128, 12 heads) with a [32, 1,
# 128, 128] fp32 padding mask; act(x + bias) on the encoder's FFN
# [4096, 3072]; dropout(x) + y on its residual stream [4096, 768]
FUSED_SOURCE = "paddle_tpu_torch/kernels/csrc/fused_ops.cu"
FUSED_REPLACES = {"rope_fwd": "paddle_tpu/ops/pallas/rope.py:52",
                  "softmax_mask_fwd": "paddle_tpu/ops/pallas/fused.py:101",
                  "bias_act_fwd": "paddle_tpu/ops/pallas/fused.py:141",
                  "dropout_add_fwd": "paddle_tpu/ops/pallas/fused.py:179"}
ROPE_MAIN, ROPE_SMALL = (4, 2048, 32, 128), [(2, 8, 3, 16), (1, 5, 2, 6),
                                              (1, 3, 1, 2), (2, 64, 5, 96)]
SOFTMAX_MAIN = ((32, 12, 128, 128), (32, 1, 128, 128))
SOFTMAX_SMALL = [("S 1", (4, 3, 1), (1,)), ("S 7", (2, 3, 5, 7), (2, 1, 5, 7)),
                 ("S 300", (2, 3, 300), (300,)),
                 ("S 1000", (2, 3, 7, 1000), (2, 1, 1, 1000)),
                 ("S 5000", (3, 2, 5000), (3, 1, 5000)),
                 ("row-broadcast mask", (2, 4, 128), (2, 4, 1))]
BIAS_ACT_MAIN, BIAS_ACT_SMALL = (4096, 3072), [(3, 3072), (64, 1001)]
ACTS = ("gelu", "relu", "silu", "tanh", "sigmoid")
DROPOUT_MAIN, DROPOUT_SMALL, DROPOUT_P = (4096, 768), [(1,), (7,),
                                                        (64, 1001)], 0.1
# the public calls' launches, predicted before the first run: RoPE on q
# and k forward and backward (one launch per tensor, the VJP the same
# kernel with sign -1), one softmax, one activation, one dropout-add at
# p 0 and one at p 0.1
FUSED_CALLS = {"rope_fwd": 4, "softmax_mask_fwd": 1, "bias_act_fwd": 1,
               "dropout_add_fwd": 2}


def one_launch(name, fn):
    """``fn()`` with the counts zeroed first; fails unless kernel ``name``
    alone was launched, once."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    layer.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    n = {k: c for k, c in layer.launch_counts().items() if c}
    if n != {name: 1}:
        raise SmokeFailure(f"{name}: one call launched {n}")
    return out


def check_pair(label, dtn, got, plain, truth, err, ratios):
    """fp32: TOL; bf16: TOL or the ratio rule against ``truth``."""
    if got.dtype != plain.dtype or got.shape != plain.shape:
        raise SmokeFailure(f"{label}: {got.dtype} {tuple(got.shape)}, plain "
                           f"{plain.dtype} {tuple(plain.shape)}")
    e = check_close(label, got, plain, TOL["float32"]) \
        if dtn == "float32" else \
        check_layer_out(label, got, plain, truth, TOL[dtn], ratios)
    err[dtn] = max(err.get(dtn, 0.0), e)


def fused_entry(name, shape, err, ratios, timed, plain_fn, lib_fn, lib_what,
                nbytes, ops, results, extra=None):
    """Time kernel ``name`` (bf16, per launch), its plain version and the
    library call; append its ``kernels`` entry."""
    ms, call = time_ms(timed, 50, per_launch=True)
    plain_ms, plain_call = time_ms(plain_fn, 5)
    lib_ms = time_ms(lib_fn, 50)[0] if lib_fn is not None else None
    bms, bby = bound_ms(nbytes, ops, dtype="float32")
    results.append(dict(
        name=name, route="cuda", source=FUSED_SOURCE,
        replaces=FUSED_REPLACES[name], shape=shape,
        max_abs_err=err["bfloat16"], max_abs_err_fp32=err["float32"],
        ms=ms, call_ms=call, plain_ms=plain_ms, plain_call_ms=plain_call,
        bound_ms=bms, bound_by=bby, library_ms=lib_ms,
        library_what=lib_what, bf16_vs_fp32_ratio=max(ratios, default=None),
        **(extra or {})))
    info(f"{name} bf16 {shape}: device {ms} ms (per call {call:.4f}), "
         f"bound {bms:.4f} ms ({bby}), plain {plain_ms} ms, library "
         f"({lib_what}) {lib_ms} ms; max |err| bf16 {err['bfloat16']:.2e} "
         f"fp32 {err['float32']:.2e}")


def fused_rope_checks(gen, dev, results):
    import torch
    from paddle_tpu_torch.ops import rope as tr
    from paddle_tpu_torch.ops.cuda import rope as cr
    err, ratios = {}, []
    for shape in ROPE_SMALL + [ROPE_MAIN]:
        x32 = torch.randn(shape, device=dev, generator=gen)
        g32 = torch.randn(shape, device=dev, generator=gen)
        for tdt in (torch.float32, torch.bfloat16):
            cos, sin = tr.rope_cos_sin(shape[1], shape[-1], dtype=tdt,
                                       device=dev)
            for dtn, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
                x, g = x32.to(dt), g32.to(dt)
                for sign in (1.0, -1.0):
                    got = one_launch("rope_fwd", lambda: cr.rope_fwd_cuda(
                        x, cos, sin, sign))
                    check_pair(f"rope_fwd {shape} tables {tdt} {dtn} sign "
                               f"{sign:+.0f}", dtn, got,
                               tr.rope_ref(x, cos, sin, sign),
                               tr.rope_ref(x.float(), cos, sin, sign), err,
                               ratios)
                # the op's VJP launches the kernel with sign -1 on g
                xr = x.detach().requires_grad_()
                out = tr.fused_rope(xr, sin=sin, cos=cos)[0]
                grad = one_launch("rope_fwd", lambda: torch.autograd.grad(
                    out, xr, g)[0])
                check_pair(f"rope_fwd VJP {shape} {dtn}", dtn, grad,
                           tr.rope_ref(g, cos, sin, -1.0),
                           tr.rope_ref(g.float(), cos, sin, -1.0), err,
                           ratios)
        info(f"rope_fwd {shape}: max |kernel - plain| fp32 "
             f"{err['float32']:.2e}, bf16 {err['bfloat16']:.2e}")
    q = torch.randn(ROPE_MAIN, device=dev, generator=gen).to(torch.bfloat16)
    cos, sin = tr.rope_cos_sin(ROPE_MAIN[1], ROPE_MAIN[-1], device=dev)
    n, tables = q.numel(), 2 * ROPE_MAIN[1] * ROPE_MAIN[-1] * 4
    # x * cos + rot * (sin * sign): 4 fp32 operations an element
    fused_entry("rope_fwd", f"q {list(ROPE_MAIN)} bf16, fp32 tables", err,
                ratios, lambda: cr.rope_fwd_cuda(q, cos, sin),
                lambda: tr.rope_ref(q, cos, sin), None,
                "none: no single torch call computes rotate-half RoPE",
                2 * n * 2 + tables, 4 * n, results)


def padding_mask(xs, ms, gen, dev):
    """A fp32 padding mask of shape ``ms`` ([B, 1, S, S]) for logits ``xs``
    [B, H, S, S]: each batch row keeps a random length of its S keys, -1e4
    past it."""
    import torch
    lengths = torch.randint(1, xs[-1] + 1, (xs[0],), device=dev,
                            generator=gen)
    pad = torch.arange(xs[-1], device=dev)[None, :] >= lengths[:, None]
    return torch.where(pad, -1e4, 0.0)[:, None, None, :].expand(ms) \
        .contiguous()


def fused_softmax_checks(gen, dev, results):
    import torch
    from paddle_tpu_torch.ops import fused as tf
    from paddle_tpu_torch.ops.cuda import fused as cf
    err, ratios = {}, []
    cases = SOFTMAX_SMALL + [("main", *SOFTMAX_MAIN)]
    for label, xs, ms_ in cases:
        x32 = torch.randn(xs, device=dev, generator=gen) * 3
        keep = torch.rand(ms_, device=dev, generator=gen) > 0.2
        for mdt in (torch.float32, torch.bfloat16):
            mask = torch.where(keep, 0.0, -1e4).to(mdt)
            for dtn, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
                x = x32.to(dt)
                got = one_launch("softmax_mask_fwd",
                                 lambda: cf.softmax_mask_fwd_cuda(x, mask))
                check_pair(f"softmax_mask_fwd {label} mask {mdt} {dtn}", dtn,
                           got, tf.softmax_mask_ref(x, mask),
                           tf.softmax_mask_ref(x.float(), mask), err, ratios)
        info(f"softmax_mask_fwd {label}: max |kernel - plain| fp32 "
             f"{err['float32']:.2e}, bf16 {err['bfloat16']:.2e}")
    # a row whose mask is all -inf gives NaN, as in the JAX kernel
    x = torch.ones(2, 3, device=dev)
    mask = torch.tensor([[-float("inf")] * 3, [0.0] * 3], device=dev)
    got = one_launch("softmax_mask_fwd",
                     lambda: cf.softmax_mask_fwd_cuda(x, mask))
    if not (torch.isnan(got[0]).all() and not torch.isnan(got[1]).any()):
        raise SmokeFailure(f"softmax_mask_fwd all-masked row: {got}")
    xs, ms_ = SOFTMAX_MAIN
    x = (torch.randn(xs, device=dev, generator=gen) * 3).to(torch.bfloat16)
    mask = padding_mask(xs, ms_, gen, dev)
    n = x.numel()
    # add, max, subtract, exp, sum, divide: 6 fp32 operations an element
    fused_entry("softmax_mask_fwd",
                f"x {list(xs)} bf16, mask {list(ms_)} fp32 (padding)", err,
                ratios, lambda: cf.softmax_mask_fwd_cuda(x, mask),
                lambda: tf.softmax_mask_ref(x, mask),
                lambda: torch.softmax(x + mask, -1),
                "torch.softmax(x + mask, -1): 2 calls",
                2 * n * 2 + mask.numel() * 4, 6 * n, results)


def fused_bias_act_checks(gen, dev, results):
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.ops import fused as tf
    from paddle_tpu_torch.ops.cuda import fused as cf
    err, ratios = {}, []
    for shape in BIAS_ACT_SMALL + [BIAS_ACT_MAIN]:
        x32 = torch.randn(shape, device=dev, generator=gen) * 3
        b32 = torch.randn(shape[-1], device=dev, generator=gen)
        for act in ACTS:
            for dtn, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
                x, b = x32.to(dt), b32.to(dt)
                got = one_launch("bias_act_fwd",
                                 lambda: cf.bias_act_fwd_cuda(x, b, act))
                check_pair(f"bias_act_fwd {shape} {act} {dtn}", dtn, got,
                           tf.bias_act_ref(x, b, act),
                           tf.bias_act_ref(x.float(), b, act), err, ratios)
        info(f"bias_act_fwd {shape}: max |kernel - plain| fp32 "
             f"{err['float32']:.2e}, bf16 {err['bfloat16']:.2e}")
    x = torch.randn(BIAS_ACT_MAIN, device=dev, generator=gen).to(
        torch.bfloat16)
    b = torch.randn(BIAS_ACT_MAIN[-1], device=dev, generator=gen).to(
        torch.bfloat16)
    n = x.numel()
    # add, cube, 2 multiply-adds, tanh (~4), the outer products: ~12
    fused_entry("bias_act_fwd", f"x {list(BIAS_ACT_MAIN)} bf16, gelu", err,
                ratios, lambda: cf.bias_act_fwd_cuda(x, b, "gelu"),
                lambda: tf.bias_act_ref(x, b, "gelu"),
                lambda: tF.gelu(x + b, approximate="tanh"),
                "F.gelu(x + b, approximate='tanh'): 2 calls",
                2 * n * 2 + BIAS_ACT_MAIN[-1] * 4, 12 * n, results)


def fused_dropout_checks(gen, dev, results):
    """The plain add, and training at p 0.1: kernel equal to the plain
    version bit for bit, the keep rate within 5 sigma of 1 - p, kept
    values x * scale, a new seed a new mask."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.ops import fused as tf
    from paddle_tpu_torch.ops.cuda import fused as cf
    err, ratios = {}, []
    p = DROPOUT_P
    for shape in DROPOUT_SMALL + [DROPOUT_MAIN]:
        x32 = torch.randn(shape, device=dev, generator=gen)
        y32 = torch.randn(shape, device=dev, generator=gen)
        seed = torch.randint(0, 2 ** 31 - 1, (1,), device=dev,
                             generator=gen)
        for dtn, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
            x, y = x32.to(dt), y32.to(dt)
            got = one_launch("dropout_add_fwd",
                             lambda: cf.dropout_add_fwd_cuda(x, y, p, False))
            check_pair(f"dropout_add_fwd {shape} p 0 {dtn}", dtn, got,
                       tf.dropout_add_ref(x, y, p, False),
                       tf.dropout_add_ref(x.float(), y.float(), p, False),
                       err, ratios)
            got = one_launch("dropout_add_fwd", lambda: cf.dropout_add_fwd_cuda(
                x, y, p, True, seed))
            plain = tf.dropout_add_ref(x, y, p, True, seed)
            if not torch.equal(got, plain):
                raise SmokeFailure(
                    f"dropout_add_fwd {shape} p {p} {dtn}: kernel differs "
                    f"from its plain version in {int((got != plain).sum())} "
                    f"values (must be bit-equal)")
            if dtn == "float32" and x.numel() > 1000:
                scale = cf.dropout_scale(p)
                kept = got != y
                if not torch.equal(got[kept], x[kept] * scale + y[kept]):
                    raise SmokeFailure(f"dropout_add_fwd {shape}: kept "
                                       f"values are not x * scale + y")
                n = x.numel()
                rate, sd = float(kept.float().mean()), math.sqrt(
                    p * (1 - p) / n)
                if abs(rate - (1 - p)) > 5 * sd:
                    raise SmokeFailure(f"dropout_add_fwd {shape}: keep "
                                       f"rate {rate} vs {1 - p} +- 5 x {sd}")
                other = cf.dropout_add_fwd_cuda(x, y, p, True, seed + 1)
                if torch.equal(other, got):
                    raise SmokeFailure("dropout_add_fwd: a new seed gave "
                                       "the same mask")
                info(f"dropout_add_fwd {shape} p {p}: bit-equal to plain, "
                     f"keep rate {rate:.5f} (1 - p = {1 - p}, sigma "
                     f"{sd:.1e}), a new seed a new mask")
        info(f"dropout_add_fwd {shape}: max |kernel - plain| fp32 "
             f"{err['float32']:.2e}, bf16 {err['bfloat16']:.2e}")
    x = torch.randn(DROPOUT_MAIN, device=dev, generator=gen).to(
        torch.bfloat16)
    y = torch.randn(DROPOUT_MAIN, device=dev, generator=gen).to(
        torch.bfloat16)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), device=dev, generator=gen)
    n = x.numel()
    ms0 = time_ms(lambda: cf.dropout_add_fwd_cuda(x, y, 0.0, False), 50,
                  per_launch=True)[0]
    # scale, select, add: 3 fp32 operations an element (the 24-bit draw
    # and its Threefry rounds are integer work the bound leaves out)
    fused_entry("dropout_add_fwd", f"x, y {list(DROPOUT_MAIN)} bf16, "
                f"training p {p}", err, ratios,
                lambda: cf.dropout_add_fwd_cuda(x, y, p, True, seed),
                lambda: tf.dropout_add_ref(x, y, p, True, seed),
                lambda: tF.dropout(x, p) + y,
                f"F.dropout(x, {p}) + y: 2 calls", 3 * n * 2, 3 * n,
                results, extra={"ms_p0": ms0})


def fused_calls(gen, dev):
    """The public calls of the incubate API once at the main shapes, the
    counts zeroed before and read after: they must be FUSED_CALLS."""
    import torch
    from paddle_tpu_torch import incubate
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops.cuda import layer
    q, k = (torch.randn(ROPE_MAIN, device=dev, generator=gen).to(
        torch.bfloat16).requires_grad_() for _ in range(2))
    xs, ms_ = SOFTMAX_MAIN
    logits = torch.randn(xs, device=dev, generator=gen).to(torch.bfloat16)
    mask = torch.zeros(ms_, device=dev)
    h = torch.randn(BIAS_ACT_MAIN, device=dev, generator=gen).to(
        torch.bfloat16)
    b = torch.zeros(BIAS_ACT_MAIN[-1], device=dev, dtype=torch.bfloat16)
    x, y = (torch.randn(DROPOUT_MAIN, device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(2))
    torch.cuda.synchronize()
    layer.reset_counts()
    oq, ok, _ = IF.fused_rotary_position_embedding(q, k)
    torch.autograd.backward((oq, ok), (torch.ones_like(oq),
                                       torch.ones_like(ok)))
    probs = incubate.softmax_mask_fuse(logits, mask)
    act = IF.fused_bias_act(h, b, "gelu")
    outs = [IF.fused_dropout_add(x, y, p, training=True, generator=gen)
            for p in (0.0, DROPOUT_P)]
    torch.cuda.synchronize()
    counts = layer.launch_counts()
    got = {n: c for n, c in counts.items() if c}
    if got != FUSED_CALLS:
        raise SmokeFailure(f"fused calls: launches {got}, predicted "
                           f"{FUSED_CALLS} (every other kernel 0)")
    for name, t in (("rope q", oq), ("rope dq", q.grad), ("softmax", probs),
                    ("bias_act", act), *[(f"dropout_add {i}", o)
                                         for i, o in enumerate(outs)]):
        if not torch.isfinite(t).all():
            raise SmokeFailure(f"fused calls: {name} is not finite")
    rows = probs.float().sum(-1)
    if not torch.allclose(rows, torch.ones_like(rows), atol=2e-2):
        raise SmokeFailure("fused calls: softmax rows do not sum to 1")
    info(f"fused calls: launches {got} as predicted")
    return counts


def phase_fused(results, dev="cuda"):
    """Kernels 15, 17, 18 and 19 against their plain versions and timed;
    then the public calls once with their launch counts."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for checks in (fused_rope_checks, fused_softmax_checks,
                   fused_bias_act_checks, fused_dropout_checks):
        checks(gen, dev, results)
        torch.cuda.empty_cache()
    return fused_calls(gen, dev)


# -------------------------------------------------------------- encoder
# a BERT-base encoder built from the incubate layers as a user would: 12
# FusedTransformerEncoderLayer(768, 12, 3072, gelu) in an nn.ModuleList,
# bf16, on BASELINE config 3's batch (b 32 x s 128), in three modes
ENC_LAYERS, ENC_D, ENC_HEADS, ENC_FFN, ENC_B, ENC_S = 12, 768, 12, 3072, \
    32, 128
ENC_WARM, ENC_TIMED, ENC_CHECK_LAYERS, ENC_DROPOUT = 2, 10, 2, 0.1
# launches per forward, predicted before the first run: flash once a
# layer without mask and dropout (eval), the FFN's activation once a layer;
# post-LN epilogues through the bias-residual LayerNorm (attention and
# FFN), pre-LN ones through dropout-add; pre-LN's LayerNorms are the jnp
# chain (no layer_norm_fwd); in training the attention takes the dense
# chain (no flash)
ENC_MODES = {
    "post-LN eval": (False, False, {"flash_fwd": ENC_LAYERS,
                                    "bias_act_fwd": ENC_LAYERS,
                                    "bias_residual_ln_fwd": 2 * ENC_LAYERS}),
    "pre-LN eval": (True, False, {"flash_fwd": ENC_LAYERS,
                                  "bias_act_fwd": ENC_LAYERS,
                                  "dropout_add_fwd": 2 * ENC_LAYERS}),
    "pre-LN train": (True, True, {"bias_act_fwd": ENC_LAYERS,
                                  "dropout_add_fwd": 2 * ENC_LAYERS}),
}


def encoder_stack(pre, layers, dev, dtype, seed=SEED):
    """The stack from a CUDA generator seeded ``seed`` (weights, then its
    dropout masks)."""
    import torch
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    stack = torch.nn.ModuleList(
        FusedTransformerEncoderLayer(
            ENC_D, ENC_HEADS, ENC_FFN, dropout_rate=ENC_DROPOUT,
            activation="gelu", normalize_before=pre, generator=gen,
            device=dev) for _ in range(layers))
    return stack.to(dtype), gen


def encoder_forward(stack, x):
    for layer in stack:
        x = layer(x)
    return x


def check_encoder(mode, x, dev="cuda"):
    """A 2-layer stack's output through the kernels against the same
    stack's plain path (rel L2 within STEP_REL_L2, or no further from an
    fp32 plain run on the same bf16 weights than BF16_SLACK x the plain
    bf16 path), the dropout masks drawn alike from one seed."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    pre, train, _ = ENC_MODES[mode]
    stack, gen = encoder_stack(pre, ENC_CHECK_LAYERS, dev, torch.bfloat16)
    stack32, gen32 = encoder_stack(pre, ENC_CHECK_LAYERS, dev,
                                   torch.float32)
    stack32.load_state_dict({k: v.float()
                             for k, v in stack.state_dict().items()})
    stack.train(train)
    stack32.train(train)
    outs = {}
    with torch.no_grad():
        gen.manual_seed(SEED + 1)
        outs["kernels"] = encoder_forward(stack, x)
        layer.reset_counts()
        with plain_path():
            gen.manual_seed(SEED + 1)
            outs["plain"] = encoder_forward(stack, x)
            gen32.manual_seed(SEED + 1)
            outs["fp32"] = encoder_forward(stack32, x.float())
        torch.cuda.synchronize()
    n = {k: c for k, c in layer.launch_counts().items() if c}
    if n:
        raise SmokeFailure(f"encoder {mode}: plain path launched {n}")
    if not torch.isfinite(outs["kernels"]).all():
        raise SmokeFailure(f"encoder {mode}: non-finite output")
    r = rel_l2(outs["kernels"], outs["plain"])
    rk, rp = rel_l2(outs["kernels"], outs["fp32"]), rel_l2(outs["plain"],
                                                           outs["fp32"])
    info(f"encoder {mode} ({ENC_CHECK_LAYERS} layers, bf16): kernels vs "
         f"plain rel L2 {r:.3e} (bound {STEP_REL_L2}); vs fp32 {rk:.3e} "
         f"(kernels) / {rp:.3e} (plain)")
    if r > STEP_REL_L2 and rk > BF16_SLACK * rp:
        raise SmokeFailure(f"encoder {mode}: kernels vs plain rel L2 {r:.3e}"
                           f" > {STEP_REL_L2} and {rk:.3e} > {BF16_SLACK} x "
                           f"{rp:.3e} from fp32")
    return r


def phase_encoder(dev="cuda"):
    """The 12-layer bf16 stack in each mode: ENC_WARM + ENC_TIMED forwards
    under no_grad with the launches exactly as ENC_MODES predicts, finite
    outputs, forward ms, tokens/s, peak memory and a profiled forward's
    device-busy share; then the 2-layer checks."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = torch.randn(ENC_B, ENC_S, ENC_D, device=dev, generator=gen).to(
        torch.bfloat16)
    counts, summary = {}, {}
    stacks = {}
    for mode, (pre, train, per_fwd) in ENC_MODES.items():
        if pre not in stacks:
            stacks[pre] = encoder_stack(pre, ENC_LAYERS, dev,
                                        torch.bfloat16)[0]
        stack = stacks[pre].train(train)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        layer.reset_counts()
        times = []
        with torch.no_grad():
            for i in range(ENC_WARM + ENC_TIMED):
                torch.cuda.synchronize()
                ts = time.perf_counter()
                out = encoder_forward(stack, x)
                torch.cuda.synchronize()
                if i >= ENC_WARM:
                    times.append(time.perf_counter() - ts)
        c = layer.launch_counts()
        n = ENC_WARM + ENC_TIMED
        got = {k: v for k, v in c.items() if v}
        want = {k: v * n for k, v in per_fwd.items()}
        if got != want:
            raise SmokeFailure(f"encoder {mode}: launch counts {got}, "
                               f"predicted {want} (every other kernel 0)")
        if out.shape != x.shape or out.dtype != torch.bfloat16 or \
                not torch.isfinite(out).all():
            raise SmokeFailure(f"encoder {mode}: output {out.dtype} "
                               f"{tuple(out.shape)} not finite bf16 "
                               f"{tuple(x.shape)}")
        mem = torch.cuda.max_memory_allocated()
        fwd_ms = 1e3 * sum(times) / len(times)
        with torch.no_grad():
            wall, busy, by = profile_once(lambda: encoder_forward(stack, x))
        top = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
        info(f"encoder {mode}: {ENC_LAYERS} layers bf16, {ENC_B} x {ENC_S}: "
             f"forward {fwd_ms:.3f} ms (times "
             f"{[round(1e3 * t, 3) for t in times]}), "
             f"{ENC_B * ENC_S / (fwd_ms / 1e3):.0f} tokens/s, peak "
             f"{mem / 2**30:.3f} GiB; launches over {n} forwards {got}")
        info(f"encoder {mode}: profiled forward {wall:.2f} ms wall, device "
             f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%); by kernel "
             f"(ms, launches): " + "; ".join(
                 f"{k.split('(')[0][:50]} {ms:.3f} x{c}"
                 for k, (ms, c) in top))
        counts[f"encoder {mode}"] = c
        summary[mode] = dict(forward_ms=fwd_ms,
                             tokens_per_s=ENC_B * ENC_S / (fwd_ms / 1e3),
                             max_memory_bytes=mem, busy_share=busy / wall,
                             device_busy_ms=busy, profiled_wall_ms=wall,
                             launches_per_forward=per_fwd)
    del stacks
    torch.cuda.empty_cache()
    for mode in ENC_MODES:
        summary[mode]["check_rel_l2"] = check_encoder(mode, x, dev)
    return counts, summary


# ------------------------------------------------ fused multi transformer
# the incubate serving stack at gpt_1p3b's width and depth (E 2048, 16
# heads, D 128, FFN 8192, 24 layers, pre-LN, tanh GELU) in bf16: one
# context call at B 4 x 512 tokens fills the head-major caches [2, B, 16,
# 1024, 128] (flash, kernel 6), then FMT_STEPS decode steps (kernel 3 on
# the caches' head-major views)
FMT_E, FMT_HEADS, FMT_FF, FMT_LAYERS = 2048, 16, 8192, 24
FMT_B, FMT_CTX, FMT_TMAX, FMT_STEPS = 4, 512, 1024, 64
FMT_PER_CALL = {"flash_fwd": FMT_LAYERS, "decode_attention": FMT_LAYERS}
# the checks run 2 layers at the main path's shapes
FMT_CHECK_LAYERS, FMT_CHECK_STEPS = 2, 4
# one MMHA call on a [2, B, 16, 1024, 128] cache, a length-0 row among them
MMHA_LENS = (1000, 37, 0, 517)


class NoPlainAttention(NoPlainPath):
    """While active, the plain attention versions raise."""
    NAMES = (("paddle_tpu_torch.ops.decode_attention", "decode_attention_ref"),
             ("paddle_tpu_torch.ops.flash_attention", "flash_fwd_ref"),
             ("paddle_tpu_torch.nn.functional", "_sdpa_ref"))


def fmt_stack(layers, dev, dtype, seed=SEED):
    import torch
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return FusedMultiTransformer(
        FMT_E, FMT_HEADS, FMT_FF, activation="gelu", normalize_before=True,
        num_layers=layers, generator=gen, device=dev).to(dtype).eval()


def fmt_caches(layers, T, dev, dtype):
    import torch
    return [torch.zeros(2, FMT_B, FMT_HEADS, T, FMT_E // FMT_HEADS,
                        device=dev, dtype=dtype) for _ in range(layers)]


def fmt_run(model, x, S, T, steps, plain=False):
    """Context on x[:, :S] into fresh caches, then ``steps`` decode steps
    on the next tokens: the outputs, context first."""
    import contextlib
    caches = fmt_caches(model.num_layers, T, x.device,
                        next(model.parameters()).dtype)
    with plain_path() if plain else contextlib.nullcontext():
        outs = [model(x[:, :S], caches=caches)[0]]
        for t in range(steps):
            outs.append(model(x[:, S + t:S + t + 1], caches=caches,
                              time_step=S + t)[0])
    return outs


def fmt_checks(dev="cuda"):
    """At 2 layers and the main path's shapes (a B x FMT_CTX context into
    FMT_TMAX-row caches): the kernel path against the plain path on the
    card (context output and FMT_CHECK_STEPS decode steps; bf16 within
    2e-2 or
    no further from an fp32 plain run than BF16_SLACK x the plain path),
    and in fp32 through the kernels each decode step against the context
    forward over the same tokens (1e-4)."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    S, T, n = FMT_CTX, FMT_TMAX, FMT_CHECK_STEPS
    m = fmt_stack(FMT_CHECK_LAYERS, dev, torch.bfloat16)
    m32 = fmt_stack(FMT_CHECK_LAYERS, dev, torch.float32)
    m32.load_state_dict({k: v.float() for k, v in m.state_dict().items()})
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    x = torch.randn(FMT_B, S + n, FMT_E, device=dev, generator=gen)
    xb = x.to(torch.bfloat16)
    kern = fmt_run(m, xb, S, T, n)
    layer.reset_counts()
    plain = fmt_run(m, xb, S, T, n, plain=True)
    truth = fmt_run(m32, xb.float(), S, T, n, plain=True)
    torch.cuda.synchronize()
    got = {k: c for k, c in layer.launch_counts().items() if c}
    if got:
        raise SmokeFailure(f"fused multi transformer: plain path launched "
                           f"{got}")
    ratios, errs = [], {}
    for i, (a, b, c) in enumerate(zip(kern, plain, truth)):
        what = "context" if i == 0 else f"decode step {i}"
        errs[what] = check_layer_out(
            f"fused multi transformer x {FMT_CHECK_LAYERS} bf16 {what}", a, b,
            c, TOL["bfloat16"], ratios)
    steps = fmt_run(m32, x, S, T, n)
    full = fmt_run(m32, x, S + n, T, 0)[0]
    cons = 0.0
    for t in range(n):
        cons = max(cons, check_close(
            f"fused multi transformer x {FMT_CHECK_LAYERS} fp32 decode step "
            f"{t + 1} vs context", steps[1 + t][:, 0], full[:, S + t],
            TOL["float32"]))
    info(f"fused multi transformer checks: bf16 kernels vs plain max |err| "
         f"{errs}, fp32 ratio max {max(ratios):.3f}; fp32 decode vs context "
         f"max |err| {cons:.2e}")
    return dict(max_abs_err=errs, bf16_vs_fp32_ratio=max(ratios),
                decode_vs_context_fp32=cons)


def mmha_check(dev="cuda"):
    """One ``masked_multihead_attention`` call on a bf16 [2, FMT_B, 16,
    FMT_TMAX, 128] cache with lengths MMHA_LENS: exactly one
    decode_attention launch and no other kernel, the caller's cache
    written in place and returned, output and cache against the same
    call on the CPU (the plain version) within 2e-2."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import \
        masked_multihead_attention
    from paddle_tpu_torch.ops.cuda import layer
    D = FMT_E // FMT_HEADS
    gen = torch.Generator()
    gen.manual_seed(SEED + 3)
    x, bias = (torch.randn(shape, generator=gen).to(torch.bfloat16)
               for shape in ((FMT_B, 3 * FMT_E), (3 * FMT_E,)))
    cache = torch.randn(2, FMT_B, FMT_HEADS, FMT_TMAX, D,
                        generator=gen).to(torch.bfloat16)
    lens = torch.tensor(MMHA_LENS, dtype=torch.int32)
    given = cache.to(dev)
    want, want_cache = masked_multihead_attention(
        x, cache, bias=bias, sequence_lengths=lens)
    layer.reset_counts()
    out, back = masked_multihead_attention(
        x.to(dev), given, bias=bias.to(dev), sequence_lengths=lens.to(dev))
    torch.cuda.synchronize()
    got = {k: c for k, c in layer.launch_counts().items() if c}
    if got != {"decode_attention": 1}:
        raise SmokeFailure(f"masked_multihead_attention: launches {got}, "
                           f"predicted one decode_attention")
    if back is not given:
        raise SmokeFailure("masked_multihead_attention: the returned cache "
                           "is not the caller's tensor")
    err = check_close("masked_multihead_attention bf16 out", out.cpu(), want,
                      TOL["bfloat16"])
    cerr = check_close("masked_multihead_attention bf16 cache", given.cpu(),
                       want_cache, TOL["bfloat16"])
    info(f"masked_multihead_attention B {FMT_B}, {FMT_HEADS} heads, D {D}, "
         f"T {FMT_TMAX}, lengths {MMHA_LENS}: one decode_attention launch on "
         f"the caller's cache; max |cuda - cpu| out {err:.2e}, cache "
         f"{cerr:.2e}")
    return dict(max_abs_err=err, cache_max_abs_err=cerr)


def fmt_step_bound_ms(model, rows):
    """A decode step's least time: every weight read once and each
    layer's K / V at ``rows`` rows (bf16), against 2 operations a weight
    a token."""
    n = sum(p.numel() for p in model.parameters())
    wb = 2 * n
    kv = FMT_LAYERS * 2 * FMT_B * FMT_HEADS * rows * (FMT_E // FMT_HEADS) * 2
    return bound_ms(wb + kv, 2 * n * FMT_B)[0], wb, kv


def phase_fmt(dev="cuda"):
    """The 24-layer bf16 stack: a warm context call and 2 decode steps,
    then with the counts zeroed the main path (one context call, FMT_STEPS
    decode steps) with the plain attention versions refused, the launches
    exactly FMT_PER_CALL a call, finite outputs; context ms, decode step
    ms (wall), tokens/s; one profiled step's wall and busy ms and kernel
    3's per-call ms against its bound; then the 2-layer checks and one
    MMHA call."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    model = fmt_stack(FMT_LAYERS, dev, torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    x = torch.randn(FMT_B, FMT_CTX, FMT_E, device=dev, generator=gen).to(
        torch.bfloat16)
    xs = torch.randn(FMT_STEPS + 1, FMT_B, 1, FMT_E, device=dev,
                     generator=gen).to(torch.bfloat16)
    caches = fmt_caches(FMT_LAYERS, FMT_TMAX, dev, torch.bfloat16)
    model(x, caches=caches)
    for t in range(2):
        model(xs[t], caches=caches, time_step=FMT_CTX + t)
    torch.cuda.synchronize()
    caches = fmt_caches(FMT_LAYERS, FMT_TMAX, dev, torch.bfloat16)
    given = list(caches)
    steps = []
    layer.reset_counts()
    with NoPlainAttention():
        ts = time.perf_counter()
        y, back = model(x, caches=caches)
        torch.cuda.synchronize()
        ctx_ms = 1e3 * (time.perf_counter() - ts)
        for t in range(FMT_STEPS):
            ts = time.perf_counter()
            out, back = model(xs[t], caches=caches, time_step=FMT_CTX + t)
            torch.cuda.synchronize()
            steps.append(1e3 * (time.perf_counter() - ts))
    counts = layer.launch_counts()
    got = {k: c for k, c in counts.items() if c}
    want = {"flash_fwd": FMT_LAYERS,
            "decode_attention": FMT_LAYERS * FMT_STEPS}
    if got != want:
        raise SmokeFailure(f"fused multi transformer: launches {got}, "
                           f"predicted {want} (every other kernel 0)")
    if not all(a is b for a, b in zip(back, given)):
        raise SmokeFailure("fused multi transformer: the returned caches are "
                           "not the caller's tensors")
    for name, t, shape in (("context", y, x.shape), ("decode", out,
                                                     xs[0].shape)):
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.bfloat16 or \
                not torch.isfinite(t).all():
            raise SmokeFailure(f"fused multi transformer {name}: output "
                               f"{t.dtype} {tuple(t.shape)} not finite bf16 "
                               f"{tuple(shape)}")
    rows = FMT_CTX + FMT_STEPS
    _, ctx_busy, ctx_by = profile_once(lambda: model(x, caches=caches))
    fk = [(ms, c) for k, (ms, c) in ctx_by.items() if "flash_fwd" in k]
    if not fk or sum(c for _, c in fk) != FMT_LAYERS:
        raise SmokeFailure(f"fused multi transformer: the profiled context "
                           f"call recorded flash {fk}")
    flash_ms = sum(ms for ms, _ in fk) / FMT_LAYERS
    flash_bound = bound_ms(*flash_bytes_ops(
        FMT_B, FMT_CTX, FMT_CTX, FMT_HEADS, FMT_HEADS, FMT_E // FMT_HEADS,
        True, 2)["flash_fwd"])
    wall, busy, by = profile_once(lambda: model(
        xs[FMT_STEPS], caches=caches, time_step=rows))
    groups = {}
    for k, (ms, c) in by.items():
        g = ("decode_attention" if "decode_attention" in k else
             "cuBLAS" if "gemm" in k.lower() or "nvjet" in k else
             "other torch kernels")
        groups[g] = [a + b for a, b in zip(groups.get(g, [0.0, 0]),
                                           (ms, c))]
    dk = [(ms, c) for k, (ms, c) in by.items() if "decode_attention" in k]
    if not dk or sum(c for _, c in dk) != FMT_LAYERS:
        raise SmokeFailure(f"fused multi transformer: the profiled step "
                           f"recorded decode attention {dk}")
    dattn_ms = sum(ms for ms, _ in dk) / FMT_LAYERS
    dattn_bound = bound_ms(*dattn_bytes_ops(
        FMT_B, FMT_HEADS, FMT_HEADS, FMT_E // FMT_HEADS, [rows + 1] * FMT_B,
        2))[0]
    step_bound, wb, kvb = fmt_step_bound_ms(model, rows)
    step_ms = sum(steps) / len(steps)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
    summary = dict(
        context_ms=ctx_ms, context_tokens_per_s=FMT_B * FMT_CTX / ctx_ms * 1e3,
        decode_step_ms=step_ms, decode_step_ms_all=steps,
        tokens_per_s=FMT_B / step_ms * 1e3, step_bound_ms=step_bound,
        weight_bytes=wb, kv_bytes_at_last_step=kvb,
        profiled_step_wall_ms=wall, profiled_step_busy_ms=busy,
        busy_share_of_step=busy / step_ms,
        device_launches_per_step=sum(c for _, c in by.values()),
        step_busy_by_group=groups,
        decode_attention_ms=dattn_ms, decode_attention_bound_ms=dattn_bound,
        context_busy_ms=ctx_busy, flash_fwd_ms=flash_ms,
        flash_fwd_bound_ms=flash_bound[0], flash_fwd_bound_by=flash_bound[1],
        launches=want)
    info(f"fused multi transformer {FMT_LAYERS} layers E {FMT_E} bf16, B "
         f"{FMT_B}: context {FMT_CTX} tokens {ctx_ms:.2f} ms; decode step "
         f"{step_ms:.3f} ms wall (min {min(steps):.3f}, max {max(steps):.3f}),"
         f" {summary['tokens_per_s']:.0f} tokens/s, bound {step_bound:.4f} "
         f"ms ({wb / 1e9:.3f} GB weights + {kvb / 1e9:.3f} GB K/V); profiled "
         f"step {wall:.2f} ms wall, {busy:.3f} ms busy "
         f"({100 * busy / step_ms:.1f} % of the unprofiled step), "
         f"{summary['device_launches_per_step']} device launches, by group "
         f"(ms, launches) {groups}; decode_attention {dattn_ms:.5f} ms a "
         f"call against {dattn_bound:.5f} bound; context busy "
         f"{ctx_busy:.3f} ms, flash_fwd {flash_ms:.5f} ms a call against "
         f"{flash_bound[0]:.5f} bound ({flash_bound[1]}); launches {got}; "
         f"by kernel (ms, launches): " + "; ".join(
             f"{k.split('(')[0][:50]} {ms:.3f} x{c}" for k, (ms, c) in top))
    del model, caches, given, back
    torch.cuda.empty_cache()
    summary["checks"] = fmt_checks(dev)
    summary["mmha_check"] = mmha_check(dev)
    return counts, summary


# ------------------------------------------------------------ BERT fine-tune
# BASELINE config 3 as the JAX bench runs it (bench.py:1253-1265):
# BertForSequenceClassification(bert_base(), 2) on b 32 x s 128, fp32,
# dropout 0.1, no pad mask, AdamW(1e-3, weight_decay=0); then in bf16, and
# the two paths that reach flash: a fine-tune with both dropouts 0, and an
# eval forward without a pad mask (a padded eval takes the dense chain).
# Launches a step / forward, predicted before the first run: attention
# takes flash only without a mask and without dropout (the JAX routing
# rule of nn.functional.scaled_dot_product_attention), once a layer each
# way; the LayerNorms are the jnp chain, the loss the dense cross-entropy
BERT_B, BERT_S, BERT_LAYERS, BERT_LR = 32, 128, 12, 1e-3
BERT_WARM, BERT_STEPS, BERT_FORWARDS, BERT_PAD = 2, 5, 10, 32
BERT_CHECK_LAYERS, BERT_CPU_TOL = 2, 1e-4
# the falling-loss check's rate: BERT's fine-tuning rate (2e-5, Devlin et
# al.); at the bench's 1e-3, and at 1e-4, Adam's first step moves each of
# the weights by about the rate and the loss rises first
BERT_CHECK_LR = 2e-5
BERT_FLASH = {"flash_fwd": BERT_LAYERS, "flash_bwd_dq": BERT_LAYERS,
              "flash_bwd_dkv": BERT_LAYERS}
# mode: (dtype, dropout, pad mask, training, launches a step / forward)
BERT_MODES = {
    "finetune": ("float32", 0.1, False, True, {}),
    "finetune bf16": ("bfloat16", 0.1, False, True, {}),
    "finetune no-dropout": ("bfloat16", 0.0, False, True, BERT_FLASH),
    "eval": ("bfloat16", 0.0, False, False, {"flash_fwd": BERT_LAYERS}),
    "eval masked": ("bfloat16", 0.0, True, False, {}),
}


def bert_model(layers, dropout, dtype, dev):
    """A seeded ``BertForSequenceClassification`` at ``bert_base`` width
    (``layers`` deep, both dropouts ``dropout``) cast to ``dtype`` (fp32
    when None); on the CPU its generator is a CPU one seeded alike, so
    load the card model's ``state_dict`` into it."""
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base(num_layers=layers, hidden_dropout_prob=dropout,
                         attention_probs_dropout_prob=dropout)
    net = bert.BertForSequenceClassification(
        cfg, 2, generator=make_generator(SEED, dev), device=dev)
    return net if dtype is None else net.to(dtype)


def bert_batch(dev):
    """ids, token types and labels from numpy seed 0, and the pad mask (the
    last BERT_PAD tokens of every other row padded)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, 30522, (BERT_B, BERT_S))
    types = rng.integers(0, 2, (BERT_B, BERT_S))
    labels = rng.integers(0, 2, (BERT_B,))
    mask = np.ones((BERT_B, BERT_S), np.int64)
    mask[::2, -BERT_PAD:] = 0
    return {k: torch.from_numpy(v).to(dev) for k, v in (
        ("ids", ids), ("types", types), ("labels", labels), ("mask", mask))}


def bert_bound_ms(net, dtype, train):
    """Least time of a step (``train``) or forward: the products (the
    layers' q / k / v / out and FFN weights over b·s tokens, QKᵀ and PV,
    pooler and classifier; 2 operations a multiply-add, the backward twice
    the forward) at the dtype's peak or the weights' bytes at the HBM
    rate, whichever is longer; a step adds AdamW's traffic (params and
    grads read, params written in their dtype; fp32 moments read and
    written) at the HBM rate."""
    import torch
    cfg = net.bert.cfg
    H, F, L, T = (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
                  BERT_B * BERT_S)
    fwd = (2 * T * L * (4 * H * H + 2 * H * F)
           + 4 * L * BERT_B * BERT_S * BERT_S * H
           + 2 * BERT_B * (H * H + 2 * H))
    n = sum(p.numel() for p in net.parameters())
    item = torch.finfo(getattr(torch, dtype)).bits // 8
    ms, by = bound_ms(n * item, 3 * fwd if train else fwd, dtype)
    if train:
        ms += 1e3 * n * (3 * item + 16) / HBM_BYTES_PER_S
    return ms, by


def bert_leaves(grads):
    """``{name: flat gradient}`` with each key bias folded into its
    weight's leaf: its gradient is zero but for rounding (softmax ignores a
    shift shared by all keys), so alone no relative distance holds it."""
    import torch
    out = {k: g.reshape(-1) for k, g in grads.items()}
    for k in [k for k in out if k.endswith("k_proj.bias")]:
        w = k.replace(".bias", ".weight")
        out[w] = torch.cat([out[w], out.pop(k)])
    return out


def bert_loss_and_grads(net, b, masked=False):
    """One step's loss and its gradients (:func:`bert_leaves`), the
    parameters' grads cleared after."""
    loss = net(b["ids"], b["types"], b["mask"] if masked else None,
               labels=b["labels"])
    loss.backward()
    grads = bert_leaves({k: p.grad for k, p in net.named_parameters()})
    net.zero_grad(set_to_none=True)
    return loss.detach(), grads


def bert_mode(mode, b, dev):
    """The 12-layer model in ``mode``: BERT_WARM + BERT_STEPS dygraph
    steps (``loss = net(...); loss.backward(); opt.step();
    opt.clear_grad()``) or BERT_WARM + BERT_FORWARDS no-grad forwards, the
    launches exactly as BERT_MODES predicts, finite results; step ms,
    tokens/s, peak memory, the bound, and one profiled call's device-busy
    share and device time by group."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    from paddle_tpu_torch.optimizer import AdamW
    dtn, dropout, masked, train, per = BERT_MODES[mode]
    t0 = time.perf_counter()
    net = bert_model(BERT_LAYERS, dropout, getattr(torch, dtn)
                     if dtn != "float32" else None, dev).train(train)
    bound, bound_by = bert_bound_ms(net, dtn, train)
    m = b["mask"] if masked else None
    if train:
        opt = AdamW(learning_rate=BERT_LR, weight_decay=0.0,
                    parameters=net.named_parameters())

        def call():
            loss = net(b["ids"], b["types"], m, labels=b["labels"])
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()
    else:
        def call():
            with torch.no_grad():
                return net(b["ids"], b["types"], m)
    torch.cuda.synchronize()
    info(f"bert {mode}: bert_base x {BERT_LAYERS} layers, {dtn}, dropout "
         f"{dropout if train else '-'}, pad mask {masked}, "
         f"{sum(p.numel() for p in net.parameters())} params, built in "
         f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    layer.reset_counts()
    n = BERT_WARM + (BERT_STEPS if train else BERT_FORWARDS)
    times, losses = [], []
    for i in range(n):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        if i >= BERT_WARM:
            times.append(time.perf_counter() - ts)
        if train:
            losses.append(float(out))
    counts = layer.launch_counts()
    got = {k: c for k, c in counts.items() if c}
    want = {k: c * n for k, c in per.items()}
    if got != want:
        raise SmokeFailure(f"bert {mode}: launch counts {got}, predicted "
                           f"{want} (every other kernel 0)")
    if train and not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"bert {mode}: losses {losses} not finite")
    if not train and (out.shape != (BERT_B, 2) or out.dtype != net.classifier
                      .weight.dtype or not torch.isfinite(out).all()):
        raise SmokeFailure(f"bert {mode}: logits {out.dtype} "
                           f"{tuple(out.shape)} not finite [{BERT_B}, 2]")
    mem = torch.cuda.max_memory_allocated()
    ms = 1e3 * sum(times) / len(times)
    tok_s = BERT_B * BERT_S / (ms / 1e3)
    wall, busy, by = profile_once(call)
    groups = device_groups(by)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
    what = "step" if train else "forward"
    info(f"bert {mode}: {what} {ms:.3f} ms (times "
         f"{[round(1e3 * t, 3) for t in times]}), {tok_s:.0f} tokens/s, "
         f"bound {bound:.3f} ms ({bound_by}; {100 * bound / ms:.1f} %), peak "
         f"{mem / 2**30:.3f} GiB; losses {[round(x, 5) for x in losses]}; "
         f"launches over {n} {what}s {got}")
    info(f"bert {mode}: profiled {what} {wall:.2f} ms wall, device busy "
         f"{busy:.3f} ms ({100 * busy / wall:.1f}%, "
         f"{100 * busy / ms:.1f}% of the unprofiled {what}); by group (ms): "
         + "; ".join(f"{g} {v:.3f}" for g, v in sorted(
             groups.items(), key=lambda kv: -kv[1]))
         + "; top kernels (ms, launches): " + "; ".join(
             f"{k.split('(')[0][:50]} {v:.3f} x{c}" for k, (v, c) in top))
    del net, call
    if train:
        del opt
    torch.cuda.empty_cache()
    return counts, {f"{what}_ms": ms, "tokens_per_s": tok_s,
                    "bound_ms": bound, "bound_by": bound_by,
                    "max_memory_bytes": mem, "busy_share": busy / wall,
                    "busy_share_of_step": busy / ms, "device_busy_ms": busy,
                    "profiled_wall_ms": wall, "device_ms_by_group": groups,
                    "losses": losses, f"launches_per_{what}": per}


def bert_check_flash(b, dev):
    """The no-dropout fine-tune at 2 layers, bf16: one step through the
    flash kernels against the plain path (loss within EAGER_LOSS_TOL
    relative, each gradient within STEP_REL_L2 or no further from an fp32
    run than BF16_SLACK x the plain path), with no launch on the plain
    path."""
    import torch
    from paddle_tpu_torch.ops.cuda import layer
    net = bert_model(BERT_CHECK_LAYERS, 0.0, torch.bfloat16, dev)
    layer.reset_counts()
    runs = {"kernels": bert_loss_and_grads(net, b)}
    torch.cuda.synchronize()
    n = {k: c for k, c in layer.launch_counts().items() if c}
    if n != {k: BERT_CHECK_LAYERS for k in BERT_FLASH}:
        raise SmokeFailure(f"bert check: the kernel step launched {n}")
    layer.reset_counts()
    with plain_path():
        runs["plain"] = bert_loss_and_grads(net, b)
        truth = bert_loss_and_grads(
            bert_model(BERT_CHECK_LAYERS, 0.0, None, dev), b)
    torch.cuda.synchronize()
    n = {k: c for k, c in layer.launch_counts().items() if c}
    if n:
        raise SmokeFailure(f"bert check: the plain path launched {n}")
    check_steps(f"bert finetune no-dropout ({BERT_CHECK_LAYERS} layers, "
                f"bf16, {BERT_B} x {BERT_S})", runs, truth,
                (("kernels vs plain path", "kernels", "plain",
                  EAGER_LOSS_TOL),))
    return {"loss_rel": rel_l2(runs["kernels"][0], runs["plain"][0])}


def bert_cpu_model(net):
    """The card model's weights (and dtype) in a CPU model."""
    import torch
    cfg = net.bert.cfg
    cpu = bert_model(cfg.num_layers, cfg.hidden_dropout_prob, None, "cpu")
    cpu.load_state_dict({k: v.float() for k, v in net.state_dict().items()})
    dt = net.classifier.weight.dtype
    return cpu if dt == torch.float32 else cpu.to(dt)


def bert_check_cpu(b, dev):
    """The fp32 fine-tune at 2 layers with dropout 0, on the card against
    the same step on the CPU (same weights and batch): without the pad
    mask (the flash kernels on the card) and with it (the dense chain),
    the loss within BERT_CPU_TOL relative and every gradient within
    BERT_CPU_TOL relative L2; then 5 AdamW steps on the card at
    BERT_CHECK_LR, the loss falling."""
    import torch
    from paddle_tpu_torch.optimizer import AdamW
    net = bert_model(BERT_CHECK_LAYERS, 0.0, None, dev)
    cpu, bc = bert_cpu_model(net), {k: v.cpu() for k, v in b.items()}
    worst = {}
    for masked in (False, True):
        (lc, gc), (lp, gp) = (bert_loss_and_grads(net, b, masked),
                              bert_loss_and_grads(cpu, bc, masked))
        rows = [("loss", lc.cpu(), lp)] + [(k, gc[k].cpu(), g)
                                           for k, g in gp.items()]
        tag = "pad mask" if masked else "no mask"
        worst[tag] = max(rel_l2(x, y) for _, x, y in rows)
        for name, x, y in rows:
            if not torch.isfinite(x).all() or rel_l2(x, y) > BERT_CPU_TOL:
                raise SmokeFailure(
                    f"bert fp32 card vs CPU ({tag}) {name}: rel L2 "
                    f"{rel_l2(x, y):.3e} > {BERT_CPU_TOL}")
        info(f"bert fp32 ({BERT_CHECK_LAYERS} layers, dropout 0, {tag}) card "
             f"vs CPU: loss {float(lc):.6f} / {float(lp):.6f}, worst rel L2 "
             f"over the loss and {len(gp)} gradient leaves "
             f"{worst[tag]:.3e} (bound {BERT_CPU_TOL})")
    opt = AdamW(learning_rate=BERT_CHECK_LR, weight_decay=0.0,
                parameters=net.named_parameters())
    losses = []
    for _ in range(5):
        loss = net(b["ids"], b["types"], labels=b["labels"])
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise SmokeFailure(f"bert fp32 5 steps: losses {losses} not finite "
                           f"and falling")
    info(f"bert fp32 ({BERT_CHECK_LAYERS} layers) 5 AdamW({BERT_CHECK_LR}) "
         f"steps on the card: losses {[round(x, 5) for x in losses]}")
    return {"worst_rel_l2": worst, "losses": losses}


def bert_check_eval_masked(b, dev):
    """The padded eval at 2 layers, bf16: the card's sequence output and
    logits against the CPU's (the bf16 rule against an fp32 CPU run on the
    same weights), and other ids under the pad leave the unpadded
    positions' outputs within 1e-5 (``tests/test_models.py:94-110``)."""
    import torch
    net = bert_model(BERT_CHECK_LAYERS, 0.0, torch.bfloat16, dev).eval()
    cpu = bert_cpu_model(net).eval()
    cpu32 = bert_cpu_model(net).float().eval()
    bc = {k: v.cpu() for k, v in b.items()}

    def seq_logits(m, x):
        seq, pooled = m.bert(x["ids"], x["types"], x["mask"])
        return seq, m.classifier(pooled)
    with torch.no_grad():
        got, logits = seq_logits(net, b)
        ref, ref32 = seq_logits(cpu, bc), seq_logits(cpu32, bc)
        outs = {"seq": (got.cpu(), ref[0], ref32[0]),
                "logits": (logits.cpu(), ref[1], ref32[1])}
        ids2 = b["ids"].clone()
        ids2[::2, -BERT_PAD:] = 1
        got2 = net.bert(ids2, b["types"], b["mask"])[0]
    err = {k: check_layer_out(f"bert eval masked ({BERT_CHECK_LAYERS} "
                              f"layers, bf16) {k}: card vs CPU", *v,
                              TOL["bfloat16"]) for k, v in outs.items()}
    keep = b["mask"].bool()
    pad = float((got - got2)[keep].abs().max())
    if pad > 1e-5:
        raise SmokeFailure(f"bert eval masked: other ids under the pad moved "
                           f"unpadded outputs by {pad:.3e} > 1e-5")
    info(f"bert eval masked: other ids under the pad move the unpadded "
         f"outputs by {pad:.3e} (bound 1e-5)")
    return {"max_abs_err": err, "padding_moves": pad}


def phase_bert(dev="cuda"):
    """BERT-base in each of BERT_MODES, then the 2-layer checks."""
    import torch
    b = bert_batch(dev)
    counts, summary = {}, {}
    for mode in BERT_MODES:
        counts[f"bert {mode}"], summary[mode] = bert_mode(mode, b, dev)
    summary["check_flash"] = bert_check_flash(b, dev)
    torch.cuda.empty_cache()
    summary["check_cpu"] = bert_check_cpu(b, dev)
    summary["check_eval_masked"] = bert_check_eval_masked(b, dev)
    torch.cuda.empty_cache()
    return counts, summary


def main():
    try:
        import torch
    except ImportError:
        info("FAILED: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        info("FAILED: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    try:
        from paddle_tpu_torch.models.llama import llama_7b
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_device()
        phase_build()
        cfg = llama_7b(dtype="bfloat16")
        kernels = []
        phase_kernels(cfg, kernels)
        torch.cuda.empty_cache()
        counts, engine = phase_engine(cfg)
        torch.cuda.empty_cache()
        qcounts, engine_q, qfcounts = phase_engine_quant(cfg, engine)
        torch.cuda.empty_cache()
        fcounts, features = phase_engine_features(cfg)
        torch.cuda.empty_cache()
        scounts, spec = phase_engine_spec(cfg)
        torch.cuda.empty_cache()
        gcounts, graphs = phase_engine_graphs(cfg)
        del cfg
        torch.cuda.empty_cache()
        gpt_serve_counts, gpt_serve = phase_gpt_serve(kernels)
        torch.cuda.empty_cache()
        gpt_quant_counts, gpt_quant = phase_gpt_serve_quant(kernels,
                                                            gpt_serve)
        torch.cuda.empty_cache()
        phase_flash(kernels)
        torch.cuda.empty_cache()
        phase_linear_ce(kernels)
        torch.cuda.empty_cache()
        train_counts, train = phase_train()
        gpt_counts, gpt = phase_gpt_train()
        torch.cuda.empty_cache()
        phase_decode_attn(kernels)
        torch.cuda.empty_cache()
        phase_quant_linear(kernels)
        torch.cuda.empty_cache()
        gen_counts, gen = phase_generate()
        torch.cuda.empty_cache()
        phase_norms(kernels)
        torch.cuda.empty_cache()
        eager_counts, eager = phase_eager()
        torch.cuda.empty_cache()
        fused_counts = phase_fused(kernels)
        torch.cuda.empty_cache()
        enc_counts, enc = phase_encoder()
        torch.cuda.empty_cache()
        fmt_counts, fmt = phase_fmt()
        torch.cuda.empty_cache()
        bert_counts, bert = phase_bert()
    except (SmokeFailure, ImportError, RuntimeError, ValueError) as e:
        info(f"FAILED: {type(e).__name__}: {e}")
        return 1
    # each kernel's launches over the main-path runs of the phases that
    # drive it (the engine, the train steps, the rollouts, the eager steps)
    by_phase = {"engine": counts, "engine quant": qcounts,
                "engine quant features": qfcounts,
                "engine features": fcounts, "engine spec": scounts,
                "engine graphs": gcounts,
                "gpt serve": gpt_serve_counts,
                "gpt serve quant": gpt_quant_counts,
                "train": train_counts, "gpt": gpt_counts,
                **{f"generate {tag}": c for tag, c in gen_counts.items()},
                **eager_counts, "fused calls": fused_counts, **enc_counts,
                "fused multi transformer": fmt_counts, **bert_counts}
    # and the per-step launches each step phase was checked against
    per_step = {"train": {**FLASH_PER_STEP, **LCE_PER_STEP},
                "gpt": GPT_PER_STEP, "eager gpt": EAGER_GPT_PER_STEP,
                "eager llama": EAGER_LLAMA_PER_STEP,
                "fused calls": FUSED_CALLS,
                **{f"encoder {m}": v[2] for m, v in ENC_MODES.items()},
                "fused multi transformer": FMT_PER_CALL,
                **{f"bert {m}": v[4] for m, v in BERT_MODES.items()}}
    for k in kernels:
        by = {ph: c[k["name"]] for ph, c in by_phase.items()
              if c.get(k["name"])}
        k["launches"], k["launches_by_phase"] = sum(by.values()), by
        k["launches_per_step_by_phase"] = {
            ph: t[k["name"]] for ph, t in per_step.items() if k["name"] in t}
    info(f"engine summary {json.dumps(engine)}")
    info(f"engine quant summary {json.dumps(engine_q)}")
    info(f"engine features summary {json.dumps(features)}")
    info(f"engine spec summary {json.dumps(spec)}")
    info(f"engine graphs summary {json.dumps(graphs)}")
    info(f"gpt serve summary {json.dumps(gpt_serve)}")
    info(f"gpt serve quant summary {json.dumps(gpt_quant)}")
    info(f"train summary {json.dumps(train)}")
    info(f"gpt summary {json.dumps(gpt)}")
    info(f"generate summary {json.dumps(gen)}")
    info(f"eager summary {json.dumps(eager)}")
    info(f"encoder summary {json.dumps(enc)}")
    info(f"fused multi transformer summary {json.dumps(fmt)}")
    info(f"bert summary {json.dumps(bert)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--warm-child"]:
        sys.exit(warm_child(*sys.argv[2:4]))
    sys.exit(main())
