#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its main path on a GPU.

    python3 chip_smoke.py [--memory-history]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit (`nvcc`); exits non-zero, printing no result, without them.
It imports nothing of JAX or of the JAX package. Phases, one line each,
any failure exits non-zero:

1. card    — name and power limit as nvidia-smi reports them;
2. kernels — build every CUDA kernel of the paths from `symbiont_tpu_torch/
             ops/csrc`, run each on the card at the paths' shapes and hold
             it against its plain PyTorch version: the flash-attention
             forward (B1), and the backward's dK/dV/dbias (B2) and dQ (B3)
             kernels fed B1's own lse, length-0 rows and partial tiles
             included (each bf16 B1/B2/B3 instance must report no spills
             from ptxas and contain HGMMA, i.e. wgmma, in its SASS); time each
             kernel, its plain version and the PyTorch library call for
             the same function (SDPA forward, SDPA backward as forward +
             backward less forward; timed as yardsticks only, never used
             by the port), beside the card's bound for the work; show that
             under autograd the forward goes through the port's Function;
3. serve   — a full-width TorchEngine (768 wide, 12 layers, bf16,
             attn_impl="flash", synthetic cross-encoder) embeds ~2,000
             texts over every length bucket; checks the flash kernel ran
             once per layer per batch, and one batch against the same
             engine with plain attention;
4. search  — the embeddings go into the port's VectorStore; fused queries
             must return the hits of search(embed_query(q)); the top hits
             are reranked;
5. train   — the encoder fine-tune at the same width: contrastive_train_step
             on 32 (query, passage) pairs made by the port's tokenizer and
             bucketing (queries at 64 tokens, passages at 256), several
             steps on one batch, then one step of 16 pairs at 512; each
             step must launch B1, B2 and B3 twice per layer, the loss must
             stay finite and fall; one step's gradients with flash must
             match plain attention (cosine >= 0.99); steps/s, tokens/s and
             each kernel's share of a step's device time; the trained
             masters then serve embeddings through a TorchEngine;
6. checkpoint — the default multilingual mpnet geometry and a MiniLM +
             ms-marco pair written from the seed in the hub's layout and
             served through `model_dir` / `cross_model_dir` with flash;
7. obs     — the device-memory ledger reconciled on the card, the padding
             counters, the dispatch ledger, one forced OOM under guard_oom;
8. memory, quant — what the allocator holds with no engine alive (by
             allocation site with --memory-history), then the mpnet dir at
             every `quantize` mode against "none": bytes, cosines, device
             time and its largest kernels, and the int8/fp8 codes made on
             the card bit for bit against the CPU's;
9. generate — B1 at the LM prefill's causal GQA shapes against its plain
             version on the real query rows (timed beside SDPA and the
             bound); then TinyLlama-1.1B and GPT-2 124M written from the
             seed in the hub's layout and served by LmEngine through
             `model_dir` (bf16, flash prefill): exact parameter bytes,
             greedy and sampled generate_batch per prompt bucket with B1
             launched once per layer per prefill and never by a decode
             step, seeded sampling that repeats, flash vs plain prefill at
             cosine > 0.995 per row; TTFT, decode tok/s at batch 8 and 64
             and the device's busy share printed with no bar;
10. session — streaming and continuous batching on the same two dirs:
             `generate_stream` joins to `generate()`'s text with B1 only in
             its prefill; `GenBatcher` serves 24 requests in three waves,
             some joining a running session; a newcomer prefilled on a
             second thread while `step()` runs is spliced with its own
             prefill's logits bit for bit; the KV claim and gauges, a
             cancel and the timeline; GPT-2 at float32 session rows
             token-identical to their standalone decodes (or a reported
             near-tie); B1 held against its plain version at this path's
             prefill shapes; tok/s, TTFT, TPOT and the busy share printed;
11. paged  — TinyLlama with `kv_layout="paged"` (pages of 16, radix on,
             the pool sized automatically, its bytes checked exactly):
             paged session rows with an admission and a cancel equal the
             dense session's, B1 once per layer per cold start and
             admission, 0 per chunk and 0 for a start of full radix hits,
             a shared 128-token prefix hit; GPT-2 float32 paged rows equal
             dense ones (kv_quant none and int8); `GenBatcher` on the pool;
             every page free again; pages and chunk ms against dense,
             the batcher's readings beside [session]'s, printed;
12. spec   — speculative decoding on TinyLlama (float32 for the identity
             checks): self-drafted streams and sessions (dense, paged) give
             spec-off's tokens at acceptance 1.0 and 9 tokens a dispatch,
             drafts corrupted from slot 2 accept 2/8 with the same tokens,
             a drafter at JackFram/llama-68m's geometry loaded through
             `spec_draft_model`; B1 once per layer for each prefill (target
             and drafter) and never in a round; a verify forward over a
             1,024-token cache equal to plain attention's; round costs
             printed;
13. stack  — the port's SymbiontStack built from a SymbiontConfig (the
             [serve] engine with flash and its cross-encoder, LmEngine on
             the GPT-2 dir, embedded stores, in-process bus, the gateway
             on a free port) driven over HTTP: 64 pages of 32 sentences
             ingested through /api/submit-url, 50 semantic searches with
             rerank (every one on the fused hop, hits = the store's
             search_fused, rerank scores = engine.rerank), 4 greedy
             streamed generations watched on /api/events (text =
             LmEngine.generate); stored vectors vs embed_texts; B1 once
             per layer per embed batch, fused query, rerank batch and LM
             prefill; /readyz, /metrics, /api/traces, /api/health/engine;
             sentences/s, search p50/p95 and TTFT beside [serve]'s,
             [search]'s and [generate]'s;
14. fleet  — the stack as supervised OS processes over the port's TCP bus
             and broker (`ProcessSupervisor`, heartbeats), in the JAX
             package's multi-process layouts, with the embed role and the
             adopting generation role in this process so that B1 is
             counted where it launches: 32 pages of 32 sentences through
             the perception process and 20 2-hop searches with rerank
             (hits = search_fused on the memory role's rows), a trace
             stitched over 3 processes, /metrics and /api/fleet naming
             every role, a scale-in drain; then 4 greedy GPT-2 float32
             streams, the worker holding some SIGKILLed after their second
             chunk and its journal's tails adopted by the survivor: SSE
             seq gapless, tokens = generate(), journals drained,
             gen.resumes counted, B1 against its plain version at every
             stream and resume prefill bucket; kill to the first replayed
             delta, the re-prefill's ms and each role's device memory.

Launch counts are set to 0 just before each main path (phases 3-4, 5, 6,
8, 9, 10, 11, 12, 13 and 14) and read just after. The last two lines are a JSON object with
every kernel's numbers and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
SEED = 0


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.cache
def _side_stream():
    """The one stream every graph warm-up runs on. torch gives each stream
    that runs a GEMM a cuBLAS workspace of its own (32 MiB on this card)
    and keeps it until the process ends, so a new stream per timing held
    ~470 MB of the card that no claim names."""
    return torch.cuda.Stream()


def graph_ms(fn, iters: int = 50) -> float:
    """Device time per fn() with the host's launch overhead taken out: one
    call captured in a CUDA graph, replayed `iters` times between events.
    Inputs stay in L2 across replays where they fit (50 MB)."""
    side = _side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters=iters)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- kernels


def _attn_inputs(gen, B, NH, NKV, Sq, Sk, D, dtype, lengths):
    dev = "cuda"
    q = torch.randn((B, NH, Sq, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, NKV, Sk, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, NKV, Sk, D), generator=gen, device=dev).to(dtype)
    lens = torch.as_tensor(lengths, device=dev)
    bias = torch.where(torch.arange(Sk, device=dev)[None, :] < lens[:, None],
                       0.0, -1e9).float().contiguous()
    return q, k, v, bias


def _bound_ms(q, k, v, bias, causal: bool) -> tuple[float, str]:
    """Least time the card could take: each input read once, each output
    (o in q's dtype, lse f32) written once, over HBM bandwidth; or the
    4·B·NH·Sq·Sk·D flops of QK^T and PV (half of it when causal and square)
    over the peak rate of the inputs' type. Whichever is larger."""
    B, NH, Sq, D = q.shape
    Sk = k.shape[2]
    nbytes = (2 * q.numel() * q.element_size() + k.numel() * k.element_size()
              + v.numel() * v.element_size() + bias.numel() * 4 + B * NH * Sq * 4)
    pairs = Sq * Sk
    if causal:
        pairs = sum(min(i + 1, Sk) for i in range(Sq))
    flops = 4.0 * B * NH * pairs * D
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(timed: bool = True) -> dict:
    """B1 against its plain version at the serve path's shapes and at
    partial, causal, GQA, float32 and D = 32/128 cases; timed at the
    encoder's shapes beside SDPA's forward and the bound."""
    from symbiont_tpu_torch.ops import _build
    from symbiont_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    _build.load()
    print(f"[kernels] built {_build.build_dir().name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    build_report()

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, NH, NKV, Sq, Sk, D, dtype, causal, lengths, timed)
    cases = []
    for S in (32, 64, 128, 256, 512):  # the encoder's attention at every serve bucket
        lens = rng.integers(1, S + 1, 32)
        lens[[0, 7]] = 0  # batch-padding rows: every key masked
        cases.append((f"enc_S{S}", 32, 12, 12, S, S, 64, bf16, False, lens, timed))
    cases += [
        ("f32_odd", 2, 4, 4, 100, 100, 64, f32, False, [100, 0], False),
        ("f32_gqa_causal_d32", 2, 8, 2, 64, 64, 32, f32, True, [64, 20], False),
        ("bf16_causal", 2, 8, 8, 256, 256, 64, bf16, True, [256, 200], False),
        ("bf16_gqa_sq_ne_sk_d32", 2, 8, 2, 96, 160, 32, bf16, False, [160, 0], False),
        ("bf16_d128_odd", 3, 4, 4, 77, 77, 128, bf16, False, [77, 5, 0], False),
        # partial tiles in both S axes at the main width
        ("bf16_d64_ragged", 4, 12, 12, 136, 200, 64, bf16, False, [200, 77, 0, 131], False),
        # causal GQA at D = 128; key 0 is real in both rows, so every causal
        # row sees a real key (ROADMAP Queue C)
        ("bf16_gqa_causal_d128", 2, 8, 2, 200, 200, 128, bf16, True, [200, 150], False),
    ]
    # every other (batch bucket, length bucket) shape the serve path gives
    # the kernel, checked untimed and summarised on one line
    grid = []
    for B in (1, 8, 128):
        for S in (32, 64, 128, 256, 512):
            lens = rng.integers(1, S + 1, B)
            lens[-1] = 0 if B > 1 else lens[-1]
            grid.append((f"grid_B{B}_S{S}", B, 12, 12, S, S, 64, bf16, False, lens, False))
    rows, grid_err = [], 0.0
    for label, B, NH, NKV, Sq, Sk, D, dtype, causal, lens, is_timed in cases + grid:
        q, k, v, bias = _attn_inputs(gen, B, NH, NKV, Sq, Sk, D, dtype, lens)
        out, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=causal)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_reference(q, k, v, bias, causal=causal)
        # bf16: p is rounded to bf16 before PV and o to bf16 at the end, on
        # both sides at different points; f32: summation order and expf ulps
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        err = (out.float() - ref.float()).abs()
        max_err = float(err.max())
        within = bool((err <= tol + tol * ref.float().abs()).all())
        lse_err = float(((lse - ref_lse).abs() / (1 + ref_lse.abs())).max())
        check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite output")
        check(within, f"{label}: max |kernel - plain| {max_err:.3g} over tolerance {tol}")
        check(lse_err <= 1e-4, f"{label}: lse relative error {lse_err:.3g} > 1e-4")
        if label.startswith("grid_"):
            grid_err = max(grid_err, max_err)
            del q, k, v, bias, out, lse, ref, ref_lse
            continue
        line = (f"[kernels] flash_attn_fwd {label} q{tuple(q.shape)} k{tuple(k.shape)} "
                f"{str(dtype)[6:]} causal={causal}: max_abs_err {max_err:.4g} "
                f"(tol {tol} abs + {tol} rel), lse rel err {lse_err:.3g}")
        if is_timed:
            bound, bound_by = _bound_ms(q, k, v, bias, causal)
            def kernel():
                return fa.flash_attention(q, k, v, bias, causal=causal)

            eager_ms = cuda_ms(kernel)
            ms = graph_ms(kernel)
            plain_ms = graph_ms(lambda: fa.flash_attention_reference(q, k, v, bias, causal=causal),
                                iters=10)
            mask = bias.to(dtype)[:, None, None, :]
            lib_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))
            line += (f"; ms {ms:.4f} (graph replay; eager loop {eager_ms:.4f}), plain_ms "
                     f"{plain_ms:.4f}, library_ms (SDPA) {lib_ms:.4f}, bound_ms {bound:.4f} "
                     f"({bound_by}), {bound / ms:.1%} of bound")
            rows.append({"label": label, "max_abs_err": max_err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                         "library_ms": lib_ms})
        print(line, flush=True)
        del q, k, v, bias, out, lse, ref, ref_lse
    print(f"[kernels] flash_attn_fwd bf16 [B, 12, S, 64] at the other {len(grid)} serve shapes "
          f"(B in 1/8/128, S in 32..512, a length-0 row in each B > 1): max_abs_err "
          f"{grid_err:.4g} (tol 0.02 abs + 0.02 rel)", flush=True)
    torch.cuda.empty_cache()
    return {r["label"]: r for r in rows}


def _bwd_bound_ms(q, k, causal: bool) -> dict:
    """Least time for each backward kernel: each input read once, each
    output written once (B2: q, k, v, g, bias, lse, δ in; dk, dv and the
    per-head dbias f32 out. B3: the same in; dq out), over HBM bandwidth;
    or 8·B·NH·pairs·D flops for B2 and 6·B·NH·pairs·D for B3 (pairs =
    Sq·Sk, the visible half when causal) over the inputs' peak rate."""
    B, NH, Sq, D = q.shape
    Sk = k.shape[2]
    es = q.element_size()
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    ins = 2 * B * NH * (Sq + Sk) * D * es + B * Sk * 4 + 2 * B * NH * Sq * 4
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    out = {}
    for name, nbytes, flops in (
            ("kv", ins + 2 * B * NH * Sk * D * es + B * NH * Sk * 4, 8.0 * B * NH * pairs * D),
            ("q", ins + B * NH * Sq * D * es, 6.0 * B * NH * pairs * D)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        out[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def _within(got, ref, dtype) -> tuple[bool, float, float]:
    """The backward bars → (within, max |kernel - plain|, worst err / bar).
    bf16: max |kernel - plain| ≤ 2e-2 · max |plain| within every (batch,
    head) slice of the output, so the Sk×-scaled gradients of a length-0
    row (ROADMAP Queue C) set no bar for the real rows; float32: |kernel -
    plain| ≤ 1e-4 + 1e-4 · |plain| per element."""
    err = (got.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        bar = 2e-2 * ref.float().abs().flatten(2).amax(-1)
        ratio = err.flatten(2).amax(-1) / bar.clamp_min(1e-30)
    else:
        ratio = err / (1e-4 + 1e-4 * ref.float().abs())
    worst = float(ratio.max())
    return worst <= 1.0, float(err.max()), worst


def kernel_label(mangled: str) -> str:
    """`bwd_kv_bf16_kernel<64>` for a mangled kernel name: the first
    `<length><name>` whose name ends in `_kernel`, with its int template
    arguments. Any other name comes back as it is."""
    for i, ch in enumerate(mangled):
        if not ch.isdigit():
            continue
        run = re.match(r"\d+", mangled[i:]).group()
        at = i + len(run)
        name = mangled[at:at + int(run)]
        if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
            args = re.match(r"I((?:Li\d+E)+)E", mangled[at + len(name):])
            if args:
                return f"{name}<{', '.join(re.findall(r'Li(\d+)E', args.group(1)))}>"
            return name
    return mangled


def ptxas_report(log: str) -> dict:
    """Per kernel of a `ptxas -v` log → {label: {"registers", "spill_stores",
    "spill_loads"}} (bytes for the spills), labels as `kernel_label`."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)", ln)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def hgmma_counts(sass: str) -> dict:
    """Per kernel of `cuobjdump -sass` text → {label: count of HGMMA (wgmma)
    instructions}, labels as `kernel_label`."""
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", ln)
        if m:
            cur = kernel_label(m.group(1))
            out.setdefault(cur, 0)
        elif cur is not None and re.search(r"\bHGMMA\b", ln):
            out[cur] += 1
    return out


WGMMA_BF16 = re.compile(r"(flash_fwd|bwd_kv|bwd_q)_bf16_kernel<(\d+)>")


def wgmma_instances(ptxas: dict, hgmma: dict) -> dict:
    """The bf16 kernel instances of B1 (`flash_fwd`), B2 (`bwd_kv`) and B3
    (`bwd_q`) from `ptxas_report` and `hgmma_counts` → {label: registers,
    spills, hgmma}, by kernel and head dim. Fails if one spills, has no
    HGMMA, or a kernel lacks a head dim of 32/64/128."""
    order = ("flash_fwd", "bwd_kv", "bwd_q")
    names = sorted((n for n in ptxas if WGMMA_BF16.fullmatch(n)),
                   key=lambda n: (order.index(WGMMA_BF16.fullmatch(n).group(1)),
                                  int(WGMMA_BF16.fullmatch(n).group(2))))
    have = {WGMMA_BF16.fullmatch(n).group(1, 2) for n in names}
    want = {(k, str(d)) for k in order for d in (32, 64, 128)}
    check(want <= have, f"bf16 kernel instances missing: {sorted(want - have)}")
    rows = {}
    for n in names:
        rows[n] = dict(ptxas[n], hgmma=hgmma.get(n, 0))
        check(rows[n].get("spill_stores", 0) == 0 and rows[n].get("spill_loads", 0) == 0,
              f"{n} spills: {rows[n]}")
        check(rows[n]["hgmma"] > 0, f"{n} has no HGMMA in its SASS")
    return rows


@functools.cache
def build_report() -> dict:
    """The bf16 B1/B2/B3 instances as built (ptxas registers and spills
    from the build log, HGMMA count from the library's SASS by
    `cuobjdump -sass`), checked by `wgmma_instances` and printed once."""
    from symbiont_tpu_torch.ops import _build

    lib = _build.build()
    sass = subprocess.run([_build.cuobjdump(), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    rows = wgmma_instances(ptxas_report((_build.build_dir() / "build.log").read_text()),
                           hgmma_counts(sass))
    print("[kernels] bf16 instances (ptxas registers, spill bytes stores/loads; "
          "HGMMA in SASS): " + "; ".join(
              f"{n} {r['registers']} regs, spills {r.get('spill_stores', 0)}/"
              f"{r.get('spill_loads', 0)}, {r['hgmma']} HGMMA" for n, r in rows.items()),
          flush=True)
    return rows


def backward_kernel_phase(timed: bool = True) -> dict:
    """B2 (dK/dV/dbias) and B3 (dQ) against their plain versions, fed the
    forward kernel's own out and lse; timed at the training path's shapes."""
    from symbiont_tpu_torch.ops import _build
    from symbiont_tpu_torch.ops import flash_attention as fa

    _build.load()
    build_report()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, NH, Sq, Sk, D, dtype, causal, lengths or "random" bias, timed)
    cases = []
    for S in (64, 128, 256, 512):  # the encoder fine-tune's buckets
        lens = rng.integers(1, S + 1, 32)
        lens[5] = 0  # one batch-padding row: every key masked
        cases.append((f"enc_S{S}", 32, 12, S, S, 64, bf16, False, lens, timed))
    cases += [
        ("f32_odd", 2, 4, 100, 100, 64, f32, False, [100, 0], False),
        ("f32_causal_d32", 2, 4, 80, 80, 32, f32, True, [80, 33], False),
        ("f32_d128_sq_ne_sk", 2, 4, 48, 130, 128, f32, False, [130, 0], False),
        ("f32_dbias", 2, 4, 64, 64, 64, f32, False, "random", False),
        ("bf16_causal_multitile", 2, 8, 256, 256, 64, bf16, True, [256, 200], False),
        ("bf16_d32_sq_ne_sk", 2, 8, 96, 160, 32, bf16, False, [160, 0], False),
        ("bf16_d128_odd", 3, 4, 77, 77, 128, bf16, False, [77, 5, 0], False),
        ("bf16_dbias", 4, 12, 128, 128, 64, bf16, False, "random", False),
        # partial tiles in both S axes at the slice's width
        ("bf16_d64_ragged", 4, 12, 136, 200, 64, bf16, False, [200, 77, 0, 131], False),
    ]
    rows = {}
    for label, B, NH, Sq, Sk, D, dtype, causal, lens, is_timed in cases:
        if isinstance(lens, str):
            q, k, v, _ = _attn_inputs(gen, B, NH, NH, Sq, Sk, D, dtype, [Sk] * B)
            bias = torch.randn((B, Sk), generator=gen, device="cuda")
        else:
            q, k, v, bias = _attn_inputs(gen, B, NH, NH, Sq, Sk, D, dtype, lens)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        scale = 1.0 / np.sqrt(D)
        out, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=causal)
        delta = fa.bwd_delta(g, out)
        args = (q, k, v, bias, g, lse, delta, causal, scale)
        dk, dv, dbh = fa.bwd_kv(*args)
        dq = fa.bwd_q(*args)
        torch.cuda.synchronize()
        rdk, rdv, rdbh = fa.bwd_kv_reference(*args)
        rdq = fa.bwd_q_reference(*args)
        errs, worst = {}, {}
        for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv),
                               ("dbias", dbh, rdbh)):
            check(bool(torch.isfinite(got.float()).all()), f"bwd {label}: non-finite {name}")
            ok, errs[name], worst[name] = _within(got, ref, dtype)
            check(ok, f"bwd {label}: {name} max |kernel - plain| {errs[name]:.4g}, "
                      f"{worst[name]:.3g}x its bar")
        bar = ("2e-2 x max|plain| per (batch, head)" if dtype == bf16
               else "1e-4 abs + 1e-4 rel")
        line = (f"[kernels] flash_attn_bwd {label} q{tuple(q.shape)} k{tuple(k.shape)} "
                f"{str(dtype)[6:]} causal={causal}: max_abs_err "
                + ", ".join(f"{n} {e:.4g} ({worst[n]:.2f} of bar)" for n, e in errs.items())
                + f" (bar {bar})")
        if is_timed:
            bounds = _bwd_bound_ms(q, k, causal)
            ms_kv = graph_ms(lambda: fa.bwd_kv(*args))
            ms_q = graph_ms(lambda: fa.bwd_q(*args))
            plain_kv = graph_ms(lambda: fa.bwd_kv_reference(*args), iters=5)
            plain_q = graph_ms(lambda: fa.bwd_q_reference(*args), iters=5)
            lib = _sdpa_backward_ms(q, k, v, bias, g)
            line += (f"; B2 ms {ms_kv:.4f} (bound {bounds['kv'][0]:.4f}, {bounds['kv'][1]}, "
                     f"{bounds['kv'][0] / ms_kv:.1%}), plain {plain_kv:.4f}; B3 ms {ms_q:.4f} "
                     f"(bound {bounds['q'][0]:.4f}, {bounds['q'][1]}, "
                     f"{bounds['q'][0] / ms_q:.1%}), plain {plain_q:.4f}; B2+B3 {ms_kv + ms_q:.4f} "
                     f"vs SDPA backward (library_ms) {lib:.4f}")
            # SDPA's backward computes dq, dk and dv in one call: it is the
            # yardstick of the pair, so each entry names the pair and its time
            for name, ms, plain in (("kv", ms_kv, plain_kv), ("q", ms_q, plain_q)):
                rows[f"{name}_{label}"] = {
                    "max_abs_err": (max(errs["dk"], errs["dv"], errs["dbias"]) if name == "kv"
                                    else errs["dq"]),
                    "ms": ms, "plain_ms": plain, "bound_ms": bounds[name][0],
                    "bound_by": bounds[name][1], "library_ms": lib,
                    "library_ms_covers": ["flash_attn_bwd_kv", "flash_attn_bwd_q"],
                    "covered_ms": ms_kv + ms_q}
        print(line, flush=True)
        del q, k, v, bias, g, out, lse, delta, args, dk, dv, dbh, dq, rdk, rdv, rdbh, rdq

    # under autograd on CUDA tensors the forward goes through the Function
    # and its backward through both kernels
    q, k, v, bias = _attn_inputs(gen, 2, 4, 4, 64, 64, 64, bf16, [64, 30])
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (fa.launches, fa.bwd_kv_launches, fa.bwd_q_launches)
    out = fa.flash_attention(q, k, v, bias)
    node = type(out.grad_fn).__name__
    check(node == "_FlashAttentionBackward", f"flash_attention under autograd: grad_fn {node}")
    out.float().square().sum().backward()
    after = (fa.launches, fa.bwd_kv_launches, fa.bwd_q_launches)
    check(tuple(a - b for a, b in zip(after, before)) == (1, 1, 1),
          f"autograd launches fwd/B2/B3 {before} -> {after}")
    check(all(bool(torch.isfinite(t.grad.float()).all()) for t in (q, k, v)),
          "non-finite autograd gradients")
    print(f"[kernels] flash_attention under autograd on the card: grad_fn {node}; one "
          f"backward launched fwd/B2/B3 {after[0] - before[0]}/{after[1] - before[1]}/"
          f"{after[2] - before[2]} times", flush=True)
    torch.cuda.empty_cache()
    return rows


def _sdpa_backward_ms(q, k, v, bias, g) -> float:
    """The yardstick for B2 + B3 together: SDPA's backward at the same
    shapes and mask, as (forward + backward) less forward, each by graph
    replay. SDPA is never used by the port."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    mask = bias.to(q.dtype)[:, None, None, :]
    fwd = graph_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask))
    both = graph_ms(lambda: torch.autograd.grad(sdpa(qs, ks, vs, attn_mask=mask),
                                                (qs, ks, vs), g))
    return both - fwd


# ------------------------------------------------------------ main path


def synth_texts(rng, n: int) -> list[str]:
    """n texts whose token counts (words + 2 specials) spread evenly over
    the length buckets 32 / 64 / 128 / 256 / 512 (the last truncates)."""
    vocab = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(5000)]
    spans = [(1, 30), (31, 62), (63, 126), (127, 254), (255, 600)]
    texts = []
    for i in range(n):
        lo, hi = spans[i % len(spans)]
        texts.append(" ".join(rng.choice(vocab, int(rng.integers(lo, hi + 1)))))
    order = rng.permutation(n)
    return [texts[i] for i in order]


def _same_hits(fused, split_all, k: int) -> bool:
    """The fused top-k equals the split top-k up to the query's bf16 rounding.

    The fused path normalises the float32 query before its bf16 cast; the
    split path gets the engine's bf16 output first, so the two bf16 queries
    can differ by one rounding step per component, and a cosine by up to
    2^-8. With random weights the corpus rows crowd together (scores within
    a few thousandths), so near-equal hits may trade places or the k-th
    place. Accepted: scores equal position by position within 2^-8, and
    every fused hit scores, under the split query, within 2^-8 of the split
    k-th score. Identical lists pass at once."""
    split = split_all[:k]
    if [h.id for h in fused] == [h.id for h in split]:
        return True
    step = 2.0 ** -8
    by_id = {h.id: h.score for h in split_all}
    return (len(fused) == len(split)
            and all(abs(a.score - b.score) <= step for a, b in zip(fused, split))
            and all(by_id[h.id] >= split[-1].score - step for h in fused))


def main_path(rng) -> dict:
    from symbiont_tpu_torch.config import EngineConfig, VectorStoreConfig
    from symbiont_tpu_torch.engine.engine import TorchEngine
    from symbiont_tpu_torch.memory.vector_store import VectorStore
    from symbiont_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    eng = TorchEngine(EngineConfig(attn_impl="flash", rerank_enabled=True))
    eng.warmup()
    torch.cuda.synchronize()
    cfg = eng.model_cfg
    print(f"[serve] TorchEngine hidden {cfg.hidden_size}, {cfg.num_layers} layers, "
          f"{cfg.num_heads} heads, {cfg.dtype}, attn_impl={cfg.attn_impl}, "
          f"length buckets {eng.config.length_buckets}, batch buckets "
          f"{eng.config.batch_buckets}; built and warmed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    texts = synth_texts(rng, 2048)

    fa.launches = fa.bwd_kv_launches = fa.bwd_q_launches = 0  # ------- main path
    b0 = eng.stats["embed_batches"]
    t0 = time.perf_counter()
    emb = eng.embed_texts(texts)
    first_s = time.perf_counter() - t0
    n_batches = eng.stats["embed_batches"] - b0
    embed_launches = fa.launches
    check(emb.shape == (len(texts), cfg.hidden_size), f"embed shape {emb.shape}")
    check(bool(np.isfinite(emb).all()), "non-finite embeddings")
    check(embed_launches == cfg.num_layers * n_batches,
          f"flash launches {embed_launches} != {cfg.num_layers} x {n_batches} batches")
    t0 = time.perf_counter()
    eng.embed_texts(texts)
    second_s = time.perf_counter() - t0

    eng_x = TorchEngine(dataclasses.replace(eng.config, attn_impl="xla", rerank_enabled=False),
                        params=eng.params, model_cfg=cfg, tokenizer=eng.tokenizer)
    part = texts[:128]
    a, b = emb[:128], eng_x.embed_texts(part)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    check(float(cos.min()) >= 0.999, f"flash vs plain attention cosine {cos.min():.5f} < 0.999")
    toks = sum(min(len(t.split()) + 2, 512) for t in texts)
    print(f"[serve] embed_texts {len(texts)} texts ({toks} tokens) in {n_batches} batches: "
          f"flash launches {embed_launches} = {cfg.num_layers} x {n_batches}; "
          f"{len(texts) / first_s:.1f} emb/s first call, {len(texts) / second_s:.1f} emb/s "
          f"second call (host clock, tokenization included); "
          f"flash vs plain attention cosine min {cos.min():.6f} over 128 rows", flush=True)
    del eng_x

    with tempfile.TemporaryDirectory() as tmp:
        store = VectorStore(VectorStoreConfig(dim=cfg.hidden_size, data_dir=tmp))
        store.upsert_rows([f"d{i}" for i in range(len(texts))], emb,
                          [{"text": t} for t in texts])
        # four corpus texts (each must find its own row first) and four new
        queries = texts[:4] + [" ".join(t.split()[:12]) for t in texts[4:8]]
        lat, exact, reranked = [], 0, 0
        for i, q in enumerate(queries):
            t0 = time.perf_counter()
            fused = store.search_fused(eng, q, 8)
            lat.append(time.perf_counter() - t0)
            split_all = store.search(eng.embed_query(q), store.count())
            check(len(fused) == 8 and _same_hits(fused, split_all, 8),
                  f"fused hits {[(h.id, h.score) for h in fused]} != split "
                  f"{[(h.id, h.score) for h in split_all[:8]]}")
            check(i >= 4 or fused[0].id == f"d{i}",
                  f"corpus text d{i} found {fused[0].id} first")
            exact += [h.id for h in fused] == [h.id for h in split_all[:8]]
            scores = eng.rerank(q, [h.payload["text"] for h in fused])
            check(scores.shape == (8,) and bool(np.isfinite(scores).all()),
                  f"rerank scores {scores}")
            reranked += len(scores)
        for q in queries * 3:
            t0 = time.perf_counter()
            store.search_fused(eng, q, 8)
            lat.append(time.perf_counter() - t0)
        n_rows = store.count()
    counts = _launch_counts(fa)  # ------------------------------------ main path end
    check(counts[1:] == (0, 0), f"backward kernels launched while serving: {counts}")
    print(f"[search] {n_rows} rows; {len(queries)} fused queries match search(embed_query) "
          f"({exact} with identical lists, the rest equal up to the query's bf16 rounding); "
          f"reranked {reranked} hits; fused query p50 {np.median(lat) * 1e3:.3f} ms, "
          f"max {max(lat) * 1e3:.3f} ms over {len(lat)} (host clock)", flush=True)
    return {"launches": counts, "emb_s_first": len(texts) / first_s,
            "emb_s_second": len(texts) / second_s, "fused_p50_ms": float(np.median(lat)) * 1e3}


def _pairs(tokenizer, texts, q_bucket: int, p_bucket: int, n: int, lo: int, hi: int):
    """n (query, passage) pairs as a device batch: passages are texts whose
    token count falls in (lo, hi], padded (and truncated) to p_bucket; each
    query is the passage's first words, padded to q_bucket. Ids and masks
    come from the port's tokenizer and bucketing, as the engine makes them."""
    from symbiont_tpu_torch.engine.bucketing import choose_bucket, pad_ids_rows

    passages = [t for t in texts if lo < len(t.split()) + 2 <= hi][:n]
    check(len(passages) == n, f"only {len(passages)} texts in ({lo}, {hi}] tokens")
    queries = [" ".join(t.split()[: q_bucket // 2 + 8 * (i % 3)]) for i, t in enumerate(passages)]
    batch = {}
    for side, rows, bucket in (("q", queries, q_bucket), ("p", passages, p_bucket)):
        encoded = tokenizer.encode_batch(rows, bucket)
        check(all(choose_bucket(len(e), [32, 64, 128, 256, 512]) == bucket for e in encoded),
              f"{side} rows outside the {bucket} bucket")
        ids, lens = pad_ids_rows(encoded, bucket, tokenizer.pad_id)
        batch[f"{side}_ids"] = torch.from_numpy(ids).to("cuda", torch.int64)
        batch[f"{side}_mask"] = (torch.arange(bucket, device="cuda")[None, :]
                                 < torch.from_numpy(lens).to("cuda")[:, None]).to(torch.int32)
    return batch


def _launch_counts(fa) -> tuple:
    return fa.launches, fa.bwd_kv_launches, fa.bwd_q_launches


def train_path(rng) -> dict:
    """The encoder fine-tune at full width: contrastive_train_step on the
    card through the flash-attention forward and both backward kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from symbiont_tpu_torch.config import EngineConfig
    from symbiont_tpu_torch.engine.engine import TorchEngine
    from symbiont_tpu_torch.engine.tokenizer import load_tokenizer
    from symbiont_tpu_torch.models import bert as bert_mod
    from symbiont_tpu_torch.ops import flash_attention as fa
    from symbiont_tpu_torch.train import trainer

    # the EngineConfig() geometry (mpnet-base size), bf16 compute
    cfg = bert_mod.BertConfig(vocab_size=30000, hidden_size=768, num_layers=12,
                              num_heads=12, intermediate_size=3072,
                              max_position_embeddings=512, dtype="bfloat16",
                              attn_impl="flash")
    L = cfg.num_layers
    params = bert_mod.init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    tok = load_tokenizer(None, cfg.vocab_size)
    texts = synth_texts(rng, 4096)
    batch = _pairs(tok, texts, 64, 256, 32, 128, 256)
    batch512 = _pairs(tok, texts, 64, 512, 16, 256, 10_000)
    probe = texts[:64]
    untrained = TorchEngine(EngineConfig(attn_impl="flash"), params=params, model_cfg=cfg,
                            tokenizer=tok).embed_texts(probe)
    state, tx = trainer.make_embedder_train_state(params)
    del params

    # one step's gradients with flash vs plain attention, same masters
    leaves = trainer.tree_leaves(state.params)
    grads = {}
    for impl in ("xla", "flash"):
        loss = trainer.contrastive_loss(state.params, batch,
                                        dataclasses.replace(cfg, attn_impl=impl))
        grads[impl] = torch.cat([g.float().flatten() for g in torch.autograd.grad(loss, leaves)])
    cos = float(torch.nn.functional.cosine_similarity(grads["flash"], grads["xla"], dim=0))
    ratio = float(grads["flash"].norm() / grads["xla"].norm())
    check(cos >= 0.99, f"flash vs plain attention gradient cosine {cos:.5f} < 0.99")
    del grads

    steps, per_step, losses, n_steps = [], [], [], 8
    fa.launches = fa.bwd_kv_launches = fa.bwd_q_launches = 0  # ------- main path
    for _ in range(n_steps):
        before = _launch_counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.contrastive_train_step(state, batch, cfg, tx)
        losses.append(float(m["loss"]))  # a host sync: the step has run
        steps.append(time.perf_counter() - t0)
        per_step.append(tuple(a - b for a, b in zip(_launch_counts(fa), before)))
    before = _launch_counts(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m512 = trainer.contrastive_train_step(state, batch512, cfg, tx)
    loss512 = float(m512["loss"])
    step512_s = time.perf_counter() - t0
    per_step.append(tuple(a - b for a, b in zip(_launch_counts(fa), before)))
    counts = _launch_counts(fa)  # ------------------------------------ main path end

    check(all(c == (2 * L,) * 3 for c in per_step),
          f"launches per step (fwd, B2, B3) {per_step} != {(2 * L,) * 3}")
    check(bool(np.isfinite(losses + [loss512]).all()), f"non-finite loss {losses} {loss512}")
    check(losses[-1] < losses[0], f"loss did not fall on the repeated batch: {losses}")
    toks = sum(int(batch[f"{s}_ids"].numel()) for s in ("q", "p"))
    real = sum(int(batch[f"{s}_mask"].sum()) for s in ("q", "p"))
    warm = steps[2:]  # the first steps pay the allocator's and cuBLAS's warm-up
    sps = len(warm) / sum(warm)
    print(f"[train] contrastive_train_step, {cfg.hidden_size} hidden, {L} layers, bf16, "
          f"attn_impl=flash, 32 pairs (queries at 64, passages at 256 tokens): launches per "
          f"step fwd/B2/B3 {per_step[0][0]}/{per_step[0][1]}/{per_step[0][2]} in every step; "
          f"loss {' '.join(f'{x:.4f}' for x in losses)}; grad_norm {float(m['grad_norm']):.4f}; "
          f"{sps:.3f} steps/s, {sps * toks:.0f} padded tokens/s ({sps * real:.0f} real) over "
          f"steps 3-{n_steps} (host clock, synchronised); 16 pairs at the 512 bucket: loss "
          f"{loss512:.4f}, {step512_s * 1e3:.1f} ms; flash vs plain attention gradient cosine "
          f"{cos:.6f}, norm ratio {ratio:.6f}", flush=True)

    # device time by kernel for one step of the repeated batch
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = trainer.contrastive_train_step(state, batch, cfg, tx)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(t for _, t in kernels)
    share = {name: sum(t for k, t in kernels if tag in k) / busy
             for name, tag in (("flash_attn_fwd", "flash_fwd"), ("flash_attn_bwd_kv", "bwd_kv_"),
                               ("flash_attn_bwd_q", "bwd_q_"))}
    top = "; ".join(f"{k[:50]} {t / busy:.1%}" for k, t in sorted(kernels, key=lambda kv: -kv[1])[:6])
    print(f"[train] one step under torch.profiler: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({busy / wall_us:.1%} of wall); share of device time: "
          + ", ".join(f"{k} {v:.1%}" for k, v in share.items()) + f"; top kernels: {top}",
          flush=True)

    trained = TorchEngine(EngineConfig(attn_impl="flash"),
                          params=bert_mod.tree_map(lambda t: t.detach(), state.params),
                          model_cfg=cfg, tokenizer=tok).embed_texts(probe)
    check(bool(np.isfinite(trained).all()), "non-finite embeddings from the trained params")
    moved = float(np.abs(trained - untrained).max())
    check(moved > 0, "the trained params embed exactly as the untrained ones")
    print(f"[train] TorchEngine(params=trained masters) embeds {len(probe)} texts with flash: "
          f"finite, max |trained - untrained| {moved:.4g}", flush=True)
    return {"launches": counts}


def profile_embed(texts) -> None:
    """Device time by kernel for one embed_texts call of `texts` under
    torch.profiler, and the device's busy share of the call's host wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from symbiont_tpu_torch.config import EngineConfig
    from symbiont_tpu_torch.engine.engine import TorchEngine

    eng = TorchEngine(EngineConfig(attn_impl="flash"))
    eng.embed_texts(texts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.embed_texts(texts)
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: a CPU op's entry repeats its kernels' time
    kernels = sorted(((e.key, e.self_device_time_total) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy = sum(t for _, t in kernels)
    flash = sum(t for name, t in kernels if "flash_fwd" in name)
    top = "; ".join(f"{name[:60]} {t / busy:.1%}" for name, t in kernels[:6])
    print(f"[profile] embed_texts of {len(texts)} texts under torch.profiler: wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({busy / wall_us:.1%} of wall), flash_attn_fwd {flash / busy:.1%} of device "
          f"time; top kernels: {top}", flush=True)


# ------------------------------------------------------------ checkpoints

# The models of BASELINE.md whose checkpoints the phases below write from
# SEED in the hub's layout (no download): the default embedder (an XLM-R
# layout, pad id 1, so positions start at 2), and the #1/#4 pair, a MiniLM
# embedder and an ms-marco cross-encoder that share BERT's 30,522 vocab.
MPNET_MULTILINGUAL = dict(  # paraphrase-multilingual-mpnet-base-v2
    vocab_size=250002, hidden_size=768, num_layers=12, num_heads=12,
    intermediate_size=3072, max_position_embeddings=514, type_vocab_size=1,
    layer_norm_eps=1e-5, position_offset=2)
MINILM_L6 = dict(  # all-MiniLM-L6-v2, and ms-marco-MiniLM-L-6-v2 with a head
    vocab_size=30522, hidden_size=384, num_layers=6, num_heads=12,
    intermediate_size=1536, max_position_embeddings=512, type_vocab_size=2,
    layer_norm_eps=1e-12)
QUANT_BARS = {"f16": 0.999, "int8": 0.999, "fp8": 0.998}  # cosine vs "none"
# rerank scores, flash vs plain attention, bf16: about 4x the 0.00124 measured
# on the MiniLM pair, against random-head scores of about +-0.15
RERANK_BAR = 5e-3
# leaves whose int8/fp8 codes [quant] holds bit for bit against the CPU's
QUANT_PROBES = {"word_embeddings": ("embeddings", "word_embeddings"),
                "layers[0].query.kernel": ("layers", 0, "attention", "query", "kernel")}


def param_counts(geom: dict, with_pooler: bool = False) -> dict:
    """Parameters of a BERT geometry by kind: "matrix" entries (rank ≥ 2
    leaves: the three tables and every kernel), "scales" (one per last-axis
    entry of each matrix, what int8/fp8 adds) and "vector" entries (biases
    and LayerNorm parameters)."""
    H, I, L = geom["hidden_size"], geom["intermediate_size"], geom["num_layers"]
    tables = (geom["vocab_size"] + geom["max_position_embeddings"]
              + geom["type_vocab_size"]) * H
    matrix = tables + L * (4 * H * H + 2 * H * I)
    scales = 3 * H + L * (4 * H + I + H)
    vector = 2 * H + L * (4 * H + I + H + 4 * H)
    if with_pooler:  # pooler [H, H] and classifier [H, 1], with biases
        matrix, scales, vector = matrix + H * H + H, scales + H + 1, vector + H + 1
    return {"matrix": matrix, "scales": scales, "vector": vector, "total": matrix + vector}


def expected_param_bytes(geom: dict, quantize: str, dtype: str = "bfloat16") -> int:
    """Bytes a TorchEngine holds for an embedder of `geom`: everything in the
    compute dtype, except int8/fp8 matrices as one-byte codes plus float32
    scales and f16 matrices as bf16 (the vectors stay in the compute
    dtype)."""
    n = param_counts(geom)
    width = 2 if dtype == "bfloat16" else 4
    if quantize in ("int8", "fp8"):
        return n["matrix"] + 4 * n["scales"] + width * n["vector"]
    if quantize == "f16":
        return 2 * n["matrix"] + width * n["vector"]
    return width * n["total"]


def write_checkpoint(out_dir, params, cfg, fmt: str = "safetensors") -> dict:
    """Write `params` as a hub-format model dir: "safetensors" through the
    port's `export_hf_bert` (model.safetensors, tensor names without a
    prefix), "bin" as a `torch.save`d state dict under `bert.*` names, as
    the ms-marco cross-encoders ship. Returns the config.json written."""
    from pathlib import Path

    from symbiont_tpu_torch.models import convert

    out_dir = Path(out_dir)
    if fmt == "safetensors":
        convert.export_hf_bert(params, cfg, out_dir)
    elif fmt == "bin":
        out_dir.mkdir(parents=True, exist_ok=True)
        sd = convert.hf_state_dict(params, prefix="bert.")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   out_dir / "pytorch_model.bin")
        (out_dir / "config.json").write_text(json.dumps(convert.hf_config(cfg), indent=2))
    else:
        raise ValueError(f"unknown checkpoint format {fmt!r}")
    return json.loads((out_dir / "config.json").read_text())


def _cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _storage_bytes(*trees) -> dict:
    """{storage pointer: bytes} of the tensors in `trees` (a QuantTensor
    gives two), each storage once."""
    from symbiont_tpu_torch.models import quant

    out = {}
    for tree in trees:
        for leaf in quant.leaves(tree):
            for t in ((leaf.q, leaf.scale) if isinstance(leaf, quant.QuantTensor) else (leaf,)):
                out.setdefault(t.untyped_storage().data_ptr(), quant.tensor_bytes(t))
    return out


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def live_cuda_storages() -> dict:
    """{storage pointer: (bytes, shape, dtype)} of every CUDA tensor the
    garbage collector can reach (not those held only inside torch, such as
    autograd's saved tensors or cuBLAS workspaces)."""
    import gc
    import warnings

    out = {}
    with warnings.catch_warnings():  # isinstance on deprecated torch objects warns
        warnings.simplefilter("ignore")
        for o in gc.get_objects():
            try:
                if isinstance(o, torch.Tensor) and o.is_cuda:
                    st = o.untyped_storage()
                    out[st.data_ptr()] = (st.nbytes(), tuple(o.shape),
                                          str(o.dtype).split(".")[-1])
            except (RuntimeError, ReferenceError):
                continue
    return out


def alloc_site(frames, root: str) -> str | None:
    """Where a block was allocated, from its memory-history frames (innermost
    first): the innermost two frames in files under `root`, as
    "file:line function < file:line function"; None without frames."""
    ours = [f"{f['filename'][len(root):].lstrip('/')}:{f['line']} {f['name']}"
            for f in frames if f["filename"].startswith(root)]
    return " < ".join(ours[:2]) or None


def group_blocks(segments, reachable, root: str) -> list:
    """The allocator's active blocks grouped by allocation site (by pool and
    size where no history was recorded): [(bytes, blocks, site,
    reachable from Python)], largest first. `segments` is
    torch.cuda.memory._snapshot()["segments"]; `reachable` the storage
    pointers the garbage collector reaches."""
    groups = {}
    for seg in segments:
        pool = tuple(seg.get("segment_pool_id") or (0, 0))
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            site = (alloc_site(blk.get("frames") or [], root)
                    or f"pool {pool}, no history, block of {blk['size']:,}")
            key = (site, blk["address"] in reachable)
            n = groups.setdefault(key, [0, 0])
            n[0] += blk["size"]
            n[1] += 1
    return sorted(((b, c, site, r) for (site, r), (b, c) in groups.items()), key=lambda g: -g[0])


def allocator_census(top: int = 5) -> str:
    """What the caching allocator holds right now, by allocation site (run
    with --memory-history for sites; without it, by pool and block size)."""
    root = str(Path(__file__).resolve().parent)
    groups = group_blocks(torch.cuda.memory._snapshot()["segments"],
                          set(live_cuda_storages()), root)
    return (f"{sum(g[0] for g in groups):,} bytes in {sum(g[1] for g in groups)} active blocks "
            f"(memory_allocated {torch.cuda.memory_allocated():,}); largest: " + "; ".join(
        f"{b:,} in {c} at {site} ({'reachable' if r else 'not reachable'} from Python)"
        for b, c, site, r in groups[:top]))


def clear_cublas_workspaces() -> int:
    """Free the cuBLAS workspaces torch keeps (one per stream that ran a
    GEMM) and return the bytes that freed; 0 where torch has no such call.
    The next GEMM on a stream takes its workspace again."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is None:
        return 0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    clear()
    return before - torch.cuda.memory_allocated()


def kernel_short(name: str, width: int = 120) -> str:
    """A profiler's kernel name without its namespaces and argument list,
    so the functor that tells two elementwise kernels apart stays in view."""
    for junk in ("void ", "(anonymous namespace)::", "at::native::", "c10::",
                 "binary_internal::"):
        name = name.replace(junk, "")
    return name.split("(", 1)[0][:width]


def top_kernels(events, n: int = 5) -> list:
    """[(name, self device ms, calls)] of the `n` device entries of a
    profiler's key_averages() with the most self device time."""
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    dev.sort(key=lambda e: -e.self_device_time_total)
    return [(e.key, e.self_device_time_total / 1e3, e.count) for e in dev[:n]]


def _embed_dispatches() -> dict:
    from symbiont_tpu_torch.obs.xprof import dispatch_ledger

    return {r["executable"]: r["dispatches"] for r in dispatch_ledger.snapshot()
            if r["executable"].startswith("embed[")}


def checkpoint_phase(rng, tmp) -> dict:
    """The default model from a checkpoint on disk: write the multilingual
    mpnet geometry from SEED, serve it through `model_dir` with flash (int32
    ids, RoBERTa positions, the synthetic XLM-R cross-encoder's one-row
    token-type table), store and rerank; then the MiniLM embedder and
    ms-marco cross-encoder pair (safetensors and pytorch_model.bin)."""
    import gc

    from symbiont_tpu_torch.config import EngineConfig, VectorStoreConfig
    from symbiont_tpu_torch.engine.engine import TorchEngine
    from symbiont_tpu_torch.memory.vector_store import VectorStore
    from symbiont_tpu_torch.models import bert as bert_mod
    from symbiont_tpu_torch.models.convert import load_bert_model
    from symbiont_tpu_torch.ops import flash_attention as fa
    from symbiont_tpu_torch.utils.telemetry import metrics

    tmp = Path(tmp)
    cfg = bert_mod.BertConfig(**MPNET_MULTILINGUAL)
    t0 = time.perf_counter()
    params = bert_mod.init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    probes = {  # (path, rows): a table's rows and transposed kernels
        "word_embeddings[-12:]": (("embeddings", "word_embeddings"), slice(-12, None)),
        "query[0]": (("layers", 0, "attention", "query", "kernel"), slice(None)),
        "mlp.out[-1]": (("layers", -1, "mlp", "out", "kernel"), slice(None)),
    }

    written = {n: _leaf(params, p)[rows].cpu().numpy() for n, (p, rows) in probes.items()}
    write_checkpoint(tmp / "mpnet", params, cfg)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    del params
    size_mb = (tmp / "mpnet" / "model.safetensors").stat().st_size / 1e6

    back, back_cfg = load_bert_model(tmp / "mpnet")
    for n, (p, rows) in probes.items():
        check(np.array_equal(_leaf(back, p)[rows], written[n]),
              f"{n} read back from model.safetensors differs from what was written")
    check(back_cfg == cfg, f"config read back {back_cfg} != {cfg}")
    host_leaves = {n: torch.from_numpy(np.ascontiguousarray(_leaf(back, p)))
                   for n, p in QUANT_PROBES.items()}
    del back

    t0 = time.perf_counter()
    eng = TorchEngine(EngineConfig(model_dir=str(tmp / "mpnet"), attn_impl="flash",
                                   rerank_enabled=True))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    mcfg = eng.model_cfg
    check(mcfg == dataclasses.replace(cfg, attn_impl="flash") and mcfg.position_offset == 2,
          f"loaded geometry {mcfg} != written {cfg}")
    check(eng._ids_dtype == np.int32, f"ids travel as {eng._ids_dtype}, not int32")
    for n, (p, rows) in probes.items():
        got = _leaf(eng.params, p)[rows]
        want = torch.from_numpy(written[n]).to("cuda", torch.bfloat16)
        check(torch.equal(got, want), f"engine's {n} != the written leaf in bf16")
    pbytes = metrics.gauge_get("engine.param_bytes", {"service": "engine", "dtype": "bf16"})
    check(pbytes == expected_param_bytes(MPNET_MULTILINGUAL, "none"),
          f"engine.param_bytes {pbytes} != {expected_param_bytes(MPNET_MULTILINGUAL, 'none')}")

    texts = synth_texts(rng, 1000)
    max_len = min(eng.config.length_buckets[-1], mcfg.max_position_embeddings)
    true_tokens = sum(len(e) for e in eng.tokenizer.encode_batch(texts, max_len))
    tok0 = (metrics.get("engine.tokens_real", {"service": "engine"}),
            metrics.get("engine.tokens_padding", {"service": "engine"}))
    sig0 = _embed_dispatches()
    fa.launches = fa.bwd_kv_launches = fa.bwd_q_launches = 0  # ------- main path
    b0 = eng.stats["embed_batches"]
    t0 = time.perf_counter()
    emb = eng.embed_texts(texts)
    first_s = time.perf_counter() - t0
    n_batches = eng.stats["embed_batches"] - b0
    embed_launches = fa.launches
    tok1 = (metrics.get("engine.tokens_real", {"service": "engine"}),
            metrics.get("engine.tokens_padding", {"service": "engine"}))
    sig1 = _embed_dispatches()
    check(emb.shape == (len(texts), mcfg.hidden_size) and bool(np.isfinite(emb).all()),
          f"embeddings {emb.shape}, finite {np.isfinite(emb).all()}")
    check(embed_launches == mcfg.num_layers * n_batches,
          f"flash launches {embed_launches} != {mcfg.num_layers} x {n_batches} batches")
    buckets_used = sorted({int(k.split("L=")[1].split(",")[0]) for k in sig1
                           if sig1[k] != sig0.get(k, 0)})
    check(buckets_used == [32, 64, 128, 256, 512], f"buckets run {buckets_used}")
    padded = sum(int(k.split("L=")[1].split(",")[0]) * int(k.split("B=")[1].rstrip("]"))
                 * (n - sig0.get(k, 0)) for k, n in sig1.items())

    eng_x = TorchEngine(dataclasses.replace(eng.config, attn_impl="xla", rerank_enabled=False),
                        params=eng.params, model_cfg=mcfg, tokenizer=eng.tokenizer)
    cos = _cosines(emb[:128], eng_x.embed_texts(texts[:128]))
    check(float(cos.min()) >= 0.999, f"flash vs plain attention cosine {cos.min():.5f}")
    del eng_x

    store = VectorStore(VectorStoreConfig(dim=mcfg.hidden_size, data_dir=str(tmp / "store")))
    store.upsert_rows([f"m{i}" for i in range(len(texts))], emb, [{"text": t} for t in texts])
    r0 = eng.stats["rerank_batches"]
    reranked = []
    for i, q in enumerate(texts[:4]):
        hits = store.search_fused(eng, q, 8)
        check(hits[0].id == f"m{i}", f"corpus text m{i} found {hits[0].id} first")
        scores = eng.rerank(q, [h.payload["text"] for h in hits])
        check(scores.shape == (8,) and bool(np.isfinite(scores).all()),
              f"rerank scores {scores}")
        reranked.append(scores)
    launches = fa.launches  # ---------------------------------------- main path end
    rerank_batches = eng.stats["rerank_batches"] - r0
    check(launches - embed_launches == mcfg.num_layers * (4 + rerank_batches),
          f"flash launches for 4 fused queries and {rerank_batches} rerank batches: "
          f"{launches - embed_launches}")
    n_params = param_counts(MPNET_MULTILINGUAL)["total"]
    print(f"[checkpoint] paraphrase-multilingual-mpnet-base-v2 geometry (XLM-R, vocab "
          f"{cfg.vocab_size:,}, {n_params:,} parameters) from seed {SEED}: model.safetensors {size_mb:.1f} MB "
          f"written in {write_s:.2f} s, TorchEngine(model_dir, flash, rerank) loaded in "
          f"{load_s:.2f} s; leaves read back bit-equal (transpose included), position_offset "
          f"{mcfg.position_offset}, int32 ids; engine.param_bytes{{dtype=bf16}} {pbytes:,.0f}; "
          f"embed_texts of {len(texts)} texts over buckets {buckets_used} in {n_batches} batches: "
          f"{first_s:.2f} s first call, {len(texts) / first_s:.1f} emb/s (host clock), flash "
          f"launches {embed_launches} = {mcfg.num_layers} x {n_batches}; flash vs plain cosine "
          f"min {cos.min():.6f}; 4 fused queries find their own rows, rerank of their top 8 "
          f"through the one-row token-type table finite (score range "
          f"{min(s.min() for s in reranked):.4f}..{max(s.max() for s in reranked):.4f})",
          flush=True)

    # the BASELINE.md #1/#4 pair: MiniLM embedder + ms-marco cross-encoder
    mini = bert_mod.BertConfig(**MINILM_L6)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    t0 = time.perf_counter()
    write_checkpoint(tmp / "minilm", bert_mod.init_params(gen, mini), mini)
    cross_cfg = write_checkpoint(tmp / "msmarco",
                                 bert_mod.init_params(gen, mini, with_pooler=True), mini, "bin")
    write2_s = time.perf_counter() - t0
    t0 = time.perf_counter()  # the host half of a load alone
    load_bert_model(tmp / "minilm")
    load_bert_model(tmp / "msmarco", with_pooler=True)
    convert2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pair = TorchEngine(EngineConfig(model_dir=str(tmp / "minilm"),
                                    cross_model_dir=str(tmp / "msmarco"), attn_impl="flash"))
    torch.cuda.synchronize()
    load2_s = time.perf_counter() - t0
    check(pair._ids_dtype == np.uint16 and pair.cross_cfg.type_vocab_size == 2
          and pair.cross_params["classifier"]["kernel"].shape == (mini.hidden_size, 1),
          f"MiniLM pair: ids {pair._ids_dtype}, cross {pair.cross_cfg}")
    e0 = pair.stats["embed_batches"]
    fa.launches = 0  # ------------------------------------------------ main path
    t0 = time.perf_counter()
    emb2 = pair.embed_texts(texts[:256])
    first2_s = time.perf_counter() - t0
    n2 = pair.stats["embed_batches"] - e0
    passages = texts[256:288]
    flash_scores = pair.rerank(texts[0], passages)
    pair_launches = fa.launches  # ------------------------------------- main path end
    check(pair_launches == mini.num_layers * (n2 + pair.stats["rerank_batches"]),
          f"MiniLM pair flash launches {pair_launches}")
    plain = TorchEngine(dataclasses.replace(pair.config, attn_impl="xla"), params=pair.params,
                        model_cfg=pair.model_cfg, tokenizer=pair.tokenizer,
                        cross_params=pair.cross_params, cross_cfg=pair.cross_cfg)
    plain_scores = plain.rerank(texts[0], passages)
    err = np.abs(flash_scores - plain_scores)
    check(bool(np.isfinite(emb2).all()) and bool(np.isfinite(flash_scores).all()),
          "MiniLM pair: non-finite output")
    check(float(err.max()) <= RERANK_BAR,
          f"rerank flash vs plain max |err| {err.max():.4g} over the bar {RERANK_BAR}")
    pair_bytes = metrics.gauge_get("engine.param_bytes", {"service": "engine", "dtype": "bf16"})
    check(pair_bytes == expected_param_bytes(MINILM_L6, "none"),
          f"MiniLM engine.param_bytes {pair_bytes}")
    print(f"[checkpoint] all-MiniLM-L6-v2 geometry ({param_counts(MINILM_L6)['total']:,} "
          f"parameters, model.safetensors) + ms-marco-MiniLM-L-6-v2 geometry "
          f"({param_counts(MINILM_L6, with_pooler=True)['total']:,} parameters, "
          f"pytorch_model.bin under bert.* names, model_type {cross_cfg['model_type']}) written "
          f"in {write2_s:.2f} s, loaded through model_dir + cross_model_dir in {load2_s:.2f} s "
          f"(their host conversion alone, just before: {convert2_s:.2f} s); "
          f"engine.param_bytes{{dtype=bf16}} {pair_bytes:,.0f}; embed of 256 texts "
          f"{first2_s:.2f} s first call; rerank of 32 passages, flash vs plain attention max "
          f"|err| {err.max():.3g} (bar {RERANK_BAR}); flash launches {pair_launches} = "
          f"{mini.num_layers} x {n2 + pair.stats['rerank_batches']} batches", flush=True)
    del pair, plain
    gc.collect()
    return {"engine": eng, "store": store, "launches": launches + pair_launches,
            "true_tokens": true_tokens, "padded_tokens": padded,
            "tokens": (tok1[0] - tok0[0], tok1[1] - tok0[1]), "mpnet_dir": tmp / "mpnet",
            "host_leaves": host_leaves}


def obs_phase(ck: dict, tmp) -> None:
    """The engine's memory ledger, padding counters, dispatch ledger and
    OOM guard, read after the checkpoint phase's serving with its engine and
    store alive."""
    from symbiont_tpu_torch.obs.hbm import guard_oom, hbm_ledger, oom_forensics
    from symbiont_tpu_torch.obs.xprof import dispatch_ledger
    from symbiont_tpu_torch.utils.telemetry import metrics

    import gc

    eng, store = ck["engine"], ck["store"]
    gc.collect()  # engines of earlier phases retire their claims
    torch.cuda.synchronize()
    rec = hbm_ledger.reconcile()
    rows = {r["subsystem"]: r["bytes"] for r in rec["subsystems"]}
    held_ptrs = _storage_bytes(eng.params, eng.cross_params)
    held = sum(held_ptrs.values())
    check(rec["basis"] == "memory_stats", f"reconcile basis {rec['basis']}")
    check(rows.get("engine.params") == held,
          f"engine.params claims {rows.get('engine.params')}, the engine holds {held}")
    check(rows.get("memory.corpus", 0) > 0, f"no memory.corpus claim: {rows}")
    claimed = rows["engine.params"] + rows["memory.corpus"]
    check(claimed <= rec["bytes_in_use"],
          f"claims {claimed} exceed the allocator's bytes in use {rec['bytes_in_use']}")
    real, pad = ck["tokens"]
    check(real == ck["true_tokens"], f"engine.tokens_real {real} != tokenized {ck['true_tokens']}")
    check(real + pad == ck["padded_tokens"],
          f"tokens_real + tokens_padding {real + pad} != padded slots {ck['padded_tokens']}")
    top = dispatch_ledger.snapshot()[:3]
    # what the ledger leaves unattributed: live tensors outside the claims
    claimed_ptrs = set(held_ptrs) | {store._device_corpus.untyped_storage().data_ptr()}
    outside = sorted((v for k, v in live_cuda_storages().items() if k not in claimed_ptrs),
                     key=lambda v: -v[0])
    outside_bytes = sum(v[0] for v in outside)
    workspaces = clear_cublas_workspaces()
    unnamed = rec["unattributed_bytes"] - outside_bytes - workspaces

    oom_forensics.configure(postmortem_dir=str(tmp / "postmortem"))
    site = {"site": "smoke"}
    before = metrics.get("engine.oom_total", site)
    raised = None
    try:
        with guard_oom("smoke"):
            torch.empty(2 ** 50, dtype=torch.uint8, device="cuda")
    except torch.cuda.OutOfMemoryError as e:
        raised = e
    count = metrics.get("engine.oom_total", site) - before
    last = oom_forensics.last
    check(raised is not None, "torch.empty(2**50) under guard_oom did not raise an OOM")
    check(count == 1 and last is not None and last["site"] == "smoke"
          and last["postmortem"] is not None,
          f"guard_oom recorded {count} OOM(s), verdict {last}")
    print(f"[obs] reconcile on the card (basis {rec['basis']}): bytes_in_use "
          f"{rec['bytes_in_use']:,}, engine.params {rows['engine.params']:,} (= the engine's "
          f"tensors), memory.corpus {rows['memory.corpus']:,}, unattributed "
          f"{rec['unattributed_bytes']:,} ({rec['unattributed_pct']}%), of which cuBLAS "
          f"workspaces {workspaces:,} (freed by clearing them), live tensors outside the claims "
          f"{outside_bytes:,} in {len(outside)} storages (largest "
          + ", ".join(f"{list(shape)} {dt} {n:,}" for n, shape, dt in outside[:3])
          + f"), not named {unnamed:,} ({100 * unnamed / max(rec['bytes_in_use'], 1):.2f}% of bytes in "
          f"use); engine.tokens_real "
          f"{real:,} = tokenized lengths, + tokens_padding {pad:,} = {ck['padded_tokens']:,} "
          f"padded slots; dispatch ledger top three: "
          + "; ".join(f"{r['executable']} x{r['dispatches']} ({r['mean_dispatch_us']} us host "
                      f"each)" for r in top)
          + f"; guard_oom('smoke') around torch.empty(2**50) re-raised "
          f"{type(raised).__name__}, engine.oom_total{{site=smoke}} {count:g}, postmortem "
          f"written", flush=True)


def quant_phase(rng, mpnet_dir, host: dict) -> dict:
    """The mpnet checkpoint at every quantize mode, flash, one engine at a
    time: each mode's embeddings of the same 512 texts against "none", its
    parameter bytes, the allocator's bytes after load, emb/s, the device
    time of one embed_texts and its largest kernels; for int8 and fp8, the
    codes and scales the engine made on the card, bit for bit against the
    same quantization on the CPU of `host` (QUANT_PROBES' float32 leaves as
    the checkpoint holds them). First, what the allocator holds with no
    engine alive."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from symbiont_tpu_torch.config import EngineConfig
    from symbiont_tpu_torch.engine.engine import TorchEngine
    from symbiont_tpu_torch.models import quant
    from symbiont_tpu_torch.ops import flash_attention as fa
    from symbiont_tpu_torch.utils.telemetry import metrics

    gc.collect()
    torch.cuda.empty_cache()
    census = allocator_census()
    workspaces = clear_cublas_workspaces()
    print(f"[memory] allocator with no engine alive, before [quant]: {census}; cuBLAS "
          f"workspaces among them {workspaces:,} (freed by clearing them)", flush=True)
    texts = synth_texts(rng, 512)
    base, parts, kernels, launches, held = None, [], [], 0, {}
    for mode in ("none", "f16", "int8", "fp8"):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eng = TorchEngine(EngineConfig(model_dir=str(mpnet_dir), attn_impl="flash",
                                       quantize=mode))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        allocated = torch.cuda.memory_allocated()
        label = quant.storage_label(eng.params)
        pbytes = metrics.gauge_get("engine.param_bytes", {"service": "engine", "dtype": label})
        want = expected_param_bytes(MPNET_MULTILINGUAL, mode)
        check(pbytes == want, f"{mode}: engine.param_bytes{{dtype={label}}} {pbytes} != {want}")
        held[mode] = pbytes
        codes = ""
        if mode in ("int8", "fp8"):
            for name, path in QUANT_PROBES.items():
                got = _leaf(eng.params, path)
                ref = quant.quantize_params({"w": host[name]}, mode)["w"]
                bad_q = int((got.q.cpu().view(torch.uint8) != ref.q.view(torch.uint8)).sum())
                bad_s = int((got.scale.cpu().view(torch.int32) != ref.scale.view(torch.int32)).sum())
                check(got.q.dtype == ref.q.dtype and bad_q == 0 and bad_s == 0,
                      f"{mode}: {name} made on the card differs from the CPU's in {bad_q} of "
                      f"{ref.q.numel()} codes and {bad_s} of {ref.scale.numel()} scales")
            codes = (f", codes and scales of {' and '.join(QUANT_PROBES)} bit-equal to the CPU's "
                     f"({got.q.dtype})")
        b0 = eng.stats["embed_batches"]
        fa.launches = 0  # ---------------------------------------------- main path
        emb = eng.embed_texts(texts)
        t0 = time.perf_counter()
        eng.embed_texts(texts)
        rate = len(texts) / (time.perf_counter() - t0)
        n = fa.launches  # ---------------------------------------------- main path end
        layers = eng.model_cfg.num_layers
        check(n == layers * (eng.stats["embed_batches"] - b0),
              f"{mode}: flash launches {n} != {layers} x {eng.stats['embed_batches'] - b0}")
        launches += n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.embed_texts(texts)
        events = prof.key_averages()
        busy_ms = sum(ms for _, ms, _ in top_kernels(events, len(events)))
        kernels.append(f"{mode}: " + "; ".join(f"{kernel_short(name)} {ms:.2f} ms x{calls}"
                                               for name, ms, calls in top_kernels(events)))
        check(bool(np.isfinite(emb).all()), f"{mode}: non-finite embeddings")
        if mode == "none":
            base, cos = emb, 1.0
        else:
            cos = float(_cosines(base, emb).min())
            check(cos >= QUANT_BARS[mode], f"{mode}: cosine vs none {cos:.5f} < {QUANT_BARS[mode]}")
        parts.append(f"{mode}: param_bytes{{dtype={label}}} {pbytes:,.0f} "
                     f"({pbytes / held['none']:.3f}x none), allocated after load {allocated:,}, "
                     f"load {load_s:.2f} s, {rate:.1f} emb/s, device time of one embed_texts "
                     f"{busy_ms:.1f} ms, cosine vs none min {cos:.6f}{codes}")
        del eng
    int8_ratio = held["int8"] / held["none"]
    check(int8_ratio <= 0.55, f"int8 holds {int8_ratio:.3f}x the bytes of none")
    print(f"[quant] multilingual mpnet checkpoint, flash, {len(texts)} texts (emb/s on the host "
          f"clock over a second call; device time under torch.profiler): " + "; ".join(parts)
          + f"; bars f16/int8 0.999, fp8 0.998", flush=True)
    print("[quant] largest kernels by self device time in one embed_texts: "
          + " | ".join(kernels), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches}


# ------------------------------------------------------------- generation

# The decoder checkpoints of BASELINE.md #5, as their hub config.json files
# give them, written from SEED at these widths (no download). The card has
# no `tokenizers`, so neither dir holds a tokenizer.json and the engine
# takes its byte tokenizer (ids 0..256) whatever the vocab.
TINYLLAMA_1B = dict(  # TinyLlama/TinyLlama-1.1B-Chat-v1.0
    model_type="llama", architectures=["LlamaForCausalLM"], vocab_size=32000,
    hidden_size=2048, num_hidden_layers=22, num_attention_heads=32, num_key_value_heads=4,
    intermediate_size=5632, max_position_embeddings=2048, rms_norm_eps=1e-5,
    rope_theta=10000.0, tie_word_embeddings=False)
GPT2_124M = dict(  # openai-community/gpt2
    model_type="gpt2", architectures=["GPT2LMHeadModel"], vocab_size=50257, n_embd=768,
    n_layer=12, n_head=12, n_positions=1024, layer_norm_epsilon=1e-5)
GEN_ROWS, GEN_NEW = 8, 64  # prompts per generate_batch, max_new_tokens
# flash vs plain prefill: next-token distribution cosine per row, the JAX
# package's bf16 decoder bar (tests/test_lm_engine.py)
GEN_COS_BAR = 0.995


def gpt_param_count(hf: dict) -> int:
    """Parameters of a GPT-2 or Llama geometry given as its config.json."""
    from symbiont_tpu_torch.models.gpt import GPTConfig

    c = GPTConfig.from_hf(hf)
    H, I, V, L = c.hidden_size, c.intermediate_size, c.vocab_size, c.num_layers
    if c.arch == "gpt2":  # tied head; every linear and LayerNorm has a bias
        layer = 4 * H + 4 * (H * H + H) + 2 * H * I + I + H
        return V * H + c.max_position_embeddings * H + 2 * H + L * layer
    kv = c.kv_heads * c.head_dim
    layer = 2 * H + 2 * H * H + 2 * H * kv + 3 * H * I
    return V * H * (1 if c.tie_word_embeddings else 2) + H + L * layer


def gpt_state_dict(params, cfg, dtype=torch.bfloat16) -> dict:
    """The inverse of `convert.convert_gpt`, under the names the hub's files
    use: GPT-2 under `transformer.*` with Conv1D weights `[in, out]` and q/k/v
    fused into `c_attn`; Llama under `model.*` with Linear weights `[out,
    in]`, and `lm_head` when untied. Values on the CPU in `dtype`: bf16
    tensors, float32 ones as numpy (what `write_safetensors` takes)."""
    def out(t):
        t = t.detach().to(dtype).contiguous().cpu()
        return t if dtype == torch.bfloat16 else t.numpy()

    sd = {}
    if cfg.arch == "gpt2":
        sd["transformer.wte.weight"] = out(params["wte"])
        sd["transformer.wpe.weight"] = out(params["wpe"])
        sd["transformer.ln_f.weight"] = out(params["ln_f"]["scale"])
        sd["transformer.ln_f.bias"] = out(params["ln_f"]["bias"])
        for i, layer in enumerate(params["layers"]):
            p = f"transformer.h.{i}"
            for hf, ours in (("ln_1", "ln1"), ("ln_2", "ln2")):
                sd[f"{p}.{hf}.weight"] = out(layer[ours]["scale"])
                sd[f"{p}.{hf}.bias"] = out(layer[ours]["bias"])
            qkv = [layer[n] for n in ("q", "k", "v")]
            sd[f"{p}.attn.c_attn.weight"] = out(torch.cat([x["kernel"] for x in qkv], 1))
            sd[f"{p}.attn.c_attn.bias"] = out(torch.cat([x["bias"] for x in qkv]))
            for hf, ours in (("attn.c_proj", layer["o"]), ("mlp.c_fc", layer["mlp"]["in"]),
                             ("mlp.c_proj", layer["mlp"]["out"])):
                sd[f"{p}.{hf}.weight"] = out(ours["kernel"])
                sd[f"{p}.{hf}.bias"] = out(ours["bias"])
        return sd
    sd["model.embed_tokens.weight"] = out(params["wte"])
    sd["model.norm.weight"] = out(params["ln_f"]["scale"])
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = out(layer["ln1"]["scale"])
        sd[f"{p}.post_attention_layernorm.weight"] = out(layer["ln2"]["scale"])
        for n in ("q", "k", "v", "o"):
            sd[f"{p}.self_attn.{n}_proj.weight"] = out(layer[n]["kernel"].T)
        for n in ("gate", "up", "down"):
            sd[f"{p}.mlp.{n}_proj.weight"] = out(layer["mlp"][n]["kernel"].T)
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = out(params["lm_head"]["kernel"].T)
    return sd


def write_gpt_checkpoint(out_dir, params, hf: dict, dtype=torch.bfloat16) -> float:
    """`params` as a hub-format model dir (config.json + model.safetensors in
    `dtype`) through the port's own safetensors writer; returns the file's
    size in bytes."""
    from symbiont_tpu_torch.models import convert
    from symbiont_tpu_torch.models.gpt import GPTConfig

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    convert.write_safetensors(out_dir / "model.safetensors",
                              gpt_state_dict(params, GPTConfig.from_hf(hf), dtype))
    (out_dir / "config.json").write_text(json.dumps(hf, indent=2))
    return (out_dir / "model.safetensors").stat().st_size


def ragged_prompts(rng, lo: int, hi: int, n: int) -> list[str]:
    """n ASCII prompts whose byte-tokenizer lengths (bytes + BOS) lie in
    (lo, hi], the last one exactly hi, so they fill the prompt bucket hi."""
    lens = list(rng.integers(lo + 1, hi + 1, n - 1)) + [hi]
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz "))
    return ["".join(rng.choice(letters, int(t) - 1)) for t in lens]


def left_pad_bias(lengths, S: int, device="cuda") -> torch.Tensor:
    """The LM prefill's float32 key bias [B, S]: prompts are right-aligned,
    so a row of length n has its padding first (-1e9) and its n real keys
    last (0)."""
    pos = torch.arange(S, device=device)[None, :]
    pad = S - torch.as_tensor(lengths, device=device)[:, None]
    return torch.where(pos >= pad, 0.0, -1e9).float().contiguous()


def real_query_rows(lengths, S: int, device="cuda") -> torch.Tensor:
    """[B, 1, S, 1] True on the query rows of real tokens: a right-aligned
    row of length n has its real queries last."""
    pad = S - torch.as_tensor(lengths, device=device)
    return (torch.arange(S, device=device)[None, :] >= pad[:, None])[:, None, :, None]


def real_rows_within(out, ref, real, tol: float) -> tuple[bool, float]:
    """B1's bar, |kernel - plain| <= tol + tol·|plain|, on the `real` query
    rows only → (within, max |err| there). A padding query under causal
    attention sees only masked keys: its value depends on the kernel's
    blocks, and no real token ever reads it (ROADMAP Queue C)."""
    err = (out.float() - ref.float()).abs()
    ok = (err <= tol + tol * ref.float().abs()) | ~real
    return bool(ok.all()), float(err.masked_fill(~real, 0).max())


def next_token_cosines(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Per row, the cosine of two next-token distributions (softmax of
    float32 logits [B, V])."""
    pa, pb = torch.softmax(a.float(), -1), torch.softmax(b.float(), -1)
    return ((pa * pb).sum(-1) / (pa.norm(dim=-1) * pb.norm(dim=-1))).cpu().numpy()


def causal_gqa_kernel_phase(timed: bool = True) -> dict:
    """B1 at the generate path's prefill shapes: TinyLlama's causal GQA,
    q [8, 32, S, 64] over k/v [8, 4, S, 64], bf16, left padding, against its
    plain version on the real query rows; timed beside SDPA (enable_gqa, a
    float mask with the causal and padding terms) and the bound."""
    from symbiont_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rng = np.random.default_rng(SEED + 7)
    rows = {}
    for S in (256, 1024):
        lens = list(rng.integers(S // 4, S + 1, GEN_ROWS - 1)) + [S]
        q = torch.randn((GEN_ROWS, 32, S, 64), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((GEN_ROWS, 4, S, 64), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        bias = left_pad_bias(lens, S)
        out, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=True)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, bias, causal=True)
        real = real_query_rows(lens, S)
        ok, err = real_rows_within(out, ref, real, 2e-2)
        lse_err = float((((lse - ref_lse).abs() / (1 + ref_lse.abs())) * real).max())
        check(bool(torch.isfinite(out.float()).all()), f"causal GQA S={S}: non-finite output")
        check(ok, f"causal GQA S={S}: max |kernel - plain| {err:.4g} on real rows over 0.02")
        check(lse_err <= 1e-4, f"causal GQA S={S}: lse relative error {lse_err:.3g} > 1e-4")
        row = {"label": f"causal_gqa_S{S}", "max_abs_err": err}
        line = (f"[kernels] flash_attn_fwd causal GQA q{tuple(q.shape)} k{tuple(k.shape)} bf16, "
                f"left padding, real query rows: max_abs_err {err:.4g} (tol 0.02 abs + 0.02 "
                f"rel), lse rel err {lse_err:.3g}")
        if timed:
            bound, bound_by = _bound_ms(q, k, v, bias, causal=True)
            ms = graph_ms(lambda: fa.flash_attention(q, k, v, bias, causal=True))
            plain = graph_ms(lambda: fa.flash_attention_reference(q, k, v, bias, causal=True),
                             iters=5)
            causal = torch.ones((S, S), dtype=torch.bool, device="cuda").tril()
            mask = torch.where(causal[None, None], bias[:, None, None, :], -1e9).bfloat16()
            lib = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True))
            row |= {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": lib}
            line += (f"; ms {ms:.4f} (graph replay), plain_ms {plain:.4f}, library_ms (SDPA, "
                     f"enable_gqa) {lib:.4f}, bound_ms {bound:.4f} ({bound_by}), "
                     f"{bound / ms:.1%} of bound")
        print(line, flush=True)
        rows[S] = row
        del q, k, v, bias, out, lse, ref, ref_lse, real
    torch.cuda.empty_cache()
    return rows


def _median_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of fn() over `reps` synchronised calls, after
    one untimed call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def generate_phase(rng, tmp) -> dict:
    """BASELINE.md #5 on the card: TinyLlama-1.1B and GPT-2 124M written from
    SEED in the hub's layout and served by LmEngine through `model_dir`
    (bf16, flash prefill). Each check fails the run: parameter bytes to the
    byte; per prompt bucket, greedy and sampled `generate_batch` of 8 ragged
    prompts at 64 new tokens with B1 launched exactly once per layer per
    call (the prefill) and never by a decode step; finite logits, tokens in
    the vocab, the same tokens from the same seed; flash against plain
    prefill at cosine > 0.995 per row. Printed, with no bar: load seconds,
    TTFT (prefill ms), decode ms per step and tok/s at batch 8 and 64 in
    turns, B1's share of one prefill's device time, and one generate_batch
    under torch.profiler."""
    import gc

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from symbiont_tpu_torch.config import LmConfig
    from symbiont_tpu_torch.engine.lm import LmEngine
    from symbiont_tpu_torch.models import gpt as gpt_mod
    from symbiont_tpu_torch.ops import flash_attention as fa
    from symbiont_tpu_torch.utils.telemetry import metrics

    tmp = Path(tmp)
    cfg = gpt_mod.GPTConfig.from_hf(TINYLLAMA_1B)
    n_params = gpt_param_count(TINYLLAMA_1B)
    t0 = time.perf_counter()
    params = gpt_mod.init_params(torch.Generator(device="cuda").manual_seed(SEED + 6), cfg)
    probes = {"wte[-4:]": (("wte",), slice(-4, None)),
              "layers[-1].k": (("layers", -1, "k", "kernel"), slice(None)),
              "lm_head[:, :8]": (("lm_head", "kernel"), (slice(None), slice(0, 8)))}
    written = {n: _leaf(params, p)[rows].to(torch.bfloat16) for n, (p, rows) in probes.items()}
    size = write_gpt_checkpoint(tmp / "tinyllama", params, TINYLLAMA_1B)
    write_s = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    eng = LmEngine(LmConfig(model_dir=str(tmp / "tinyllama"), dtype="bfloat16",
                            attn_impl="flash"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    mcfg, L = eng.model_cfg, eng.model_cfg.num_layers
    check(mcfg == dataclasses.replace(cfg, attn_impl="flash"), f"loaded geometry {mcfg}")
    gauge = metrics.gauge_get("lm.param_bytes", {"service": "lm", "dtype": "bfloat16"})
    check(eng.param_bytes() == gauge == 2 * n_params,
          f"TinyLlama param_bytes {eng.param_bytes()} (gauge {gauge}) != {2 * n_params}")
    for n, (p, rows) in probes.items():
        check(torch.equal(_leaf(eng.params, p)[rows], written[n]),
              f"engine's {n} != the written bf16 leaf")
    V = mcfg.vocab_size

    def device_prompts(prompts, rows=GEN_ROWS):
        ids, mask, new = eng._prepare_prompts(prompts, GEN_NEW, min_rows=rows)
        return eng._device_ids(ids), eng._device_ids(mask), new

    launches, per_bucket, lo, cached = 0, [], 0, {}
    for P in eng.config.prompt_buckets:
        prompts = ragged_prompts(rng, lo, P, GEN_ROWS)
        lo = P
        ids, mask, new = device_prompts(prompts)
        check(tuple(ids.shape) == (GEN_ROWS, P) and new == GEN_NEW,
              f"bucket {P}: prompts shaped {tuple(ids.shape)}, new bucket {new}")
        walls = []
        for temp in (0.0, 0.8):
            tok0 = eng.stats["tokens_generated"]
            fa.launches = 0  # ------------------------------------------ main path
            t0 = time.perf_counter()
            texts = eng.generate_batch(prompts, [GEN_NEW] * GEN_ROWS, temperature=temp)
            walls.append(time.perf_counter() - t0)
            n = fa.launches  # ------------------------------------------ main path end
            check(n == L, f"bucket {P}, temperature {temp}: B1 launches {n} != {L} per call")
            made = eng.stats["tokens_generated"] - tok0
            check(len(texts) == GEN_ROWS and made == GEN_ROWS * GEN_NEW,
                  f"bucket {P}: {made} tokens counted for {GEN_ROWS} x {GEN_NEW}")
            launches += n
        # the model's own functions: logits, tokens and seeds
        with torch.inference_mode():
            cache, logits, kv_valid, plen = gpt_mod.prefill(eng.params, ids, mask, mcfg, new)
            fa.launches = 0
            done = torch.zeros(GEN_ROWS, dtype=torch.bool, device="cuda")
            cache, last, *_ = gpt_mod.decode_chunk(eng.params, cache, logits, plen, done,
                                                   kv_valid, eng._new_generator(SEED), 4,
                                                   mcfg, 0.8, 40)
            check(fa.launches == 0, f"bucket {P}: B1 launched {fa.launches} x in 4 decode steps")
            check(bool(torch.isfinite(logits).all() and torch.isfinite(last).all()),
                  f"bucket {P}: non-finite logits")
            runs = [gpt_mod.generate(eng.params, ids, mask, eng._new_generator(SEED), mcfg,
                                     GEN_NEW, 0.8, 40)[0] for _ in range(2)]
            check(torch.equal(runs[0], runs[1]), f"bucket {P}: one seed, two token streams")
            check(int(runs[0].min()) >= 0 and int(runs[0].max()) < V,
                  f"bucket {P}: tokens outside the vocab")
            if P in (256, 1024):
                cached[P] = (ids, mask, logits)
            del cache, last, kv_valid, runs
        per_bucket.append(f"P={P}: greedy {walls[0]:.2f} s, sampled {walls[1]:.2f} s")

    # check 3: flash against plain prefill, and TTFT of both
    eng_x = LmEngine(dataclasses.replace(eng.config, attn_impl="xla"), params=eng.params,
                     model_cfg=mcfg, tokenizer=eng.tokenizer)
    cos, ttft = {}, {}
    with torch.inference_mode():
        for P, (ids, mask, logits) in cached.items():
            plain = gpt_mod.prefill(eng_x.params, ids, mask, eng_x.model_cfg, GEN_NEW)[1]
            cos[P] = next_token_cosines(logits, plain)
            check(float(cos[P].min()) > GEN_COS_BAR,
                  f"P={P}: flash vs plain next-token cosine {cos[P].min():.5f}")
            for name, e in (("flash", eng), ("plain", eng_x)):
                ttft[P, name] = _median_ms(lambda e=e: gpt_mod.prefill(
                    e.params, ids, mask, e.model_cfg, GEN_NEW))
    del eng_x

    # decode speed at batch 8 and 64 after a flash prefill of the 1024
    # bucket, read in turns (8, 64, 8, 64): the step is host-bound
    steps, runs, decode = 16, {}, {}
    long_prompts = ragged_prompts(rng, 256, 1024, 64)
    with torch.inference_mode():
        for rows in (GEN_ROWS, 64):
            ids, mask, new = device_prompts(long_prompts[:rows], rows)
            state = gpt_mod.prefill(eng.params, ids, mask, mcfg, new)
            done = torch.zeros(rows, dtype=torch.bool, device="cuda")

            def run(state=state, done=done, P=ids.shape[1]):
                cache, logits, kv_valid, plen = state
                gpt_mod.decode_chunk(eng.params, cache._replace(length=P), logits, plen, done,
                                     kv_valid, eng._new_generator(SEED), steps, mcfg, 0.0, 0)

            runs[rows] = (run, gpt_mod.cache_bytes(state[0]))
        for rows in (GEN_ROWS, 64, GEN_ROWS, 64):
            ms = _median_ms(runs[rows][0]) / steps
            decode.setdefault(rows, []).append((ms, rows * 1e3 / ms))
        kv_bytes = {rows: kv for rows, (_, kv) in runs.items()}
        del runs

    # one prefill of the longest bucket under the profiler: B1's share
    ids, mask, logits = cached[max(cached)]
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gpt_mod.prefill(eng.params, ids, mask, mcfg, GEN_NEW)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    prefill_ms = sum(e.self_device_time_total for e in events) / 1e3
    b1_ms = sum(e.self_device_time_total for e in events if "flash_fwd" in e.key) / 1e3
    check(prefill_ms > 0, "the profiler saw no device time in a prefill")

    # one generate_batch under the profiler: the device's busy share
    prompts = ragged_prompts(rng, 64, 256, GEN_ROWS)
    eng.generate_batch(prompts, [GEN_NEW] * GEN_ROWS, temperature=0.0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate_batch(prompts, [GEN_NEW] * GEN_ROWS, temperature=0.0)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    top = "; ".join(f"{kernel_short(name, 80)} {ms:.2f} ms x{calls}"
                    for name, ms, calls in top_kernels(events))
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[generate] TinyLlama-1.1B geometry (llama, vocab {V:,}, {L} layers, "
          f"{mcfg.num_heads} heads over {mcfg.kv_heads} KV heads of {mcfg.head_dim}, "
          f"{n_params:,} parameters) from seed {SEED}: model.safetensors (bf16) "
          f"{size / 1e9:.2f} GB written in {write_s:.2f} s, LmEngine(model_dir, bf16, flash) "
          f"loaded in {load_s:.2f} s; param_bytes {2 * n_params:,} (lm.param_bytes gauge "
          f"equal), leaves read back bit-equal; generate_batch of {GEN_ROWS} ragged prompts x "
          f"{GEN_NEW} new tokens per prompt bucket, host clock: " + ", ".join(per_bucket)
          + f"; B1 launches {L} per call (one prefill) and 0 in decode steps; logits finite, "
          f"sampled tokens repeat under one seed", flush=True)
    print("[generate] flash vs plain prefill, next-token cosine per row (bar > "
          f"{GEN_COS_BAR}): " + ", ".join(f"P={P} min {c.min():.6f}" for P, c in cos.items())
          + "; TTFT (prefill ms, host clock, median of 3): " + ", ".join(
              f"P={P} {name} {ms:.2f}" for (P, name), ms in ttft.items()), flush=True)
    print(f"[generate] decode after a flash prefill of the 1024 bucket, {steps} greedy steps, "
          "read in turns 8, 64, 8, 64 (host clock, median of 3): " + ", ".join(
              f"batch {b}: " + " and ".join(f"{ms:.2f} ms/step ({tps:,.0f} tok/s)"
                                            for ms, tps in r)
              + f", KV cache {kv_bytes[b] / 1e9:.2f} GB" for b, r in decode.items())
          + f"; one prefill of the {max(cached)} bucket: device time {prefill_ms:.2f} ms, B1 "
          f"{b1_ms:.3f} ms ({b1_ms / prefill_ms:.2%})", flush=True)
    print(f"[generate] one generate_batch ({GEN_ROWS} prompts in the 256 bucket, {GEN_NEW} "
          f"new) under torch.profiler: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({busy_ms / wall_ms:.1%} of wall); top kernels: {top}", flush=True)

    # GPT-2 124M: float32 safetensors as the hub ships it, tied head, no GQA
    g2 = gpt_mod.GPTConfig.from_hf(GPT2_124M)
    n2 = gpt_param_count(GPT2_124M)
    params = gpt_mod.init_params(torch.Generator(device="cuda").manual_seed(SEED + 8), g2)
    size2 = write_gpt_checkpoint(tmp / "gpt2", params, GPT2_124M, torch.float32)
    del params
    t0 = time.perf_counter()
    eng = LmEngine(LmConfig(model_dir=str(tmp / "gpt2"), dtype="bfloat16", attn_impl="flash"))
    torch.cuda.synchronize()
    load2_s = time.perf_counter() - t0
    check(eng.param_bytes() == 2 * n2, f"GPT-2 param_bytes {eng.param_bytes()} != {2 * n2}")
    prompts = ragged_prompts(rng, 16, 64, GEN_ROWS)
    tok0 = eng.stats["tokens_generated"]
    fa.launches = 0  # ---------------------------------------------------- main path
    t0 = time.perf_counter()
    eng.generate_batch(prompts, [GEN_NEW] * GEN_ROWS, temperature=0.8)
    wall2 = time.perf_counter() - t0
    n = fa.launches  # ---------------------------------------------------- main path end
    check(n == eng.model_cfg.num_layers, f"GPT-2: B1 launches {n} != {eng.model_cfg.num_layers}")
    check(eng.stats["tokens_generated"] - tok0 == GEN_ROWS * GEN_NEW, "GPT-2 token count")
    launches += n
    with torch.inference_mode():
        ids, mask, new = eng._prepare_prompts(prompts, GEN_NEW)
        logits = gpt_mod.prefill(eng.params, eng._device_ids(ids), eng._device_ids(mask),
                                 eng.model_cfg, new)[1]
    check(bool(torch.isfinite(logits).all()), "GPT-2: non-finite logits")
    print(f"[generate] GPT-2 124M geometry (vocab {g2.vocab_size:,}, tied head, {n2:,} "
          f"parameters): model.safetensors (float32) {size2 / 1e9:.2f} GB, loaded in "
          f"{load2_s:.2f} s, param_bytes {2 * n2:,}; generate_batch of {GEN_ROWS} prompts in "
          f"the {ids.shape[1]} bucket x {GEN_NEW} new, sampled: {wall2:.2f} s; B1 launches {n} "
          f"= {eng.model_cfg.num_layers} per prefill; logits finite", flush=True)
    del eng, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches,
            "ttft": {f"P{P}_{name}": ms for (P, name), ms in ttft.items()},
            "decode": {f"batch{b}": [{"ms_per_step": ms, "tok_s": tps} for ms, tps in r]
                       for b, r in decode.items()},
            "prefill_1024": {"device_ms": prefill_ms, "flash_attn_fwd_ms": b1_ms}}


# ---------------------------------------------------------------- session

# [session]'s sizes on the card: the stream's prompt bucket (lo, hi] and new
# tokens, the chunk, the session's and GPT-2's prompt buckets, and the
# batcher's waves (the first wave's budgets, the later waves')
SESSION = dict(stream_bucket=(256, 1024), new=64, chunk=16, session_bucket=(64, 256),
               gpt2_bucket=(16, 64), batcher_bucket=(16, 64),
               first_wave=(24, 32, 40, 48, 56, 64, 64, 64),
               later_waves=(16, 16, 16, 16, 64, 48, 32, 16), waves=3, wave_gap_s=0.05,
               max_batch=8)
# a token that differs from the standalone decode passes only at a near-tie:
# the standalone's top-2 logit gap under this share of the logits' largest |x|
TIE_SHARE = 1e-4


class IdTokenizer:
    """Bytes in, as the port's byte tokenizer encodes them (ids 0..255, BOS
    256), and every id of the model's vocabulary out, as its number in
    brackets: the card has no `tokenizers` package to read a hub
    tokenizer.json with, and the byte tokenizer's decode drops every id past
    255, which is nearly all that a random-weight 32,000-id model samples,
    so its text would be empty."""

    bos_id = pad_id = 256

    def encode(self, text: str, max_len: int) -> list:
        return ([self.bos_id] + list(text.encode("utf-8")))[:max_len]

    def decode(self, ids) -> str:
        return "".join(f"[{int(i)}]" for i in ids)


def greedy_trace(eng, prompt: str, max_new: int) -> tuple[list, list]:
    """The standalone greedy decode of one prompt, step by step →
    (tokens, per step (top-2 logit gap, largest |logit|)). The same ops in
    the same order as `eng.generate`, one `decode_chunk` step at a time."""
    from symbiont_tpu_torch.models import gpt as gpt_mod

    ids, mask, new = eng._prepare_prompts([prompt], max_new)
    tokens, gaps = [], []
    with torch.inference_mode():
        cache, logits, kv_valid, pos = eng._prefill(eng.params, ids, mask, new)
        done = torch.zeros((1,), dtype=torch.bool, device=eng.device)
        gen = eng._new_generator(SEED)
        for _ in range(max_new):
            top2 = logits[0].topk(2).values
            gaps.append((float(top2[0] - top2[1]), float(logits[0].abs().max())))
            cache, logits, pos, done, tok, _ = gpt_mod.decode_chunk(
                eng.params, cache, logits, pos, done, kv_valid, gen, 1, eng.model_cfg, 0.0, 0)
            tokens.append(int(tok[0, 0]))
    return tokens, gaps


def b1_against_plain(rng, B: int, mc, S: int, device="cuda", tag="session",
                     lens=None) -> None:
    """B1 at one LM prefill shape (causal, left-padded, the model's heads and
    dtype) against its plain version on the real query rows, out and lse,
    printed under `tag`; its launch is not counted. `lens` gives the rows'
    real lengths (default: one full row, the others drawn)."""
    from symbiont_tpu_torch.models.bert import torch_dtype
    from symbiont_tpu_torch.ops import flash_attention as fa

    NH, NKV, D, dtype = mc.num_heads, mc.kv_heads, mc.head_dim, torch_dtype(mc.dtype)
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    lens = list(lens) if lens is not None else [S] + list(rng.integers(1, S + 1, B - 1))
    q = torch.randn((B, NH, S, D), generator=gen, device=device).to(dtype)
    k, v = (torch.randn((B, NKV, S, D), generator=gen, device=device).to(dtype)
            for _ in range(2))
    bias = left_pad_bias(lens, S, device)
    before = fa.launches
    out, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=True)
    fa.launches = before
    ref, ref_lse = fa.flash_attention_reference(q, k, v, bias, True)
    real = real_query_rows(lens, S, device)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    ok, err = real_rows_within(out, ref, real, tol)
    lse_err = float(((lse - ref_lse).abs() / (1 + ref_lse.abs())).masked_fill(~real, 0).max())
    name = (f"causal q[{B}, {NH}, {S}, {D}] over {NKV} KV heads, {mc.dtype}"
            + ("" if lens[0] == S else f", {lens[0]} real rows"))
    check(ok, f"B1 {name}: |kernel - plain| {err:.4g} over {tol}")
    check(lse_err <= 1e-4, f"B1 {name}: lse relative error {lse_err:.3g} > 1e-4")
    print(f"[{tag}] flash_attn_fwd {name}: max_abs_err {err:.4g} on real query rows "
          f"(tol {tol} abs + {tol} rel), lse rel err {lse_err:.3g}", flush=True)


def session_phase(rng, tmp, sizes=None, device="cuda", lm_kw=None) -> dict:
    """ROADMAP A11's rest on the card, on the TinyLlama-1.1B and GPT-2 dirs
    `generate_phase` wrote (bf16, flash prefill; GPT-2 also at float32).
    Each check fails the run:

    - B1 against its plain version at this path's prefill shapes (a stream
      row at its bucket, a session of 4 rows, one admission row);
    - `generate_stream` of one prompt in the 1024 bucket, 64 new tokens in
      chunks of 16: its deltas join to `generate()`'s text, there is more
      than one, and B1 launches once per layer (the prefill) and never in a
      chunk;
    - `GenBatcher`: 24 requests at max_batch 8 in three waves 50 ms apart on
      one asyncio loop; every future resolves to text, some join a running
      session (`admitted_midflight` > 0), and B1 launches once per layer
      per prefill (session starts and admissions);
    - a session of 3 ragged prompts (bb 4) steps one chunk; a newcomer
      prefills on a second thread while `step()` runs here, then is
      spliced: its carried logits row equals its own prefill's bit for bit;
      B1 launches once per layer per session start and admission prefill
      and never in a `step()`; the `lm.kv_cache` claim and
      `lm.kv_cache_bytes` equal the session cache's bytes; `cancel_tag`
      drops `lm.kv_rows_active` by one; the timeline has step, admit,
      finish and cancel events;
    - GPT-2 at float32: every row of a session with one admission is
      token-identical to its standalone decode, or differs first where the
      standalone's top-2 gap is a near-tie (< TIE_SHARE of the logits'
      largest |x|), which is reported.

    Printed with no bar: the stream's times to its first and last delta,
    the batcher's tok/s, `lm.ttft_ms` p50/p95, `lm.tpot_ms` p50 and the
    timeline's decode summary, and the device's busy share of one session
    under torch.profiler. Text is decoded by `IdTokenizer`. `sizes`,
    `device` and `lm_kw` let the CPU tests rehearse it at tiny
    geometries."""
    import gc
    import threading

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from symbiont_tpu_torch.config import LmConfig
    from symbiont_tpu_torch.engine.lm import LmEngine
    from symbiont_tpu_torch.models import gpt as gpt_mod
    from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
    from symbiont_tpu_torch.obs.hbm import hbm_ledger
    from symbiont_tpu_torch.obs.xprof import dispatch_ledger
    from symbiont_tpu_torch.ops import flash_attention as fa
    from symbiont_tpu_torch.utils.telemetry import metrics

    s = {**SESSION, **(sizes or {})}
    lm_kw = dict(lm_kw or {})
    cuda = device == "cuda"
    tmp = Path(tmp)
    chunk, new = s["chunk"], s["new"]

    def prefills() -> int:
        return sum(r["dispatches"] for r in dispatch_ledger.snapshot()
                   if r["executable"].startswith("lm.prefill["))

    eng = LmEngine(LmConfig(model_dir=str(tmp / "tinyllama"), dtype="bfloat16",
                            attn_impl="flash", stream_chunk=chunk, **lm_kw),
                   tokenizer=IdTokenizer())
    L = eng.model_cfg.num_layers
    labels = {"service": "lm", "kv_dtype": eng.model_cfg.dtype}
    # every prefill shape below: the stream's row, the session's start and
    # admission, the batcher's starts and admissions (1 to max_batch rows,
    # in powers of two) and the profiled session
    shapes = [(1, s["stream_bucket"][1]), (4, s["session_bucket"][1]),
              (1, s["session_bucket"][1])]
    shapes += [(1 << i, s["batcher_bucket"][1]) for i in range(s["max_batch"].bit_length())]
    for B, S in shapes:
        b1_against_plain(rng, B, eng.model_cfg, S, device)
    counted = 0  # B1 launches on this phase's main path

    # -- generate_stream
    prompt = ragged_prompts(rng, *s["stream_bucket"], 1)[0]
    seen, deltas = [], []
    fa.launches = 0  # ---------------------------------------------------- main path
    text = eng.generate(prompt, new, temperature=0.0)  # the reference, and a warm-up
    counted += fa.launches
    fa.launches = 0
    t0 = time.perf_counter()
    for d in eng.generate_stream(prompt, new, temperature=0.0):
        seen.append((time.perf_counter() - t0, fa.launches))
        deltas.append(d)
    stream_launches = fa.launches  # ----------------------------------------- main path end
    counted += stream_launches
    check(stream_launches == L and all(n == L for _, n in seen),
          f"stream: B1 launches {[n for _, n in seen]} by delta, {stream_launches} in all "
          f"(want {L}, all in the prefill)")
    check("".join(deltas) == text, "stream: the joined deltas are not generate()'s text")
    check(len(deltas) > 1, f"stream: {len(deltas)} delta")
    first_ms, last_ms = seen[0][0] * 1e3, seen[-1][0] * 1e3
    print(f"[session] generate_stream of a {s['stream_bucket'][1]}-token prompt, {new} new "
          f"tokens in chunks of {chunk}, greedy: {len(deltas)} deltas joined = generate()'s "
          f"text; first delta {first_ms:.1f} ms, last {last_ms:.1f} ms (host clock, after "
          f"one generate() of the same prompt); B1 launches {stream_launches} (the prefill), 0 "
          f"per chunk", flush=True)

    # -- GenBatcher: 24 requests in three waves
    waves = []
    for w in range(s["waves"]):
        budgets = s["first_wave"] if w == 0 else s["later_waves"]
        waves.append(list(zip(ragged_prompts(rng, *s["batcher_bucket"], len(budgets)),
                              budgets)))

    engine_timeline.clear()
    tok0, prefills0 = eng.stats["tokens_generated"], prefills()
    fa.launches = 0  # ---------------------------------------------------- main path
    texts, bstats, batch_s = serve_batcher(eng, waves, s["max_batch"], s["wave_gap_s"])
    batch_launches = fa.launches  # ------------------------------------------ main path end
    counted += batch_launches
    n_prefills = prefills() - prefills0
    n_req = sum(len(w) for w in waves)
    toks = eng.stats["tokens_generated"] - tok0
    check(len(texts) == n_req and all(isinstance(t, str) for t in texts),
          f"GenBatcher: {sum(isinstance(t, str) for t in texts)} of {n_req} futures gave text")
    check(bstats["admitted_midflight"] > 0, f"GenBatcher: nothing joined a running session "
                                            f"({bstats})")
    check(batch_launches == L * n_prefills,
          f"GenBatcher: B1 launches {batch_launches} != {L} x {n_prefills} prefills")
    ttft = metrics.histogram_summary("lm.ttft_ms", {"service": "lm"})
    tpot = metrics.histogram_summary("lm.tpot_ms", {"service": "lm"})
    summ = engine_timeline.summary()
    decode = {k: v for k, v in summ.items() if k.startswith("decode_")}
    print(f"[session] GenBatcher: {n_req} requests at max_batch {s['max_batch']} in "
          f"{s['waves']} waves {s['wave_gap_s'] * 1e3:.0f} ms apart: {bstats['sessions']} "
          f"sessions, {bstats['admitted_midflight']} admitted mid-flight, {toks} tokens in "
          f"{batch_s:.2f} s = {toks / batch_s:.1f} tok/s (host clock); lm.ttft_ms p50 "
          f"{ttft['p50']:.1f} p95 {ttft['p95']:.1f} ({ttft['count']} rows), lm.tpot_ms p50 "
          f"{tpot['p50']:.2f} ({tpot['count']} chunks); B1 launches {batch_launches} = {L} x "
          f"{n_prefills} prefills; timeline: {decode}; dominant stall: "
          f"{summ['dominant_stall']}", flush=True)

    # -- one session, one admission on a second thread
    engine_timeline.clear()
    prompts = ragged_prompts(rng, *s["session_bucket"], 3)
    newcomer = ragged_prompts(rng, *s["session_bucket"], 1)[0]
    fa.launches = 0  # ---------------------------------------------------- main path
    sess = eng.start_session(prompts, [new] * 3, temperature=0.0)
    start_launches = fa.launches
    check((sess.bb, sess.P, sess.capacity()) == (4, s["session_bucket"][1], 1),
          f"session: bb {sess.bb}, P {sess.P}, capacity {sess.capacity()}")
    sess.step()  # one chunk: the admitted row will have a gap
    step_launches = [fa.launches - start_launches]
    box = {}

    def prepare():
        try:
            box["prep"] = sess.prepare_admit([newcomer], [new - 2 * chunk], temperature=[0.0])
        except Exception as e:  # read on the main thread
            box["error"] = e

    before = fa.launches
    th = threading.Thread(target=prepare)
    th.start()
    sess.step()  # decodes here while the newcomer prefills there
    th.join(timeout=600)
    check(not th.is_alive(), "prepare_admit did not finish")
    if "error" in box:
        raise box["error"]
    admit_launches = fa.launches - before
    (tag,) = sess.splice(box["prep"])
    check(tag == 3, f"splice gave tag {tag}")
    row = next(i for i, r in enumerate(sess.rows) if r is not None and r.tag == tag)
    session_launches = fa.launches  # ----------------------------------------- main path end
    counted += session_launches
    check(start_launches == L and admit_launches == L and step_launches == [0],
          f"session: B1 launches {start_launches} at start, {admit_launches} for the admission "
          f"prefill and a step, {step_launches} in a step (want {L}, {L}, [0])")
    ids = np.full((1, sess.P), getattr(eng.tokenizer, "pad_id", 0), np.int32)
    mask = np.zeros((1, sess.P), np.int32)
    own = eng.tokenizer.encode(newcomer, 1 << 30)[-sess.P:]  # as prepare_admit trims it
    ids[0, :len(own)], mask[0, :len(own)] = own, 1
    # the admission bytes forecast, read before the newcomer's prefill is
    # run again alone: there it is measured, with the allocator's peak reset
    forecast, headroom = eng._admit_bytes_forecast(1), eng.hbm_headroom_bytes()
    rejects = metrics.get("lm.admit_hbm_rejects")
    check(eng.can_admit(1) and metrics.get("lm.admit_hbm_rejects") == rejects,
          f"lm.can_admit(1) refused a row: forecast {forecast:,} bytes, headroom {headroom}")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(eng.device)
        live0 = torch.cuda.memory_allocated(eng.device)
    before = fa.launches
    with torch.inference_mode():
        alone = eng._prefill(eng.params, ids, mask, sess.new_bucket, note_peak=False)[1][0]
    fa.launches = before  # a comparison, not the main path
    admit_bytes = torch.cuda.max_memory_allocated(eng.device) - live0 if cuda else None
    if cuda:
        check(forecast >= admit_bytes, f"the bytes forecast for one admission, {forecast:,}, is "
                                       f"under what its prefill took, {admit_bytes:,}")
    print(f"[session] admission bytes: forecast for one row {forecast:,} (scratch term "
          f"{eng._prefill_peak_growth:,}), headroom {headroom if headroom is None else f'{headroom:,}'}"
          f", lm.can_admit(1) admits; the newcomer's prefill alone peaks "
          + (f"{admit_bytes:,} bytes above live" if cuda else "not measured (no card)"),
          flush=True)
    check(torch.equal(sess._logits[row], alone),
          f"spliced row's logits differ from its own prefill by "
          f"{float((sess._logits[row] - alone).abs().max()):.3g}")
    nbytes = gpt_mod.cache_bytes(sess._cache)
    claim = sum(r["bytes"] for r in hbm_ledger.rows() if r["subsystem"] == "lm.kv_cache")
    gauge = metrics.gauge_get("lm.kv_cache_bytes", labels)
    check(claim == gauge == nbytes, f"lm.kv_cache claim {claim}, gauge {gauge}, cache {nbytes}")
    active = metrics.gauge_get("lm.kv_rows_active", labels)
    check(sess.cancel_tag(0), "cancel_tag(0) found no row")
    check(metrics.gauge_get("lm.kv_rows_active", labels) == active - 1,
          f"lm.kv_rows_active {active} -> {metrics.gauge_get('lm.kv_rows_active', labels)}")
    while not sess.done():
        sess.step()
    kinds = {e["kind"] for e in engine_timeline.events()}
    check({"step", "admit", "finish", "cancel"} <= kinds, f"timeline kinds {sorted(kinds)}")
    print(f"[session] start_session of 3 ragged prompts in the {sess.P} bucket (bb {sess.bb}), "
          f"one chunk, then prepare_admit on a second thread beside step() and splice: the "
          f"spliced row's logits equal its own prefill's bit for bit; B1 launches {L} at the "
          f"start, {L} for the admission, 0 per step; lm.kv_cache claim = lm.kv_cache_bytes = "
          f"{nbytes:,} bytes of cache; cancel_tag dropped lm.kv_rows_active {active} -> "
          f"{active - 1}; timeline kinds {sorted(kinds)}", flush=True)

    # -- one session under the profiler: the device's busy share
    busy = None
    prompts = ragged_prompts(rng, *s["batcher_bucket"], s["max_batch"])
    fa.launches = 0  # ---------------------------------------------------- main path
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sess = eng.start_session(prompts, [new] * len(prompts), temperature=0.0)
        while not sess.done():
            sess.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof_launches = fa.launches  # ------------------------------------------- main path end
    counted += prof_launches
    check(prof_launches == L, f"profiled session: B1 launches {prof_launches} != {L}")
    if cuda:
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3
        check(busy > 0, "the profiler saw no device time in a session")
    print(f"[session] one session of {len(prompts)} prompts x {new} new under torch.profiler: "
          f"wall {wall_ms:.1f} ms, device busy "
          + (f"{busy:.1f} ms ({busy / wall_ms:.1%} of wall)" if busy is not None
             else "not measured (no card)"), flush=True)
    tinyllama = (eng.params, eng.model_cfg)  # for [paged] and [spec]: no second load
    del eng, sess
    gc.collect()

    # -- GPT-2 at float32: every session row against its standalone decode
    eng = LmEngine(LmConfig(model_dir=str(tmp / "gpt2"), dtype="float32", attn_impl="flash",
                            stream_chunk=chunk, **lm_kw), tokenizer=IdTokenizer())
    L2 = eng.model_cfg.num_layers
    for B in (4, 1):  # the session's start and admission, and the standalone decodes
        b1_against_plain(rng, B, eng.model_cfg, s["gpt2_bucket"][1], device)
    prompts = ragged_prompts(rng, *s["gpt2_bucket"], 4)
    wants = [new, new - chunk, new, new - 2 * chunk]
    fa.launches = 0  # ---------------------------------------------------- main path
    sess = eng.start_session(prompts[:3], wants[:3], temperature=0.0)
    rows = {r.tag: r for r in sess.rows if r is not None}
    sess.step()
    (tag,) = sess.admit(prompts[3:], wants[3:], temperature=[0.0])
    rows[tag] = next(r for r in sess.rows if r is not None and r.tag == tag)
    while not sess.done():
        sess.step()
    g2_launches = fa.launches  # --------------------------------------------- main path end
    counted += g2_launches
    check(g2_launches == 2 * L2, f"GPT-2 session: B1 launches {g2_launches} != 2 x {L2}")
    ties = []
    for t, (p, w) in enumerate(zip(prompts, wants)):
        before = fa.launches
        want, gaps = greedy_trace(eng, p, w)
        fa.launches = before  # comparisons, not the main path
        got = rows[t].tokens
        check(len(got) == w, f"GPT-2 row {t}: {len(got)} tokens for a budget of {w}")
        diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if diff is not None:
            gap, scale = gaps[diff]
            check(gap < TIE_SHARE * scale,
                  f"GPT-2 row {t} differs from its standalone decode at step {diff}, where "
                  f"the standalone's top-2 gap is {gap:.3g} (bar {TIE_SHARE} x {scale:.3g})")
            ties.append(f"row {t} step {diff}: top-2 gap {gap:.3g} of |logit| {scale:.3g}")
    print(f"[session] GPT-2 124M at float32 (flash prefill): a session of 3 prompts in the "
          f"{sess.P} bucket plus one admitted after one chunk, every row against its "
          f"standalone greedy decode: " + ("token-identical" if not ties else
                                           "near-ties " + "; ".join(ties))
          + f"; B1 launches {g2_launches} = 2 x {L2}", flush=True)
    del eng, sess
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"launches": counted, "stream": {"first_delta_ms": first_ms, "last_delta_ms": last_ms},
            "batcher": {"tok_s": toks / batch_s, "ttft_ms_p50": ttft["p50"],
                        "ttft_ms_p95": ttft["p95"], "tpot_ms_p50": tpot["p50"],
                        "admitted_midflight": bstats["admitted_midflight"],
                        "sessions": bstats["sessions"]},
            "session_busy_pct": None if busy is None else 100.0 * busy / wall_ms,
            "admit_bytes": {"forecast_1_row": forecast, "headroom": headroom,
                            "prefill_peak_above_live": admit_bytes},
            "gpt2_near_ties": ties, "tinyllama": tinyllama}


# ------------------------------------------------------------ paged, spec

# [paged]'s and [spec]'s sizes on the card: the sessions' prompt bucket
# (lo, hi], new tokens, chunk, the partial hit's shared prefix, the KV page,
# the drafts a round, and the verify check's rows and cache length
PAGED = dict(bucket=(128, 256), new=64, chunk=16, prefix=128, page=16, spec_k=8,
             verify_rows=8, verify_cache=1024)
# JackFram/llama-68m's config.json: a llama drafter over the Llama-2
# tokenizer's 32,000 ids, which TinyLlama shares; the hub ships float32
LLAMA_68M = dict(
    model_type="llama", architectures=["LlamaForCausalLM"], vocab_size=32000, hidden_size=768,
    num_hidden_layers=2, num_attention_heads=12, num_key_value_heads=12,
    intermediate_size=3072, max_position_embeddings=2048, rms_norm_eps=1e-6,
    tie_word_embeddings=False)


def drive_session(eng, prompts, wants, admit=None, cancel_after=None) -> dict:
    """One greedy session of `prompts` driven to its end; `admit` = (prompt,
    want) joins after the first step(), `cancel_after` = n cancels tag 0
    after step n. → its rows' tokens by tag (a cancelled row left out), the
    start's host ms (synchronised), each step()'s host ms, B1 launches at
    the start, in step() calls and in the admission, and, paged, the peak
    pages live and the largest `kv.page_fragmentation_pct` read after a
    step."""
    from symbiont_tpu_torch.kv.pool import kv_dtype_label
    from symbiont_tpu_torch.ops import flash_attention as fa
    from symbiont_tpu_torch.utils.telemetry import metrics

    labels = {"service": "lm",
              "kv_dtype": kv_dtype_label(eng.model_cfg.dtype, eng.model_cfg.kv_quant)}
    cuda = eng.device.type == "cuda"
    before, t0 = fa.launches, time.perf_counter()
    sess = eng.start_session(prompts, wants, temperature=0.0)
    if cuda:
        torch.cuda.synchronize()
    out = {"start_ms": (time.perf_counter() - t0) * 1e3, "step_ms": [], "peak_pages": 0,
           "frag_pct": 0.0, "launches": {"start": fa.launches - before, "steps": 0, "admit": 0},
           "session": sess}
    rows = {r.tag: r for r in sess.rows if r is not None}
    while not sess.done():
        before, t0 = fa.launches, time.perf_counter()
        sess.step()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"]["steps"] += fa.launches - before
        if eng.pool is not None:
            out["peak_pages"] = max(out["peak_pages"], eng.pool.pages_live)
            out["frag_pct"] = max(out["frag_pct"],
                                  metrics.gauge_get("kv.page_fragmentation_pct", labels))
        n = len(out["step_ms"])
        if n == 1 and admit is not None:
            before = fa.launches
            (tag,) = sess.admit([admit[0]], [admit[1]], temperature=[0.0])
            out["launches"]["admit"] = fa.launches - before
            rows[tag] = next(r for r in sess.rows if r is not None and r.tag == tag)
        if n == cancel_after:
            check(sess.cancel_tag(0), "cancel_tag(0) found no row")
            rows.pop(0)
    out["tokens"] = {t: list(r.tokens) for t, r in rows.items()}
    return out


def timeline_latency(events) -> dict:
    """TTFT p50/p95 over the finish events and TPOT p50 over the step
    events of a window, nearest rank as the engine's histograms take them."""
    def q(vals, p):
        vals = sorted(vals)
        return vals[min(len(vals) - 1, int(p * len(vals)))] if vals else 0.0

    ttft = [e["ttft_ms"] for e in events if e["kind"] == "finish" and "ttft_ms" in e]
    tpot = [e["wall_ms"] / e["steps"] for e in events if e["kind"] == "step" and e["steps"]]
    return {"ttft_ms_p50": q(ttft, 0.5), "ttft_ms_p95": q(ttft, 0.95), "tpot_ms_p50": q(tpot, 0.5)}


def serve_batcher(eng, waves, max_batch: int, wave_gap_s: float):
    """`GenBatcher` over `waves` of (prompt, budget) pairs, greedy, on one
    asyncio loop, waves `wave_gap_s` apart → (texts, batcher stats, host
    seconds)."""
    import asyncio

    from symbiont_tpu_torch.engine.batcher import GenBatcher

    async def serve():
        b = GenBatcher(eng, max_batch=max_batch)
        await b.start()
        try:
            tasks = []
            for w, wave in enumerate(waves):
                if w:
                    await asyncio.sleep(wave_gap_s)
                tasks += [asyncio.ensure_future(b.generate(p, int(n), temperature=0.0))
                          for p, n in wave]
            return await asyncio.gather(*tasks), dict(b.stats)
        finally:
            await b.close()

    t0 = time.perf_counter()
    texts, stats = asyncio.run(serve())
    return texts, stats, time.perf_counter() - t0


def paged_phase(rng, tmp, tinyllama, dense_batcher=None, sizes=None, device="cuda",
                lm_kw=None) -> dict:
    """ROADMAP A12 on the card: TinyLlama-1.1B (`tinyllama` = the params and
    config [session] loaded, bf16, flash) with `kv_layout="paged"`, pages of
    16 tokens, the radix cache on and the pool sized automatically; GPT-2
    at float32 from its dir. Each check fails the run:

    - the pool's bytes: 2·8·128 + 1 pages × 16 tokens × the model's KV
      bytes per token, exactly, in the pool, the `kv.page_pool` claim and
      `lm.kv_cache_bytes`;
    - a session of 7 ragged prompts in the 256 bucket × 64 new, one
      admission after the first chunk and one cancel after the second:
      every row's tokens equal the dense session's; B1 launches once per
      layer at the start and the admission and never in a step(); pages
      are mapped (peak > 0);
    - the same 7 prompts again: every start is a full radix hit, B1
      launches 0 times, the finished rows' tokens repeat;
    - a prompt sharing the first 128 tokens of a committed one: 128 hit
      tokens at its start;
    - GPT-2 at float32, kv_quant none and int8: a session with an
      admission, paged rows token-identical to dense ones;
    - `GenBatcher` of [session]'s 24 requests in three waves on the paged
      engine: every future gives text, rows join mid-flight, B1 launches
      once per layer per prefill;
    - after the phase no page is live and, with the radix cache cleared,
      every page is free again.

    Printed with no bar: the starts' wall (cold against full hit), the
    peak pages live and fragmentation against the dense slab's bytes, the
    median ms a chunk paged against dense, and the batcher's tok/s, TTFT,
    TPOT and timeline readings beside `dense_batcher` ([session]'s)."""
    import gc

    from symbiont_tpu_torch.config import LmConfig
    from symbiont_tpu_torch.engine.lm import LmEngine
    from symbiont_tpu_torch.models.bert import torch_dtype
    from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
    from symbiont_tpu_torch.obs.hbm import hbm_ledger
    from symbiont_tpu_torch.obs.xprof import dispatch_ledger
    from symbiont_tpu_torch.ops import flash_attention as fa
    from symbiont_tpu_torch.utils.telemetry import metrics

    s = {**SESSION, **PAGED, **(sizes or {})}
    lm_kw = dict(lm_kw or {})
    tmp = Path(tmp)
    chunk, new, page = s["chunk"], s["new"], s["page"]
    params, mcfg = tinyllama
    L = mcfg.num_layers
    base = LmConfig(model_dir=str(tmp / "tinyllama"), dtype="bfloat16", attn_impl="flash",
                    stream_chunk=chunk, kv_page_tokens=page, **lm_kw)
    def pool_claim() -> int:
        return sum(r["bytes"] for r in hbm_ledger.rows() if r["subsystem"] == "kv.page_pool")

    dense = LmEngine(base, params=params, model_cfg=mcfg, tokenizer=IdTokenizer())
    claim0 = pool_claim()
    eng = LmEngine(dataclasses.replace(base, kv_layout="paged"), params=params, model_cfg=mcfg,
                   tokenizer=IdTokenizer())
    pool, counted = eng.pool, 0

    # -- the pool's bytes: one session batch at the largest bucket pair
    # (every row at its worst case), twice over, plus the scratch page
    per_token = L * 2 * mcfg.kv_heads * mcfg.head_dim * torch_dtype(mcfg.dtype).itemsize
    rows = max(base.session_min_rows, base.gen_max_batch)
    bb = 1 << (rows - 1).bit_length()
    new_b = max(base.new_token_buckets)
    span = max(b for b in base.prompt_buckets if b <= mcfg.max_position_embeddings - new_b) + new_b
    n_pages = 2 * bb * -(-span // page) + 1
    want_bytes = n_pages * page * per_token
    claim = pool_claim() - claim0
    gauge = metrics.gauge_get("lm.kv_cache_bytes", {"service": "lm", "kv_dtype": mcfg.dtype})
    check(pool.n_pages == n_pages and pool.device_bytes == claim == gauge == want_bytes,
          f"pool {pool.n_pages} pages, {pool.device_bytes:,} bytes (claim {claim:,}, gauge "
          f"{gauge:,}); want {n_pages} pages, {want_bytes:,}")
    total = pool.pages_free
    print(f"[paged] TinyLlama-1.1B, kv_layout paged, pages of {page} tokens, radix on: pool of "
          f"{n_pages:,} pages (2 x {bb} rows x {-(-span // page)} blocks + scratch) x {page} tokens "
          f"x {per_token:,} bytes a token = {want_bytes:,} bytes, the kv.page_pool claim and "
          f"lm.kv_cache_bytes equal", flush=True)

    # -- paged against dense: 7 prompts, an admission, a cancel
    prompts = ragged_prompts(rng, *s["bucket"], 8)
    runs = {}
    for name, e in (("dense", dense), ("paged", eng)):
        fa.launches = 0  # ------------------------------------------------ main path
        runs[name] = drive_session(e, prompts[:7], [new] * 7, admit=(prompts[7], new - chunk),
                                   cancel_after=2)
        counted += fa.launches  # ---------------------------------------- main path end
        check(runs[name]["launches"] == {"start": L, "steps": 0, "admit": L},
              f"{name} session: B1 launches {runs[name]['launches']} (want {L} at the start "
              f"and the admission, 0 in steps)")
    cold = runs["paged"]
    diff = [t for t in runs["dense"]["tokens"] if cold["tokens"][t] != runs["dense"]["tokens"][t]]
    check(set(cold["tokens"]) == set(runs["dense"]["tokens"]) and not diff,
          f"paged rows {diff} differ from the dense session's")
    check(cold["peak_pages"] > 0, "the paged session mapped 0 pool pages")
    P = cold["session"].P
    slab = cold["session"].bb * (P + cold["session"].new_bucket) * per_token
    paged_ms, dense_ms = (float(np.median(runs[n]["step_ms"])) for n in ("paged", "dense"))
    print(f"[paged] a session of 7 ragged prompts in the {P} bucket x {new} new, one admitted "
          f"after the first chunk, one cancelled after the second: paged rows token-identical to "
          f"the dense session's; B1 launches {L} at the start, {L} for the admission, 0 per step; "
          f"peak pages live {cold['peak_pages']} = {cold['peak_pages'] * page * per_token:,} bytes "
          f"against the dense slab's {slab:,}, kv.page_fragmentation_pct up to "
          f"{cold['frag_pct']:.2f}; median ms a chunk of {chunk} (host clock) paged "
          f"{paged_ms:.2f}, dense {dense_ms:.2f} ({paged_ms / dense_ms:.3f}x)", flush=True)

    # -- the same prompts again: full radix hits, no prefill
    hits0 = eng.radix.stats["full_hits"]
    fa.launches = 0  # ---------------------------------------------------- main path
    hit = drive_session(eng, prompts[:7], [new] * 7)
    counted += fa.launches  # -------------------------------------------- main path end
    check(hit["launches"] == {"start": 0, "steps": 0, "admit": 0},
          f"full-hit session: B1 launches {hit['launches']} (want none)")
    check(eng.radix.stats["full_hits"] - hits0 == 7,
          f"{eng.radix.stats['full_hits'] - hits0} of 7 starts were full hits")
    diff = [t for t, toks in cold["tokens"].items() if t < 7 and hit["tokens"][t] != toks]
    check(not diff, f"full-hit rows {diff} differ from the cold session's")

    # -- a prompt sharing the first `prefix` tokens of a committed one
    engine_timeline.clear()
    twin = prompts[7][:s["prefix"] - 1] + "".join(
        rng.choice(list("abcdefghijklmnopqrstuvwxyz "), len(prompts[7]) - s["prefix"] + 1))
    fa.launches = 0  # ---------------------------------------------------- main path
    part = drive_session(eng, [twin], [new])
    counted += fa.launches  # -------------------------------------------- main path end
    admit_ev = next(e for e in engine_timeline.events() if e["kind"] == "admit")
    check(admit_ev["hit_tokens"] == s["prefix"] and part["launches"]["start"] == L,
          f"partial hit: {admit_ev['hit_tokens']} hit tokens (want {s['prefix']}), B1 "
          f"{part['launches']['start']}")
    print(f"[paged] the 7 prompts again: 7 full radix hits, B1 launches 0, rows token-identical "
          f"to the cold run; start wall (host clock, synchronised) cold {cold['start_ms']:.1f} ms, "
          f"full hit {hit['start_ms']:.1f} ms; a prompt sharing the first {s['prefix']} tokens of "
          f"a committed one: {admit_ev['hit_tokens']} hit tokens = {s['prefix'] // page} shared "
          f"pages of {admit_ev['prompt_tokens']} prompt tokens, start {part['start_ms']:.1f} ms; "
          f"radix {eng.radix.stats}", flush=True)

    # -- GenBatcher on the paged engine: [session]'s waves
    waves = []
    for w in range(s["waves"]):
        budgets = s["first_wave"] if w == 0 else s["later_waves"]
        waves.append(list(zip(ragged_prompts(rng, *s["batcher_bucket"], len(budgets)), budgets)))
    engine_timeline.clear()
    tok0 = eng.stats["tokens_generated"]
    prefills0 = sum(r["dispatches"] for r in dispatch_ledger.snapshot()
                    if r["executable"].startswith("lm.prefill["))
    fa.launches = 0  # ---------------------------------------------------- main path
    texts, bstats, batch_s = serve_batcher(eng, waves, s["max_batch"], s["wave_gap_s"])
    batch_launches = fa.launches  # ------------------------------------------ main path end
    counted += batch_launches
    n_prefills = sum(r["dispatches"] for r in dispatch_ledger.snapshot()
                     if r["executable"].startswith("lm.prefill[")) - prefills0
    n_req = sum(len(w) for w in waves)
    check(len(texts) == n_req and all(isinstance(t, str) for t in texts),
          f"paged GenBatcher: {sum(isinstance(t, str) for t in texts)} of {n_req} gave text")
    check(bstats["admitted_midflight"] > 0, f"paged GenBatcher: none joined mid-flight {bstats}")
    check(batch_launches == L * n_prefills,
          f"paged GenBatcher: B1 launches {batch_launches} != {L} x {n_prefills} prefills")
    toks = eng.stats["tokens_generated"] - tok0
    lat = timeline_latency(engine_timeline.events())
    summ = engine_timeline.summary()
    batcher = {"tok_s": toks / batch_s, **lat, "admitted_midflight": bstats["admitted_midflight"],
               "sessions": bstats["sessions"]} | {
        k: summ.get(k) for k in ("decode_occupancy_pct", "decode_kv_stranded_pct",
                                 "decode_pages_live_pct", "decode_radix_hit_pct")}
    print(f"[paged] GenBatcher, {n_req} requests in {s['waves']} waves: {bstats['sessions']} "
          f"sessions, {bstats['admitted_midflight']} admitted mid-flight, {toks} tokens in "
          f"{batch_s:.2f} s = {batcher['tok_s']:.1f} tok/s; TTFT p50 {lat['ttft_ms_p50']:.1f} "
          f"p95 {lat['ttft_ms_p95']:.1f} ms, TPOT p50 {lat['tpot_ms_p50']:.2f} ms; timeline "
          f"occupancy {summ['decode_occupancy_pct']}%, stranded KV {summ['decode_kv_stranded_pct']}"
          f"%, pages live {summ.get('decode_pages_live_pct')}%; B1 launches {batch_launches} = "
          f"{L} x {n_prefills} prefills; [session]'s dense run: " + (
              ", ".join(f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in (dense_batcher or {}).items())), flush=True)
    check(pool.pages_live == 0 and pool.pages_free + pool.pages_retained == total,
          f"after the phase: {pool.pages_live} pages live, {pool.pages_free} free + "
          f"{pool.pages_retained} retained of {total}")
    eng.radix.clear()
    check(pool.pages_free == total, f"radix cleared: {pool.pages_free} of {total} pages free")
    result = {"pool_bytes": want_bytes, "pool_pages": n_pages,
              "start_ms": {"cold": cold["start_ms"], "full_hit": hit["start_ms"],
                           "partial_hit": part["start_ms"]},
              "peak_pages": cold["peak_pages"], "peak_bytes": cold["peak_pages"] * page * per_token,
              "dense_slab_bytes": slab, "fragmentation_pct": cold["frag_pct"],
              "chunk_ms": {"paged": paged_ms, "dense": dense_ms}, "batcher": batcher}
    del eng, dense, runs, cold, hit, part
    gc.collect()

    # -- GPT-2 at float32: paged rows against dense, kv_quant none and int8
    g2, g2_launches = None, 0
    prompts = ragged_prompts(rng, *s["gpt2_bucket"], 4)
    for kv_quant in ("none", "int8"):
        cfg = LmConfig(model_dir=str(tmp / "gpt2"), dtype="float32", attn_impl="flash",
                       stream_chunk=chunk, kv_quant=kv_quant, kv_page_tokens=page, **lm_kw)
        d = LmEngine(cfg, params=g2 and g2[0], model_cfg=g2 and g2[1], tokenizer=IdTokenizer())
        g2 = g2 or (d.params, d.model_cfg)
        p = LmEngine(dataclasses.replace(cfg, kv_layout="paged"), params=g2[0], model_cfg=g2[1],
                     tokenizer=IdTokenizer())
        fa.launches = 0  # ------------------------------------------------ main path
        a, b = (drive_session(e, prompts[:3], [new] * 3, admit=(prompts[3], new - chunk))
                for e in (d, p))
        g2_launches += fa.launches  # ------------------------------------- main path end
        check(a["tokens"] == b["tokens"], f"GPT-2 float32, kv_quant {kv_quant}: paged rows "
                                          f"differ from dense")
        check(b["peak_pages"] > 0 and p.pool.pages_live == 0,
              f"GPT-2 paged: peak {b['peak_pages']} pages, {p.pool.pages_live} live after")
        del d, p, a, b
    counted += g2_launches
    check(g2_launches == 2 * 2 * 2 * g2[1].num_layers, f"GPT-2 sessions: B1 {g2_launches}")
    print(f"[paged] GPT-2 124M at float32: a session of 3 prompts plus one admitted, paged rows "
          f"token-identical to dense for kv_quant none and int8; B1 launches {g2_launches}; "
          f"after the phase no page live, every page free once the radix cache is cleared",
          flush=True)
    del g2
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"launches": counted, **result}


def same_or_near_tie(name: str, got: dict, want: dict, eng, prompts: dict) -> list:
    """Rows of two greedy runs token for token (tag → tokens): a row may
    differ only first at a near-tie, where the standalone greedy decode of
    its prompt (on `eng`) has its top-2 logits closer than TIE_SHARE of the
    largest |logit|. → the near-ties met, reported."""
    check(set(got) == set(want), f"{name}: rows {sorted(got)} != {sorted(want)}")
    ties = []
    for t in sorted(want):
        d = next((i for i, (a, b) in enumerate(zip(got[t], want[t])) if a != b), None)
        if d is None:
            check(len(got[t]) == len(want[t]), f"{name} row {t}: {len(got[t])} tokens, want "
                                               f"{len(want[t])}")
            continue
        gap, scale = greedy_trace(eng, prompts[t], len(want[t]))[1][d]
        check(gap < TIE_SHARE * scale, f"{name} row {t} differs at step {d}, where the top-2 "
                                       f"gap is {gap:.3g} (bar {TIE_SHARE} x {scale:.3g})")
        ties.append(f"{name} row {t} step {d}: gap {gap:.3g}")
    return ties


def spec_rounds(events, k: int) -> dict:
    """The spec rounds of a timeline window: their count, mean draft and
    verify ms, and the mean tokens a live row emitted per target dispatch
    (its accepted drafts and the correction)."""
    rounds = [e for e in events if e["kind"] == "step" and "spec_proposed" in e]
    if not rounds:
        return {"rounds": 0}
    per = [e["spec_accepted"] / (e["spec_proposed"] / k) + 1 for e in rounds if e["spec_proposed"]]
    return {"rounds": len(rounds),
            "draft_ms": float(np.mean([e["spec_draft_ms"] for e in rounds])),
            "verify_ms": float(np.mean([e["spec_verify_ms"] for e in rounds])),
            "tokens_per_round": float(np.mean(per)) if per else 0.0}


def spec_phase(rng, tmp, tinyllama, sizes=None, device="cuda", lm_kw=None) -> dict:
    """ROADMAP A13 on the card, TinyLlama-1.1B the target (`tinyllama`,
    flash), spec_k 8, greedy. The identity checks run the target at
    float32: a bf16 forward of k + 1 tokens rounds differently from k + 1
    one-token forwards, so bf16 greedy speculation may part from plain
    decode wherever two logits are within its rounding. Each check fails
    the run:

    - self-drafted (the drafter is the target's own params): a stream and
      sessions on the dense and paged layouts give spec-off's tokens (or a
      reported near-tie), acceptance 1.0, 9 tokens per target dispatch, B1
      launches once per layer for the target's prefill and once for the
      drafter's, never in a round, a track or an ingest;
    - drafts corrupted from slot 2 on: acceptance 2/8 and spec-off's tokens;
    - a drafter at JackFram/llama-68m's published geometry, written from the
      seed in the hub's layout and loaded through `spec_draft_model`
      (`validate_spec_draft`, `load_gpt_model`): spec-off's tokens, B1 22 +
      2 at the start; then the same drafter beside the bf16 target for its
      round costs (tokens against bf16 spec-off reported, no bar);
    - one `verify_chunk` at [8, 9] over a 1,024-token bf16 cache: B1 0
      times, and the logits of its forward under "flash" equal a plain
      forward's (next-token cosine >= 0.995 at every position), its
      accepted drafts and correction are the plain logits' argmax;
    - every sub-phase that should speculate proposed drafts.

    Printed with no bar: draft and verify ms a round, tokens a round,
    acceptance, the round at which the EMA turned a session plain, and
    tok/s against plain."""
    import gc
    import re

    from symbiont_tpu_torch.config import LmConfig
    from symbiont_tpu_torch.engine.lm import LmEngine
    from symbiont_tpu_torch.models import gpt as gpt_mod
    from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
    from symbiont_tpu_torch.ops import flash_attention as fa

    s = {**PAGED, **(sizes or {})}
    lm_kw = dict(lm_kw or {})
    tmp = Path(tmp)
    chunk, new, k = s["chunk"], s["new"], s["spec_k"]
    params, mcfg = tinyllama
    L = mcfg.num_layers
    counted, ties = 0, []
    base = LmConfig(model_dir=str(tmp / "tinyllama"), dtype="float32", attn_impl="flash",
                    stream_chunk=chunk, spec_k=k, kv_page_tokens=s["page"], **lm_kw)
    off = LmEngine(base, params=params, model_cfg=mcfg, tokenizer=IdTokenizer())
    f32 = (off.params, off.model_cfg)  # float32 leaves, shared by every engine below

    def engine(cfg=base, draft=None, **kw):
        extra = {} if draft is None else dict(draft_params=draft[0], draft_model_cfg=draft[1])
        return LmEngine(dataclasses.replace(cfg, **kw), params=f32[0], model_cfg=f32[1],
                        tokenizer=IdTokenizer(), **extra)

    prompts = ragged_prompts(rng, *s["bucket"], 8)
    by_tag = dict(enumerate(prompts))
    d_hf = s.get("drafter", LLAMA_68M)
    dcfg = gpt_mod.GPTConfig.from_hf(d_hf)
    # B1 at this phase's prefill shapes: the float32 target's sessions and
    # stream, the llama-68m drafter's (its own dtype, bf16) sessions
    for B, mc in ((8, off.model_cfg), (1, off.model_cfg), (8, dcfg)):
        b1_against_plain(rng, B, mc, s["bucket"][1], device, tag="spec")

    def proposed(e, since: int, name: str) -> int:
        n = e._spec_proposed - since
        check(n > 0, f"{name}: 0 draft tokens proposed")
        return n

    # -- self-drafted: a stream, sessions dense and paged
    on = engine(draft=f32)
    prompt = prompts[0]
    want_text = "".join(off.generate_stream(prompt, new, temperature=0.0))
    fa.launches = 0  # ---------------------------------------------------- main path
    got_text = "".join(on.generate_stream(prompt, new, temperature=0.0))
    stream_launches = fa.launches  # ----------------------------------------- main path end
    counted += stream_launches
    proposed(on, 0, "self-drafted stream")
    ids = [[int(x) for x in re.findall(r"\[(\d+)\]", t)] for t in (got_text, want_text)]
    ties += same_or_near_tie("self-drafted stream", {0: ids[0]}, {0: ids[1]}, off, {0: prompt})
    check(stream_launches == 2 * L, f"self-drafted stream: B1 launches {stream_launches} != "
                                    f"{2 * L} (target and drafter prefills)")
    check(on._spec_accepted == on._spec_proposed,
          f"self-drafted stream: acceptance {on._spec_accepted}/{on._spec_proposed}")
    self_runs, refs = {}, {}
    for layout in ("dense", "paged"):
        e_off = off if layout == "dense" else engine(kv_layout="paged")
        e_on = on if layout == "dense" else engine(draft=f32, kv_layout="paged")
        ref = drive_session(e_off, prompts, [new] * 8)
        refs[layout] = ref
        engine_timeline.clear()
        p0, a0 = e_on._spec_proposed, e_on._spec_accepted
        fa.launches = 0  # ------------------------------------------------ main path
        run = drive_session(e_on, prompts, [new] * 8)
        counted += fa.launches  # ------------------------------------------ main path end
        n_prop = proposed(e_on, p0, f"self-drafted {layout} session")
        rate = (e_on._spec_accepted - a0) / n_prop
        ties += same_or_near_tie(f"self-drafted {layout} session", run["tokens"], ref["tokens"],
                                 off, by_tag)
        check(run["launches"] == {"start": 2 * L, "steps": 0, "admit": 0},
              f"self-drafted {layout} session: B1 launches {run['launches']} (want {2 * L} at "
              f"the start, 0 in rounds, tracks and ingests)")
        rounds = spec_rounds(engine_timeline.events(), k)
        check(rate == 1.0 and rounds["tokens_per_round"] == k + 1,
              f"self-drafted {layout} session: acceptance {rate}, {rounds}")
        if layout == "paged":
            check(run["peak_pages"] > 0 and e_on.pool.pages_live == 0,
                  f"paged spec session: peak {run['peak_pages']} pages, "
                  f"{e_on.pool.pages_live} live after")
        self_runs[layout] = {"acceptance": rate, **rounds,
                             "tok_s": 8 * new * 1e3 / (run["start_ms"] + sum(run["step_ms"])),
                             "plain_tok_s": 8 * new * 1e3 / (ref["start_ms"] + sum(ref["step_ms"]))}
        if layout == "paged":
            del e_off, e_on
    print(f"[spec] self-drafted (the target's own params), spec_k {k}, TinyLlama at float32: a "
          f"stream and sessions of 8 prompts x {new} new, dense and paged, give spec-off's tokens"
          + (f" (near-ties: {'; '.join(ties)})" if ties else "") + f"; acceptance 1.0, "
          f"{k + 1} tokens per target dispatch; B1 launches {2 * L} per start or stream ({L} "
          f"target + {L} drafter prefill), 0 per round, track and ingest; " + "; ".join(
              f"{n}: {r['rounds']} rounds, draft {r['draft_ms']:.1f} ms, verify "
              f"{r['verify_ms']:.1f} ms a round, {r['tok_s']:.1f} tok/s against plain "
              f"{r['plain_tok_s']:.1f}" for n, r in self_runs.items()), flush=True)

    # -- drafts corrupted from slot 2: partial acceptance
    real = gpt_mod.draft_chunk

    def corrupt(draft_params, d_cache, pending, cur_pos, done, kv_valid, dcfg, spec_k):
        cache, drafts = real(draft_params, d_cache, pending, cur_pos, done, kv_valid, dcfg,
                             spec_k)
        bad = (drafts + 1) % dcfg.vocab_size
        return cache, torch.where(torch.arange(spec_k, device=drafts.device)[None] >= 2, bad,
                                  drafts)

    ref = refs["dense"]
    p0, a0 = on._spec_proposed, on._spec_accepted
    gpt_mod.draft_chunk = corrupt
    try:
        fa.launches = 0  # ------------------------------------------------ main path
        run = drive_session(on, prompts, [new] * 8)
        counted += fa.launches  # ------------------------------------------ main path end
    finally:
        gpt_mod.draft_chunk = real
    n_prop = proposed(on, p0, "corrupted session")
    corrupt_rate = (on._spec_accepted - a0) / n_prop
    ties += same_or_near_tie("corrupted session", run["tokens"], ref["tokens"], off, by_tag)
    check(corrupt_rate == 2 / k, f"corrupted drafts: acceptance {corrupt_rate} != 2/{k}")
    print(f"[spec] drafts corrupted from slot 2: acceptance {on._spec_accepted - a0}/{n_prop} = "
          f"{corrupt_rate:.4f} (2/{k}), tokens spec-off's", flush=True)
    del on
    gc.collect()

    # -- a drafter at JackFram/llama-68m's geometry, through spec_draft_model
    dparams = gpt_mod.init_params(torch.Generator(device=device).manual_seed(SEED + 12), dcfg)
    write_gpt_checkpoint(tmp / "llama68m", dparams, d_hf, torch.float32)
    del dparams
    d_layers = dcfg.num_layers
    small = {}
    for dtype in ("float32", "bfloat16"):
        if dtype == "float32":
            e_off = off
            e_on = LmEngine(dataclasses.replace(base, spec_draft_model=str(tmp / "llama68m")),
                            params=f32[0], model_cfg=f32[1], tokenizer=IdTokenizer())
        else:
            cfg = dataclasses.replace(base, dtype="bfloat16")
            e_off = LmEngine(cfg, params=params, model_cfg=mcfg, tokenizer=IdTokenizer())
            e_on = LmEngine(dataclasses.replace(cfg, spec_draft_model=str(tmp / "llama68m")),
                            params=params, model_cfg=mcfg, tokenizer=IdTokenizer())
        check(e_on._draft is not None and e_on._draft[1].hidden_size == dcfg.hidden_size,
              f"the llama-68m drafter did not load ({dtype} target)")
        ref = refs["dense"] if e_off is off else drive_session(e_off, prompts, [new] * 8)
        engine_timeline.clear()
        fa.launches = 0  # ------------------------------------------------ main path
        run = drive_session(e_on, prompts, [new] * 8)
        counted += fa.launches  # ------------------------------------------ main path end
        n_prop = proposed(e_on, 0, f"llama-68m drafter, {dtype} target")
        check(run["launches"] == {"start": L + d_layers, "steps": 0, "admit": 0},
              f"llama-68m drafter: B1 launches {run['launches']} (want {L} + {d_layers} at the "
              "start, 0 in rounds)")
        if dtype == "float32":
            ties += same_or_near_tie("llama-68m session", run["tokens"], ref["tokens"], off,
                                     by_tag)
        differ = sum(run["tokens"][t] != ref["tokens"][t] for t in ref["tokens"])
        sess = run["session"]
        small[dtype] = {"acceptance": e_on._spec_accepted / n_prop,
                        **spec_rounds(engine_timeline.events(), k),
                        "plain_after_round": None if sess._spec_on else sess._spec_rounds,
                        "tok_s": 8 * new * 1e3 / (run["start_ms"] + sum(run["step_ms"])),
                        "plain_tok_s": 8 * new * 1e3 / (ref["start_ms"] + sum(ref["step_ms"])),
                        "rows_differing": differ}
        del e_on, run, ref
        if dtype == "bfloat16":
            del e_off
    print(f"[spec] drafter at JackFram/llama-68m's geometry ({dcfg.num_layers} layers x "
          f"{dcfg.hidden_size}, {dcfg.num_heads} heads, FFN {dcfg.intermediate_size}, random "
          f"weights from the seed, float32 safetensors) through spec_draft_model: B1 launches "
          f"{L} + {d_layers} at the start, 0 per round; float32 target: spec-off's tokens; "
          + "; ".join(f"{dt} target: acceptance {r['acceptance']:.4f}, {r['rounds']} rounds, "
                      f"draft {r.get('draft_ms', 0):.2f} ms and verify {r.get('verify_ms', 0):.2f} "
                      f"ms a round, {r.get('tokens_per_round', 0):.3f} tokens a round, plain after "
                      f"round {r['plain_after_round']}, {r['tok_s']:.1f} tok/s against plain "
                      f"{r['plain_tok_s']:.1f}, rows differing from spec-off "
                      f"{r['rows_differing']}/8" for dt, r in small.items()), flush=True)

    # -- one verify_chunk at [rows, k + 1] over a long cache, bf16, flash
    eng = LmEngine(dataclasses.replace(base, dtype="bfloat16"), params=params, model_cfg=mcfg,
                   tokenizer=IdTokenizer())
    rows, P = s["verify_rows"], s["verify_cache"]
    long_prompts = ragged_prompts(rng, P // 4, P, rows)
    ids_np, mask_np, nb = eng._prepare_prompts(long_prompts, k + 1)
    check(ids_np.shape == (rows, P), f"verify prompts shaped {ids_np.shape}")
    with torch.inference_mode():
        cache, logits, kv_valid, pos = eng._prefill(eng.params, ids_np, mask_np, nb)
        cache = cache._replace(length=P)
        pending = logits.argmax(-1)
        drafts = torch.from_numpy(rng.integers(0, mcfg.vocab_size, (rows, k))).to(eng.device)
        seq = torch.cat([pending[:, None], drafts], 1)
        positions = pos[:, None] + torch.arange(k + 1, device=eng.device)[None]
        snap = [t.clone() for t in cache[:-1]]
        fa.launches = 0  # ------------------------------------------------ main path
        out = gpt_mod.verify_chunk(eng.params, cache, pending, drafts, pos,
                                   torch.zeros(rows, dtype=torch.bool, device=eng.device),
                                   kv_valid, eng._new_generator(SEED), eng.model_cfg,
                                   temperature=0.0, top_k=0)
        verify_launches = fa.launches  # -------------------------------------- main path end
        fwd = {}
        for impl in ("flash", "xla"):
            c = type(cache)(*[t.clone() for t in snap], P)
            fwd[impl] = gpt_mod.forward(eng.params, seq, c, positions,
                                        dataclasses.replace(eng.model_cfg, attn_impl=impl),
                                        kv_valid)[0]
        fa.launches = 0  # the comparison forwards are not the main path
    check(verify_launches == 0, f"verify_chunk over a {P}-token cache: B1 launches "
                                f"{verify_launches}")
    cos = next_token_cosines(fwd["flash"].flatten(0, 1), fwd["xla"].flatten(0, 1))
    check(float(cos.min()) >= GEN_COS_BAR, f"verify forward flash vs plain: cosine {cos.min():.6f}")
    em, o = out[7].cpu(), out[5].cpu()
    argmax = fwd["xla"].argmax(-1).cpu()
    check(all(torch.equal(o[i, :int(em[i])], argmax[i, :int(em[i])]) for i in range(rows)),
          "verify_chunk's accepted drafts and correction are not the plain logits' argmax")
    max_diff = float((fwd["flash"] - fwd["xla"]).abs().max())
    print(f"[spec] verify_chunk at [{rows}, {k + 1}] over a {P}-token cache (bf16, flash): B1 "
          f"launches {verify_launches}; its forward's logits against a plain-attention forward: "
          f"next-token cosine min {cos.min():.6f} (bar {GEN_COS_BAR}), max |diff| {max_diff:.3g}; "
          f"emitted {em.tolist()}, each the plain argmax", flush=True)
    del eng, cache, snap, fwd, off
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"launches": counted, "self_drafted": self_runs, "corrupted_acceptance": corrupt_rate,
            "llama_68m": small, "verify": {"cosine_min": float(cos.min()), "max_abs_diff": max_diff},
            "near_ties": ties}


# ------------------------------------------------------------------ stack

# [stack]'s sizes on the card: pages x sentences a page (2,048 sentences,
# [serve]'s bulk embed), the semantic queries and their top_k, the greedy
# stream requests, the non-stream requests posted at once (the GenBatcher
# takes them into one session), their new tokens and prompt bucket (lo, hi],
# and the seconds any one wait may take before the phase fails
STACK = dict(pages=64, sentences=32, queries=50, top_k=5, gen=4, batch=4, gen_new=64,
             gen_bucket=(16, 64), timeout_s=180.0)


def stack_pages(rng, pages: int, per_page: int) -> tuple[dict, list]:
    """`pages` HTML pages of `per_page` sentences each, one <p> a sentence,
    from synth_texts (words of lowercase letters, so each sentence ends at
    the full stop added to it) → ({url: html}, [(url, sentences), ...])."""
    texts = synth_texts(rng, pages * per_page)
    html, docs = {}, []
    for p in range(pages):
        sents = [t + "." for t in texts[p * per_page:(p + 1) * per_page]]
        url = f"http://pages.invalid/doc{p}"
        html[url] = ("<html><body><article>"
                     + "".join(f"<p>{s}</p>" for s in sents) + "</article></body></html>")
        docs.append((url, sents))
    return html, docs


def _http(port: int, method: str, path: str, body=None, timeout: float = 60.0,
          accept: str = "application/json", headers=None):
    """One HTTP request to the stack's gateway → (status, raw body bytes)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", "Accept": accept, **(headers or {})},
        method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


_EXPOSITION_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*",?)*\})?'
    r' [-+]?(\d+(\.\d*)?([eE][-+]?\d+)?|\.\d+([eE][-+]?\d+)?|NaN|[-+]?Inf)( \d+)?$')


def exposition_families(text: str) -> set:
    """The metric names of a Prometheus 0.0.4 exposition; every sample line
    must parse (name, labels, value)."""
    names = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        check(bool(_EXPOSITION_LINE.match(line)), f"/metrics line does not parse: {line!r}")
        names.add(line.split("{", 1)[0].split(" ", 1)[0])
    return names


def span_totals(before: dict, after: dict) -> dict:
    """Per span name, the calls and host milliseconds between two
    `metrics.snapshot()["histograms"]` readings (`span.<name>.ms`), most
    time first. Handlers overlap, so the totals explain where host time
    went, not a partition of the wall."""
    out = {}
    for key, s in after.items():
        if not (key.startswith("span.") and key.endswith(".ms")):
            continue
        b = before.get(key, {"count": 0, "sum": 0.0})
        n, ms = s["count"] - b["count"], s["sum"] - b["sum"]
        if n:
            out[key[len("span."):-len(".ms")]] = {"calls": n, "ms": ms}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


def lm_prefills(metrics) -> int:
    """LM prefills dispatched so far, from the dispatch ledger's counters
    (`xla.dispatches_total{executable="lm.prefill[...]"}`), which outlive
    the ledger's bounded rows."""
    return int(sum(v for k, v in metrics.snapshot()["counters"].items()
                   if k.startswith('xla.dispatches_total{executable="lm.prefill[')))


def span_names(tree) -> set:
    """Every span name in a `/api/traces/<id>` tree."""
    if isinstance(tree, dict):
        return ({tree["name"]} if isinstance(tree.get("name"), str) else set()).union(
            *(span_names(v) for v in tree.values()))
    if isinstance(tree, list):
        return set().union(*(span_names(v) for v in tree))
    return set()


def stack_phase(rng, tmp, sizes=None, device="cuda", engine_kw=None, lm_kw=None,
                serve=None) -> dict:
    """The port's SymbiontStack built from a SymbiontConfig as a deployment
    builds it (no engine passed in): the full-width synthetic TorchEngine
    of [serve] with flash attention and its cross-encoder, the embedded
    vector and graph stores in `tmp`, the in-process bus, the gateway on a
    free port, and LmEngine on [generate]'s GPT-2 124M dir behind
    `text_generator`. Over real HTTP it ingests `pages` synthetic pages
    (`/api/submit-url`, a fetcher that touches no network), runs
    `queries` semantic searches with rerank, streams `gen` greedy
    generations one after another and then posts `batch` non-stream ones at
    once, all watched by one `/api/events` client. Each check fails the
    run: B1 against its plain version at every LM prefill shape the phase
    runs (the LM's dtype and heads, the prompts' bucket, 1 to `batch`
    rows); the store and the graph at their counts; every search on the
    fused hop, its hits those of the store's own `search_fused`, its rerank
    scores `engine.rerank`'s; stored vectors at cosine >= 0.999 to
    `embed_texts`; each stream's text `LmEngine.generate`'s (or a reported
    near-tie) with its partials and final event on the SSE stream; the
    batched requests in one GenBatcher session, their texts the rows of
    `LmEngine.generate_batch` of the same prompts (or near-ties); B1
    launched once per layer per embed batch, fused query, rerank batch and
    LM prefill of the window; /readyz, /metrics, /api/traces/recent and
    /api/health/engine; no task left after stop()."""
    import asyncio
    import threading

    from symbiont_tpu_torch.bus.inproc import InprocBus
    from symbiont_tpu_torch.config import (ApiConfig, EngineConfig, GraphStoreConfig, LmConfig,
                                           SymbiontConfig, TextGeneratorConfig,
                                           VectorStoreConfig)
    from symbiont_tpu_torch.ops import flash_attention as fa
    from symbiont_tpu_torch.runner import SymbiontStack
    from symbiont_tpu_torch.utils.telemetry import metrics

    s = dict(STACK, **(sizes or {}))
    tmp = Path(tmp)
    if not (tmp / "gpt2" / "config.json").exists():
        from symbiont_tpu_torch.models import gpt as gpt_mod

        params = gpt_mod.init_params(torch.Generator(device=device).manual_seed(SEED + 8),
                                     gpt_mod.GPTConfig.from_hf(GPT2_124M))
        write_gpt_checkpoint(tmp / "gpt2", params, GPT2_124M, torch.float32)
        del params
    html, docs = stack_pages(rng, s["pages"], s["sentences"])
    n_sent = s["pages"] * s["sentences"]
    prompts = ragged_prompts(rng, *s["gen_bucket"], s["gen"])
    batch_prompts = ragged_prompts(rng, *s["gen_bucket"], s["batch"])
    cpu = device == "cpu"
    cfg = SymbiontConfig(
        engine=EngineConfig(**{"attn_impl": "flash", "rerank_enabled": True,
                               "force_cpu": cpu, **(engine_kw or {})}),
        vector_store=VectorStoreConfig(data_dir=str(tmp / "stack_vs")),
        graph_store=GraphStoreConfig(data_dir=str(tmp / "stack_gs")),
        text_generator=TextGeneratorConfig(markov_state_path=str(tmp / "stack_markov.json")),
        api=ApiConfig(host="127.0.0.1", port=0, sse_keepalive_s=1.0),
        lm=LmConfig(**{"enabled": True, "model_dir": str(tmp / "gpt2"), "attn_impl": "flash",
                       **(lm_kw or {})}))
    limit = s["timeout_s"]
    ready_seen: list = []

    def fetcher(url: str) -> str:
        return html[url]

    async def wait_for(pred, what: str) -> None:
        t_end = time.monotonic() + limit
        while not pred():
            check(time.monotonic() < t_end, f"{what}: stalled past {limit:.0f} s")
            await asyncio.sleep(0.005)

    def poll_ready(stack) -> None:
        """/readyz from a second thread while the stack starts: 503 until
        mark_ready (when a poll lands in that window), then 200."""
        t_end = time.monotonic() + limit
        while time.monotonic() < t_end:
            try:
                port = stack.api.port
            except AttributeError:  # no gateway yet, or its socket not bound
                port = None
            if port:
                try:
                    st = _http(port, "GET", "/readyz", timeout=limit)[0]
                except OSError:
                    st = None
                if st is not None:
                    ready_seen.append(st)
                    if st == 200:
                        return
            time.sleep(0.002)

    async def scenario() -> dict:
        loop = asyncio.get_running_loop()

        def http(method, path, body=None, accept="application/json", headers=None):
            return loop.run_in_executor(None, lambda: _http(port, method, path, body,
                                                            timeout=limit, accept=accept,
                                                            headers=headers))

        async def ok_json(method, path, body=None, headers=None):
            st, raw = await http(method, path, body, headers=headers)
            check(200 <= st < 300, f"{method} {path}: HTTP {st} {raw[:300]!r}")
            return json.loads(raw or b"{}")

        t0 = time.perf_counter()
        stack = SymbiontStack(cfg, bus=InprocBus(), fetcher=fetcher)
        poller = threading.Thread(target=poll_ready, args=(stack,), daemon=True)
        poller.start()
        await stack.start()
        try:
            start_s = time.perf_counter() - t0
            await loop.run_in_executor(None, poller.join, limit)
            port = stack.api.port
            eng, lm, store = stack.engine, stack.lm, stack.vector_store
            lm.tokenizer = IdTokenizer()  # every id out, as [session] reads GPT-2
            layers, lm_layers = eng.model_cfg.num_layers, lm.model_cfg.num_layers
            out = {"start_s": start_s}
            sse = {"partials": {}, "finals": {}, "first_t": {}, "final_t": {}}

            async def sse_reader() -> None:
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
                writer.write(b"GET /api/events HTTP/1.1\r\nHost: x\r\n\r\n")
                await writer.drain()
                try:
                    while True:
                        line = await reader.readline()
                        if not line:
                            return
                        if not line.startswith(b"data: "):
                            continue
                        ev = json.loads(line[6:])
                        tid = ev["original_task_id"]
                        if "text_delta" in ev:
                            sse["partials"].setdefault(tid, []).append(ev)
                            sse["first_t"].setdefault(tid, time.perf_counter())
                        else:
                            sse["finals"][tid] = ev["generated_text"]
                            sse["final_t"][tid] = time.perf_counter()
                finally:
                    writer.close()

            # B1 against its plain version at every LM prefill shape below:
            # a stream's row, and the batcher's session start and admissions
            # (1 to `batch` rows, in powers of two), all in the one prompt
            # bucket the prompts reach, at the LM's heads and dtype
            for B in (1 << i for i in range(s["batch"].bit_length())):
                b1_against_plain(rng, B, lm.model_cfg, s["gen_bucket"][1], device, tag="stack")
            stats0 = dict(eng.stats)
            bstats0 = dict(stack._lm_batcher.stats)
            prefill0 = lm_prefills(metrics)
            fa.launches = 0  # ----------------------------------------------- main path
            # ingest: every page through perception → preprocessing (the
            # MicroBatcher, B1) → vector memory and the knowledge graph
            hist0 = metrics.snapshot()["histograms"]
            t_ing = time.perf_counter()
            for url in html:
                await ok_json("POST", "/api/submit-url", {"url": url})
            posts_s = time.perf_counter() - t_ing
            await wait_for(lambda: store.count() >= n_sent, f"ingest ({store.count()} of {n_sent})")
            ingest_s = time.perf_counter() - t_ing
            ingest_spans = span_totals(hist0, metrics.snapshot()["histograms"])
            await wait_for(lambda: stack.graph_store.counts()["Document"] >= s["pages"],
                           "knowledge graph documents")
            stats1 = dict(eng.stats)
            # search: the fused hop (B1) and the rerank hop (B1)
            queries = [docs[i % len(docs)][1][i % s["sentences"]] for i in range(s["queries"] // 2)]
            queries += [" ".join(q.split()[:12]) for q in queries][:s["queries"] - len(queries)]
            fused0 = metrics.get("api.fused_search")
            fallback0 = metrics.get("api.fused_search_fallback")
            lat, answers = [], []
            for i, q in enumerate(queries):
                t1 = time.perf_counter()
                # the first search carries its own trace id, read back below
                body = await ok_json("POST", "/api/search/semantic",
                                     {"query_text": q, "top_k": s["top_k"], "rerank": True},
                                     headers={"X-Trace-Id": "stack-search"} if i == 0 else None)
                lat.append((time.perf_counter() - t1) * 1e3)
                check(body["error_message"] is None and len(body["results"]) == s["top_k"],
                      f"search {q[:40]!r}: {body['error_message']}, "
                      f"{len(body['results'])} results")
                answers.append(body["results"])
            fused = metrics.get("api.fused_search") - fused0
            fallbacks = metrics.get("api.fused_search_fallback") - fallback0
            # generate: greedy streams, one SSE client watching
            reader = asyncio.create_task(sse_reader())
            await asyncio.sleep(0.2)
            gen_t0 = {}
            for i, p in enumerate(prompts):
                tid = f"stack-gen-{i}"
                gen_t0[tid] = time.perf_counter()
                await ok_json("POST", "/api/generate-text",
                              {"task_id": tid, "prompt": p, "max_length": s["gen_new"],
                               "stream": True, "temperature": 0.0})
                await wait_for(lambda: tid in sse["finals"], f"generation {tid}")
            # batched: non-stream requests posted at once from as many
            # threads, which the GenBatcher behind text_generator serves
            together = threading.Barrier(len(batch_prompts), timeout=limit)

            def post_at_once(tid, p):
                together.wait()
                return _http(port, "POST", "/api/generate-text",
                             {"task_id": tid, "prompt": p, "max_length": s["gen_new"],
                              "stream": False, "temperature": 0.0}, timeout=limit)

            btids = [f"stack-batch-{i}" for i in range(len(batch_prompts))]
            t_batch = time.perf_counter()
            replies = await asyncio.gather(*(loop.run_in_executor(None, post_at_once, t, p)
                                             for t, p in zip(btids, batch_prompts)))
            for tid, (st, raw) in zip(btids, replies):
                check(200 <= st < 300, f"POST /api/generate-text {tid}: HTTP {st} {raw[:300]!r}")
            await wait_for(lambda: all(t in sse["finals"] for t in btids), "batched generations")
            batch_ms = (time.perf_counter() - t_batch) * 1e3
            counted = fa.launches  # ----------------------------------------- main path end
            stats2 = dict(eng.stats)
            prefills = lm_prefills(metrics) - prefill0
            sessions = stack._lm_batcher.stats["sessions"] - bstats0["sessions"]
            admitted = (stack._lm_batcher.stats["admitted_midflight"]
                        - bstats0["admitted_midflight"])

            # ---- what came out, held against the engines driven directly
            check(store.count() == n_sent, f"store holds {store.count()} rows, want {n_sent}")
            check(stack.graph_store.counts()["Document"] == s["pages"],
                  f"graph documents {stack.graph_store.counts()['Document']} != {s['pages']}")
            with store._lock:
                rows = [(p["sentence_text"], store._vectors[i].copy())
                        for i, p in enumerate(store._payloads)]
            pick = rng.choice(len(rows), min(64, len(rows)), replace=False)
            stored = np.stack([rows[i][1] for i in pick])
            direct = eng.embed_texts([rows[i][0] for i in pick])
            cos = _cosines(stored, direct)
            check(float(cos.min()) >= 0.999, f"stored vs embed_texts cosine {cos.min():.5f} < 0.999")
            check(fused == len(queries) and fallbacks == 0,
                  f"{fused} of {len(queries)} searches on the fused hop, {fallbacks} fell back "
                  f"to the 2-hop path")
            ties = 0
            max_rr = 0.0
            for q, res in zip(queries, answers):
                want = store.search_fused(eng, q, 2 * s["top_k"])
                got_ids = {r["qdrant_point_id"] for r in res}
                want_ids = {h.id for h in want[:s["top_k"]]}
                if got_ids != want_ids:
                    by_id = {h.id: h.score for h in want}
                    kth = want[s["top_k"] - 1].score
                    check(all(i in by_id and by_id[i] >= kth - 2.0 ** -8 for i in got_ids),
                          f"search {q[:40]!r}: hits {sorted(got_ids)} != search_fused "
                          f"{sorted(want_ids)} beyond a near-tie")
                    ties += 1
                scores = eng.rerank(q, [r["payload"]["sentence_text"] for r in res])
                err = np.abs(scores - np.array([r["score"] for r in res], np.float32))
                max_rr = max(max_rr, float(err.max()))
            check(max_rr <= RERANK_BAR, f"gateway rerank vs engine.rerank max |err| {max_rr:.4g} "
                                        f"over the bar {RERANK_BAR}")
            def ids_of(text: str) -> list:
                return [int(x) for x in re.findall(r"\[(\d+)\]", text)]

            texts_ties, direct_first, direct_total = [], [], []
            for i, p in enumerate(prompts):
                tid = f"stack-gen-{i}"
                parts = sse["partials"].get(tid, [])
                check(bool(parts) and parts[-1]["done"], f"{tid}: SSE partials {len(parts)}, "
                                                         f"no done chunk")
                joined = "".join(c["text_delta"] for c in parts)
                final = sse["finals"][tid]
                check(joined == final, f"{tid}: the partials do not join to the final text")
                want = lm.generate(p, s["gen_new"], temperature=0.0)
                if final != want:
                    texts_ties += same_or_near_tie("stack", {i: ids_of(final)},
                                                   {i: ids_of(want)}, lm, {i: p})
                # the same stream on the engine directly: its first chunk and
                # its end, beside the gateway's
                t1 = time.perf_counter()
                deltas = []
                for d in lm.generate_stream(p, s["gen_new"], temperature=0.0):
                    if not deltas:
                        direct_first.append((time.perf_counter() - t1) * 1e3)
                    deltas.append(d)
                direct_total.append((time.perf_counter() - t1) * 1e3)
                check("".join(deltas) == want, f"{tid}: the direct stream is not generate()'s text")
            # the batched rows: one session of all of them, as generate_batch
            # decodes them (at bf16 a row's numbers depend on the batch's
            # shape, so the reference is a batch of the same rows)
            check(sessions == 1 and admitted == 0,
                  f"the {len(btids)} requests posted at once took {sessions} GenBatcher sessions "
                  f"and {admitted} admissions, not one session")
            t1 = time.perf_counter()
            wants = lm.generate_batch(batch_prompts, [s["gen_new"]] * len(batch_prompts),
                                      temperature=0.0)
            direct_batch_ms = (time.perf_counter() - t1) * 1e3
            batch_ties = []
            for i, (tid, p, want) in enumerate(zip(btids, batch_prompts, wants)):
                check(tid not in sse["partials"], f"{tid}: a non-stream request sent partials")
                if sse["finals"][tid] != want:
                    batch_ties += same_or_near_tie("stack batch", {i: ids_of(sse["finals"][tid])},
                                                   {i: ids_of(want)}, lm, {i: p})
            reader.cancel()
            await asyncio.gather(reader, return_exceptions=True)

            embed_b = stats2["embed_batches"] - stats0["embed_batches"]
            qsearch = stats2["qsearch_calls"] - stats0["qsearch_calls"]
            rerank_b = stats2["rerank_batches"] - stats0["rerank_batches"]
            want_b1 = layers * (embed_b + qsearch + rerank_b) + lm_layers * prefills
            equation = (f"{counted} = {layers} x ({embed_b} embed batches + {qsearch} fused queries "
                        f"+ {rerank_b} rerank batches) + {lm_layers} x {prefills} LM prefills")
            check(counted == want_b1 and prefills == len(prompts) + 1
                  and qsearch == len(queries),
                  f"B1 launches: {equation} does not hold (want {want_b1}, and "
                  f"{len(prompts) + 1} LM prefills)")

            # ---- surfaces
            check(bool(ready_seen) and ready_seen[-1] == 200, f"/readyz answers {ready_seen[-3:]}")
            st, raw = await http("GET", "/metrics", accept="text/plain")
            check(st == 200, f"/metrics: HTTP {st}")
            fams = exposition_families(raw.decode())
            check(any(f.startswith("symbiont_engine_") for f in fams)
                  and any(f.startswith("symbiont_span_") for f in fams),
                  f"/metrics families lack engine_* or span_*: {sorted(fams)[:20]}")
            recent = (await ok_json("GET", "/api/traces/recent"))["traces"]
            check(bool(recent) and all(t["error_count"] == 0 for t in recent),
                  f"/api/traces/recent: {str(recent)[:300]}")
            names = span_names(await ok_json("GET", "/api/traces/stack-search"))
            check({"api.search", "engine.query.search", "engine.rerank"} <= names,
                  f"the search's trace holds {sorted(names)}, not gateway -> engine")
            health = await ok_json("GET", "/api/health/engine")
            check(health["ok"] and health["stats"]["embed_batches"] == eng.stats["embed_batches"],
                  f"/api/health/engine: {str(health)[:300]}")
            flushes = stats1["embed_calls"] - stats0["embed_calls"]
            out.update({
                "ingest": {"sentences": n_sent, "seconds": ingest_s, "posts_s": posts_s,
                           "spans": ingest_spans,
                           "sentences_per_s": n_sent / ingest_s, "flushes": flushes,
                           "rows_per_flush": n_sent / flushes,
                           "embed_batches": stats1["embed_batches"] - stats0["embed_batches"],
                           "sampled": len(pick), "cosine_min": float(cos.min())},
                "search": {"queries": len(queries), "fused": fused, "fallbacks": fallbacks,
                           "p50_ms": float(np.percentile(lat, 50)),
                           "p95_ms": float(np.percentile(lat, 95)), "near_ties": ties,
                           "rerank_max_abs_err": max_rr},
                "generate": {"requests": len(prompts), "new_tokens": s["gen_new"],
                             "chunk": min(lm.config.stream_chunk, s["gen_new"]),
                             "first_chunk_ms": [(sse["first_t"][t] - gen_t0[t]) * 1e3
                                                for t in gen_t0],
                             "total_ms": [(sse["final_t"][t] - gen_t0[t]) * 1e3 for t in gen_t0],
                             "direct_first_chunk_ms": direct_first,
                             "direct_total_ms": direct_total,
                             "partials": [len(sse["partials"][t]) for t in gen_t0],
                             "near_ties": texts_ties},
                "batched": {"requests": len(btids), "sessions": sessions, "admitted": admitted,
                            "ms": batch_ms, "direct_ms": direct_batch_ms,
                            "near_ties": batch_ties},
                "b1": {"launches": counted, "equation": equation},
                "readyz": {"503_seen": ready_seen.count(503), "polls": len(ready_seen)},
                "search_trace_spans": sorted(names),
                "recent_traces": len(recent),
            })
        except BaseException:
            await stack.stop()  # a failed check leaves no server or task behind
            raise
        await stack.stop()
        await asyncio.sleep(0.05)
        left = [t for t in asyncio.all_tasks()
                if t is not asyncio.current_task() and not t.done()]
        check(not left, f"tasks left after stop(): {[t.get_name() for t in left]}")
        return out

    out = asyncio.run(scenario())
    ing, se, ge = out["ingest"], out["search"], out["generate"]
    print(f"[stack] SymbiontStack up in {out['start_s']:.1f} s (TorchEngine flash + "
          f"cross-encoder, LmEngine GPT-2, in-process bus, gateway on 127.0.0.1); /readyz "
          f"{out['readyz']['503_seen']} x 503 of {out['readyz']['polls']} polls while "
          f"starting, then 200", flush=True)
    serve_s = "" if not serve else (f"; [serve] {serve['emb_s_first']:.1f} / "
                                    f"{serve['emb_s_second']:.1f} emb/s direct")
    print(f"[stack] ingest: {s['pages']} pages, {ing['sentences']} sentences over HTTP in "
          f"{ing['seconds']:.2f} s = {ing['sentences_per_s']:.1f} sentences/s (first POST to "
          f"the last row){serve_s}; {ing['flushes']} MicroBatcher flushes, "
          f"{ing['rows_per_flush']:.1f} rows a flush, {ing['embed_batches']} embed batches; "
          f"graph {s['pages']} documents; {ing['sampled']} stored vectors vs embed_texts cosine min "
          f"{ing['cosine_min']:.6f}", flush=True)
    print(f"[stack] ingest host time by span (calls, ms; handlers overlap): the {s['pages']} POSTs "
          f"answered after {ing['posts_s']:.2f} s; " + ", ".join(
              f"{k} {v['calls']} / {v['ms']:.1f}" for k, v in ing["spans"].items()), flush=True)
    direct_s = "" if not serve else f"; [search] direct search_fused p50 {serve['fused_p50_ms']:.3f} ms"
    print(f"[stack] search: {se['queries']} queries top_k {s['top_k']} with rerank, "
          f"{se['fused']} on the fused hop, {se['fallbacks']} fallbacks; HTTP p50 "
          f"{se['p50_ms']:.2f} ms, p95 {se['p95_ms']:.2f} ms{direct_s}; hits = search_fused "
          f"({se['near_ties']} near-ties); rerank vs engine.rerank max |err| "
          f"{se['rerank_max_abs_err']:.3g}", flush=True)
    def ms(xs):
        return ", ".join(f"{x:.1f}" for x in xs)

    print(f"[stack] generate: {ge['requests']} greedy streams x {ge['new_tokens']} tokens "
          f"(GPT-2, flash prefill), one after another: POST to the first {ge['chunk']}-token "
          f"chunk {ms(ge['first_chunk_ms'])} ms, to the final event {ms(ge['total_ms'])} ms on "
          f"/api/events; the same streams on LmEngine.generate_stream directly: first chunk "
          f"{ms(ge['direct_first_chunk_ms'])} ms, end {ms(ge['direct_total_ms'])} ms; partials "
          f"{ge['partials']} and a final event each; text = LmEngine.generate "
          f"({len(ge['near_ties'])} near-ties)", flush=True)
    bt = out["batched"]
    print(f"[stack] batched: {bt['requests']} non-stream requests x {ge['new_tokens']} tokens "
          f"posted at once: {bt['sessions']} GenBatcher session, {bt['admitted']} admissions; "
          f"first POST to the last final event {bt['ms']:.1f} ms, LmEngine.generate_batch of the "
          f"same prompts directly {bt['direct_ms']:.1f} ms; texts = its rows "
          f"({len(bt['near_ties'])} near-ties)", flush=True)
    print(f"[stack] B1 launches {out['b1']['equation']}; /metrics parses with engine_* and "
          f"span_* families; /api/traces/recent lists {out['recent_traces']} traces, no error, and a search's "
          f"trace holds {', '.join(out['search_trace_spans'])}; "
          f"/api/health/engine stats; no task left after stop()", flush=True)
    return {"launches": out["b1"]["launches"], **{k: v for k, v in out.items() if k != "b1"},
            "b1_equation": out["b1"]["equation"]}


FLEET = dict(pages=32, sentences=32, queries=20, top_k=5, gen=4, gen_new=64, chunk=16,
             gen_bucket=(16, 64), heartbeat_s=0.5, timeout_s=180.0)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def config_env(section: str, fields: dict) -> dict:
    """`fields` of one config section as the `SYMBIONT_<SECTION>_<FIELD>`
    variables `load_config` reads (lists as JSON, booleans as 1/0)."""
    def text(v):
        if isinstance(v, bool):
            return "1" if v else "0"
        return json.dumps(v) if isinstance(v, (list, tuple)) else str(v)

    return {f"SYMBIONT_{section.upper()}_{k.upper()}": text(v) for k, v in fields.items()}


def serve_pages(pages: dict):
    """A localhost HTTP server handing `pages` ({path: html}) to the
    perception role's process, which fetches what it is told to; → the
    server (its port at `server_address[1]`), serving on a thread."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Pages(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = pages.get(self.path, "").encode()
            self.send_response(200 if body else 404)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Pages)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def card_memory_used_mib() -> int | None:
    """The card's memory in use over all processes, MiB, as nvidia-smi
    reports it; None without nvidia-smi. (It lists no process of this
    machine by pid, so a process's share is read as a difference.)"""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30).stdout.split()
    except (OSError, subprocess.SubprocessError):
        return None
    return int(out[0]) if out and out[0].isdigit() else None


def search_hops(tree) -> list:
    """The spans of a stitched `/api/traces/<id>` tree in start order, as
    (name, role, duration ms, self ms): self is the time no child covers."""
    from symbiont_tpu_torch.obs.critical_path import annotate_self_times

    annotate_self_times(tree)
    rows, stack = [], list(tree.get("roots", []))
    while stack:
        n = stack.pop()
        stack.extend(n["children"])
        rows.append((n["start_ms"], n["name"], (n.get("fields") or {}).get("role", "gateway"),
                     n["duration_ms"], n["self_ms"]))
    return [r[1:] for r in sorted(rows)]


def journal_chunks(path):
    """The chunk records of one journal file, in order (done markers and a
    torn last line skipped)."""
    for line in Path(path).read_text().splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "tokens" in rec:
            yield rec


def journal_records(path) -> dict:
    """Per task id, the chunk records a journal file holds."""
    out: dict = {}
    for rec in journal_chunks(path):
        out[rec["task_id"]] = out.get(rec["task_id"], 0) + 1
    return out


def journal_tokens(jdir) -> dict:
    """Per task id, the most tokens any record in `jdir`'s journals (live
    and rotated aside) holds: a stream's whole output once its last chunk
    is journalled, whichever worker wrote it."""
    out: dict = {}
    for path in sorted(Path(jdir).glob("*.genlog*")):
        for rec in journal_chunks(path):
            if len(rec["tokens"]) >= len(out.get(rec["task_id"], [])):
                out[rec["task_id"]] = list(rec["tokens"])
    return out


def exposition_roles(text: str) -> set:
    """Every `role` label value of a /metrics exposition."""
    return set(re.findall(r'role="([^"]+)"', text))


def trace_processes(tree) -> int:
    """Processes a stitched `/api/traces/<id>` tree spans: the gateway's
    own spans, and one per pid its remote spans carry."""
    pids, local = set(), [False]

    def walk(n):
        f = n.get("fields") or {}
        if "pid" in f:
            pids.add(f["pid"])
        else:
            local[0] = True
        for c in n.get("children", []):
            walk(c)

    for root in tree.get("roots", []):
        walk(root)
    return len(pids) + local[0]


async def _until(pred, what: str, limit: float, poll: float = 0.01):
    t_end = time.monotonic() + limit
    while True:
        got = pred()
        if asyncio.iscoroutine(got):
            got = await got
        if got:
            return got
        check(time.monotonic() < t_end, f"{what}: not reached in {limit:.0f} s")
        await asyncio.sleep(poll)


def _fleet_env(tmp, device) -> dict:
    """What every supervised role's process gets: fast fleet publishes, its
    stores under `tmp`, the checkout on its path, and the embed engine on
    the CPU (no role process holds one: those that would run in this
    process), so a role without a CUDA engine never opens a context."""
    return {"SYMBIONT_OBS_FLEET_PUBLISH_S": "0.3", "SYMBIONT_ENGINE_FORCE_CPU": "1",
            "SYMBIONT_VECTOR_STORE_DATA_DIR": str(tmp / "fleet_vs"),
            "SYMBIONT_GRAPH_STORE_DATA_DIR": str(tmp / "fleet_gs"),
            "SYMBIONT_TEXT_GENERATOR_MARKOV_STATE_PATH": str(tmp / "fleet_markov.json"),
            "PYTHONPATH": str(Path(__file__).resolve().parent)}


async def _fleet_search(rng, tmp, s, device, engine_kw, sup_log) -> dict:
    """Ingest and search over a supervised deployment (JAX's
    load_multiproc layout): the port's broker, gateway (2-hop search, as
    there), perception, memory and graphgen as supervised processes, the
    embed role (preprocessing + the engine plane for rerank) a
    SymbiontStack in this process on the same bus, so its B1 launches are
    counted where they happen."""
    from symbiont_tpu_torch import subjects
    from symbiont_tpu_torch.config import (BusConfig, EngineConfig, GraphStoreConfig, ObsConfig,
                                           RunnerConfig, SymbiontConfig, TextGeneratorConfig,
                                           VectorStoreConfig)
    from symbiont_tpu_torch.ops import flash_attention as fa
    from symbiont_tpu_torch.resilience.procsup import (ProcessSupervisor, pybroker_spec,
                                                       runner_spec)
    from symbiont_tpu_torch.runner import SymbiontStack

    limit = s["timeout_s"]
    html, docs = stack_pages(rng, s["pages"], s["sentences"])
    n_sent = s["pages"] * s["sentences"]
    pages = {url.split("pages.invalid", 1)[1]: body for url, body in html.items()}
    srv = serve_pages(pages)
    urls = [f"http://127.0.0.1:{srv.server_address[1]}{path}" for path in pages]
    broker_port, api_port = _free_port(), _free_port()
    bus_url = f"symbus://127.0.0.1:{broker_port}"
    ecfg = EngineConfig(**{"attn_impl": "flash", "rerank_enabled": True,
                           "force_cpu": device == "cpu", **(engine_kw or {})})
    # at-least-once ingest, as JAX's layout runs it: the pipeline's subjects
    # on a durable stream of the broker, acked after each side effect
    durable = dict(durable=True, durable_ack_wait_s=30.0, durable_max_deliver=10)
    common = {**_fleet_env(tmp, device), **config_env("bus", durable)}
    hb = dict(heartbeat_s=s["heartbeat_s"], heartbeat_timeout_s=30.0)
    # no exporter of the supervisor's own: it shares this process with a
    # role, whose exporter already sends the process's registry (procsup.*
    # included, which /api/fleet folds from any role) and spans
    sup = ProcessSupervisor(bus_url=bus_url, stdio=sup_log, fleet_telemetry=False)
    sup.add_worker(pybroker_spec(broker_port, str(tmp / "fleet_bus")))
    sup.add_worker(runner_spec("gateway", "api", bus_url, env={
        **common, "SYMBIONT_API_HOST": "127.0.0.1", "SYMBIONT_API_PORT": str(api_port),
        "SYMBIONT_API_FUSED_SEARCH": "0"}, **hb))
    sup.add_worker(runner_spec("perception", "perception", bus_url, env=common, **hb))
    # the memory role's store on the host, one capacity block for the
    # whole corpus (a search scores every row of the block)
    sup.add_worker(runner_spec("memory", "vector_memory", bus_url, env={
        **common, "SYMBIONT_VECTOR_STORE_DIM": str(ecfg.embedding_dim),
        "SYMBIONT_VECTOR_STORE_SHARD_CAPACITY": str(max(256, n_sent))}, **hb))
    sup.add_worker(runner_spec("graphgen", "knowledge_graph,text_generator", bus_url,
                               env=common, **hb))
    roles = ("gateway", "perception", "memory", "graphgen")
    embed = SymbiontStack(SymbiontConfig(
        engine=ecfg, bus=BusConfig(url=bus_url, **durable),
        vector_store=VectorStoreConfig(data_dir=str(tmp / "fleet_embed_vs")),
        graph_store=GraphStoreConfig(data_dir=str(tmp / "fleet_embed_gs")),
        text_generator=TextGeneratorConfig(markov_state_path=None),
        runner=RunnerConfig(services="preprocessing,engine", role="embed",
                            heartbeat_s=s["heartbeat_s"]),
        obs=ObsConfig(fleet_publish_s=0.3)))
    loop = asyncio.get_running_loop()

    def http(method, path, body=None, headers=None, accept="application/json"):
        def call():
            try:
                return _http(api_port, method, path, body, timeout=limit, accept=accept,
                             headers=headers)
            except OSError:
                return 0, b""  # the gateway's socket is not bound yet
        return loop.run_in_executor(None, call)

    async def ok_json(method, path, body=None, headers=None):
        st, raw = await http(method, path, body, headers)
        check(200 <= st < 300, f"[fleet] {method} {path}: HTTP {st} {raw[:300]!r}")
        return json.loads(raw or b"{}")

    async def store_count() -> int:
        try:
            reply = await embed.bus.request(subjects.TASKS_MEMORY_COUNT, b"{}", timeout=5.0)
            return int(json.loads(reply.data).get("count") or 0)
        except (TimeoutError, ConnectionError, ValueError):
            return -1

    out: dict = {}
    t_boot = time.monotonic()
    used0 = card_memory_used_mib()
    await sup.start()
    try:
        for role in roles:
            await sup.wait_role_up(role, after=t_boot - 1, timeout_s=limit)
        # the four supervised roles hold no engine: they must not have
        # opened a CUDA context (each would take hundreds of MiB)
        used1 = card_memory_used_mib()
        roles_mib = None if used0 is None else used1 - used0
        check(roles_mib is None or roles_mib < 128,
              f"[fleet] the card's memory rose {roles_mib} MiB while {', '.join(roles)} "
              f"started: a role without an engine opened a CUDA context")
        await embed.start()
        await _until(lambda: _ready(api_port), "the gateway's /readyz", limit, poll=0.05)
        out["boot_s"] = time.monotonic() - t_boot
        eng = embed.engine
        layers = eng.model_cfg.num_layers
        stats0 = dict(eng.stats)
        fa.launches = 0  # ------------------------------------------------- main path
        t_ing = time.perf_counter()
        for url in urls:
            await ok_json("POST", "/api/submit-url", {"url": url})

        async def ingested():
            return await store_count() >= n_sent
        await _until(ingested, f"ingest of {n_sent} sentences", limit, poll=0.05)
        ingest_s = time.perf_counter() - t_ing
        queries = [docs[i % len(docs)][1][i % s["sentences"]] for i in range(s["queries"])]
        lat, answers = [], []
        for i, q in enumerate(queries):
            t1 = time.perf_counter()
            body = await ok_json("POST", "/api/search/semantic",
                                 {"query_text": q, "top_k": s["top_k"], "rerank": True},
                                 headers=({"X-Trace-Id": "fleet-search"}
                                          if i == len(queries) - 1 else None))
            lat.append((time.perf_counter() - t1) * 1e3)
            check(body["error_message"] is None and len(body["results"]) == s["top_k"],
                  f"[fleet] search {q[:40]!r}: {body['error_message']}, "
                  f"{len(body['results'])} results")
            answers.append(body["results"])
        counted = fa.launches  # -------------------------------------------- main path end
        stats1 = dict(eng.stats)
        embed_b = stats1["embed_batches"] - stats0["embed_batches"]
        qsearch = stats1["qsearch_calls"] - stats0["qsearch_calls"]
        rerank_b = stats1["rerank_batches"] - stats0["rerank_batches"]
        want_b1 = layers * (embed_b + qsearch + rerank_b)
        equation = (f"{counted} = {layers} x ({embed_b} embed batches + {qsearch} fused "
                    f"queries + {rerank_b} rerank batches)")
        check(counted == want_b1 and rerank_b >= len(queries) and embed_b >= 1,
              f"[fleet] embed role's B1 launches: {equation} does not hold")
        gw = (await ok_json("GET", "/api/metrics"))["counters"]
        fallbacks = int(gw.get("api.fused_search_fallback", 0))
        check(fallbacks == 0, f"[fleet] {fallbacks} searches took the 2-hop fallback")
        # the federated surfaces: one stitched trace, one role-labelled
        # exposition, the roll-up
        all_roles = set(roles) | {"embed"}

        hops = {"api.search", "preprocessing.handle", "vector_memory.search", "engine.rerank"}

        async def stitched():
            # every hop's span federated (each role publishes every 0.3 s)
            st, raw = await http("GET", "/api/traces/fleet-search")
            tree = json.loads(raw) if st == 200 else {}
            return tree if (trace_processes(tree) >= 3 and len(tree.get("roots", [])) == 1
                            and hops <= span_names(tree)) else None
        tree = await _until(stitched, "a search trace stitched over 3 processes", limit, 0.1)

        async def exposition():
            st, raw = await http("GET", "/metrics", accept="text/plain")
            text = raw.decode() if st == 200 else ""
            return text if all_roles <= exposition_roles(text) else None
        text = await _until(exposition, f"/metrics labelled with {sorted(all_roles)}", limit,
                            0.1)
        exposition_families(text)
        fleet = await ok_json("GET", "/api/fleet")
        check(all_roles <= set(fleet["roles"]), f"[fleet] /api/fleet lists "
                                                f"{sorted(fleet['roles'])}, not every role")
        # a scale-in drain: a second perception replica out, then drained
        t_out = time.monotonic()
        added = (await sup.scale_role("perception", 2))["added"]
        await sup.wait_role_up(added[0], after=t_out, timeout_s=limit)
        drained = (await sup.scale_role("perception", 1))["drained"]
        _, replica, clean, drain_s = sup.drain_events[-1]
        check(drained == added and replica == added[0] and clean,
              f"[fleet] scale-in of {added}: drained {drained}, clean {clean}")
        out.update({
            "ingest": {"sentences": n_sent, "seconds": ingest_s,
                       "sentences_per_s": n_sent / ingest_s, "embed_batches": embed_b},
            "search": {"queries": len(queries), "p50_ms": float(np.percentile(lat, 50)),
                       "p95_ms": float(np.percentile(lat, 95)), "fallbacks": fallbacks},
            "b1": {"launches": counted, "equation": equation},
            "trace_processes": trace_processes(tree), "roles": sorted(fleet["roles"]),
            "search_hops": search_hops(tree),
            "drain": {"replica": replica, "clean": clean, "seconds": drain_s},
            "memory": {"embed (this process, allocated)": torch.cuda.memory_allocated()
                       if device == "cuda" else None,
                       "gateway, perception, memory, graphgen (card MiB)": roles_mib},
        })
    finally:
        await embed.stop()
        await sup.stop()
        srv.shutdown()
    check(all(w.proc is None or w.proc.poll() is not None for w in sup.workers.values()),
          "[fleet] a supervised process outlived stop()")
    # what came out: the memory role's rows, read back from its journal,
    # hold the HTTP hits to search_fused on this process's engine
    from symbiont_tpu_torch.graph.store import GraphStore
    from symbiont_tpu_torch.memory.vector_store import VectorStore

    store = VectorStore(VectorStoreConfig(dim=eng.model_cfg.hidden_size,
                                          data_dir=str(tmp / "fleet_vs")), device=eng.device)
    check(store.count() == n_sent, f"[fleet] the memory role holds {store.count()} rows, "
                                   f"want {n_sent}")
    graph = GraphStore(GraphStoreConfig(data_dir=str(tmp / "fleet_gs")))
    docs_n = graph.counts()["Document"]
    graph.close()
    check(docs_n == s["pages"], f"[fleet] graph documents {docs_n} != {s['pages']}")
    ties, max_rr = 0, 0.0
    for q, res in zip(queries, answers):
        want = store.search_fused(eng, q, 2 * s["top_k"])
        got_ids = {r["qdrant_point_id"] for r in res}
        if got_ids != {h.id for h in want[:s["top_k"]]}:
            by_id = {h.id: h.score for h in want}
            kth = want[s["top_k"] - 1].score
            check(all(i in by_id and by_id[i] >= kth - 2.0 ** -8 for i in got_ids),
                  f"[fleet] search {q[:40]!r}: hits {sorted(got_ids)} != search_fused beyond "
                  f"a near-tie")
            ties += 1
        scores = eng.rerank(q, [r["payload"]["sentence_text"] for r in res])
        max_rr = max(max_rr, float(np.abs(scores - np.array([r["score"] for r in res],
                                                             np.float32)).max()))
    check(max_rr <= RERANK_BAR, f"[fleet] rerank vs engine.rerank max |err| {max_rr:.4g}")
    out["search"].update({"near_ties": ties, "rerank_max_abs_err": max_rr})
    out["graph_documents"] = docs_n
    return out


def _ready(port: int) -> bool:
    try:
        return _http(port, "GET", "/readyz", timeout=5)[0] == 200
    except OSError:
        return False


async def _fleet_durable(rng, tmp, s, device, lm_kw, sup_log) -> dict:
    """Durable generation over a supervised deployment (JAX's
    load_multiproc_gen layout): the port's broker, the gateway and gen1 as
    supervised processes, gen2 a SymbiontStack in this process, both
    generation roles on one GPT-2 dir at float32 with flash prefill and the
    journal on. `gen` greedy streams are posted at once and watched on
    /api/events; once every stream gen1 holds has sent its second chunk,
    gen1 is SIGKILLed, the supervisor rescues its journal's tails and gen2
    adopts them, re-prefilling each prompt + generated prefix through B1."""
    from symbiont_tpu_torch import subjects
    from symbiont_tpu_torch.config import (BusConfig, GenJournalConfig, LmConfig, ObsConfig,
                                           RunnerConfig, SymbiontConfig, TextGeneratorConfig)
    from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
    from symbiont_tpu_torch.ops import flash_attention as fa
    from symbiont_tpu_torch.resilience.genlog import GenJournal
    from symbiont_tpu_torch.resilience.procsup import (ProcessSupervisor, pybroker_spec,
                                                       runner_spec)
    from symbiont_tpu_torch.runner import SymbiontStack
    from symbiont_tpu_torch.services.text_generator import TextGeneratorService
    from symbiont_tpu_torch.utils.telemetry import metrics

    limit = s["timeout_s"]
    prompts = ragged_prompts(rng, *s["gen_bucket"], s["gen"])
    tids = [f"fleet-gen-{i}" for i in range(len(prompts))]
    jdir = tmp / "fleet_genlog"
    lm_fields = {"enabled": True, "model_dir": str(tmp / "gpt2"), "dtype": "float32",
                 "attn_impl": "flash", "stream_chunk": s["chunk"], **(lm_kw or {})}
    broker_port, api_port = _free_port(), _free_port()
    bus_url = f"symbus://127.0.0.1:{broker_port}"
    common = _fleet_env(tmp, device)
    hb = dict(heartbeat_s=s["heartbeat_s"], heartbeat_timeout_s=30.0)
    sup = ProcessSupervisor(bus_url=bus_url, stdio=sup_log, fleet_telemetry=False)
    sup.add_worker(pybroker_spec(broker_port, str(tmp / "fleet_gen_bus")))
    sup.add_worker(runner_spec("gateway", "api", bus_url, env={
        **common, "SYMBIONT_API_HOST": "127.0.0.1", "SYMBIONT_API_PORT": str(api_port),
        "SYMBIONT_API_SSE_KEEPALIVE_S": "0.5"}, **hb))
    gen1 = runner_spec("gen1", "text_generator", bus_url, env={
        **common, **config_env("lm", lm_fields),
        **config_env("gen_journal", {"enabled": True, "dir": str(jdir)})}, **hb)
    # the runner's main through this script, for its id tokenizer (below)
    gen1.argv = [sys.executable, str(Path(__file__).resolve()), "--fleet-worker"]
    sup.add_worker(gen1)
    gen2 = SymbiontStack(SymbiontConfig(
        bus=BusConfig(url=bus_url), lm=LmConfig(**lm_fields),
        gen_journal=GenJournalConfig(enabled=True, dir=str(jdir)),
        text_generator=TextGeneratorConfig(markov_state_path=None),
        runner=RunnerConfig(services="text_generator", role="gen2",
                            heartbeat_s=s["heartbeat_s"]),
        obs=ObsConfig(fleet_publish_s=0.3)))
    loop = asyncio.get_running_loop()
    sse = {t: [] for t in tids}
    finals: dict = {}
    published: list = []  # (wall t, task, seq) of every partial on the bus

    async def sse_reader():
        reader, writer = await asyncio.open_connection("127.0.0.1", api_port)
        writer.write(b"GET /api/events HTTP/1.1\r\nHost: x\r\n\r\n")
        await writer.drain()
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                if line.startswith(b"data: "):
                    ev = json.loads(line[6:])
                    tid = ev.get("original_task_id")
                    if tid in sse and "text_delta" in ev:
                        sse[tid].append(ev)
                    elif tid in sse:
                        finals[tid] = ev["generated_text"]
        finally:
            writer.close()

    async def bus_reader(sub):
        async for msg in sub:
            ev = json.loads(msg.data)
            published.append((time.time(), ev["original_task_id"], ev["seq"]))

    def post(tid, prompt):
        return _http(api_port, "POST", "/api/generate-text",
                     {"task_id": tid, "prompt": prompt, "max_length": s["gen_new"],
                      "stream": True, "temperature": 0.0}, timeout=limit)

    out: dict = {}
    tasks = []
    t_boot = time.monotonic()
    used0 = card_memory_used_mib()
    await sup.start()
    try:
        for role in ("gateway", "gen1"):
            await sup.wait_role_up(role, after=t_boot - 1, timeout_s=limit)
        used1 = card_memory_used_mib()  # gen1 up: its context, weights and cache
        await gen2.start()
        await _until(lambda: _ready(api_port), "the gateway's /readyz", limit, poll=0.05)
        out["boot_s"] = time.monotonic() - t_boot
        lm = gen2.lm
        # every id out as text, in both generation roles (gen1's through
        # --fleet-worker): the card has no tokenizer package, and the byte
        # tokenizer would drop nearly every GPT-2 id, so chunks would send
        # no delta
        lm.tokenizer = IdTokenizer()
        mc = lm.model_cfg
        [svc] = [x for x in gen2.services if isinstance(x, TextGeneratorService)]
        # B1 against its plain version at this path's prefill shapes: the
        # buckets of the prompts' streams and of each resume's prompt +
        # generated prefix after 1 to 3 chunks (one row, causal, GPT-2's
        # heads, float32), each at the shortest real row it meets there
        shapes: dict = {}
        for prompt in prompts:
            ids = lm.tokenizer.encode(prompt, 1 << 30)
            for k in range(s["gen_new"] // s["chunk"]):
                body = ids + [0] * (k * s["chunk"])
                P = lm._prepare_prompts([""], s["gen_new"] - k * s["chunk"],
                                        encoded=[body])[0].shape[1]
                shapes[P] = min(shapes.get(P, P), len(body))
        for P, n in sorted(shapes.items()):
            b1_against_plain(rng, 1, mc, P, device, tag="fleet", lens=[n])
        sub = await gen2.bus.subscribe(subjects.EVENTS_TEXT_GENERATED_PARTIAL)
        tasks.append(asyncio.create_task(bus_reader(sub)))
        tasks.append(asyncio.create_task(sse_reader()))
        await asyncio.sleep(0.3)  # the SSE client is registered
        prefill0 = lm_prefills(metrics)
        resumes0, orphans0 = metrics.get("gen.resumes"), metrics.get("gen.orphans")
        abandoned0 = metrics.get("gen.resume_abandoned")
        n_events0 = len(engine_timeline.events())
        fa.launches = 0  # ------------------------------------------------- main path
        replies = await asyncio.gather(*(loop.run_in_executor(None, post, t, p)
                                         for t, p in zip(tids, prompts)))
        for tid, (st, raw) in zip(tids, replies):
            check(200 <= st < 300, f"[fleet] POST /api/generate-text {tid}: HTTP {st}")
        # who holds what: gen2 (this process) knows its own tasks; gen1's
        # journal names its own, a record a chunk. Killed once each of its
        # streams has journalled a chunk and one has journalled a second
        # (the journal is written before a chunk is sent: the earliest sign)
        held2, gen1_recs = set(), {}

        def kill_now() -> bool:
            path = jdir / "gen1.genlog"
            gen1_recs.clear()
            gen1_recs.update(journal_records(path) if path.exists() else {})
            held2.update(set(svc._inflight) | set(svc._completed_recent))
            return (len(held2) + len(gen1_recs) == len(tids)
                    and bool(gen1_recs) and max(gen1_recs.values()) >= 2)

        await _until(kill_now, "gen1's second journalled chunk", limit, poll=0.002)
        os.kill(sup.pid("gen1"), signal.SIGKILL)
        t_kill = time.time()
        held1 = sorted(gen1_recs)  # read before the kill: the rescue rotates the file
        await _until(lambda: all(t in finals for t in tids), "every stream's final event",
                     limit)
        await _until(lambda: all(not GenJournal(p).live_tails()
                                 for p in jdir.glob("*.genlog")),
                     "journals with no live tail", limit)
        counted = fa.launches  # -------------------------------------------- main path end
        prefills = lm_prefills(metrics) - prefill0
        resumes = metrics.get("gen.resumes") - resumes0
        orphans = metrics.get("gen.orphans") - orphans0
        abandoned = metrics.get("gen.resume_abandoned") - abandoned0
        resume_ev = [e for e in engine_timeline.events()[n_events0:] if e["kind"] == "resume"]
        # every tail the supervisor rescued from gen1's journal (its streams
        # not marked done when it died) was adopted, once
        check(resumes == len(resume_ev) == orphans >= 1 and abandoned == 0,
              f"[fleet] gen.orphans {orphans}, gen.resumes {resumes}, {len(resume_ev)} resume "
              f"events, abandoned {abandoned}")
        want_b1 = mc.num_layers * prefills
        equation = (f"{counted} = {mc.num_layers} x ({prefills - resumes} stream prefills + "
                    f"{resumes} resume re-prefills)")
        check(counted == want_b1 and prefills == len(tids) - len(held1) + resumes,
              f"[fleet] gen2's B1 launches: {equation} does not hold")
        # the first partial of a resumed stream published after gen2 noted
        # its first resume (what gen1 sent before its death can still be in
        # flight after the kill): the replay of a journalled chunk
        adopted_t = min(e["t"] for e in resume_ev)
        first_replay = min((t for t, tid, _ in published if tid in held1 and t >= adopted_t),
                           default=None)
        check(first_replay is not None, "[fleet] no resumed delta published after the kill")
        # what came out: seq gapless and unrepeated, partials = the final
        # text, and every stream's tokens (from the journals) = generate()
        ties = []
        ids_of = journal_tokens(jdir)
        tok = lm.tokenizer
        wants = {i: [int(x) for x in re.findall(r"\[(\d+)\]",
                                                  lm.generate(p, s["gen_new"], 0.0))]
                 for i, p in enumerate(prompts)}
        for i, t in enumerate(tids):
            seqs = [e["seq"] for e in sse[t]]
            check(seqs == list(range(len(seqs))) and sse[t][-1]["done"],
                  f"[fleet] {t}: SSE seq {seqs} has a gap or a duplicate")
            joined = "".join(e["text_delta"] for e in sse[t])
            check(joined == finals[t] == tok.decode(ids_of.get(t, [])),
                  f"[fleet] {t}: partials, final text and journalled tokens disagree")
            if ids_of.get(t) != wants[i]:
                ties += same_or_near_tie(f"fleet {t}", {i: ids_of.get(t, [])}, {i: wants[i]},
                                         lm, {i: prompts[i]})
        st, raw = await loop.run_in_executor(None, lambda: _http(
            api_port, "GET", "/metrics", timeout=limit, accept="text/plain"))
        text = raw.decode() if st == 200 else ""
        check({"gateway", "gen1", "gen2"} <= exposition_roles(text),
              f"[fleet] /metrics roles {sorted(exposition_roles(text))}")
        fed = {m.group(1): float(m.group(2)) for m in re.finditer(
            r'symbiont_device_bytes_in_use\{[^}]*role="([^"]+)"[^}]*\} (\S+)', text)}
        out.update({
            "streams": len(tids), "held_by_gen1": len(held1), "resumed": resumes,
            "kill_to_first_replayed_delta_ms": (first_replay - t_kill) * 1e3,
            "resume_prefill_ms": [e["prefill_ms"] for e in resume_ev],
            "resume_tokens": [e["tokens"] for e in resume_ev],
            "b1": {"launches": counted, "equation": equation},
            "near_ties": ties, "gen_orphans": orphans,
            "memory": {"gen2 (this process, allocated)": torch.cuda.memory_allocated()
                       if device == "cuda" else None,
                       "gen1 (its federated device.bytes_in_use)": fed.get("gen1"),
                       "gateway and gen1 (card MiB)": (None if used0 is None
                                                       else used1 - used0)},
        })
    finally:
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await gen2.stop()
        await sup.stop()
    check(all(w.proc is None or w.proc.poll() is not None for w in sup.workers.values()),
          "[fleet] a supervised process outlived stop()")
    return out


def fleet_phase(rng, tmp, sizes=None, device="cuda", engine_kw=None, lm_kw=None) -> dict:
    """ROADMAP A8 stage 2 on the card: the port's stack as supervised OS
    processes over its own TCP bus and broker, in the role layouts of the
    JAX package's multi-process runs. Ingest and search: `pages` pages of
    `sentences` sentences through /api/submit-url and `queries` searches
    with rerank over HTTP, their hits held to search_fused on the memory
    role's rows and their scores to engine.rerank; a stitched trace over 3
    processes, the role-labelled /metrics and /api/fleet of every role, a
    scale-in drain. Durable generation: `gen` greedy GPT-2 streams at
    float32, the worker holding some SIGKILLed after their second chunk,
    each stream's SSE seq gapless, its tokens `generate()`'s (or a named
    near-tie), the journals drained, `gen.resumes` counted. B1 against its
    plain version at every prefill shape of the generation roles, and its
    launches counted in this process, which hosts the embed role and the
    adopting generation role, and held to the launch equation. Every child
    is stopped on every exit path. The GPT-2 dir is the one [generate]
    writes in `tmp` (written here when absent)."""
    s = dict(FLEET, **(sizes or {}))
    tmp = Path(tmp)
    if not (tmp / "gpt2" / "config.json").exists():
        from symbiont_tpu_torch.models import gpt as gpt_mod

        params = gpt_mod.init_params(torch.Generator(device=device).manual_seed(SEED + 8),
                                     gpt_mod.GPTConfig.from_hf(GPT2_124M))
        write_gpt_checkpoint(tmp / "gpt2", params, GPT2_124M, torch.float32)
        del params
    card = card_line() if device == "cuda" else "cpu"
    with open(tmp / "fleet_workers.log", "ab") as log:
        try:
            search = asyncio.run(_fleet_search(rng, tmp, s, device, engine_kw, log))
            durable = asyncio.run(_fleet_durable(rng, tmp, s, device, lm_kw, log))
        except BaseException:
            log.flush()
            tail = (tmp / "fleet_workers.log").read_text(errors="replace")[-3000:]
            print(f"[fleet] the supervised processes' last output:\n{tail}", file=sys.stderr)
            raise
    ing, se = search["ingest"], search["search"]
    print(f"[fleet] ({card}) ingest and search over the port's broker: gateway, perception, "
          f"memory, graphgen supervised (up in {search['boot_s']:.1f} s), embed in this "
          f"process; {ing['sentences']} sentences in {ing['seconds']:.2f} s = "
          f"{ing['sentences_per_s']:.1f} sentences/s; {se['queries']} searches with rerank "
          f"(2-hop: the store is the memory role's), HTTP p50 {se['p50_ms']:.2f} ms, p95 "
          f"{se['p95_ms']:.2f} ms, {se['fallbacks']} fallbacks, hits = search_fused on the "
          f"memory role's rows ({se['near_ties']} near-ties), rerank max |err| "
          f"{se['rerank_max_abs_err']:.3g}; graph {search['graph_documents']} documents",
          flush=True)
    print(f"[fleet] ({card}) the last search's spans (role: ms, self ms), in start order: "
          + ", ".join(f"{name} ({role}: {ms:.2f}, {own:.2f})"
                      for name, role, ms, own in search["search_hops"])
, flush=True)
    print(f"[fleet] ({card}) a search's trace stitched over {search['trace_processes']} "
          f"processes; /metrics and /api/fleet name {', '.join(search['roles'])}; scale-in "
          f"drained {search['drain']['replica']} cleanly in {search['drain']['seconds']:.2f} "
          f"s; B1 launches {search['b1']['equation']}; device memory "
          f"{search['memory']}", flush=True)
    du = durable
    print(f"[fleet] ({card}) durable generation: {du['streams']} greedy GPT-2 float32 streams "
          f"x {s['gen_new']} tokens, chunks of {s['chunk']}; gen1 held {du['held_by_gen1']} "
          f"and was SIGKILLed once one had journalled its second chunk; {du['resumed']} "
          f"resumed on gen2 "
          f"(gen.orphans {du['gen_orphans']}); SIGKILL to the first replayed delta "
          f"{du['kill_to_first_replayed_delta_ms']:.1f} ms; resume re-prefill ms "
          f"{[round(x, 3) for x in du['resume_prefill_ms']]} over "
          f"{du['resume_tokens']} generated tokens; SSE seq gapless, tokens = generate() "
          f"({len(du['near_ties'])} near-ties); journals drained; B1 launches "
          f"{du['b1']['equation']}; device memory {du['memory']}", flush=True)
    return {"launches": search["b1"]["launches"] + durable["b1"]["launches"],
            "search": search, "durable": durable}


def main(argv=()) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port's main path on one CUDA card.")
    ap.add_argument("--fleet-worker", action="store_true",
                    help="run one generation role of [fleet]: the runner's main, its config "
                         "from SYMBIONT_* as the supervisor sets it, with the id tokenizer "
                         "[fleet] reads GPT-2 through")
    ap.add_argument("--memory-history", action="store_true",
                    help="record the allocator's history from the start, so the [memory] "
                         "line names where each block still held was allocated (slows "
                         "every phase)")
    args = ap.parse_args(argv)
    if args.fleet_worker:
        from symbiont_tpu_torch import runner
        from symbiont_tpu_torch.engine import lm

        lm.ByteTokenizer = IdTokenizer  # what LmEngine takes without a tokenizer.json
        asyncio.run(runner.main())
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    if args.memory_history:
        torch.cuda.memory._record_memory_history(max_entries=200_000, stacks="python")
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    rng = np.random.default_rng(SEED)
    wall = {}  # phase -> host seconds
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        wall[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    kern = kernel_phase()
    lap("kernels")
    bwd = backward_kernel_phase()
    lap("backward kernels")
    serve = main_path(rng)
    lap("serve")
    train = train_path(np.random.default_rng(SEED + 3))
    lap("train")
    profile_embed(synth_texts(np.random.default_rng(SEED + 1), 1024))
    lap("profile")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ck = checkpoint_phase(np.random.default_rng(SEED + 4), tmp)
        lap("checkpoint")
        obs_phase(ck, tmp)
        lap("obs")
        ck_launches, mpnet_dir, host_leaves = ck["launches"], ck["mpnet_dir"], ck["host_leaves"]
        del ck
        qt = quant_phase(np.random.default_rng(SEED + 5), mpnet_dir, host_leaves)
        lap("quant")
        shutil.rmtree(mpnet_dir)  # room on the disk for the decoder checkpoints
        gqa = causal_gqa_kernel_phase()
        gen = generate_phase(np.random.default_rng(SEED + 6), tmp)
        lap("generate")
        sess = session_phase(np.random.default_rng(SEED + 10), tmp)
        lap("session")
        tinyllama = sess.pop("tinyllama")
        paged = paged_phase(np.random.default_rng(SEED + 13), tmp, tinyllama,
                            dense_batcher=sess["batcher"])
        lap("paged")
        spec = spec_phase(np.random.default_rng(SEED + 14), tmp, tinyllama)
        lap("spec")
        del tinyllama
        stack = stack_phase(np.random.default_rng(SEED + 15), tmp, serve=serve)
        lap("stack")
        fleet = fleet_phase(np.random.default_rng(SEED + 16), tmp)
        lap("fleet")
    fwd = {"serve": serve["launches"][0], "train": train["launches"][0],
           "checkpoint": ck_launches, "quant": qt["launches"], "generate": gen["launches"],
           "session": sess["launches"], "paged": paged["launches"], "spec": spec["launches"],
           "stack": stack["launches"], "fleet": fleet["launches"]}
    fwd_launches = sum(fwd.values())
    print("[phases] host seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items())
          + f"; total {sum(wall.values()):.1f}. flash_attn_fwd launches on the main path: "
          + ", ".join(f"{k} {v}" for k, v in fwd.items()) + f"; total {fwd_launches}",
          flush=True)
    entries = []
    causal_gqa = [{"shape": f"q [8, 32, {S}, 64], k/v [8, 4, {S}, 64] bf16, causal, left "
                            f"padding", **{k: v for k, v in r.items() if k != "label"}}
                  for S, r in gqa.items()]
    for name, src, line, ref, launches, shape in (
            ("flash_attn_fwd", "flash_attn_fwd.cu", 81, kern["enc_S128"], fwd_launches,
             "q/k/v [32, 12, 128, 64] bf16, padding bias"),
            ("flash_attn_bwd_kv", "flash_attn_bwd.cu", 212, bwd["kv_enc_S256"],
             train["launches"][1], "q/k/v/g [32, 12, 256, 64] bf16, padding bias, a length-0 row"),
            ("flash_attn_bwd_q", "flash_attn_bwd.cu", 281, bwd["q_enc_S256"],
             train["launches"][2], "q/k/v/g [32, 12, 256, 64] bf16, padding bias, a length-0 row")):
        entries.append({"name": name, "route": "cuda",
                        "source": f"symbiont_tpu_torch/ops/csrc/{src}",
                        "replaces": f"symbiont_tpu/ops/flash_attention.py:{line}",
                        "launches": launches, "shape": shape}
                       | {k: v for k, v in ref.items() if k != "label"})
    entries[0] |= {"generate_launches": gen["launches"], "causal_gqa": causal_gqa,
                   "generate": {"ttft_ms": gen["ttft"], "decode": gen["decode"],
                                "prefill_1024": gen["prefill_1024"]},
                   "session_launches": sess["launches"],
                   "session": {k: v for k, v in sess.items() if k != "launches"},
                   "paged_launches": paged["launches"],
                   "paged": {k: v for k, v in paged.items() if k != "launches"},
                   "spec_launches": spec["launches"],
                   "spec": {k: v for k, v in spec.items() if k != "launches"},
                   "stack_launches": stack["launches"],
                   "stack": {k: v for k, v in stack.items() if k != "launches"},
                   "fleet_launches": fleet["launches"],
                   "fleet": {k: v for k, v in fleet.items() if k != "launches"}}
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
