#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its main path on a GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit (`nvcc`); exits non-zero, printing no result, without them.
It imports nothing of JAX or of the JAX package. Phases, one line each,
any failure exits non-zero:

1. card    — name and power limit as nvidia-smi reports them;
2. kernels — build every CUDA kernel of the path from `symbiont_tpu_torch/
             ops/csrc`, run each on the card at the main path's shapes and
             hold it against its plain PyTorch version; time the kernel,
             the plain version and the PyTorch library call for the same
             function (SDPA, timed as a yardstick only, never used by the
             port), beside the card's bound for the work;
3. serve   — a full-width TorchEngine (768 wide, 12 layers, bf16,
             attn_impl="flash", synthetic cross-encoder) embeds ~2,000
             texts over every length bucket; checks the flash kernel ran
             once per layer per batch, and one batch against the same
             engine with plain attention;
4. search  — the embeddings go into the port's VectorStore; fused queries
             must return the hits of search(embed_query(q)); the top hits
             are reranked.

Launch counts are set to 0 just before the main path (phases 3-4) and read
just after. The last two lines are a JSON object with every kernel's
numbers and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

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


def graph_ms(fn, iters: int = 50) -> float:
    """Device time per fn() with the host's launch overhead taken out: one
    call captured in a CUDA graph, replayed `iters` times between events.
    Inputs stay in L2 across replays where they fit (50 MB)."""
    side = torch.cuda.Stream()
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


def kernel_phase() -> dict:
    from symbiont_tpu_torch.ops import _build
    from symbiont_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    _build.load()
    regs = [ln.strip() for ln in (_build.build_dir() / "build.log").read_text().splitlines()
            if "registers" in ln]
    print(f"[kernels] built {_build.build_dir().name} in {time.perf_counter() - t0:.1f} s; "
          f"ptxas: {' | '.join(regs)}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    # (label, B, NH, NKV, Sq, Sk, D, dtype, causal, lengths, timed)
    cases = []
    for S in (32, 128, 512):  # the encoder's attention at the slice's widths
        lens = rng.integers(1, S + 1, 32)
        lens[[0, 7]] = 0  # batch-padding rows: every key masked
        cases.append((f"enc_S{S}", 32, 12, 12, S, S, 64, torch.bfloat16, False, lens, True))
    cases += [
        ("f32_odd", 2, 4, 4, 100, 100, 64, torch.float32, False, [100, 0], False),
        ("f32_gqa_causal_d32", 2, 8, 2, 64, 64, 32, torch.float32, True, [64, 20], False),
        ("bf16_causal", 2, 8, 8, 256, 256, 64, torch.bfloat16, True, [256, 200], False),
        ("bf16_gqa_sq_ne_sk_d32", 2, 8, 2, 96, 160, 32, torch.bfloat16, False, [160, 0], False),
        ("bf16_d128_odd", 3, 4, 4, 77, 77, 128, torch.bfloat16, False, [77, 5, 0], False),
    ]
    # every other (batch bucket, length bucket) shape the serve path gives
    # the kernel, checked untimed and summarised on one line
    grid = []
    for B in (1, 8, 32, 128):
        for S in (32, 64, 128, 256, 512):
            if B != 32 or S in (64, 256):
                lens = rng.integers(1, S + 1, B)
                lens[-1] = 0 if B > 1 else lens[-1]
                grid.append((f"grid_B{B}_S{S}", B, 12, 12, S, S, 64, torch.bfloat16,
                             False, lens, False))
    rows, grid_err = [], 0.0
    for label, B, NH, NKV, Sq, Sk, D, dtype, causal, lens, timed in cases + grid:
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
        if timed:
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
          f"(B in 1/8/32/128, S in 32..512, a length-0 row in each B > 1): max_abs_err "
          f"{grid_err:.4g} (tol 0.02 abs + 0.02 rel)", flush=True)
    torch.cuda.empty_cache()
    return {r["label"]: r for r in rows}


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
    import dataclasses

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

    fa.launches = 0  # ------------------------------------------ main path
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
    total_launches = fa.launches  # ------------------------------ main path end
    print(f"[search] {n_rows} rows; {len(queries)} fused queries match search(embed_query) "
          f"({exact} with identical lists, the rest equal up to the query's bf16 rounding); "
          f"reranked {reranked} hits; fused query p50 {np.median(lat) * 1e3:.3f} ms, "
          f"max {max(lat) * 1e3:.3f} ms over {len(lat)} (host clock)", flush=True)
    return {"launches": total_launches}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    rng = np.random.default_rng(SEED)
    kern = kernel_phase()
    run = main_path(rng)
    profile_embed(synth_texts(np.random.default_rng(SEED + 1), 1024))
    ref = kern["enc_S128"]
    entry = {"name": "flash_attn_fwd", "route": "cuda",
             "source": "symbiont_tpu_torch/ops/csrc/flash_attn_fwd.cu",
             "replaces": "symbiont_tpu/ops/flash_attention.py:81",
             "launches": run["launches"], "max_abs_err": ref["max_abs_err"],
             "ms": ref["ms"], "plain_ms": ref["plain_ms"], "bound_ms": ref["bound_ms"],
             "bound_by": ref["bound_by"], "library_ms": ref["library_ms"],
             "shape": "q/k/v [32, 12, 128, 64] bf16, padding bias"}
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
