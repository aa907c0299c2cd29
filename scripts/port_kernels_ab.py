#!/usr/bin/env python3
"""Time the port's CUDA kernels of two checkouts in turns on one CUDA card:
the flash-attention forward B1 and the backward kernels B2 (dK/dV/dbias)
and B3 (dQ).

    python3 scripts/port_kernels_ab.py BASE_DIR [CHANGE_DIR]

Each checkout's `symbiont_tpu_torch.ops.flash_attention` runs in a process
of its own (each builds its own kernels under its own `build/`), in the
order base, change, change, base. B1 runs at the serve path's shapes: q/k/v
[32, 12, S, 64] bf16 at S = 32, 64, 128, 256, 512 with a padding bias and
two length-0 rows, SDPA's forward timed beside it. B2/B3 run at the
encoder fine-tune's: q/k/v/g [32, 12, S, 64] bf16 at S = 64, 128, 256,
512, a padding bias with one length-0 row, the forward kernel's own lse,
SDPA's backward beside the pair. B2/B3 also run in float32, causal with
no bias, at the LM training path's shapes: q/k/v/g [8, 12, S, 64] at S =
64 and 1024 (GPT-2) and [8, 6, 1024, 64] (Ulysses' head shard), the plain
versions and SDPA's causal backward beside the pair, and the float32
bound (3xTF32, `chip_smoke._bwd_bound_ms`). B1 also runs in float32,
causal with no bias, at q/k/v [8, 12, S, 64] for S = 64 and 1024, [8, 6,
1024, 64] (Ulysses' head shard) and [1, 16, 2048, 64] (TinyLlama's), and
at [spec]'s float32 prefill, causal GQA q [8, 32, 256, 64] over k/v [8, 4,
256, 64] with left padding (as `chip_smoke.causal_gqa_kernel_phase`),
beside its plain version, SDPA's causal forward and the float32 bound
(`chip_smoke._bound_ms`). Times are device time per call by CUDA-graph
replay (`chip_smoke.graph_ms`, the same inputs for both sides).
CHANGE_DIR defaults to this script's checkout; `--parts` takes a
comma-separated subset of b1, b2b3, b2b3_f32, b1_f32 (all by default).
Prints the card, one JSON line per run, and per kernel and shape each
side's mean of its two runs and change / base.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FWD_SEQS = (32, 64, 128, 256, 512)
BWD_SEQS = (64, 128, 256, 512)
F32_BWD = {"f32_8x12x64": (8, 12, 64), "f32_8x12x1024": (8, 12, 1024),
           "f32_8x6x1024": (8, 6, 1024)}  # (batch, heads, S), D = 64, causal
F32_FWD = dict(F32_BWD, f32_1x16x2048=(1, 16, 2048))
GQA_F32 = "f32_gqa_8x32x256"  # (8, 32 q heads, 4 kv heads, S 256), left padding
PARTS = ("b1", "b2b3", "b2b3_f32", "b1_f32")


def _helpers():
    """This checkout's chip_smoke, loaded by path so both sides share its
    inputs and timer whatever checkout the kernels come from."""
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: str, parts) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from symbiont_tpu_torch.ops import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(Path(root).resolve()), fa.__file__
    c = _helpers()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"root": root, "fwd": {}, "bwd": {}, "bwd_f32": {}, "fwd_f32": {}}
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    rng = np.random.default_rng(c.SEED)
    for S in FWD_SEQS if "b1" in parts else ():
        lens = rng.integers(1, S + 1, 32)
        lens[[0, 7]] = 0
        q, k, v, bias = c._attn_inputs(gen, 32, 12, 12, S, S, 64, torch.bfloat16, lens)
        mask = bias.to(q.dtype)[:, None, None, :]
        out["fwd"][S] = {"fwd": c.graph_ms(lambda: fa.flash_attention(q, k, v, bias), iters=100),
                         "sdpa_fwd": c.graph_ms(lambda: sdpa(q, k, v, attn_mask=mask), iters=100)}
        del q, k, v, bias, mask
    gen = torch.Generator(device="cuda").manual_seed(c.SEED + 2)
    rng = np.random.default_rng(c.SEED + 2)
    for S in BWD_SEQS if "b2b3" in parts else ():
        lens = rng.integers(1, S + 1, 32)
        lens[5] = 0
        q, k, v, bias = c._attn_inputs(gen, 32, 12, 12, S, S, 64, torch.bfloat16, lens)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        o, lse = fa.flash_attention_with_lse(q, k, v, bias)
        args = (q, k, v, bias, g, lse, fa.bwd_delta(g, o), False, 1.0 / 8.0)
        out["bwd"][S] = {"kv": c.graph_ms(lambda: fa.bwd_kv(*args), iters=100),
                         "q": c.graph_ms(lambda: fa.bwd_q(*args), iters=100),
                         "sdpa_bwd": c._sdpa_backward_ms(q, k, v, bias, g)}
        del q, k, v, bias, g, o, lse, args
    gen = torch.Generator(device="cuda").manual_seed(c.SEED + 18)
    for label, (B, NH, S) in F32_BWD.items() if "b2b3_f32" in parts else ():
        q, k, v, g = (torch.randn((B, NH, S, 64), generator=gen, device="cuda") for _ in range(4))
        bias = torch.zeros((B, S), device="cuda")
        o, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=True)
        args = (q, k, v, bias, g, lse, fa.bwd_delta(g, o), True, 1.0 / 8.0)
        out["bwd_f32"][label] = {
            "kv": c.graph_ms(lambda: fa.bwd_kv(*args), iters=100),
            "q": c.graph_ms(lambda: fa.bwd_q(*args), iters=100),
            "plain_kv": c.graph_ms(lambda: fa.bwd_kv_reference(*args), iters=5),
            "plain_q": c.graph_ms(lambda: fa.bwd_q_reference(*args), iters=5),
            "sdpa_bwd": c._sdpa_causal_backward_ms(q, k, v, g)}
        del q, k, v, bias, g, o, lse, args
    if "b1_f32" not in parts:
        return out
    gen = torch.Generator(device="cuda").manual_seed(c.SEED + 19)
    for label, (B, NH, S) in F32_FWD.items():
        q, k, v = (torch.randn((B, NH, S, 64), generator=gen, device="cuda") for _ in range(3))
        out["fwd_f32"][label] = {
            "fwd": c.graph_ms(lambda: fa.flash_attention(q, k, v, None, causal=True), iters=100),
            "plain": c.graph_ms(lambda: fa.flash_attention_reference(q, k, v, None, causal=True),
                                iters=5),
            "sdpa_fwd": c.graph_ms(lambda: sdpa(q, k, v, is_causal=True), iters=100)}
        del q, k, v
    B, NH, NKV, S = 8, 32, 4, 256
    lens = list(np.random.default_rng(c.SEED + 7).integers(S // 4, S + 1, B - 1)) + [S]
    q = torch.randn((B, NH, S, 64), generator=gen, device="cuda")
    k, v = (torch.randn((B, NKV, S, 64), generator=gen, device="cuda") for _ in range(2))
    bias = c.left_pad_bias(lens, S)
    causal = torch.ones((S, S), dtype=torch.bool, device="cuda").tril()
    mask = torch.where(causal[None, None], bias[:, None, None, :], -1e9)
    out["fwd_f32"][GQA_F32] = {
        "fwd": c.graph_ms(lambda: fa.flash_attention(q, k, v, bias, causal=True), iters=100),
        "plain": c.graph_ms(lambda: fa.flash_attention_reference(q, k, v, bias, causal=True),
                            iters=5),
        "sdpa_fwd": c.graph_ms(lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True),
                               iters=100)}
    return out


def _mean(runs, side, part, S, key) -> float:
    return sum(r[part][str(S)][key] for s, r in runs if s == side) / 2


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2], sys.argv[3].split(","))), flush=True)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base")
    ap.add_argument("change", nargs="?", default=str(HERE))
    ap.add_argument("--parts", default=",".join(PARTS))
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts takes {', '.join(PARTS)}")
    base, change = str(Path(args.base).resolve()), str(Path(args.change).resolve())
    print(_helpers().card_line(), flush=True)
    runs = []
    for side, root in (("base", base), ("change", change), ("change", change), ("base", base)):
        res = subprocess.run([sys.executable, __file__, "--child", root, ",".join(parts)],
                             capture_output=True, text=True, cwd=root)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": side, **row}), flush=True)
        runs.append((side, row))
    for S in FWD_SEQS if "b1" in parts else ():
        b, ch = (_mean(runs, side, "fwd", S, "fwd") for side in ("base", "change"))
        lib = (_mean(runs, "base", "fwd", S, "sdpa_fwd") + _mean(runs, "change", "fwd", S, "sdpa_fwd")) / 2
        print(f"B1 S={S}: base {b:.4f} change {ch:.4f} ms ({ch / b:.3f}x); SDPA forward "
              f"{lib:.4f} ms (change {ch / lib:.3f}x of it)", flush=True)
    for S in BWD_SEQS if "b2b3" in parts else ():
        b, ch = ({key: _mean(runs, side, "bwd", S, key) for key in ("kv", "q", "sdpa_bwd")}
                 for side in ("base", "change"))
        lib = (b["sdpa_bwd"] + ch["sdpa_bwd"]) / 2
        print(f"B2/B3 S={S}: B2 base {b['kv']:.4f} change {ch['kv']:.4f} ms "
              f"({ch['kv'] / b['kv']:.3f}x); B3 base {b['q']:.4f} change {ch['q']:.4f} ms "
              f"({ch['q'] / b['q']:.3f}x); B2+B3 change {ch['kv'] + ch['q']:.4f} ms vs SDPA "
              f"backward {lib:.4f} ms ({(ch['kv'] + ch['q']) / lib:.3f}x)", flush=True)
    import torch

    helpers = _helpers()
    keys = ("kv", "q", "plain_kv", "plain_q", "sdpa_bwd")
    for label, (B, NH, S) in F32_BWD.items() if "b2b3_f32" in parts else ():
        b, ch = ({key: _mean(runs, side, "bwd_f32", label, key) for key in keys}
                 for side in ("base", "change"))
        lib = (b["sdpa_bwd"] + ch["sdpa_bwd"]) / 2
        meta = torch.empty((B, NH, S, 64), device="meta")
        bound = helpers._bwd_bound_ms(meta, meta, True)
        print(f"B2/B3 f32 causal [{B}, {NH}, {S}, 64]: B2 base {b['kv']:.4f} change "
              f"{ch['kv']:.4f} ms ({ch['kv'] / b['kv']:.3f}x; bound {bound['kv'][0]:.4f} "
              f"{bound['kv'][1]}, {bound['kv'][0] / ch['kv']:.1%} of it; plain "
              f"{(b['plain_kv'] + ch['plain_kv']) / 2:.4f}); B3 base {b['q']:.4f} change "
              f"{ch['q']:.4f} ms ({ch['q'] / b['q']:.3f}x; bound {bound['q'][0]:.4f} "
              f"{bound['q'][1]}, {bound['q'][0] / ch['q']:.1%} of it; plain "
              f"{(b['plain_q'] + ch['plain_q']) / 2:.4f}); B2+B3 base {b['kv'] + b['q']:.4f} "
              f"change {ch['kv'] + ch['q']:.4f} ms vs SDPA causal backward {lib:.4f} ms "
              f"({(ch['kv'] + ch['q']) / lib:.3f}x)", flush=True)
    shapes = {label: ((B, NH, S, 64), (B, NH, S, 64)) for label, (B, NH, S) in F32_FWD.items()}
    shapes[GQA_F32] = ((8, 32, 256, 64), (8, 4, 256, 64))
    for label, (qs, ks) in shapes.items() if "b1_f32" in parts else ():
        b, ch = ({key: _mean(runs, side, "fwd_f32", label, key)
                  for key in ("fwd", "plain", "sdpa_fwd")} for side in ("base", "change"))
        lib = (b["sdpa_fwd"] + ch["sdpa_fwd"]) / 2
        meta = [torch.empty(s, device="meta") for s in (qs, ks, ks, (qs[0], ks[2]))]
        bound, by = helpers._bound_ms(*meta, True)
        what = "causal GQA, left padding" if label == GQA_F32 else "causal, no bias"
        print(f"B1 f32 {what} q{list(qs)} k{list(ks)}: base {b['fwd']:.4f} change "
              f"{ch['fwd']:.4f} ms ({ch['fwd'] / b['fwd']:.3f}x); bound {bound:.4f} "
              f"{helpers._bound_name(by, torch.float32)}, {bound / ch['fwd']:.1%} of it "
              f"(base {bound / b['fwd']:.1%}); plain {(b['plain'] + ch['plain']) / 2:.4f}; SDPA "
              f"causal forward {lib:.4f} ms (change {ch['fwd'] / lib:.3f}x of it)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
