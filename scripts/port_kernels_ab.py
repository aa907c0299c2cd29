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
SDPA's backward beside the pair. Times are device time per call by
CUDA-graph replay (`chip_smoke.graph_ms`, the same inputs for both sides).
CHANGE_DIR defaults to this script's checkout. Prints the card, one JSON
line per run, and per kernel and S each side's mean of its two runs and
change / base.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FWD_SEQS = (32, 64, 128, 256, 512)
BWD_SEQS = (64, 128, 256, 512)


def _helpers():
    """This checkout's chip_smoke, loaded by path so both sides share its
    inputs and timer whatever checkout the kernels come from."""
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from symbiont_tpu_torch.ops import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(Path(root).resolve()), fa.__file__
    c = _helpers()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"root": root, "fwd": {}, "bwd": {}}
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    rng = np.random.default_rng(c.SEED)
    for S in FWD_SEQS:
        lens = rng.integers(1, S + 1, 32)
        lens[[0, 7]] = 0
        q, k, v, bias = c._attn_inputs(gen, 32, 12, 12, S, S, 64, torch.bfloat16, lens)
        mask = bias.to(q.dtype)[:, None, None, :]
        out["fwd"][S] = {"fwd": c.graph_ms(lambda: fa.flash_attention(q, k, v, bias), iters=100),
                         "sdpa_fwd": c.graph_ms(lambda: sdpa(q, k, v, attn_mask=mask), iters=100)}
        del q, k, v, bias, mask
    gen = torch.Generator(device="cuda").manual_seed(c.SEED + 2)
    rng = np.random.default_rng(c.SEED + 2)
    for S in BWD_SEQS:
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
    return out


def _mean(runs, side, part, S, key) -> float:
    return sum(r[part][str(S)][key] for s, r in runs if s == side) / 2


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    base = str(Path(sys.argv[1]).resolve())
    change = str(Path(sys.argv[2]).resolve()) if len(sys.argv) == 3 else str(HERE)
    print(_helpers().card_line(), flush=True)
    runs = []
    for side, root in (("base", base), ("change", change), ("change", change), ("base", base)):
        res = subprocess.run([sys.executable, __file__, "--child", root], capture_output=True,
                             text=True, cwd=root)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": side, **row}), flush=True)
        runs.append((side, row))
    for S in FWD_SEQS:
        b, ch = (_mean(runs, side, "fwd", S, "fwd") for side in ("base", "change"))
        lib = (_mean(runs, "base", "fwd", S, "sdpa_fwd") + _mean(runs, "change", "fwd", S, "sdpa_fwd")) / 2
        print(f"B1 S={S}: base {b:.4f} change {ch:.4f} ms ({ch / b:.3f}x); SDPA forward "
              f"{lib:.4f} ms (change {ch / lib:.3f}x of it)", flush=True)
    for S in BWD_SEQS:
        b, ch = ({key: _mean(runs, side, "bwd", S, key) for key in ("kv", "q", "sdpa_bwd")}
                 for side in ("base", "change"))
        lib = (b["sdpa_bwd"] + ch["sdpa_bwd"]) / 2
        print(f"B2/B3 S={S}: B2 base {b['kv']:.4f} change {ch['kv']:.4f} ms "
              f"({ch['kv'] / b['kv']:.3f}x); B3 base {b['q']:.4f} change {ch['q']:.4f} ms "
              f"({ch['q'] / b['q']:.3f}x); B2+B3 change {ch['kv'] + ch['q']:.4f} ms vs SDPA "
              f"backward {lib:.4f} ms ({(ch['kv'] + ch['q']) / lib:.3f}x)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
