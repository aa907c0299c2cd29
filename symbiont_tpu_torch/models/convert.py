"""HF checkpoints → the port's BERT and GPT parameter trees, and back.

The port's copy of `symbiont_tpu/models/convert.py`: a local model dir
(`config.json` plus `model.safetensors`, a sharded safetensors set with its
`model.safetensors.index.json`, or `pytorch_model.bin`) becomes the
`models.bert` or `models.gpt` tree as float32 numpy arrays, kernels in
`[in, out]` layout. `models.bridge` moves a tree onto the device. BERT
layouts: `bert.*` (MiniLM, bge, e5, the ms-marco cross-encoder),
`roberta.*` (XLM-R, the multilingual mpnet), and bare encoder dumps;
`export_hf_bert` writes a tree back in the hub's layout, so `transformers`
and either package load it. GPT layouts (`convert_gpt`): GPT-2, whose
Conv1D weights are already `[in, out]` and whose fused `c_attn` is split
into q, k and v, and Llama/Mistral, whose Linear weights are transposed.

Safetensors files are read and written by the short reader and writer
below (an 8-byte little-endian header length, a JSON header with
`__metadata__ {"format": "pt"}`, then raw little-endian data), so a machine
without the `safetensors` package reads and writes them. A bf16 tensor
reads back as float32, and a bf16 torch tensor is written as BF16; the
converter upcasts every tensor anyway.

    python -m symbiont_tpu_torch.models.convert DIR [--out CKPT] [--kind auto|bert|gpt]
        [--pooler]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from symbiont_tpu_torch.models.bert import BertConfig
from symbiont_tpu_torch.models.gpt import GPTConfig
from symbiont_tpu_torch.models.quant import leaves

Params = Any

_GPT_TYPES = ("gpt2", "llama", "mistral")

# safetensors dtype names ↔ numpy; BF16 has no numpy dtype and reads as
# float32 (`read_safetensors`)
_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


# ------------------------------------------------------------ safetensors


def read_safetensors(path: str | Path) -> Dict[str, np.ndarray]:
    """A `.safetensors` file → {name: numpy array}; BF16 tensors upcast to
    float32 exactly."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = np.fromfile(f, dtype=np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = data[begin:end]
        if info["dtype"] == "BF16":
            bits = raw.view("<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif info["dtype"] in _ST_DTYPES:
            arr = raw.view(np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        out[name] = arr.reshape(info["shape"])
    return out


def write_safetensors(path: str | Path, tensors: Dict[str, Any]) -> None:
    """{name: numpy array, or a bfloat16 torch tensor} → a `.safetensors`
    file, `__metadata__` format "pt" (transformers refuses a file without
    it). A bf16 tensor is written as BF16, its bits as they are."""
    if sys.byteorder != "little":
        raise NotImplementedError("write_safetensors writes from little-endian hosts only")
    header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
    arrays, offset = [], 0
    for name in sorted(tensors):
        t, st_dtype = tensors[name], None
        if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
            t, st_dtype = t.detach().cpu().contiguous().view(torch.int16).numpy(), "BF16"
        a = np.asarray(t, order="C")  # ascontiguousarray makes 0-d 1-d
        if st_dtype is None and a.dtype not in _ST_NAMES:
            raise ValueError(f"tensor {name!r}: dtype {a.dtype} has no safetensors name")
        header[name] = {"dtype": st_dtype or _ST_NAMES[a.dtype],
                        "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        arrays.append(a)
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for a in arrays:
            f.write(a.data)


# ------------------------------------------------------------------- load


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        # numpy has no bfloat16 (a bf16 .bin checkpoint): float32, exactly
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def load_state_dict(model_dir: str | Path) -> Dict[str, np.ndarray]:
    """Weights of a local model dir: `model.safetensors`, else the shards of
    `model.safetensors.index.json`, else `pytorch_model.bin` (read with
    `torch.load(weights_only=True)`)."""
    model_dir = Path(model_dir)
    st = model_dir / "model.safetensors"
    idx = model_dir / "model.safetensors.index.json"
    if st.exists():
        return read_safetensors(st)
    if idx.exists():
        weight_map = json.loads(idx.read_text())["weight_map"]
        out: Dict[str, np.ndarray] = {}
        for shard in sorted(set(weight_map.values())):
            out.update(read_safetensors(model_dir / shard))
        return out
    bin_path = model_dir / "pytorch_model.bin"
    if bin_path.exists():
        sd = torch.load(str(bin_path), map_location="cpu", weights_only=True)
        return {k: _to_numpy(v) for k, v in sd.items()}
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {model_dir}")


def load_hf_config(model_dir: str | Path) -> dict:
    return json.loads((Path(model_dir) / "config.json").read_text())


_PREFIXES = ("bert.", "roberta.", "mpnet.", "model.", "electra.")


def _strip_prefix(name: str) -> str:
    for p in _PREFIXES:
        if name.startswith(p):
            return name[len(p):]
    return name


def convert_bert(state_dict: Dict[str, Any], cfg: BertConfig,
                 with_pooler: bool = False) -> Params:
    """An HF BERT/XLM-R state dict → the `models.bert` tree (float32 numpy,
    kernels `[in, out]`)."""
    sd = {_strip_prefix(k): v for k, v in state_dict.items()}

    def take(name: str) -> np.ndarray:
        if name not in sd:
            raise KeyError(f"checkpoint missing tensor {name!r}; have e.g. "
                           f"{sorted(sd)[:5]}")
        return _to_numpy(sd[name]).astype(np.float32)

    def linear(prefix: str) -> dict:
        return {"kernel": take(f"{prefix}.weight").T, "bias": take(f"{prefix}.bias")}

    def ln(prefix: str) -> dict:
        return {"scale": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}

    params: Params = {
        "embeddings": {
            "word_embeddings": take("embeddings.word_embeddings.weight"),
            "position_embeddings": take("embeddings.position_embeddings.weight"),
            "token_type_embeddings": (
                take("embeddings.token_type_embeddings.weight")
                if "embeddings.token_type_embeddings.weight" in sd
                else np.zeros((cfg.type_vocab_size, cfg.hidden_size), np.float32)),
            "ln": ln("embeddings.LayerNorm"),
        },
        "layers": [],
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}"
        params["layers"].append({
            "attention": {
                "query": linear(f"{p}.attention.self.query"),
                "key": linear(f"{p}.attention.self.key"),
                "value": linear(f"{p}.attention.self.value"),
                "out": linear(f"{p}.attention.output.dense"),
                "ln": ln(f"{p}.attention.output.LayerNorm"),
            },
            "mlp": {
                "in": linear(f"{p}.intermediate.dense"),
                "out": linear(f"{p}.output.dense"),
                "ln": ln(f"{p}.output.LayerNorm"),
            },
        })
    if with_pooler:
        params["pooler"] = linear("pooler.dense")
        # the cross-encoder's classifier sits outside the encoder prefix
        if "classifier.weight" in sd:
            params["classifier"] = linear("classifier")
    return params


def load_bert_model(model_dir: str | Path, with_pooler: bool = False):
    """(params as float32 numpy, BertConfig) from a local HF model dir."""
    hf_cfg = load_hf_config(model_dir)
    cfg = BertConfig.from_hf(hf_cfg)
    params = convert_bert(load_state_dict(model_dir), cfg, with_pooler=with_pooler)
    return params, cfg


def convert_gpt(state_dict: Dict[str, Any], cfg: GPTConfig) -> Params:
    """An HF GPT-2 or Llama state dict → the `models.gpt` tree (float32
    numpy, kernels `[in, out]`). GPT-2's Conv1D weights are already
    `[in, out]` and its fused `c_attn` `[H, 3H]` is split into q/k/v;
    Llama's Linear weights are transposed, and `lm_head` is read only when
    the embeddings are untied."""
    sd = {_strip_prefix(k.replace("transformer.", "")): v for k, v in state_dict.items()}

    def take(name: str) -> np.ndarray:
        if name not in sd:
            raise KeyError(f"checkpoint missing tensor {name!r}")
        return _to_numpy(sd[name]).astype(np.float32)

    params: Params = {"layers": []}
    if cfg.arch == "gpt2":
        params["wte"] = take("wte.weight")
        params["wpe"] = take("wpe.weight")
        params["ln_f"] = {"scale": take("ln_f.weight"), "bias": take("ln_f.bias")}
        for i in range(cfg.num_layers):
            p = f"h.{i}"
            qw, kw, vw = np.split(take(f"{p}.attn.c_attn.weight"), 3, axis=1)
            qb, kb, vb = np.split(take(f"{p}.attn.c_attn.bias"), 3)
            params["layers"].append({
                "ln1": {"scale": take(f"{p}.ln_1.weight"), "bias": take(f"{p}.ln_1.bias")},
                "ln2": {"scale": take(f"{p}.ln_2.weight"), "bias": take(f"{p}.ln_2.bias")},
                "q": {"kernel": qw, "bias": qb},
                "k": {"kernel": kw, "bias": kb},
                "v": {"kernel": vw, "bias": vb},
                "o": {"kernel": take(f"{p}.attn.c_proj.weight"),
                      "bias": take(f"{p}.attn.c_proj.bias")},
                "mlp": {
                    "in": {"kernel": take(f"{p}.mlp.c_fc.weight"),
                           "bias": take(f"{p}.mlp.c_fc.bias")},
                    "out": {"kernel": take(f"{p}.mlp.c_proj.weight"),
                            "bias": take(f"{p}.mlp.c_proj.bias")},
                },
            })
    elif cfg.arch == "llama":
        params["wte"] = take("embed_tokens.weight")
        params["ln_f"] = {"scale": take("norm.weight")}
        for i in range(cfg.num_layers):
            p = f"layers.{i}"

            def t(name):
                return take(f"{p}.{name}.weight").T

            params["layers"].append({
                "ln1": {"scale": take(f"{p}.input_layernorm.weight")},
                "ln2": {"scale": take(f"{p}.post_attention_layernorm.weight")},
                "q": {"kernel": t("self_attn.q_proj")},
                "k": {"kernel": t("self_attn.k_proj")},
                "v": {"kernel": t("self_attn.v_proj")},
                "o": {"kernel": t("self_attn.o_proj")},
                "mlp": {"gate": {"kernel": t("mlp.gate_proj")},
                        "up": {"kernel": t("mlp.up_proj")},
                        "down": {"kernel": t("mlp.down_proj")}},
            })
        if not cfg.tie_word_embeddings:
            params["lm_head"] = {"kernel": take("lm_head.weight").T}
    else:
        raise ValueError(f"unsupported arch {cfg.arch!r}")
    return params


def load_gpt_model(model_dir: str | Path):
    """(params as float32 numpy, GPTConfig) from a local HF model dir."""
    cfg = GPTConfig.from_hf(load_hf_config(model_dir))
    return convert_gpt(load_state_dict(model_dir), cfg), cfg


# ------------------------------------------------------------------ export


def hf_state_dict(params: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    """The inverse of `convert_bert`: HF tensor names (each after `prefix`,
    as `"bert."`; the classifier never takes it) → float32 numpy, kernels
    back in torch Linear's `[out, in]`. Leaves may be numpy arrays or
    tensors."""
    sd: Dict[str, np.ndarray] = {}

    def f32(a) -> np.ndarray:
        return np.ascontiguousarray(_to_numpy(a), dtype=np.float32)

    def put_linear(name: str, p: dict) -> None:
        sd[f"{name}.weight"] = np.ascontiguousarray(f32(p["kernel"]).T)
        sd[f"{name}.bias"] = f32(p["bias"])

    def put_ln(name: str, p: dict) -> None:
        sd[f"{name}.weight"] = f32(p["scale"])
        sd[f"{name}.bias"] = f32(p["bias"])

    emb = params["embeddings"]
    for table in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{prefix}embeddings.{table}.weight"] = f32(emb[table])
    put_ln(f"{prefix}embeddings.LayerNorm", emb["ln"])
    for i, layer in enumerate(params["layers"]):
        p = f"{prefix}encoder.layer.{i}"
        put_linear(f"{p}.attention.self.query", layer["attention"]["query"])
        put_linear(f"{p}.attention.self.key", layer["attention"]["key"])
        put_linear(f"{p}.attention.self.value", layer["attention"]["value"])
        put_linear(f"{p}.attention.output.dense", layer["attention"]["out"])
        put_ln(f"{p}.attention.output.LayerNorm", layer["attention"]["ln"])
        put_linear(f"{p}.intermediate.dense", layer["mlp"]["in"])
        put_linear(f"{p}.output.dense", layer["mlp"]["out"])
        put_ln(f"{p}.output.LayerNorm", layer["mlp"]["ln"])
    if "pooler" in params:
        put_linear(f"{prefix}pooler.dense", params["pooler"])
    if "classifier" in params:
        put_linear("classifier", params["classifier"])
    return sd


def hf_config(cfg: BertConfig) -> dict:
    """config.json for `cfg`. model_type inverts `BertConfig.from_hf`: an
    XLM-R tree (position_offset = pad_token_id + 1) is written as
    "xlm-roberta" with that pad id, so its positions survive the trip."""
    if cfg.position_offset:
        model_type, architectures = "xlm-roberta", ["XLMRobertaModel"]
        pad_token_id = cfg.position_offset - 1
    else:
        model_type, architectures = "bert", ["BertModel"]
        pad_token_id = 0
    return {
        "model_type": model_type,
        "architectures": architectures,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "type_vocab_size": cfg.type_vocab_size,
        "layer_norm_eps": cfg.layer_norm_eps,
        "hidden_act": cfg.hidden_act,
        "pad_token_id": pad_token_id,
    }


def export_hf_bert(params: Params, cfg: BertConfig, out_dir: str | Path) -> Path:
    """Write a hub-format model dir (config.json + model.safetensors, the
    tensor names BertModel's own save_pretrained uses) from a `models.bert`
    tree, loadable by the engine's `model_dir` and by `transformers`."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_safetensors(out_dir / "model.safetensors", hf_state_dict(params))
    (out_dir / "config.json").write_text(json.dumps(hf_config(cfg), indent=2))
    return out_dir


# --------------------------------------------------------------------- CLI


def main(argv=None) -> None:
    """Convert a local HF checkpoint and, with --out, keep the tree as a
    checkpoint dir in the JAX package's format (train/checkpoint.py), so a
    restart skips the conversion. Without --out it checks the layout and
    prints the geometry."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m symbiont_tpu_torch.models.convert",
                                 description=main.__doc__)
    ap.add_argument("model_dir", help="local HF model dir (safetensors/.bin + config.json)")
    ap.add_argument("--out", help="checkpoint dir to write the converted params to")
    ap.add_argument("--kind", choices=["auto", "bert", "gpt"], default="auto")
    ap.add_argument("--pooler", action="store_true",
                    help="include the pooler and classifier head (cross-encoders)")
    args = ap.parse_args(argv)

    hf_cfg = load_hf_config(args.model_dir)
    kind = args.kind
    if kind == "auto":
        kind = "gpt" if hf_cfg.get("model_type") in _GPT_TYPES else "bert"
    if kind == "gpt":
        params, cfg = load_gpt_model(args.model_dir)
    else:
        params, cfg = load_bert_model(args.model_dir, with_pooler=args.pooler)
    n_params = sum(int(np.prod(leaf.shape)) for leaf in leaves(params))
    print(f"{kind}: {type(cfg).__name__} hidden={cfg.hidden_size} "
          f"layers={cfg.num_layers} heads={cfg.num_heads} — "
          f"{n_params / 1e6:.1f}M params converted OK")
    if args.out:
        import dataclasses

        from symbiont_tpu_torch.train.checkpoint import save_params

        save_params(args.out, params,
                    meta={"kind": kind, "config": dataclasses.asdict(cfg),
                          "source": str(args.model_dir)})
        print(f"saved checkpoint to {args.out}")


if __name__ == "__main__":
    main()
