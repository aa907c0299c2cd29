"""BERT-family encoder and cross-encoder in PyTorch.

A port of `symbiont_tpu/models/bert.py`, function for function, on the same
parameter tree: a nested dict of tensors whose linear kernels are stored
`[in, out]`, so every projection is `x @ W + b` exactly as in the JAX
package (`models/bridge.py` turns a JAX parameter tree into this one).

Numerics follow the JAX package's dtype modes:
- layer norm statistics, pooling and the mask bias are float32 whatever
  the compute dtype;
- float32 mode: exact (erf) GELU and a float32 softmax;
- bfloat16 mode: tanh GELU, and the `attn_impl="xla"` softmax stays a
  bfloat16 tensor (no float32 `[B, NH, S, S]` intermediate);
- `attn_impl="flash"` runs the hand-written CUDA flash-attention kernel
  (`ops/flash_attention.py`) on CUDA tensors, its plain version on CPU ones.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from symbiont_tpu_torch.ops.flash_attention import flash_attention

Params = Any  # nested dict of tensors; "layers" is a list


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    # XLM-RoBERTa offsets position ids by pad_token_id + 1 and counts only
    # non-pad tokens; classic BERT uses offset 0
    position_offset: int = 0
    hidden_act: str = "gelu"
    dtype: str = "bfloat16"
    # "xla" = plain torch attention (the JAX package's name for its einsum
    # path); "flash" = the CUDA flash-attention kernel
    attn_impl: str = "xla"

    @staticmethod
    def from_hf(cfg: dict) -> "BertConfig":
        """Map an HF config.json dict (BertConfig/XLMRobertaConfig) to ours."""
        model_type = cfg.get("model_type", "bert")
        offset = 0
        if model_type in ("xlm-roberta", "roberta", "mpnet"):
            offset = cfg.get("pad_token_id", 1) + 1
        return BertConfig(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_layers=cfg.get("num_hidden_layers", 12),
            num_heads=cfg.get("num_attention_heads", 12),
            intermediate_size=cfg.get("intermediate_size", 4 * cfg["hidden_size"]),
            max_position_embeddings=cfg.get("max_position_embeddings", 512),
            type_vocab_size=cfg.get("type_vocab_size", 2) or 1,
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
            position_offset=offset,
            hidden_act=cfg.get("hidden_act", "gelu"),
        )


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def tree_map(fn, tree):
    """`fn` on every leaf of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Floating leaves → `dtype` (a no-op on leaves already in it)."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, params)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    # float32 statistics regardless of compute dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * scale + bias).to(x.dtype)


def _act(name: str, compute_dtype=None):
    if name in ("gelu", "gelu_new", "gelu_python"):
        # exact (erf) GELU in float32 for checkpoint parity; the tanh
        # approximation in bfloat16 mode, as the JAX package does
        approx = "tanh" if compute_dtype == torch.bfloat16 else "none"
        return lambda h: F.gelu(h, approximate=approx)
    if name == "relu":
        return F.relu
    if name == "silu":
        return F.silu
    raise ValueError(f"unsupported activation {name!r}")


def attention(params: Params, x: torch.Tensor, mask_bias: torch.Tensor,
              cfg: BertConfig) -> torch.Tensor:
    """x [B, S, H]; mask_bias [B, 1, 1, S] float32 additive (0 / -1e9)."""
    B, S, H = x.shape
    nh = cfg.num_heads
    hd = H // nh

    def proj(p):
        return (x @ p["kernel"] + p["bias"]).view(B, S, nh, hd)

    q = proj(params["query"])
    k = proj(params["key"])
    v = proj(params["value"])

    if cfg.attn_impl == "flash":
        heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        ctx = flash_attention(*heads, kv_bias=mask_bias[:, 0, 0, :].contiguous())
        ctx = ctx.transpose(1, 2).reshape(B, S, H)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if x.dtype == torch.bfloat16:
            # the softmax tensor stays bfloat16, as in the JAX package's
            # bf16 mode; padded keys take the large negative bias
            probs = torch.softmax(scores + mask_bias.to(scores.dtype), dim=-1)
        else:
            scores = scores.float() + mask_bias.float()
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, H)
    return ctx @ params["out"]["kernel"] + params["out"]["bias"]


def encoder_layer(params: Params, x: torch.Tensor, mask_bias: torch.Tensor,
                  cfg: BertConfig) -> torch.Tensor:
    # post-LN transformer block (classic BERT ordering)
    attn_out = attention(params["attention"], x, mask_bias, cfg)
    x = layer_norm(x + attn_out, params["attention"]["ln"]["scale"],
                   params["attention"]["ln"]["bias"], cfg.layer_norm_eps)
    h = x @ params["mlp"]["in"]["kernel"] + params["mlp"]["in"]["bias"]
    h = _act(cfg.hidden_act, x.dtype)(h)
    h = h @ params["mlp"]["out"]["kernel"] + params["mlp"]["out"]["bias"]
    return layer_norm(x + h, params["mlp"]["ln"]["scale"],
                      params["mlp"]["ln"]["bias"], cfg.layer_norm_eps)


def embeddings(params: Params, input_ids: torch.Tensor,
               attention_mask: torch.Tensor, cfg: BertConfig,
               token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, S = input_ids.shape
    tok = params["word_embeddings"][input_ids]
    if cfg.position_offset:
        # RoBERTa-style: positions count only non-pad tokens, offset past pad
        mask = attention_mask.to(torch.int64)
        positions = torch.cumsum(mask, dim=1) * mask + cfg.position_offset - 1
        positions = positions.clamp(0, cfg.max_position_embeddings - 1)
    else:
        positions = torch.arange(S, device=input_ids.device).expand(B, S)
    pos = params["position_embeddings"][positions]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    typ = params["token_type_embeddings"][token_type_ids]
    x = tok + pos + typ
    return layer_norm(x, params["ln"]["scale"], params["ln"]["bias"],
                      cfg.layer_norm_eps)


def bert_encode(params: Params, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, cfg: BertConfig,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full encoder forward → last hidden state [B, S, H] in cfg.dtype."""
    dtype = torch_dtype(cfg.dtype)
    params = cast_params(params, dtype)
    x = embeddings(params["embeddings"], input_ids, attention_mask, cfg,
                   token_type_ids).to(dtype)
    # additive mask bias in float32: 0 for real tokens, -1e9 for padding
    mask_bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
    for layer_params in params["layers"]:
        x = encoder_layer(layer_params, x, mask_bias, cfg)
    return x


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Attention-masked mean pooling in float32: sum(h * mask) / sum(mask)."""
    mask = attention_mask[..., None].float()
    summed = (hidden.float() * mask).sum(dim=1)
    counts = mask.sum(dim=1).clamp(min=1.0)
    return summed / counts


def cls_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """CLS-token pooling (bge-style checkpoints)."""
    del attention_mask
    return hidden[:, 0, :].float()


POOLERS = {"mean": mean_pool, "cls": cls_pool}


def embed_sentences(params: Params, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor, cfg: BertConfig,
                    pooling: str = "mean", normalize: bool = False) -> torch.Tensor:
    """Encoder forward + pooling → [B, H] float32 sentence embeddings."""
    hidden = bert_encode(params, input_ids, attention_mask, cfg)
    pooled = POOLERS[pooling](hidden, attention_mask)
    if normalize:
        pooled = pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return pooled


def cross_encoder_score(params: Params, input_ids: torch.Tensor,
                        attention_mask: torch.Tensor, cfg: BertConfig,
                        token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-encoder relevance score [B] float32 (pooler + linear head)."""
    hidden = bert_encode(params, input_ids, attention_mask, cfg, token_type_ids)
    # the head runs in float32: in the JAX package the compute-dtype CLS
    # vector meets the float32-at-rest head weights and promotes
    pooler, classifier = params["pooler"], params["classifier"]
    pooled = torch.tanh(hidden[:, 0, :].float() @ pooler["kernel"].float()
                        + pooler["bias"].float())
    logits = pooled @ classifier["kernel"].float() + classifier["bias"].float()
    return logits[..., 0]


# ---------------------------------------------------------------------------
# Init (random params for tests and the synthetic engine)
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: BertConfig,
                with_pooler: bool = False, device=None) -> Params:
    """Random init with BERT's trunc-normal(0.02) scheme, float32 storage,
    drawn from `generator` on `device` (the generator's device)."""
    device = generator.device if device is None else torch.device(device)

    def dense(shape):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0,
                                    generator=generator)
        return t.mul_(0.02)

    def linear(n_in, n_out):
        return {"kernel": dense((n_in, n_out)),
                "bias": torch.zeros((n_out,), dtype=torch.float32, device=device)}

    def ln():
        return {"scale": torch.ones((cfg.hidden_size,), dtype=torch.float32, device=device),
                "bias": torch.zeros((cfg.hidden_size,), dtype=torch.float32, device=device)}

    H, I = cfg.hidden_size, cfg.intermediate_size
    params: Params = {
        "embeddings": {
            "word_embeddings": dense((cfg.vocab_size, H)),
            "position_embeddings": dense((cfg.max_position_embeddings, H)),
            "token_type_embeddings": dense((cfg.type_vocab_size, H)),
            "ln": ln(),
        },
        "layers": [
            {
                "attention": {
                    "query": linear(H, H),
                    "key": linear(H, H),
                    "value": linear(H, H),
                    "out": linear(H, H),
                    "ln": ln(),
                },
                "mlp": {"in": linear(H, I), "out": linear(I, H), "ln": ln()},
            }
            for _ in range(cfg.num_layers)
        ],
    }
    if with_pooler:
        params["pooler"] = linear(H, H)
        params["classifier"] = linear(H, 1)
    return params
