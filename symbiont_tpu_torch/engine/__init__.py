"""The port's engines (embed, generation) and their host-side helpers.

bucketing : length buckets + padding (copy of the JAX package's module)
tokenizer : HF tokenizer file or hash tokenizer (copy of the JAX package's)
engine    : TorchEngine — embed / fused query search / rerank
lm        : LmEngine — text generation from GPT-2 / Llama checkpoints
"""
