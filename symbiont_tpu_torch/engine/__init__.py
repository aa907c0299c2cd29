"""The port's embed engine and its host-side helpers.

bucketing : length buckets + padding (copy of the JAX package's module)
tokenizer : HF tokenizer file or hash tokenizer (copy of the JAX package's)
engine    : TorchEngine — embed / fused query search / rerank
"""
