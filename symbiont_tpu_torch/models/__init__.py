"""Models of the port (PyTorch functions over parameter dicts).

bert   : encoder family and cross-encoder (port of symbiont_tpu/models/bert.py)
gpt    : GPT-2 / Llama decoder, KV cache and sampling (port of models/gpt.py)
bridge : JAX parameter trees (as numpy) → the port's tensors
"""
