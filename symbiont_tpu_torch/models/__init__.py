"""Models of the port (PyTorch functions over parameter dicts).

bert   : encoder family and cross-encoder (port of symbiont_tpu/models/bert.py)
bridge : JAX parameter trees (as numpy) → the port's tensors
"""
