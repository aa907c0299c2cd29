"""Hand-written CUDA kernels of the port and their wrappers.

Each kernel's source is under `csrc/`, built for sm_90a by `_build.py` on
first use and loaded with ctypes; each wrapper keeps a plain PyTorch
version beside it (the CPU path, and the yardstick `chip_smoke.py` holds
the kernel against) and a launch count.

flash_attention : the JAX package's Pallas flash attention — forward
                  (csrc/flash_attn_fwd.cu), the fused backward's dK/dV/dbias
                  and dQ kernels (csrc/flash_attn_bwd.cu), and the autograd
                  Function over them
"""
