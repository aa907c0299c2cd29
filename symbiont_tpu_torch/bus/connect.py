"""Transport selection by URL scheme.

The port's counterpart of the JAX package's `symbiont_tpu/bus/connect.py`.
Only the in-process bus is ported: the TCP client and the broker
(`symbus://`, and `nats://` as its alias) come with ROADMAP A8 stage 2, and
until then those URLs raise by name instead of falling back to anything.
"""

from __future__ import annotations


async def connect(url: str):
    """inproc:// → the shared in-process bus."""
    if url.startswith("inproc://"):
        from symbiont_tpu_torch.bus.inproc import connect_inproc

        return connect_inproc(shared=True)
    if url.startswith(("symbus://", "nats://")):
        raise ValueError(
            f"bus url {url!r}: the TCP bus and the broker are not ported yet "
            "(ROADMAP A8 stage 2); use inproc://")
    raise ValueError(f"unsupported bus url {url!r}")
