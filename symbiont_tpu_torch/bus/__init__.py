"""Message fabric — the DCN/control plane.

Copy of the JAX package's `symbiont_tpu/bus/__init__.py`, with both
transports: the in-process bus and the TCP client (`bus/tcp.py`) of the
native broker or of its Python twin (`python -m
symbiont_tpu_torch.bus.pybroker`).

The reference glues its services with core NATS: plain subscribe (no queue
groups — two replicas would double-process, SURVEY.md §1-L3 notes),
fire-and-forget pub/sub plus inbox-based request-reply. This package provides
the same interaction styles behind one small client interface with two
transports:

- inproc  : asyncio in-process bus — tests and single-process deployments
            (the reference needed Docker+NATS to run at all; we don't)
- tcp     : client for the native C++ broker (native/symbus) speaking a
            length-prefixed binary protocol over TCP

Improvements over the reference carried in the interface: queue groups
(horizontal scale-out), wildcard subjects ('*' token, '>' tail), headers
(trace propagation, SURVEY.md §5.1 plan).

connect(url): "inproc://" → shared in-process bus, "symbus://host:port" → TCP.
"""

from symbiont_tpu_torch.bus.core import Msg, Subscription
from symbiont_tpu_torch.bus.inproc import InprocBus, connect_inproc
from symbiont_tpu_torch.bus.connect import connect

__all__ = ["Msg", "Subscription", "InprocBus", "connect", "connect_inproc"]
