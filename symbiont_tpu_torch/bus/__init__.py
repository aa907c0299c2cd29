"""Message fabric — the DCN/control plane.

Copy of the JAX package's `symbiont_tpu/bus/__init__.py`. The port has the
in-process transport only; the TCP one below comes with ROADMAP A8 stage 2
and `connect` refuses its URLs until then.

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
