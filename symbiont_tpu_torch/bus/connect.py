"""Transport selection by URL scheme.

Copy of the JAX package's `symbiont_tpu/bus/connect.py`. An unreachable
broker fails after the retries; no URL falls back to another transport.
"""

from __future__ import annotations


async def connect(url: str, retries: int = 30, retry_delay_s: float = 1.0):
    """inproc:// → shared in-process bus; symbus://host:port → native broker;
    nats://host:port → accepted as an alias for symbus (reference-era configs,
    reference: .env.example NATS_URL) since the wire protocol is ours.

    The initial broker dial RETRIES (C++ `connect_with_retry` parity, same
    30×1s default): under process supervision workers and broker start
    concurrently, and a worker that crashes because the broker's listen
    socket is 200ms behind would burn a supervised restart for nothing.
    `retries=1` restores fail-fast for callers that want it."""
    if url.startswith("inproc://"):
        from symbiont_tpu_torch.bus.inproc import connect_inproc

        return connect_inproc(shared=True)
    if url.startswith(("symbus://", "nats://")):
        from symbiont_tpu_torch.bus.tcp import TcpBus
        from symbiont_tpu_torch.utils.retry import connect_retry_async

        hostport = url.split("://", 1)[1].rstrip("/")
        host, _, port = hostport.partition(":")

        async def dial() -> TcpBus:
            bus = TcpBus(host or "127.0.0.1", int(port or 4233))
            await bus.connect()
            return bus

        return await connect_retry_async(
            dial, retries=max(1, retries), delay_s=retry_delay_s,
            what=f"symbus broker at {hostport}", jitter=True)
    raise ValueError(f"unsupported bus url {url!r}")
