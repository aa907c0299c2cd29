"""The port's `LmEngine.generate_stream` against the JAX engine's on the CPU,
at tiny geometries on the same weights (tests/test_torch_lm.py's `_pair`):
greedy deltas join to the JAX stream's text and to `generate()`'s, token
for token, for llama GQA and gpt2 with dense and int8 KV, including a
multi-byte character split across chunks and `max_new` trims; the same
dispatch-ledger rows, host syncs and usage as JAX; a closed stream still
records its stats; a paused consumer holds no lock; sampled streams repeat
under one seed whatever runs between their chunks; `resume=` raises
naming its ROADMAP item."""

import threading

import pytest

from symbiont_tpu.obs import usage as jusage
from symbiont_tpu.obs import xprof as jxprof
from symbiont_tpu.utils import telemetry as jtelemetry
from symbiont_tpu_torch.engine.lm import ByteTokenizer
from symbiont_tpu_torch.obs import usage as tusage
from symbiont_tpu_torch.obs import xprof as txprof
from symbiont_tpu_torch.utils import telemetry as ttelemetry
from tests.test_torch_lm import _pair, _port

STREAM = dict(stream_chunk=4, new_token_buckets=[8, 16])
VARIANTS = [("llama", 2, {}), ("llama", 2, dict(kv_quant="int8")),
            ("gpt2", None, {}), ("gpt2", None, dict(kv_quant="int8"))]
IDS = ["llama-dense", "llama-int8kv", "gpt2-dense", "gpt2-int8kv"]


class EuroTokenizer(ByteTokenizer):
    """Byte-level encode; decode maps the k-th generated token to the k-th
    byte of a run of "€" (E2 82 AC) whatever its id, so every chunk of 4
    tokens ends inside a 3-byte character and the stream must hold the
    partial character back."""

    def decode(self, ids) -> str:
        return bytes(b"\xe2\x82\xac"[k % 3] for k in range(len(ids))).decode(
            "utf-8", errors="replace")


@pytest.fixture(scope="module", params=VARIANTS, ids=IDS)
def engines(request):
    arch, nkv, kw = request.param
    return _pair(arch, nkv, **STREAM, **kw)


@pytest.mark.parametrize("prompt,max_new", [("hello", 16), ("a much longer prompt here", 11),
                                            ("", 5), ("byteés", 8)])
def test_greedy_stream_matches_jax_and_generate(engines, prompt, max_new):
    jax_eng, port = engines
    deltas = list(port.generate_stream(prompt, max_new))
    assert deltas == list(jax_eng.generate_stream(prompt, max_new))  # delta for delta
    assert "".join(deltas) == port.generate(prompt, max_new)


def test_multibyte_character_split_across_chunks(engines):
    jax_eng, port = engines
    for eng in engines:
        eng.tokenizer = EuroTokenizer()
    try:
        deltas = list(port.generate_stream("hello", 16))
        assert deltas == list(jax_eng.generate_stream("hello", 16))
        assert "".join(deltas) == port.generate("hello", 16) == "€" * 5 + "�"
        # chunk boundaries at 4, 8, 12 tokens fall inside a character: the
        # held-back partial never leaks, only the final flush shows the
        # dangling byte
        assert all("�" not in d for d in deltas[:-1]) and len(deltas) >= 4
    finally:
        for eng in engines:
            eng.tokenizer = ByteTokenizer()


def test_stream_trims_to_max_new(engines):
    jax_eng, port = engines
    before = port.stats["tokens_generated"]
    text = "".join(port.generate_stream("x", 3))
    assert port.stats["tokens_generated"] - before == 3
    assert text == "".join(jax_eng.generate_stream("x", 3)) == port.generate("x", 3)
    # past the largest bucket the stream stops at the bucket, as generate()
    assert "".join(port.generate_stream("x", 40)) == port.generate("x", 16)


def _ledger_rows(ledger):
    return {r["executable"]: r["dispatches"] for r in ledger.snapshot()}


def test_dispatches_host_syncs_and_usage_match_jax(engines):
    jax_eng, port = engines
    site = {"site": "LmEngine._generate_stream_impl"}
    seen = []
    for eng, ledger, m, meter in ((jax_eng, jxprof.dispatch_ledger, jtelemetry.metrics,
                                   jusage.usage),
                                  (port, txprof.dispatch_ledger, ttelemetry.metrics,
                                   tusage.usage)):
        meter.reset()
        rows0, syncs0 = _ledger_rows(ledger), m.get("engine.host_syncs_total", site)
        list(eng.generate_stream("hello there", 14, tenant="acme"))
        rows = {k: n - rows0.get(k, 0) for k, n in _ledger_rows(ledger).items()
                if n - rows0.get(k, 0)}
        snap = meter.snapshot()["acme"]
        seen.append((rows, m.get("engine.host_syncs_total", site) - syncs0,
                     snap["tokens_in"], snap["tokens_out"]))
        assert snap["kv_row_seconds"] > 0
    assert seen[1] == seen[0]
    rows, syncs, tokens_in, tokens_out = seen[1]
    assert rows == {"lm.prefill[P=16,B=1,new=16]": 1, "lm.decode_chunk[P=16,B=1,chunk=4]": 4}
    assert syncs == 4 and tokens_in == 12 and tokens_out == 14


def test_closed_stream_still_records_stats():
    port = _port(**STREAM)
    stream = port.generate_stream("hello", 16)
    assert next(stream)
    stream.close()  # the client went away mid-stream
    assert port.stats["generate_calls"] == 1
    assert 0 < port.stats["tokens_generated"] < 16 and port.stats["decode_s"] > 0
    assert port._lock.acquire(timeout=1)  # the engine is free
    port._lock.release()
    assert isinstance(port.generate("x", 8), str)


def test_paused_consumer_does_not_starve_generate():
    port = _port(**STREAM)
    stream = port.generate_stream("hello", 16)
    first = next(stream)  # the consumer is parked mid-stream
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("text", port.generate("other", 8)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "generate() waited on a paused stream"
    assert isinstance(out["text"], str)
    assert first + "".join(stream) == port.generate("hello", 16)


def test_sampled_stream_repeats_under_one_seed():
    """A stream samples from a generator of its own, seeded by one draw
    from the engine's: the same seed repeats its text, and a sampled batch
    run between its chunks changes nothing in it."""
    a, b = (_port(temperature=1.0, top_k=20, **STREAM) for _ in range(2))
    quiet = list(a.generate_stream("seeded", 16))
    s = b.generate_stream("seeded", 16)
    busy = [next(s)]
    b.generate_batch(["noise", "more noise"], [16, 16])
    busy += list(s)
    assert "".join(busy) == "".join(quiet)
    assert "".join(a.generate_stream("seeded", 16)) != "".join(quiet)  # the draw moved on


def test_resume_raises_naming_the_journal():
    port = _port(**STREAM)
    with pytest.raises(ValueError, match="A8"):
        next(port.generate_stream("x", 8, resume={"tokens": [1]}))
    # task_id and stream are taken and, without a journal, record nothing
    assert "".join(port.generate_stream("x", 8, task_id="t-1", stream=False)) == \
        port.generate("x", 8)
