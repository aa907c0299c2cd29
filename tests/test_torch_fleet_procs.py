"""The port's multi-process stack on the CPU: `ProcessSupervisor`
supervising the port's broker (`python -m symbiont_tpu_torch.bus.pybroker`)
and three `python -m symbiont_tpu_torch.runner` roles with
`SYMBIONT_ENGINE_FORCE_CPU=1` and `SYMBIONT_LM_FORCE_CPU=1`: a gateway and
two journalled generation workers on one small float32 GPT-2 checkpoint.
A greedy stream is watched on the gateway's `/api/events`; after its second
chunk the worker that holds it (the one whose journal names it) is
SIGKILLed. The supervisor rescues the dead worker's tail and the survivor
adopts it: the stream's SSE text equals the uninterrupted stream of an
in-process engine on the same checkpoint, its `seq` runs 0, 1, 2, ... with
no gap and no duplicate, the final event carries the same text, and the
survivor's journal ends with no live tail. Every wait is a condition with
a deadline, and the supervisor stops every child in a `finally`."""

import asyncio
import json
import os
import signal
import socket
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import torch

import chip_smoke
from symbiont_tpu_torch.config import LmConfig
from symbiont_tpu_torch.engine.lm import LmEngine
from symbiont_tpu_torch.models import gpt as gpt_mod
from symbiont_tpu_torch.resilience.genlog import GenJournal
from symbiont_tpu_torch.resilience.procsup import ProcessSupervisor, pybroker_spec, runner_spec

# a byte-vocab GPT-2 (the byte tokenizer reads its every id), its kernels
# x8 off the default init so greedy decoding has clear margins
GPT = dict(model_type="gpt2", architectures=["GPT2LMHeadModel"], vocab_size=257, n_embd=128,
           n_layer=4, n_head=4, n_positions=512, layer_norm_epsilon=1e-5)
NEW, CHUNK = 64, 2
LM_ENV = {"SYMBIONT_LM_ENABLED": "1", "SYMBIONT_LM_FORCE_CPU": "1",
          "SYMBIONT_LM_DTYPE": "float32", "SYMBIONT_LM_STREAM_CHUNK": str(CHUNK),
          "SYMBIONT_LM_PROMPT_BUCKETS": "[16, 64, 256]",
          "SYMBIONT_LM_NEW_TOKEN_BUCKETS": "[128]", "SYMBIONT_LM_TEMPERATURE": "0"}
PROMPT = "durable streams outlive their worker"
DEADLINE_S = 60.0
REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_model(path):
    cfg = gpt_mod.GPTConfig.from_hf(GPT)
    params = gpt_mod.init_params(torch.Generator().manual_seed(3), cfg)

    def scale(tree):
        if isinstance(tree, dict):
            return {k: scale(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [scale(v) for v in tree]
        return tree * 8 if tree.ndim >= 2 else tree

    chip_smoke.write_gpt_checkpoint(path, scale(params), GPT, torch.float32)


def _http(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except OSError:
        return 0, b""  # the gateway is still booting


async def _until(pred, what):
    t_end = time.monotonic() + DEADLINE_S
    while not pred():
        assert time.monotonic() < t_end, f"{what}: not reached in {DEADLINE_S:.0f} s"
        await asyncio.sleep(0.01)


def test_a_journalled_stream_survives_its_workers_sigkill(tmp_path):
    model = tmp_path / "gpt2"
    _write_model(model)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one core, as each worker has: no oversubscription
    try:
        want = "".join(LmEngine(LmConfig(model_dir=str(model), **{
            "dtype": "float32", "stream_chunk": CHUNK, "prompt_buckets": [16, 64, 256],
            "new_token_buckets": [128], "temperature": 0.0}), device="cpu").generate_stream(
                PROMPT, NEW))
    finally:
        torch.set_num_threads(threads)
    assert len(want) > 16
    broker_port, api_port = _free_port(), _free_port()
    bus_url = f"symbus://127.0.0.1:{broker_port}"
    jdir = tmp_path / "genlog"
    common = {"SYMBIONT_ENGINE_FORCE_CPU": "1", "SYMBIONT_OBS_FLEET_PUBLISH_S": "0.3",
              "SYMBIONT_VECTOR_STORE_DATA_DIR": str(tmp_path / "vs"),
              "SYMBIONT_GRAPH_STORE_DATA_DIR": str(tmp_path / "gs"),
              "SYMBIONT_TEXT_GENERATOR_MARKOV_STATE_PATH": str(tmp_path / "markov.json"),
              "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    gen_env = {**common, **LM_ENV, "SYMBIONT_LM_MODEL_DIR": str(model),
               "SYMBIONT_GEN_JOURNAL_ENABLED": "1", "SYMBIONT_GEN_JOURNAL_DIR": str(jdir)}
    log = open(tmp_path / "workers.log", "ab")
    hb = dict(heartbeat_s=0.3, heartbeat_timeout_s=10.0)
    sup = ProcessSupervisor(bus_url=bus_url, stdio=log, fleet_publish_s=0.3)
    sup.add_worker(pybroker_spec(broker_port, str(tmp_path / "bus")))
    sup.add_worker(runner_spec("gateway", "api", bus_url, env={
        **common, "SYMBIONT_API_HOST": "127.0.0.1", "SYMBIONT_API_PORT": str(api_port),
        "SYMBIONT_API_SSE_KEEPALIVE_S": "0.5"}, **hb))
    for role in ("gen1", "gen2"):
        sup.add_worker(runner_spec(role, "text_generator", bus_url, env=gen_env, **hb))
    events = []

    async def sse_reader():
        while True:  # the gateway may still be binding its socket
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1", api_port)
                break
            except OSError:
                await asyncio.sleep(0.05)
        writer.write(b"GET /api/events HTTP/1.1\r\nHost: x\r\n\r\n")
        await writer.drain()
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                if line.startswith(b"data: "):
                    events.append(json.loads(line[6:]))
        finally:
            writer.close()

    def holder(task_id):
        """The generation role whose journal names the task."""
        for role in ("gen1", "gen2"):
            path = jdir / f"{role}.genlog"
            if path.exists() and task_id.encode() in path.read_bytes():
                return role
        return None

    async def main():
        loop = asyncio.get_running_loop()
        await sup.start()
        reader = None
        try:
            t0 = time.monotonic()
            for role in ("gateway", "gen1", "gen2"):
                await sup.wait_role_up(role, after=t0 - 1, timeout_s=DEADLINE_S)
            reader = asyncio.create_task(sse_reader())
            await _until(lambda: _http(api_port, "GET", "/readyz")[0] == 200, "gateway ready")
            await asyncio.sleep(0.3)  # the SSE client is registered
            st, raw = await loop.run_in_executor(None, lambda: _http(
                api_port, "POST", "/api/generate-text",
                {"task_id": "durable-1", "prompt": PROMPT, "max_length": NEW,
                 "stream": True, "temperature": 0.0}))
            assert st == 200, raw

            def partials():
                return [e for e in events
                        if e.get("original_task_id") == "durable-1" and "text_delta" in e]

            await _until(lambda: any(e["seq"] >= 1 for e in partials()), "the second chunk")
            role = holder("durable-1")
            assert role is not None, "no journal names the stream"
            os.kill(sup.pid(role), signal.SIGKILL)
            survivor = "gen2" if role == "gen1" else "gen1"
            await _until(lambda: any(e.get("original_task_id") == "durable-1"
                                     and "generated_text" in e for e in events),
                         "the final event")
            parts = partials()
            seqs = [e["seq"] for e in parts]
            assert seqs == list(range(len(seqs))), f"seq {seqs}: a gap or a duplicate"
            assert parts[-1]["done"]
            text = "".join(e["text_delta"] for e in parts)
            final = next(e["generated_text"] for e in events
                         if e.get("original_task_id") == "durable-1"
                         and "generated_text" in e)
            assert text == final == want
            # the survivor adopted it (its journal names it) and, once the
            # result was published, marked it done
            assert (jdir / f"{survivor}.genlog").exists()
            assert b"durable-1" in (jdir / f"{survivor}.genlog").read_bytes()
            await _until(lambda: not GenJournal(jdir / f"{survivor}.genlog").live_tails(),
                         "the survivor's journal drained")
            # the dead worker's journal was rotated aside when it was rescued
            assert (jdir / f"{role}.genlog.orphaned").exists()
        finally:
            if reader is not None:
                reader.cancel()
                await asyncio.gather(reader, return_exceptions=True)
            await sup.stop()

    try:
        asyncio.run(main())
    except BaseException:
        log.flush()
        sys.stderr.write((tmp_path / "workers.log").read_text()[-4000:])
        raise
    finally:
        log.close()
    assert all(w.proc.poll() is not None for w in sup.workers.values())
