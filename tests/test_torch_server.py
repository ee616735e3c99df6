# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The port's OpenAI-compatible HTTP server (``serving/server.py``) against
the JAX package's: real sockets on 127.0.0.1 port 0, real threads, the
port's engine underneath.

- tests/server_test.py's scenarios over the port's server (a completion,
  LoRA chosen by ``model``, three concurrent requests, streamed against
  non-streamed, ``n`` 2, a string prompt, ``/v1/models`` and ``/health``);
  every greedy output must equal the JAX engine's direct ``generate`` on
  tests/server_test.py's tiny model and adapter (carried across with
  ``params_from_jax`` and ``lora_from_jax``).
- The same invalid bodies and routes sent to a JAX server and to the
  port's give the same status codes and the same error JSON.
- An engine fault: the waiting request gets the error, the worker ends with
  the fault kept, and a later request gets the error at once.

Every test fails if its worker died (``EngineWorker.alive``): a fault in
the worker thread is not lost.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from conch_tpu.models.llama import init_llama_params as jax_init_llama_params
from conch_tpu.models.lora import init_lora_adapter as jax_init_lora_adapter
from conch_tpu.models.lora import stack_lora_adapters as jax_stack_lora_adapters
from conch_tpu.serving import EngineConfig as JaxEngineConfig
from conch_tpu.serving import LLMEngine as JaxLLMEngine
from conch_tpu.serving import SamplingParams as JaxSamplingParams
from conch_tpu.serving import server as jax_server
from conch_tpu_torch.models.llama import LlamaConfig, params_from_jax
from conch_tpu_torch.models.lora import lora_from_jax
from conch_tpu_torch.serving import EngineConfig, EngineWorker, LLMEngine, ServerConfig, make_server
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

DIMS = {"vocab_size": 128, "hidden_size": 128, "intermediate_size": 256, "num_layers": 2, "num_heads": 4,
        "num_kv_heads": 2, "head_dim": 32, "max_position": 512}
ENGINE = {"page_size": 16, "num_pages": 64, "max_batch_size": 4, "max_pages_per_seq": 8, "max_prefill_tokens": 64}
SERVER = {"model_name": "tiny", "adapters": {"tiny-lora": 0}}


class ByteTokenizer:
    def encode(self, s: str) -> list[int]:
        return [b % 128 for b in s.encode()]

    def decode(self, toks: list[int]) -> str:
        return "".join(chr(t) for t in toks)


def _rand_prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, 128, size=n).tolist()


# tests/server_test.py's prompts: (seed, length, max_tokens, lora_id).
DIRECT = {
    "completion": (0, 20, 8, None), "lora_base": (1, 18, 8, None), "lora": (1, 18, 8, 0),
    "concurrent0": (2, 15, 8, None), "concurrent1": (2, 22, 8, None), "concurrent2": (2, 19, 8, None),
    "stream": (3, 17, 6, None), "n2": (4, 16, 5, None),
}


def _direct_prompt(name: str) -> list[int]:
    seed, n, _, _ = DIRECT[name]
    if name.startswith("concurrent"):  # three prompts drawn from one generator, as tests/server_test.py:141
        rng = np.random.default_rng(seed)
        return [rng.integers(0, 128, size=m).tolist() for m in (15, 22, 19)][int(name[-1])]
    return _rand_prompt(seed, n)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX engine's direct greedy outputs (one engine, all prompts, their
    max_tokens in two groups), the params and adapters, and a JAX server
    (no tokenizer) for the error comparison."""
    cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    params = jax_init_llama_params(0, cfg, "bf16")
    adapters = jax_stack_lora_adapters([jax_init_lora_adapter(1, cfg, rank=4, alpha=128.0, dtype=jnp.float32)])
    engine = JaxLLMEngine(params, cfg, JaxEngineConfig(**ENGINE), lora=adapters)
    direct = {}
    for max_tokens in sorted({m for _, _, m, _ in DIRECT.values()}):
        names = [k for k, v in DIRECT.items() if v[2] == max_tokens]
        outs = engine.generate([_direct_prompt(k) for k in names], JaxSamplingParams(max_tokens=max_tokens),
                               lora_ids=[DIRECT[k][3] for k in names])
        direct.update(zip(names, outs))
    worker = jax_server.EngineWorker(JaxLLMEngine(params, cfg, JaxEngineConfig(**ENGINE), lora=adapters))
    httpd = jax_server.make_server(worker, jax_server.ServerConfig(**SERVER), "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield {"direct": direct, "params": jax.tree.map(np.asarray, params),
           "adapters": jax.tree.map(np.asarray, adapters), "base": f"http://127.0.0.1:{httpd.server_address[1]}"}
    httpd.shutdown()
    httpd.server_close()
    worker.shutdown()


def _port_engine(jax_side) -> LLMEngine:
    cfg = LlamaConfig(**DIMS, dtype=torch.float32)
    return LLMEngine(params_from_jax(jax_side["params"], cfg, device="cpu"), cfg, EngineConfig(**ENGINE),
                     lora=lora_from_jax(jax_side["adapters"], device="cpu"), device="cpu")


def _start(worker, server_config):
    httpd = make_server(worker, server_config, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def served(jax_side):
    worker = EngineWorker(_port_engine(jax_side))
    httpd, base = _start(worker, ServerConfig(**SERVER, tokenizer=ByteTokenizer()))
    yield base, worker, jax_side["direct"]
    assert worker.alive and worker.fault is None, f"the engine worker died: {worker.fault!r}"
    httpd.shutdown()
    httpd.server_close()
    worker.shutdown()


def _post(base, path, body, raw_body: bytes | None = None):
    data = json.dumps(body).encode() if raw_body is None else raw_body
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_completion_matches_jax_direct(served):
    base, _, direct = served
    status, resp = _post(base, "/v1/completions", {"prompt": _direct_prompt("completion"), "max_tokens": 8,
                                                   "temperature": 0.0})
    assert status == 200 and resp["object"] == "text_completion" and resp["model"] == "tiny"
    assert resp["id"].startswith("cmpl-") and resp["usage"] == {"prompt_tokens": 20, "completion_tokens": 8,
                                                               "total_tokens": 28}
    assert resp["choices"][0]["token_ids"] == direct["completion"]
    assert resp["choices"][0]["finish_reason"] == "length"
    assert resp["choices"][0]["text"] == ByteTokenizer().decode(direct["completion"])


def test_lora_model_selection(served):
    base, _, direct = served
    prompt = _direct_prompt("lora")
    _, base_resp = _post(base, "/v1/completions", {"prompt": prompt, "max_tokens": 8})
    status, lora_resp = _post(base, "/v1/completions", {"prompt": prompt, "max_tokens": 8, "model": "tiny-lora"})
    assert status == 200 and lora_resp["model"] == "tiny-lora"
    assert base_resp["choices"][0]["token_ids"] == direct["lora_base"]
    assert lora_resp["choices"][0]["token_ids"] == direct["lora"] != direct["lora_base"]


def test_concurrent_requests_batch(served):
    base, _, direct = served
    results = {}

    def hit(i):
        _, resp = _post(base, "/v1/completions", {"prompt": _direct_prompt(f"concurrent{i}"), "max_tokens": 8})
        results[i] = resp["choices"][0]["token_ids"]

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert [results[i] for i in range(3)] == [direct[f"concurrent{i}"] for i in range(3)]


def _stream(base, body) -> tuple[list[int], str | None, list[dict]]:
    req = urllib.request.Request(base + "/v1/completions", data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    tokens, finish, chunks = [], None, []
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        lines = [line.decode().strip() for line in resp]
    assert lines[-2:] == ["data: [DONE]", ""] or lines[-1] == "data: [DONE]"
    for line in lines:
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        chunk = json.loads(line[6:])
        chunks.append(chunk)
        choice = chunk["choices"][0]
        tokens.extend(choice["token_ids"])
        finish = choice["finish_reason"] or finish
    return tokens, finish, chunks


def test_streaming_matches_nonstreaming(served):
    base, _, direct = served
    prompt = _direct_prompt("stream")
    _, full = _post(base, "/v1/completions", {"prompt": prompt, "max_tokens": 6})
    tokens, finish, chunks = _stream(base, {"prompt": prompt, "max_tokens": 6})
    assert tokens == full["choices"][0]["token_ids"] == direct["stream"]
    assert finish == "length" and len(chunks) == 7 and len({c["id"] for c in chunks}) == 1
    assert all(c["choices"][0]["text"] == chr(t) for c, t in zip(chunks, tokens))


def test_parallel_sampling_choices(served):
    base, _, direct = served
    status, resp = _post(base, "/v1/completions", {"prompt": _direct_prompt("n2"), "max_tokens": 5, "n": 2,
                                                   "temperature": 0.0})
    assert status == 200 and [c["index"] for c in resp["choices"]] == [0, 1]
    assert [c["token_ids"] for c in resp["choices"]] == [direct["n2"]] * 2
    assert resp["usage"]["completion_tokens"] == 10


def test_string_prompt_models_and_health(served):
    base, worker, _ = served
    status, resp = _post(base, "/v1/completions", {"prompt": "hello tpu", "max_tokens": 4})
    assert status == 200 and resp["usage"]["prompt_tokens"] == 9
    assert resp["choices"][0]["text"] == ByteTokenizer().decode(resp["choices"][0]["token_ids"])
    status, models = _get(base, "/v1/models")
    assert status == 200 and models == {"object": "list", "data": [
        {"id": "tiny", "object": "model"}, {"id": "tiny-lora", "object": "model", "parent": "tiny"}]}
    status, health = _get(base, "/health")
    assert status == 200 and health["status"] == "ok"
    assert health["stats"] == worker.engine.stats() and health["stats"]["free_pages"] == ENGINE["num_pages"] - len(
        worker.engine._cached_lru)


INVALID = [  # (method, path, body or raw bytes)
    ("POST", "/v1/completions", {"prompt": {"bad": 1}}),
    ("POST", "/v1/completions", {"prompt": [1, 2], "stream": True, "n": 2}),
    ("POST", "/v1/completions", {"prompt": [1, 2], "model": "nope"}),
    ("POST", "/v1/completions", {"prompt": "no tokenizer mounted"}),
    ("POST", "/v1/completions", {"prompt": [1, 2], "max_tokens": "x"}),
    ("POST", "/v1/completions", {"prompt": [1] * 200, "max_tokens": 4}),
    ("POST", "/v1/completions", {"prompt": [1, 2], "n": 0}),
    ("POST", "/v1/completions", b"{not json"),
    ("POST", "/v1/chat", {"prompt": [1, 2]}),
    ("GET", "/v1/nope", None),
]


def test_invalid_requests_match_jax_server(jax_side):
    """The JAX server and the port's, both without a tokenizer: the same
    status codes and error JSON for each invalid body and route."""
    worker = EngineWorker(_port_engine(jax_side))
    httpd, base = _start(worker, ServerConfig(**SERVER))
    try:
        for method, path, body in INVALID:
            got = []
            for url in (jax_side["base"], base):
                if method == "GET":
                    got.append(_get(url, path))
                else:
                    raw = body if isinstance(body, bytes) else None
                    got.append(_post(url, path, body, raw_body=raw))
            assert got[1] == got[0], (method, path, body)
            assert got[0][0] in (400, 404) and "message" in got[0][1]["error"]
        assert worker.alive and worker.engine.allocator.num_free == ENGINE["num_pages"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        worker.shutdown()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")  # the fault, re-raised in its thread
def test_engine_fault_reaches_every_waiter(jax_side):
    engine = _port_engine(jax_side)

    def broken_step():
        raise RuntimeError("device lost")

    engine.step = broken_step
    worker = EngineWorker(engine)
    httpd, base = _start(worker, ServerConfig(**SERVER))
    try:
        status, err = _post(base, "/v1/completions", {"prompt": [1, 2, 3], "max_tokens": 4})
        assert status == 400 and "device lost" in err["error"]["message"]
        worker._thread.join(timeout=10)
        assert not worker.alive and isinstance(worker.fault, RuntimeError)
        status, err = _post(base, "/v1/completions", {"prompt": [4, 5], "max_tokens": 4})
        assert status == 400 and "engine step failed" in err["error"]["message"]
    finally:
        httpd.shutdown()
        httpd.server_close()
