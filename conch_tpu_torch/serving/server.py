# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""OpenAI-compatible HTTP front end (counterpart of
``conch_tpu/serving/server.py``), on the standard library's
``ThreadingHTTPServer``:

- ``POST /v1/completions``: prompt in, tokens (and text, with a tokenizer)
  out, OpenAI request and response shapes, SSE streaming with
  ``"stream": true``;
- ``GET /v1/models``: the base model and every mounted LoRA adapter;
- ``GET /health``: liveness and the engine's ``stats()``.

One worker thread owns the ``LLMEngine``; the engine's continuous batcher
is the concurrency layer, and HTTP threads never touch the engine. Handler
threads submit work through a queue and block on per-request event queues;
the worker drains submissions between engine steps, so requests join the
running batch as they come.

Prompts are token-id lists, or strings when a tokenizer with ``encode`` /
``decode`` is mounted. The request's ``model`` field picks a LoRA adapter
mounted at ``ServerConfig.adapters`` (name -> lora_id); the base model's
name picks none. An engine fault ends the worker: every waiting request
gets an error event, the fault is kept in ``EngineWorker.fault`` and
re-raised in the worker thread, ``alive`` turns False, and later
submissions get the error at once.
"""

from __future__ import annotations

import json
import queue
import threading
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from conch_tpu_torch.serving.engine import LLMEngine, RequestState
from conch_tpu_torch.serving.sampling import SamplingParams


@dataclass
class ServerConfig:
    model_name: str = "conch-tpu"
    adapters: dict[str, int] = field(default_factory=dict)  # name -> lora_id
    # Optional tokenizer with .encode(str)->list[int] and
    # .decode(list[int])->str (duck-typed; transformers tokenizers work).
    tokenizer: object | None = None


class _Submission:
    def __init__(self, prompt, sampling, lora_id):
        self.prompt = prompt
        self.sampling = sampling
        self.lora_id = lora_id
        self.events: queue.Queue = queue.Queue()
        self.rid: int | None = None
        self.ready = threading.Event()


class EngineWorker:
    """Single thread that owns the engine and streams per-token events.

    Event protocol on each submission's queue:
    ``("token", token_id)`` per generated token, then ``("done", reason)``
    once, or ``("error", message)``. Parallel sampling (n>1) emits
    ``("sibling", rid)`` for each forked sequence's own event stream. An
    engine fault is kept in ``fault`` and ends the thread (``alive``).
    """

    def __init__(self, engine: LLMEngine):
        self.engine = engine
        self._submit: queue.Queue[_Submission] = queue.Queue()
        self._events: dict[int, queue.Queue] = {}
        self._emitted: dict[int, int] = {}
        self._known_siblings: dict[int, set[int]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.fault: Exception | None = None
        self._thread = threading.Thread(target=self._loop, name="engine-worker", daemon=True)
        self._thread.start()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def submit(self, prompt: list[int], sampling: SamplingParams, lora_id: int | None) -> _Submission:
        sub = _Submission(prompt, sampling, lora_id)
        self._submit.put(sub)
        if self.fault is not None:  # the worker is gone: nobody else drains the queue
            self._fail_pending()
        return sub

    def shutdown(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)

    # -- worker side ---------------------------------------------------------

    def _drain_submissions(self, block: bool) -> None:
        while True:
            try:
                sub = self._submit.get(timeout=0.05 if block else 0)
            except queue.Empty:
                return
            try:
                rid = self.engine.add_request(sub.prompt, sub.sampling, lora_id=sub.lora_id)
            except Exception as exc:  # invalid request (too long, bad lora id)
                sub.events.put(("error", str(exc)))
                sub.ready.set()
                continue
            sub.rid = rid
            self._events[rid] = sub.events
            self._emitted[rid] = 0
            sub.ready.set()
            block = False  # got one; drain the rest without waiting

    def _emit_new_tokens(self, req) -> None:
        q = self._events.get(req.request_id)
        if q is None:
            return
        n = self._emitted.get(req.request_id, 0)
        for tok in req.output_tokens[n:]:
            q.put(("token", int(tok)))
        self._emitted[req.request_id] = len(req.output_tokens)

    def _fail_pending(self) -> None:
        """Answer every submission still queued with the engine's fault."""
        while True:
            try:
                sub = self._submit.get_nowait()
            except queue.Empty:
                return
            sub.events.put(("error", f"engine step failed: {self.fault!r}"))
            sub.ready.set()

    def _announce_siblings(self) -> None:
        # Parallel sampling: the engine forks siblings during prefill;
        # route each sibling's stream to its own queue and tell the
        # handler where to listen.
        for parent_id, sibs in self.engine._group.items():
            if parent_id not in self._events:
                continue
            known = self._known_siblings.setdefault(parent_id, set())
            for rid in sibs:
                if rid in known:
                    continue
                known.add(rid)
                self._events[rid] = queue.Queue()
                self._emitted[rid] = 0
                self._events[parent_id].put(("sibling", rid))

    def sibling_queue(self, rid: int) -> queue.Queue:
        return self._events[rid]

    def _loop(self) -> None:
        while not self._stop.is_set():
            idle = not (self.engine.running or self.engine.waiting)
            self._drain_submissions(block=idle)
            if not (self.engine.running or self.engine.waiting):
                continue
            try:
                finished = self.engine.step()
            except Exception as exc:  # surface engine faults to all waiters
                self.fault = exc
                for q in self._events.values():
                    q.put(("error", f"engine step failed: {exc!r}"))
                self._events.clear()
                self._fail_pending()
                raise
            self._announce_siblings()
            for req in self.engine.running:
                if req.state == RequestState.RUNNING:
                    self._emit_new_tokens(req)
            for req in finished:
                self._emit_new_tokens(req)
                q = self._events.pop(req.request_id, None)
                self._emitted.pop(req.request_id, None)
                if q is not None:
                    reason = (
                        "length"
                        if len(req.output_tokens) >= req.sampling.max_tokens
                        else "stop"
                    )
                    q.put(("done", reason))


def _sampling_from_request(body: dict) -> SamplingParams:
    return SamplingParams(
        temperature=float(body.get("temperature", 0.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        max_tokens=int(body.get("max_tokens", 16)),
        n=int(body.get("n", 1)),
        stop_token_ids=tuple(body.get("stop_token_ids", ())),
        min_tokens=int(body.get("min_tokens", 0)),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        logprobs=bool(body.get("logprobs", False)),
    )


def make_server(
    worker: EngineWorker, server_config: ServerConfig, host: str = "127.0.0.1", port: int = 0
) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; ``server.serve_forever()``
    or drive it from a thread. ``port=0`` binds an ephemeral port."""
    cfg = server_config

    def resolve_lora(model: str | None) -> int | None:
        if model is None or model == cfg.model_name:
            return None
        if model in cfg.adapters:
            return cfg.adapters[model]
        raise ValueError(f"unknown model {model!r}")

    def encode_prompt(prompt) -> list[int]:
        if isinstance(prompt, str):
            if cfg.tokenizer is None:
                raise ValueError("string prompts need a mounted tokenizer; send token ids")
            return list(cfg.tokenizer.encode(prompt))
        if isinstance(prompt, list) and all(isinstance(t, int) for t in prompt):
            return prompt
        raise ValueError("prompt must be a string or a list of token ids")

    def decode_text(tokens: list[int]) -> str | None:
        if cfg.tokenizer is None:
            return None
        return cfg.tokenizer.decode(tokens)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet test output
            pass

        def _json(self, code: int, obj: dict) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok", "stats": worker.engine.stats()})
            elif self.path == "/v1/models":
                models = [{"id": cfg.model_name, "object": "model"}] + [
                    {"id": name, "object": "model", "parent": cfg.model_name}
                    for name in sorted(cfg.adapters)
                ]
                self._json(200, {"object": "list", "data": models})
            else:
                self._json(404, {"error": {"message": f"no route {self.path}"}})

        def do_POST(self):
            if self.path != "/v1/completions":
                self._json(404, {"error": {"message": f"no route {self.path}"}})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                prompt = encode_prompt(body.get("prompt"))
                sampling = _sampling_from_request(body)
                lora_id = resolve_lora(body.get("model"))
            except (ValueError, json.JSONDecodeError) as exc:
                self._json(400, {"error": {"message": str(exc), "type": "invalid_request_error"}})
                return
            if body.get("stream"):
                if sampling.n != 1:
                    self._json(400, {"error": {"message": "stream does not support n>1"}})
                    return
                self._stream(prompt, sampling, lora_id, body)
            else:
                self._complete(prompt, sampling, lora_id, body)

        def _collect(self, events: queue.Queue) -> tuple[list[int], str]:
            tokens, reason = [], "stop"
            while True:
                kind, val = events.get(timeout=120)
                if kind == "token":
                    tokens.append(val)
                elif kind == "done":
                    reason = val
                    return tokens, reason
                elif kind == "error":
                    raise RuntimeError(val)

        def _complete(self, prompt, sampling, lora_id, body) -> None:
            sub = worker.submit(prompt, sampling, lora_id)
            choices = []
            sib_queues = []
            try:
                tokens, reason = [], "stop"
                while True:
                    kind, val = sub.events.get(timeout=120)
                    if kind == "token":
                        tokens.append(val)
                    elif kind == "sibling":
                        sib_queues.append(worker.sibling_queue(val))
                    elif kind == "done":
                        reason = val
                        break
                    elif kind == "error":
                        self._json(400, {"error": {"message": val}})
                        return
                results = [(tokens, reason)] + [self._collect(q) for q in sib_queues]
            except (queue.Empty, RuntimeError) as exc:
                self._json(500, {"error": {"message": str(exc)}})
                return
            for i, (toks, why) in enumerate(results):
                choice = {"index": i, "token_ids": toks, "finish_reason": why}
                text = decode_text(toks)
                if text is not None:
                    choice["text"] = text
                choices.append(choice)
            self._json(
                200,
                {
                    "id": f"cmpl-{uuid.uuid4().hex[:24]}",
                    "object": "text_completion",
                    "model": body.get("model") or cfg.model_name,
                    "choices": choices,
                    "usage": {
                        "prompt_tokens": len(prompt),
                        "completion_tokens": sum(len(t) for t, _ in results),
                        "total_tokens": len(prompt) + sum(len(t) for t, _ in results),
                    },
                },
            )

        def _stream(self, prompt, sampling, lora_id, body) -> None:
            sub = worker.submit(prompt, sampling, lora_id)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def send_chunk(payload: str) -> None:
                data = payload.encode()
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            cid = f"cmpl-{uuid.uuid4().hex[:24]}"
            sent = []
            while True:
                try:
                    kind, val = sub.events.get(timeout=120)
                except queue.Empty:
                    break
                if kind == "token":
                    sent.append(val)
                    chunk = {
                        "id": cid,
                        "object": "text_completion",
                        "model": body.get("model") or cfg.model_name,
                        "choices": [{"index": 0, "token_ids": [val], "finish_reason": None}],
                    }
                    text = decode_text([val])
                    if text is not None:
                        chunk["choices"][0]["text"] = text
                    send_chunk(f"data: {json.dumps(chunk)}\n\n")
                elif kind == "done":
                    chunk = {
                        "id": cid,
                        "object": "text_completion",
                        "choices": [{"index": 0, "token_ids": [], "finish_reason": val}],
                    }
                    send_chunk(f"data: {json.dumps(chunk)}\n\n")
                    send_chunk("data: [DONE]\n\n")
                    break
                elif kind == "error":
                    send_chunk(f'data: {json.dumps({"error": {"message": val}})}\n\n')
                    break
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

    return ThreadingHTTPServer((host, port), Handler)


def serve(engine: LLMEngine, server_config: ServerConfig | None = None, host: str = "127.0.0.1", port: int = 8000) -> None:
    """Blocking convenience entry point: wrap ``engine``, serve forever."""
    worker = EngineWorker(engine)
    httpd = make_server(worker, server_config or ServerConfig(), host, port)
    try:
        httpd.serve_forever()
    finally:
        worker.shutdown()
