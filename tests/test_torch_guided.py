# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Guided decoding in the port (``serving/guided.py`` and the engine's
guided masks) against the JAX package's.

- The FSM compiler: tests/guided_test.py's oracle cases against
  ``re.fullmatch``, and the port's ``transitions``, ``allowed`` and
  ``accepting`` equal to JAX's bit for bit, and ``json_schema_to_regex``'s
  strings equal, for every pattern and schema there.
- ``_apply_logit_rules`` with guided rows (a mid-match state, a forced EOS
  under ``min_tokens``, an accepting state, a dead state) equals JAX's bit
  for bit on the same logits.
- One JAX engine on tests/guided_test.py:143's tiny model (carried across
  with ``params_from_jax``) serves four greedy guided requests in one batch:
  a regex, JSON mode with logprobs, a fixed-length pattern under
  ``min_tokens`` 10 and an ``n`` 2 group; the port's tokens must equal
  JAX's and its logprobs JAX's within 1e-4 (f32).
- On the port alone, at temperature 1 (the two packages draw different
  numbers): the regex, forced-finish, JSON-mode, preemption and mixed-batch
  cases of tests/guided_test.py, guided logprobs (0.0 where one token is
  legal), ``n`` 3 siblings each walking their own state, and the two
  ``ValueError``s.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from guided_test import ORACLE_CASES, SCHEMA

from conch_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from conch_tpu.models.llama import init_llama_params as jax_init_llama_params
from conch_tpu.serving import EngineConfig as JaxEngineConfig
from conch_tpu.serving import LLMEngine as JaxLLMEngine
from conch_tpu.serving import SamplingParams as JaxSamplingParams
from conch_tpu.serving import guided as jax_guided
from conch_tpu.serving.engine import Request as JaxRequest
from conch_tpu_torch.models.llama import LlamaConfig, params_from_jax
from conch_tpu_torch.serving import EngineConfig, LLMEngine, Request, SamplingParams
from conch_tpu_torch.serving import guided as port_guided
from conch_tpu_torch.serving.guided import TokenFSM, fsm_for_json_schema, json_schema_to_regex
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

VOCAB_SIZE, EOS = 128, 0
DIMS = {"vocab_size": VOCAB_SIZE, "hidden_size": 128, "intermediate_size": 256, "num_layers": 2, "num_heads": 4,
        "num_kv_heads": 2, "head_dim": 32, "max_position": 512}
ENGINE = {"page_size": 16, "num_pages": 64, "max_batch_size": 4, "max_pages_per_seq": 8, "max_prefill_tokens": 64,
          "eos_token_id": EOS}
JSON_SCHEMA = {"type": "object", "properties": {"count": {"type": "integer"}, "ok": {"type": "boolean"}}}
ARRAY_SCHEMA = {"type": "object", "properties": {"xs": {"type": "array", "items": {"type": "integer"}}}}
# Every pattern of tests/guided_test.py beyond its oracle cases.
PATTERNS = [p for p, _ in ORACLE_CASES] + [r"\d+\.\d{2}", "(yes|no|maybe)", "[ab]{3}", "(abc|xyz){1,4}", "[xy]{2}",
                                           "a"]


def char_vocab() -> list[str]:
    """Token i decodes to chr(i) for printable ASCII; the others (EOS among
    them) to '', which no FSM allows."""
    return ["" if i < 32 or i == 127 else chr(i) for i in range(VOCAB_SIZE)]


def decode(tokens: list[int]) -> str:
    return "".join(chr(t) for t in tokens if t != EOS)


def _accepts(fsm, s: str) -> bool:
    state = fsm.walk([ord(c) for c in s])
    return state >= 0 and bool(fsm.accepting[state])


@pytest.mark.parametrize(("pattern", "candidates"), ORACLE_CASES)
def test_fsm_matches_re_oracle(pattern, candidates):
    fsm = TokenFSM.from_regex(pattern, char_vocab())
    for s in candidates:
        assert _accepts(fsm, s) == bool(re.fullmatch(pattern, s)), (pattern, s)


def test_fsm_multichar_tokens_and_escapes():
    vocab = ["", "a", "b", "ab", "abc", "c", "x"]
    fsm = TokenFSM.from_regex("(abc)+", vocab)
    s = fsm.start_state
    assert fsm.accepting[fsm.advance(fsm.advance(s, 3), 5)]  # "ab" then "c"
    s2 = fsm.advance(s, 4)
    assert s2 >= 0 and fsm.accepting[s2] and fsm.accepting[fsm.advance(s2, 4)]
    assert fsm.advance(s, 6) == -1 and fsm.advance(s, 0) == -1  # "x" and the empty token never legal
    fsm = TokenFSM.from_regex(r"\d+\.\d{2}", char_vocab())
    for text, ok in [("3.14", True), ("12.50", True), ("3.1", False), ("a.12", False), ("3.141", False)]:
        assert _accepts(fsm, text) == ok, text
    assert hash(fsm) == id(fsm) and fsm != TokenFSM.from_regex(r"\d+\.\d{2}", char_vocab())  # identity semantics


@pytest.mark.parametrize("pattern", PATTERNS)
def test_fsm_tables_equal_jax(pattern):
    for vocab in (char_vocab(), ["", "a", "b", "ab", "abc", "c", "x", "yes", "no", "1.", "23", "{\"", "\":"]):
        ours, ref = TokenFSM.from_regex(pattern, vocab), jax_guided.TokenFSM.from_regex(pattern, vocab)
        assert ours.transitions.dtype == ref.transitions.dtype == np.int32
        np.testing.assert_array_equal(ours.transitions, ref.transitions)
        np.testing.assert_array_equal(ours.allowed, ref.allowed)
        np.testing.assert_array_equal(ours.accepting, ref.accepting)
        assert ours.pattern == ref.pattern == pattern


@pytest.mark.parametrize("schema", [SCHEMA, ARRAY_SCHEMA, JSON_SCHEMA])
def test_json_schema_regex_and_tables_equal_jax(schema):
    rx = json_schema_to_regex(schema)
    assert rx == jax_guided.json_schema_to_regex(schema)
    ours, ref = fsm_for_json_schema(schema, char_vocab()), jax_guided.fsm_for_json_schema(schema, char_vocab())
    np.testing.assert_array_equal(ours.transitions, ref.transitions)
    np.testing.assert_array_equal(ours.accepting, ref.accepting)
    if schema is SCHEMA:  # tests/guided_test.py's conforming and violating instances
        assert re.fullmatch(rx, '{"name": "bo", "age": 41, "score": -2.5e3, "active": true, "tag": "red"}')
        assert not re.fullmatch(rx, '{"name": "bo", "age": 4.5, "score": 1, "active": true, "tag": "red"}')
    with pytest.raises(ValueError, match="top-level"):
        json_schema_to_regex({"type": "array"})


def test_apply_guided_masks_matches_jax():
    """The logit rules with guided rows, bit for bit: a mid-match state
    under a repetition penalty, a complete fixed-length match under
    min_tokens (EOS suppressed, then forced to 0.0), an accepting state
    that can extend, an unguided row, and a dead state."""
    small = {**DIMS, "vocab_size": 16, "hidden_size": 32, "intermediate_size": 64, "num_layers": 1}
    vocab = ["", *"abcdefghijklmno"]
    jax_cfg = JaxLlamaConfig(**small, dtype=jnp.float32)
    jax_engine = JaxLLMEngine(jax_init_llama_params(0, jax_cfg, "bf16"), jax_cfg,
                              JaxEngineConfig(page_size=16, num_pages=8, eos_token_id=EOS))
    cfg = LlamaConfig(**small, dtype=torch.float32)
    engine = LLMEngine(params_from_jax(jax.tree.map(np.asarray, jax_init_llama_params(0, jax_cfg, "bf16")), cfg,
                                       device="cpu"),
                       cfg, EngineConfig(page_size=16, num_pages=8, eos_token_id=EOS), device="cpu")
    rules = [  # (pattern, outputs, sampling fields)
        ("(ab|cd)*e", [1], {"repetition_penalty": 1.5}),
        ("[ab]{3}", [1, 2, 1], {"min_tokens": 10}),
        ("a+", [1, 1], {"logit_bias": ((1, 2.0),)}),
        (None, [3], {"min_tokens": 4}),
        ("ab", [3], {}),  # "c" cannot start "ab": a dead state
    ]
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(6, 16)).astype(np.float32)
    rows = [0, 2, 3, 4, 5]
    jax_reqs, reqs = [], []
    for i, (pattern, outputs, kw) in enumerate(rules):
        jax_fsm = None if pattern is None else jax_guided.TokenFSM.from_regex(pattern, vocab)
        fsm = None if pattern is None else TokenFSM.from_regex(pattern, vocab)
        jr = JaxRequest(i, prompt=[5, 6], sampling=JaxSamplingParams(guided=jax_fsm, **kw))
        r = Request(i, prompt=[5, 6], sampling=SamplingParams(guided=fsm, **kw))
        jr.output_tokens, r.output_tokens = list(outputs), list(outputs)
        jax_reqs.append(jr)
        reqs.append(r)
    ref = np.asarray(jax_engine._apply_logit_rules(jnp.asarray(logits), jax_reqs, rows=rows))
    given = torch.from_numpy(logits.copy())
    ours = engine._apply_logit_rules(given, reqs, rows=rows).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert torch.equal(given, torch.from_numpy(logits))  # the caller's logits untouched
    assert ours[2, EOS] == 0.0 and np.isneginf(np.delete(ours[2], EOS)).all()  # forced EOS beats min_tokens
    assert ours[5, EOS] == 0.0 and np.isneginf(np.delete(ours[5], EOS)).all()  # dead state: EOS only
    assert np.isfinite(ours[3, [EOS, 1]]).all() and np.isneginf(ours[3, 2:]).all()  # accepting "a+": EOS or "a"
    assert (ours[1] == logits[1]).all()  # no request on row 1
    assert reqs[0].guided_cache == (1, reqs[0].sampling.guided.walk([1]))


# -- engines -------------------------------------------------------------------

# The JAX batch: (prompt, pattern or schema, sampling fields), all greedy.
JAX_BATCH = [
    ([10, 20, 30], "(yes|no|maybe)", {"max_tokens": 16}),
    ([7, 8, 9], JSON_SCHEMA, {"max_tokens": 24, "logprobs": True}),
    ([5, 6], "[ab]{3}", {"max_tokens": 32, "min_tokens": 10}),
    ([11, 12, 13], "(abc|xyz){1,4}", {"max_tokens": 20, "n": 2}),
]


def _fsm(fsm_module, spec):
    if isinstance(spec, dict):
        return fsm_module.fsm_for_json_schema(spec, char_vocab())
    return fsm_module.TokenFSM.from_regex(spec, char_vocab())


def _serve(engine, sampling_cls, fsm_module) -> dict:
    """JAX_BATCH through ``engine``; {request id: (tokens, logprobs)} with
    the n 2 group's sibling under its own id."""
    for prompt, spec, kw in JAX_BATCH:
        engine.add_request(prompt, sampling_cls(guided=_fsm(fsm_module, spec), **kw))
    done = {}
    while engine.waiting or engine.running:
        for r in engine.step():
            done[r.request_id] = (r.output_tokens, r.output_logprobs)
    return done


@pytest.fixture(scope="module")
def jax_run():
    cfg = JaxLlamaConfig(**DIMS, dtype=jnp.float32)
    params = jax_init_llama_params(0, cfg, "bf16")
    done = _serve(JaxLLMEngine(params, cfg, JaxEngineConfig(**ENGINE)), JaxSamplingParams, jax_guided)
    return jax.tree.map(np.asarray, params), done


def _engine(numpy_params, **over) -> LLMEngine:
    cfg = LlamaConfig(**DIMS, dtype=torch.float32)
    return LLMEngine(params_from_jax(numpy_params, cfg, device="cpu"), cfg, EngineConfig(**{**ENGINE, **over}),
                     device="cpu")


def test_greedy_guided_tokens_match_jax(jax_run):
    numpy_params, ref = jax_run
    ours = _serve(_engine(numpy_params), SamplingParams, port_guided)
    assert sorted(ours) == sorted(ref) == [0, 1, 2, 3, 4]
    for rid in ref:
        assert ours[rid][0] == ref[rid][0], rid
        np.testing.assert_allclose(ours[rid][1], ref[rid][1], atol=1e-4, rtol=0)
    assert re.fullmatch("(yes|no|maybe)", decode(ours[0][0])) and ours[0][0][-1] == EOS
    assert ours[2][0][-1] == EOS and len(ours[2][0]) == 4 and re.fullmatch("[ab]{3}", decode(ours[2][0]))
    assert ours[3][0] == ours[4][0]  # a greedy group's members agree
    lps = ours[1][1]
    assert len(lps) == len(ours[1][0]) and all(-30.0 < lp <= 0.0 for lp in lps)
    assert lps[0] == 0.0  # '{' is the only legal first token: log 1 under the masked logits


def _generate(engine, prompts, **kw):
    return engine.generate(prompts, SamplingParams(**kw))


def test_sampled_guided_requests(jax_run):
    """tests/guided_test.py's temperature-1 cases on the port."""
    numpy_params = jax_run[0]
    fsm = TokenFSM.from_regex("(yes|no|maybe)", char_vocab())
    for out in _generate(_engine(numpy_params), [[10, 20, 30], [40, 50], [60]], temperature=1.0, max_tokens=16,
                         guided=fsm):
        assert out[-1] == EOS and re.fullmatch("(yes|no|maybe)", decode(out)), out
    fsm = TokenFSM.from_regex("[ab]{3}", char_vocab())
    out = _generate(_engine(numpy_params), [[5, 6]], temperature=1.0, max_tokens=32, min_tokens=10, guided=fsm)[0]
    assert re.fullmatch("[ab]{3}", decode(out)) and out[-1] == EOS and len(out) == 4
    fsm = fsm_for_json_schema(JSON_SCHEMA, char_vocab())
    out = _generate(_engine(numpy_params), [[7, 8, 9]], temperature=1.0, max_tokens=64, guided=fsm)[0]
    if out[-1] == EOS:
        obj = json.loads(decode(out))
        assert isinstance(obj["count"], int) and isinstance(obj["ok"], bool)
    else:  # cut at max_tokens inside the match: a prefix of a conforming instance
        assert len(out) == 64 and fsm.walk(out) >= 0
    fsm = TokenFSM.from_regex("a+", char_vocab())  # min_tokens holds EOS back while the match can extend
    out = _generate(_engine(numpy_params), [[9]], temperature=1.0, max_tokens=12, min_tokens=6, guided=fsm)[0]
    assert len(out) >= 6 and set(out[:6]) == {97} and re.fullmatch("a+", decode(out))


def test_guided_survives_preemption(jax_run):
    """A pool of 7 pages preempts (three 24-token prompts, each match 9 to
    18 characters: 3 pages a request); each request walks its state again
    from its output tokens. Sampled outputs keep the pattern, and greedy
    ones equal the same requests served without preemption."""
    numpy_params = jax_run[0]
    pattern = "(abc|xyz){3,6}"
    fsm = TokenFSM.from_regex(pattern, char_vocab())
    prompts = [[11, 12, 13] * 8, [14, 15] * 12, [16, 17, 18] * 8]
    tight = {"num_pages": 7, "max_batch_size": 3, "max_pages_per_seq": 4}
    for temperature in (1.0, 0.0):
        engine = _engine(numpy_params, **tight)
        ids = [engine.add_request(p, SamplingParams(temperature=temperature, max_tokens=20, guided=fsm))
               for p in prompts]
        done = {}
        while engine.waiting or engine.running:
            for r in engine.step():
                done[r.request_id] = r
        assert sum(done[i].num_preemptions for i in ids) > 0
        assert all(re.fullmatch(pattern, decode(done[i].output_tokens)) for i in ids)
        assert engine.allocator.num_free + len(engine._cached_lru) == 7
    alone = _generate(_engine(numpy_params), prompts, max_tokens=20, guided=fsm)
    assert [done[i].output_tokens for i in ids] == alone


def test_guided_and_unguided_mix(jax_run):
    numpy_params = jax_run[0]
    engine = _engine(numpy_params)
    fsm = TokenFSM.from_regex("[xy]{2}", char_vocab())
    rid_g = engine.add_request([3, 4], SamplingParams(temperature=1.0, max_tokens=8, guided=fsm))
    rid_u = engine.add_request([3, 4], SamplingParams(max_tokens=5))
    results = {}
    while engine.waiting or engine.running:
        for req in engine.step():
            results[req.request_id] = req.output_tokens
    assert re.fullmatch("[xy]{2}", decode(results[rid_g]))
    assert results[rid_u] == _generate(_engine(numpy_params), [[3, 4]], max_tokens=5)[0]


def test_guided_siblings_and_logprobs(jax_run):
    """n 3 at temperature 1: every member walks its own state and keeps the
    pattern; logprobs come from the masked logits (a fixed word: every
    token is forced, log 1 = 0)."""
    numpy_params = jax_run[0]
    pattern = "(abc|xyz){1,4}"
    fsm = TokenFSM.from_regex(pattern, char_vocab())
    group = _generate(_engine(numpy_params), [[11, 12, 13]], temperature=1.0, max_tokens=20, n=3, guided=fsm)[0]
    assert len(group) == 3 and all(re.fullmatch(pattern, decode(out)) for out in group)
    engine = _engine(numpy_params)
    rid = engine.add_request([1, 2], SamplingParams(temperature=1.0, max_tokens=10, logprobs=True,
                                                    guided=TokenFSM.from_regex("hello", char_vocab())))
    done = {}
    while engine.waiting or engine.running:
        for r in engine.step():
            done[r.request_id] = r
    assert decode(done[rid].output_tokens) == "hello" and done[rid].output_logprobs == [0.0] * 6


def test_guided_value_errors(jax_run):
    numpy_params = jax_run[0]
    fsm = TokenFSM.from_regex("a", char_vocab())
    with pytest.raises(ValueError, match="eos_token_id"):
        _engine(numpy_params, eos_token_id=None).add_request([1], SamplingParams(guided=fsm))
    with pytest.raises(ValueError, match="vocab"):
        _engine(numpy_params).add_request([1], SamplingParams(guided=TokenFSM.from_regex("a", char_vocab()[:64])))
