# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The port's HF checkpoint converters (``conch_tpu_torch.models.hf``)
against the JAX package's (``conch_tpu.models.hf``).

Each converter turns the same random numpy state dict (f32, drawn from a
seed, with HF's key names and (out, in) layouts) into params on both
sides; the JAX params, carried across with ``tree_from_jax``, must equal
the port's bit for bit (every tensor, dtype, projection kind and meta),
in bf16 and int4 (Llama also int8; DeepSeek's converter stores bf16
projections only), in f32 and bf16 activations. A bf16 torch state dict
stays bit for bit, and a ``safetensors`` round trip through
``load_safetensors_dir`` gives the same params. Two tests hold the
converted Llama and Mixtral against a randomly initialized
``transformers`` model's logits, through the port's prefill on the CPU:
bf16 projections against f32 HF, so directions (cosine > 0.999) and the
argmax, as tests/hf_convert_test.py holds JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conch_tpu.models.deepseek as jax_ds
import conch_tpu.models.gemma as jax_gemma
import conch_tpu.models.hf as jax_hf
import conch_tpu.models.llama as jax_llama
import conch_tpu.models.moe as jax_moe
import conch_tpu_torch.models.deepseek as ds
import conch_tpu_torch.models.gemma as gemma
import conch_tpu_torch.models.hf as hf
import conch_tpu_torch.models.llama as llama
import conch_tpu_torch.models.moe as moe
from conch_tpu_torch.models.linear import QuantizedLinear
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

V, H, F, L = 96, 128, 256, 2
ATTN = {"num_heads": 4, "num_kv_heads": 2, "head_dim": 32}
LLAMA_DIMS = {"vocab_size": V, "hidden_size": H, "intermediate_size": F, "num_layers": L, "max_position": 64,
              **ATTN}
GEMMA_DIMS = {**LLAMA_DIMS, "gemma2": True, "sliding_window": 16}
DS_DIMS = {"vocab_size": V, "hidden_size": H, "num_layers": 3, "num_heads": 4, "kv_lora_rank": 32,
           "qk_rope_head_dim": 16, "qk_nope_head_dim": 32, "v_head_dim": 32, "n_routed_experts": 4,
           "n_shared_experts": 1, "num_experts_per_tok": 2, "moe_intermediate_size": 64, "intermediate_size": F,
           "first_k_dense_replace": 1, "max_position": 64}
E = 4
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _state(kind: str, seed: int = 0, q_lora: int | None = None) -> dict[str, np.ndarray]:
    """A random f32 HF state dict of ``kind``'s architecture."""
    rng = np.random.default_rng(seed)
    q, kv = ATTN["num_heads"] * ATTN["head_dim"], ATTN["num_kv_heads"] * ATTN["head_dim"]
    state = {}

    def put(name, *shape, scale=0.05):
        state[name] = (rng.normal(size=shape) * scale).astype(np.float32)

    put("model.embed_tokens.weight", V, H)
    put("model.norm.weight", H, scale=1.0)
    if kind != "gemma":
        put("lm_head.weight", V, H)
    if kind == "deepseek":
        lora, rope, nope, vd, nh = 32, 16, 32, 32, 4
        for i in range(DS_DIMS["num_layers"]):
            p = f"model.layers.{i}."
            if q_lora:
                put(p + "self_attn.q_a_proj.weight", q_lora, H)
                put(p + "self_attn.q_a_layernorm.weight", q_lora, scale=1.0)
                put(p + "self_attn.q_b_proj.weight", nh * (nope + rope), q_lora)
            else:
                put(p + "self_attn.q_proj.weight", nh * (nope + rope), H)
            put(p + "self_attn.kv_a_proj_with_mqa.weight", lora + rope, H)
            put(p + "self_attn.kv_a_layernorm.weight", lora, scale=1.0)
            put(p + "self_attn.kv_b_proj.weight", nh * (nope + vd), lora)
            put(p + "self_attn.o_proj.weight", H, nh * vd)
            put(p + "input_layernorm.weight", H, scale=1.0)
            put(p + "post_attention_layernorm.weight", H, scale=1.0)
            if i == 0:
                for name, shape in (("gate_proj", (F, H)), ("up_proj", (F, H)), ("down_proj", (H, F))):
                    put(f"{p}mlp.{name}.weight", *shape)
            else:
                put(p + "mlp.gate.weight", 4, H)
                for e in range(4):
                    for name, shape in (("gate_proj", (64, H)), ("up_proj", (64, H)), ("down_proj", (H, 64))):
                        put(f"{p}mlp.experts.{e}.{name}.weight", *shape)
                for name, shape in (("gate_proj", (64, H)), ("up_proj", (64, H)), ("down_proj", (H, 64))):
                    put(f"{p}mlp.shared_experts.{name}.weight", *shape)
        return state
    for i in range(L):
        p = f"model.layers.{i}."
        if kind == "phi3":
            put(p + "self_attn.qkv_proj.weight", q + 2 * kv, H)
            put(p + "mlp.gate_up_proj.weight", 2 * F, H)
        else:
            put(p + "self_attn.q_proj.weight", q, H)
            put(p + "self_attn.k_proj.weight", kv, H)
            put(p + "self_attn.v_proj.weight", kv, H)
        put(p + "self_attn.o_proj.weight", H, q)
        if kind == "mixtral":
            put(p + "block_sparse_moe.gate.weight", E, H)
            for e in range(E):
                put(f"{p}block_sparse_moe.experts.{e}.w1.weight", F, H)
                put(f"{p}block_sparse_moe.experts.{e}.w2.weight", H, F)
                put(f"{p}block_sparse_moe.experts.{e}.w3.weight", F, H)
        elif kind != "phi3":
            put(p + "mlp.gate_proj.weight", F, H)
            put(p + "mlp.up_proj.weight", F, H)
        if kind != "mixtral":
            put(p + "mlp.down_proj.weight", H, F)
        if kind == "qwen2":
            for name, n in (("q_proj", q), ("k_proj", kv), ("v_proj", kv)):
                put(f"{p}self_attn.{name}.bias", n)
        put(p + "input_layernorm.weight", H, scale=1.0)
        put(p + "post_attention_layernorm.weight", H, scale=1.0)
        if kind == "gemma":
            put(p + "pre_feedforward_layernorm.weight", H, scale=1.0)
            put(p + "post_feedforward_layernorm.weight", H, scale=1.0)
    return state


def _configs(kind: str, dtype: str, q_lora: int | None = None):
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    if kind in ("llama", "phi3", "qwen2"):
        bias = kind == "qwen2"
        return (jax_llama.LlamaConfig(**LLAMA_DIMS, dtype=jd, attention_bias=bias),
                llama.LlamaConfig(**LLAMA_DIMS, dtype=td, attention_bias=bias))
    if kind == "mixtral":
        return (jax_moe.MoEConfig(llama=jax_llama.LlamaConfig(**LLAMA_DIMS, dtype=jd), num_experts=E),
                moe.MoEConfig(llama=llama.LlamaConfig(**LLAMA_DIMS, dtype=td), num_experts=E))
    if kind == "gemma":
        return jax_gemma.GemmaConfig(**GEMMA_DIMS, dtype=jd), gemma.GemmaConfig(**GEMMA_DIMS, dtype=td)
    return (jax_ds.DeepseekV2Config(**DS_DIMS, q_lora_rank=q_lora, dtype=jd),
            ds.DeepseekV2Config(**DS_DIMS, q_lora_rank=q_lora, dtype=td))


CONVERTERS = {
    "llama": (jax_hf.llama_params_from_hf, hf.llama_params_from_hf),
    "qwen2": (jax_hf.llama_params_from_hf, hf.llama_params_from_hf),
    "mixtral": (jax_hf.mixtral_params_from_hf, hf.mixtral_params_from_hf),
    "gemma": (jax_hf.gemma_params_from_hf, hf.gemma_params_from_hf),
    "phi3": (jax_hf.phi3_params_from_hf, hf.phi3_params_from_hf),
    "deepseek": (jax_hf.deepseek_params_from_hf, hf.deepseek_params_from_hf),
}


def _assert_same(ours, want, path="params") -> None:
    """Two param trees equal bit for bit."""
    if isinstance(want, dict):
        assert isinstance(ours, dict) and set(ours) == set(want), (path, sorted(ours), sorted(want))
        for k in want:
            _assert_same(ours[k], want[k], f"{path}.{k}")
    elif isinstance(want, QuantizedLinear):
        assert isinstance(ours, QuantizedLinear), path
        assert (ours.kind, ours.meta) == (want.kind, want.meta), (path, ours.kind, ours.meta, want.meta)
        _assert_same(ours.arrays, want.arrays, path)
    elif want is None:
        assert ours is None, path
    else:
        assert ours.dtype == want.dtype and ours.shape == want.shape, (path, ours.dtype, want.dtype)
        assert ours.device.type == "cpu" and ours.is_contiguous(), path
        same = ours.view(torch.uint8) if ours.dtype.is_floating_point else ours
        assert torch.equal(same, want.view(torch.uint8) if want.dtype.is_floating_point else want), path


def _jax_to_port(tree) -> dict:
    """The JAX converter's params carried across (a missing stack stays None)."""
    numpy_tree = jax.tree.map(np.asarray, {k: v for k, v in tree.items() if v is not None})
    out = llama.tree_from_jax(numpy_tree, device="cpu")
    return {**{k: None for k, v in tree.items() if v is None}, **out}


def _convert_both(kind, dtype, quant_mode, state, q_lora=None):
    jax_cfg, cfg = _configs(kind, dtype, q_lora)
    jax_fn, port_fn = CONVERTERS[kind]
    if kind == "deepseek":
        return jax_fn(state, jax_cfg), port_fn(state, cfg, device="cpu")
    return (jax_fn(state, jax_cfg, quant_mode=quant_mode, group_size=64),
            port_fn(state, cfg, quant_mode=quant_mode, group_size=64, device="cpu"))


CASES = [(k, d, m) for k in ("llama", "qwen2", "mixtral", "gemma", "phi3") for d in JAX_DTYPES
         for m in ("bf16", "int4", *(("int8",) if k == "llama" else ()))]


@pytest.mark.parametrize("kind,dtype,quant_mode", CASES)
def test_converter_matches_jax(kind, dtype, quant_mode):
    want, ours = _convert_both(kind, dtype, quant_mode, _state(kind))
    _assert_same(ours, _jax_to_port(want))


@pytest.mark.parametrize("dtype", list(JAX_DTYPES))
@pytest.mark.parametrize("q_lora", [None, 48])
def test_deepseek_converter_matches_jax(dtype, q_lora):
    want, ours = _convert_both("deepseek", dtype, "bf16", _state("deepseek", q_lora=q_lora), q_lora)
    assert ours["layers_moe"]["e_gate"].shape == (2, 4, H, 64)
    _assert_same(ours, _jax_to_port(want))


@pytest.mark.parametrize("kind", ["llama", "mixtral"])
def test_bf16_torch_state_stays_bit_for_bit(kind):
    """A bf16 checkpoint's tensors, taken as torch tensors, arrive bit for
    bit (the JAX converter goes through f32 numpy, which keeps bf16 too)."""
    state = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _state(kind, seed=1).items()}
    jax_cfg, cfg = _configs(kind, "bfloat16")
    jax_fn, port_fn = CONVERTERS[kind]
    ours = port_fn(state, cfg, device="cpu")
    assert torch.equal(ours["embedding"], state["model.embed_tokens.weight"])
    assert ours["embedding"].data_ptr() != state["model.embed_tokens.weight"].data_ptr()  # a copy
    assert torch.equal(ours["layers"]["wo"].arrays["w"][1], state["model.layers.1.self_attn.o_proj.weight"].t())
    _assert_same(ours, _jax_to_port(jax_fn(state, jax_cfg)))


def test_tied_head_falls_back_to_the_embedding():
    state = {k: v for k, v in _state("llama", seed=2).items() if k != "lm_head.weight"}
    _, cfg = _configs("llama", "float32")
    params = hf.llama_params_from_hf(state, cfg, device="cpu")
    want = torch.from_numpy(state["model.embed_tokens.weight"]).t().to(torch.bfloat16)
    assert torch.equal(params["lm_head"].arrays["w"], want)


def test_converters_refuse_mismatched_configs():
    _, cfg = _configs("llama", "float32")
    with pytest.raises(ValueError, match="attention_bias"):
        hf.llama_params_from_hf(_state("qwen2"), cfg, device="cpu")
    _, gcfg = _configs("gemma", "float32")
    with pytest.raises(ValueError, match="gemma2"):
        hf.gemma_params_from_hf(_state("gemma"), dataclasses.replace(gcfg, gemma2=False), device="cpu")


def test_safetensors_round_trip(tmp_path):
    pytest.importorskip("safetensors")
    from safetensors.torch import save_file

    state = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _state("mixtral", seed=3).items()}
    keys = sorted(state)
    save_file({k: state[k] for k in keys[::2]}, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file({k: state[k] for k in keys[1::2]}, str(tmp_path / "model-00002-of-00002.safetensors"))
    loaded = hf.load_safetensors_dir(tmp_path)
    assert sorted(loaded) == keys
    assert all(loaded[k].dtype == torch.bfloat16 and torch.equal(loaded[k], state[k]) for k in keys)
    _, cfg = _configs("mixtral", "bfloat16")
    _assert_same(hf.mixtral_params_from_hf(loaded, cfg, device="cpu"), hf.mixtral_params_from_hf(state, cfg, device="cpu"))
    with pytest.raises(FileNotFoundError):
        hf.load_safetensors_dir(tmp_path / "empty")


def _prefix_logits(prefill, params, cfg, kv_caches, tokens: list[int], lengths: list[int]) -> np.ndarray:
    """The port's last-token logits after each prefix in ``lengths``, one
    prefill a prefix (identity block table, page 16)."""
    out = []
    for n in lengths:
        kc, vc = kv_caches()
        positions = torch.arange(n, dtype=torch.int32)
        logits, _, _ = prefill(
            params, cfg, torch.tensor(tokens[:n], dtype=torch.int32), positions, torch.tensor([0, n], dtype=torch.int32),
            n, torch.tensor([n], dtype=torch.int32), torch.arange(4, dtype=torch.int32)[None, :], positions, kc, vc,
        )
        out.append(logits[0].numpy())
    return np.stack(out)


def _same_direction(ours: np.ndarray, theirs: np.ndarray) -> None:
    a = ours - ours.mean(-1, keepdims=True)
    b = theirs - theirs.mean(-1, keepdims=True)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.min() > 0.999, cos
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


TOKENS = [3, 17, 60, 4, 4, 33, 56, 23, 8, 1]
LENGTHS = [1, 4, 7, 10]


def test_llama_conversion_matches_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, max_position_embeddings=64, rope_theta=10000.0, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        theirs = model(torch.tensor([TOKENS])).logits[0].float().numpy()
    cfg = llama.LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
                            num_kv_heads=2, head_dim=16, max_position=64, rope_theta=10000.0, dtype=torch.float32)
    params = hf.llama_params_from_hf(model.state_dict(), cfg, device="cpu")
    ours = _prefix_logits(llama.llama_prefill, params, cfg,
                          lambda: llama.init_kv_caches(cfg, 4, 16, device="cpu"), TOKENS, LENGTHS)
    _same_direction(ours, theirs[[n - 1 for n in LENGTHS]])


def test_mixtral_conversion_matches_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.MixtralConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=64, num_local_experts=4, num_experts_per_tok=2,
        rope_theta=10000.0,
    )
    torch.manual_seed(2)
    model = transformers.MixtralForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        theirs = model(torch.tensor([TOKENS])).logits[0].float().numpy()
    # Capacity factor 4: no selection drops (HF's Mixtral has no capacity).
    cfg = moe.MoEConfig(
        llama=llama.LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
                                num_kv_heads=2, head_dim=16, max_position=64, rope_theta=10000.0, dtype=torch.float32),
        num_experts=4, top_k=2, capacity_factor=4.0,
    )
    params = hf.mixtral_params_from_hf(model.state_dict(), cfg, device="cpu")
    assert params["layers"]["w_gate"].shape == (2, 4, 64, 128) and params["layers"]["router"].shape == (2, 64, 4)
    ours = _prefix_logits(moe.mixtral_prefill, params, cfg,
                          lambda: moe.init_moe_kv_caches(cfg, 4, 16, device="cpu"), TOKENS, LENGTHS)
    _same_direction(ours, theirs[[n - 1 for n in LENGTHS]])
