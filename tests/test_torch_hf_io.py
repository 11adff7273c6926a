"""Weight files and HF converters in the port (``models/io.py``) against the
JAX package's and the ``safetensors`` / ``transformers`` libraries, on the
CPU.

- The port's own safetensors writer and reader against ``safetensors``:
  files written here load there and the other way round (``BF16`` reads
  as f32), every value equal.
- ``save_params`` / ``load_params`` interchange with the reference's;
  ``stack_scanned_layers`` is the reference's.
- Llama: the reference's ``export_llama_hf`` -> the port's
  ``convert_llama_hf`` gives the reference's logits; the port's export is
  the reference's; an HF ``LlamaForCausalLM`` loaded through
  ``load_pretrained`` gives HF's logits.
- GPT-2: an HF tensor dict built in numpy converts as the reference
  converts it and gives the reference's logits; an HF ``GPT2LMHeadModel``
  loaded through ``load_pretrained`` gives HF's logits.
- ``load_pretrained`` reads the framework's own files (bare or under
  ``params/``) and rejects a mismatch.

Tolerances: converted weights are compared exactly; logits in f32 against
the JAX package at atol 2e-5 / rtol 1e-4 (summation order), and against
``transformers`` at atol 2e-4, the reference's own bound for that
comparison (``tests/test_io.py``: HF's attention and RoPE compute in
another order and through ``sdpa``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import numpy as stnp
from safetensors import torch as sttorch

from distributeddataparallel_tpu.models import io as jio
from distributeddataparallel_tpu.models import transformer as jtfm
from distributeddataparallel_tpu_torch.models import io as tio
from distributeddataparallel_tpu_torch.models import transformer as ttfm
from distributeddataparallel_tpu_torch.models.resnet import ResNet18

TOL = dict(atol=2e-5, rtol=1e-4)
LLAMA = dict(vocab_size=128, max_seq_len=32, d_model=64, num_layers=2, num_heads=4, num_kv_heads=2,
             d_ff=128, rope_theta=10000.0)
GPT2 = dict(vocab_size=128, max_seq_len=32, d_model=64, num_layers=2, num_heads=4, d_ff=256)


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f64": rng.standard_normal(4),
        "f16": rng.standard_normal((2, 2)).astype(np.float16),
        "i64": rng.integers(-9, 9, size=(7,)),
        "i32/nested": rng.integers(0, 2**31 - 1, size=(2, 3)).astype(np.int32),
        "u16": rng.integers(0, 2**16, size=(5,)).astype(np.uint16),
        "u8": rng.integers(0, 256, size=(1, 3, 2)).astype(np.uint8),
        "bool": rng.random(6) < 0.5,
        "scalar": np.array(2.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }


def test_safetensors_written_here_load_in_the_library(tmp_path):
    arrays = _arrays()
    tio.save_safetensors(arrays, str(tmp_path / "a.safetensors"))
    back = stnp.load_file(str(tmp_path / "a.safetensors"))
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)


def test_safetensors_from_the_library_load_here(tmp_path):
    arrays = _arrays()
    stnp.save_file(arrays, str(tmp_path / "n.safetensors"))
    back = tio.load_safetensors(str(tmp_path / "n.safetensors"))
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)
    bf = torch.randn(4, 6).to(torch.bfloat16)
    sttorch.save_file({"w": bf, "x": torch.arange(3)}, str(tmp_path / "t.safetensors"))
    back = tio.load_safetensors(str(tmp_path / "t.safetensors"))
    assert back["w"].dtype == np.float32
    np.testing.assert_array_equal(back["w"], bf.float().numpy())
    np.testing.assert_array_equal(back["x"], np.arange(3))


def _jax_params(cfg_fn, **kw):
    model = jtfm.TransformerLM(cfg_fn(**kw))
    toks = np.random.default_rng(1).integers(0, kw["vocab_size"], size=(2, 12)).astype(np.int32)
    return model, model.init(jax.random.PRNGKey(2), jnp.asarray(toks))["params"], toks


def test_params_files_interchange_with_the_references(tmp_path):
    _, params, _ = _jax_params(jtfm.llama3_8b, **LLAMA, dtype=jnp.float32)  # stacked layout
    like = jax.tree.map(np.asarray, dict(params))
    tio.save_params(like, str(tmp_path / "ours.safetensors"))
    jio.save_params(params, str(tmp_path / "ref.safetensors"))
    from_ours = jio.load_params(str(tmp_path / "ours.safetensors"), like=params)
    from_ref = tio.load_params(str(tmp_path / "ref.safetensors"), like=like)
    for a, b, c in zip(jax.tree.leaves(like), jax.tree.leaves(from_ours), jax.tree.leaves(from_ref)):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)
    assert set(tio.flatten_tree(like)) == set(jio.flatten_tree(params))
    flat = tio.load_params(str(tmp_path / "ref.safetensors"))
    with pytest.raises(ValueError, match="unconsumed"):
        tio.unflatten_into(like, {**flat, "extra": np.zeros(1)})
    with pytest.raises(KeyError, match="missing"):
        tio.unflatten_into(like, {k: v for k, v in flat.items() if "lm_head" not in k})


def test_stack_scanned_layers_is_the_references():
    _, params, _ = _jax_params(jtfm.tiny_lm, num_layers=3, vocab_size=64)
    tree = jax.tree.map(np.asarray, dict(params))
    ours, ref = tio.stack_scanned_layers(tree, 3), jio.stack_scanned_layers(params, 3)
    assert tio.flatten_tree(ours).keys() == jio.flatten_tree(ref).keys()
    for k, v in tio.flatten_tree(ours).items():
        np.testing.assert_array_equal(v, jio.flatten_tree(ref)[k])
    back = tio.unstack_scanned_layers(ours, 3)
    for k, v in tio.flatten_tree(tree).items():
        np.testing.assert_array_equal(tio.flatten_tree(back)[k], v)


def test_llama_hf_export_converts_to_the_references_logits():
    jmodel, params, toks = _jax_params(jtfm.llama3_8b, **LLAMA, dtype=jnp.float32, attn_impl="xla",
                                       scan_layers=False)  # the reference exports this layout
    cfg = ttfm.llama3_8b(**LLAMA, dtype=torch.float32)
    hf = jio.export_llama_hf(params, cfg)
    tree = jax.tree.map(np.asarray, dict(params))
    for layout in (tree, tio.stack_scanned_layers(tree, 2)):
        ours_export = tio.export_llama_hf(layout, cfg)
        assert ours_export.keys() == hf.keys()
        for k in hf:
            np.testing.assert_array_equal(ours_export[k], hf[k])
    model = ttfm.TransformerLM(cfg)
    model.load_state_dict(tio.from_jax_params(tio.convert_llama_hf(hf, cfg), cfg))
    with torch.no_grad():
        ours = model(torch.from_numpy(toks).long())
    ref = jmodel.apply({"params": params}, jnp.asarray(toks))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_llama_from_transformers_gives_its_logits(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32, rope_theta=10000.0,
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False, rms_norm_eps=1e-5)).eval()
    path = str(tmp_path / "llama.safetensors")
    sttorch.save_file({k: v.contiguous() for k, v in hf.state_dict().items()}, path)
    model = ttfm.TransformerLM(ttfm.llama3_8b(**LLAMA, dtype=torch.float32))  # stacked layout
    model.load_state_dict(tio.load_pretrained(path, model))
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 128, size=(2, 16)))
    with torch.no_grad():
        np.testing.assert_allclose(model(toks).numpy(), hf(toks).logits.numpy(), atol=2e-4)


def _gpt2_hf_dict(rng, cfg):
    d, L, V, P = cfg["d_model"], cfg["num_layers"], cfg["vocab_size"], cfg["max_seq_len"]
    w = lambda *s: (0.05 * rng.standard_normal(s)).astype(np.float32)
    sd = {"transformer.wte.weight": w(V, d), "transformer.wpe.weight": w(P + 8, d),
          "transformer.ln_f.weight": 1 + w(d), "transformer.ln_f.bias": w(d)}
    for i in range(L):
        p = f"transformer.h.{i}."
        sd.update({
            p + "ln_1.weight": 1 + w(d), p + "ln_1.bias": w(d), p + "ln_2.weight": 1 + w(d),
            p + "ln_2.bias": w(d), p + "attn.c_attn.weight": w(d, 3 * d), p + "attn.c_attn.bias": w(3 * d),
            p + "attn.c_proj.weight": w(d, d), p + "attn.c_proj.bias": w(d),
            p + "mlp.c_fc.weight": w(d, 4 * d), p + "mlp.c_fc.bias": w(4 * d),
            p + "mlp.c_proj.weight": w(4 * d, d), p + "mlp.c_proj.bias": w(d),
        })
    return sd


def test_gpt2_hf_dict_converts_as_the_reference_does(tmp_path):
    """An HF GPT-2 tensor dict built in numpy (``transformer.``-prefixed,
    ``wpe`` longer than the config's positions), saved as a torch ``.pth``:
    the port's conversion is the reference's, and ``load_pretrained`` gives
    the reference's logits."""
    sd = _gpt2_hf_dict(np.random.default_rng(4), GPT2)
    jcfg, tcfg = jtfm.gpt2_124m(**GPT2, attn_impl="xla"), ttfm.gpt2_124m(**GPT2)
    ours, ref = tio.convert_gpt2_hf(sd, tcfg), jio.convert_gpt2_hf(sd, jcfg)
    assert tio.flatten_tree(ours).keys() == jio.flatten_tree(ref).keys()
    for k, v in tio.flatten_tree(ours).items():
        np.testing.assert_array_equal(v, jio.flatten_tree(ref)[k])
    path = str(tmp_path / "gpt2.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    model = ttfm.TransformerLM(tcfg)
    model.load_state_dict(tio.load_pretrained(path, model))
    toks = np.random.default_rng(5).integers(0, 128, size=(2, 16)).astype(np.int32)
    with torch.no_grad():
        logits = model(torch.from_numpy(toks).long())
    want = jtfm.TransformerLM(jcfg).apply({"params": ref}, jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


def test_gpt2_from_transformers_gives_its_logits(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=128, n_positions=32, n_embd=64, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)).eval()
    path = str(tmp_path / "gpt2.safetensors")
    sd = {k: v.contiguous() for k, v in hf.state_dict().items() if k != "lm_head.weight"}  # tied
    sttorch.save_file(sd, path)
    model = ttfm.TransformerLM(ttfm.gpt2_124m(**GPT2, scan_layers=True))
    model.load_state_dict(tio.load_pretrained(path, model))
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 128, size=(2, 16)))
    with torch.no_grad():
        np.testing.assert_allclose(model(toks).numpy(), hf(toks).logits.numpy(), atol=2e-4)


@pytest.mark.parametrize("prefix", ["", "params/"])
def test_load_pretrained_reads_the_frameworks_files(tmp_path, prefix):
    jmodel, params, toks = _jax_params(jtfm.llama3_8b, **LLAMA, dtype=jnp.float32, attn_impl="xla")
    flat = {prefix + k: v for k, v in jio.flatten_tree(params).items()}
    path = str(tmp_path / "p.safetensors")
    stnp.save_file(flat, path)
    model = ttfm.TransformerLM(ttfm.llama3_8b(**LLAMA, dtype=torch.float32))
    model.load_state_dict(tio.load_pretrained(path, model))
    with torch.no_grad():
        ours = model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(ours.numpy(), np.asarray(jmodel.apply({"params": params}, jnp.asarray(toks))),
                               **TOL)


def test_load_pretrained_rejects_a_mismatch(tmp_path):
    _, params, _ = _jax_params(jtfm.llama3_8b, **LLAMA, dtype=jnp.float32)
    path = str(tmp_path / "p.safetensors")
    jio.save_params(params, path)
    wider = ttfm.TransformerLM(ttfm.llama3_8b(**{**LLAMA, "d_model": 128}, dtype=torch.float32))
    with pytest.raises(ValueError, match="shape"):
        tio.load_pretrained(path, wider)
    unstacked = ttfm.llama3_8b(**LLAMA, dtype=torch.float32, scan_layers=False)
    with pytest.raises(KeyError, match="missing"):
        tio.load_pretrained(path, ttfm.TransformerLM(unstacked))
    with pytest.raises(KeyError, match="missing"):  # an LM's tree on a ResNet, as the reference
        tio.load_pretrained(path, ResNet18(num_classes=10))
