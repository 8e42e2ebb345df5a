"""Port models against the JAX package, on the CPU, float32.

The geometry engages the JAX package's Pallas kernels (interpret mode):
hidden 128 (the fused LN needs hidden % 128 == 0) with 2 heads of 64 or 4
heads of 32, and encoder length 128 (the fused attention needs L % 128 ==
0). Flax params go through models/convert.py into the port.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textreact_tpu.models import EncoderDecoder as JaxEncoderDecoder
from textreact_tpu.models import TransformerConfig as JaxConfig
from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.models import (DecoderStep, EncoderDecoder,
                                        TransformerConfig, build_model,
                                        from_flax)

# f32 on both sides through 2 encoder and 2 decoder layers; the two differ
# in summation order only (einsum vs interpret-mode dot, reduction order
# in softmax and LN), a few f32 ulps compounded over the layers
ATOL = RTOL = 1e-4

B, L, LD, PREFIX = 3, 128, 8, 16


def jax_configs(heads):
    enc = JaxConfig(vocab_size=64, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=heads, intermediate_size=256,
                    max_position_embeddings=128, type_vocab_size=2,
                    attention_impl="flash", layernorm_impl="fused")
    dec = enc.replace(vocab_size=40, max_position_embeddings=32,
                      type_vocab_size=1, is_decoder=True,
                      add_cross_attention=True, bos_token_id=1,
                      eos_token_id=2, pad_token_id=0)
    return enc, dec


def port_config(cfg):
    return TransformerConfig(**dataclasses.asdict(cfg))


def make_batch(seed=0):
    """Ragged encoder mask with a dummy last row (every key masked)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, L), np.int32)
    mask[0, :] = 1
    mask[1, :77] = 1
    dec_mask = np.ones((B, LD), np.int32)
    dec_mask[1, 6:] = 0
    return dict(
        input_ids=rng.integers(1, 64, (B, L)).astype(np.int32),
        attention_mask=mask,
        decoder_input_ids=rng.integers(3, 40, (B, LD)).astype(np.int32),
        decoder_attention_mask=dec_mask,
    )


def random_params(module, batch, seed=0):
    """Flax params drawn with numpy (LN scales near 1), shaped by tracing
    init: no forward pass runs."""
    shapes = jax.eval_shape(
        lambda b: module.init(jax.random.PRNGKey(0), **b,
                              mlm_prefix_len=PREFIX), batch)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return jnp.asarray(1.0 + 0.1 * noise if name == "scale"
                           else 0.05 * noise)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def build_pair(heads, mlm_layer):
    """(JAX module, its params, JAX outputs on make_batch(), port module)."""
    enc, dec = jax_configs(heads)
    jmodel = JaxEncoderDecoder(encoder_config=enc, decoder_config=dec,
                               dtype=jnp.float32, mlm_layer=mlm_layer)
    batch = {k: jnp.asarray(v) for k, v in make_batch().items()}
    params = random_params(jmodel, batch)
    jout = jax.jit(lambda p, b: jmodel.apply(p, **b, mlm_prefix_len=PREFIX))(
        params, batch)
    tmodel = EncoderDecoder(port_config(enc), port_config(dec),
                            dtype=torch.float32, mlm_layer=mlm_layer)
    tmodel.load_state_dict(from_flax(jax.device_get(params)))
    return params, jax.device_get(jout), tmodel.eval()


# the two geometries also cover both MLM head variants
@pytest.fixture(scope="module", params=[(2, "mlp"), (4, "linear")],
                ids=["h2d64-mlp", "h4d32-linear"])
def pair(request):
    return build_pair(*request.param)


@pytest.fixture(scope="module")
def outputs(pair):
    _, jout, tmodel = pair
    with torch.no_grad():
        tout = tmodel(**{k: torch.as_tensor(v)
                         for k, v in make_batch().items()},
                      mlm_prefix_len=PREFIX)
    return jout, tout


@pytest.mark.parametrize("key", ["encoder_last_hidden_state", "logits",
                                 "mlm_logits"])
def test_forward_matches_jax(outputs, key):
    jout, tout = outputs
    np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                               rtol=RTOL, atol=ATOL)


def test_dummy_row_stays_finite(outputs):
    _, tout = outputs
    for key in ("encoder_last_hidden_state", "logits"):
        assert torch.isfinite(tout[key][B - 1]).all()


def test_converted_state_is_complete_and_tied(pair):
    params, _, tmodel = pair
    state = from_flax(jax.device_get(params))
    assert set(state) == set(tmodel.state_dict())
    dec = tmodel.decoder
    # one table serves the embedding lookup and the LM head
    assert not hasattr(dec.embeddings, "word_embeddings")
    np.testing.assert_array_equal(
        dec.word_embedding.detach().numpy(),
        np.asarray(params["params"]["decoder"]["word_embedding"]))
    kernel = np.asarray(params["params"]["encoder"]["layer_1"]["attention"]
                        ["query"]["kernel"])
    np.testing.assert_array_equal(
        tmodel.encoder.layers[1].attention.query.weight.detach().numpy(),
        kernel.T)


@pytest.mark.parametrize("num_beams", [1, 2])
def test_decoder_step_matches_full_decoder(pair, outputs, num_beams):
    """Token-by-token decoding through the cache reproduces the
    teacher-forced logits of the port and of the JAX package; with beams,
    every beam row of an example sees the same unreplicated cross K/V."""
    _, tmodel = pair[0], pair[2]
    jlogits = np.asarray(outputs[0]["logits"])
    batch = make_batch()
    ids = torch.as_tensor(batch["decoder_input_ids"], dtype=torch.long)
    dec_mask = batch["decoder_attention_mask"]
    mask = torch.as_tensor(batch["attention_mask"])
    step = DecoderStep(tmodel.decoder)
    with torch.no_grad():
        enc = tmodel.encode(torch.as_tensor(batch["input_ids"]), mask)
        full = tmodel.decode_logits(ids, enc, encoder_attention_mask=mask)
        cache = step.init_cache(enc, mask, num_beams, LD)
        rows = ids.repeat_interleave(num_beams, dim=0)
        for t in range(LD):
            logits = step(rows[:, t:t + 1], cache, t)[:, 0]
            logits = logits.view(B, num_beams, -1).numpy()
            # the JAX logits were taken with the decoder padding mask: hold
            # the rows whose prefix up to t is unpadded
            valid = dec_mask[:, :t + 1].all(axis=1)
            for g in range(num_beams):
                np.testing.assert_allclose(logits[:, g], full[:, t].numpy(),
                                           rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(logits[valid, g],
                                           jlogits[valid, t],
                                           rtol=RTOL, atol=ATOL)


def test_decode_cache_reorder_moves_rows(pair):
    """The row move that the grouped cache stands for: after one step, a
    per-row cache whose rows are moved to the beams' parents, and the
    row-stable grouped cache under the ancestor bias of the gathered
    table, give the same logits at the next step; the grouped cache's
    first position is not moved by it."""
    from textreact_tpu_torch.inference.beam import ancestor_bias
    tmodel = pair[2]
    batch = make_batch()
    mask = torch.as_tensor(batch["attention_mask"])
    K = 2
    per_row = DecoderStep(tmodel.decoder)
    grouped = DecoderStep(tmodel.decoder, beam_groups=K)
    rows = torch.tensor([1, 1, 2, 3, 5, 4])
    parents = (rows - torch.arange(B).repeat_interleave(K) * K).view(B, K)
    src = torch.zeros(B, K, LD, dtype=torch.long)
    with torch.no_grad():
        enc = tmodel.encode(torch.as_tensor(batch["input_ids"]), mask)
        cache = per_row.init_cache(enc, mask, K, LD)
        gcache = grouped.init_cache(enc, mask, K, LD)
        first = torch.arange(3, 3 + K * B)[:, None]
        per_row(first, cache, 0)
        src[:, :, 0] = torch.arange(K)
        grouped(first, gcache, 0, ancestor_bias(src, 1, B, K, LD))
        before = gcache.self_k[0].clone()
        cache.self_k = [c[rows] for c in cache.self_k]
        cache.self_v = [c[rows] for c in cache.self_v]
        src = torch.gather(src, 1, parents[:, :, None].expand(-1, -1, LD))
        src[:, :, 1] = torch.arange(K)
        second = torch.arange(10, 10 + K * B)[:, None]
        want = per_row(second, cache, 1)
        got = grouped(second, gcache, 1, ancestor_bias(src, 2, B, K, LD))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(gcache.self_k[0][..., :K], before[..., :K],
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["bond_mask_2d", "length_96"])
def test_plain_attention_paths_match_jax(case):
    """Where the fused kernel's gate declines (a 2-D bond mask, a length
    that is not a multiple of 128), both packages take the additive-bias
    attention; the decoder's cross mask keeps any valid bond-mask row."""
    enc, dec = jax_configs(2)
    jmodel = JaxEncoderDecoder(encoder_config=enc, decoder_config=dec,
                               dtype=jnp.float32)
    batch = make_batch(seed=4)
    if case == "bond_mask_2d":
        rng = np.random.default_rng(4)
        bonds = rng.integers(0, 2, (B, L, L)).astype(np.int32)
        batch["attention_mask"] = bonds * batch["attention_mask"][:, None, :]
    else:
        batch["input_ids"] = batch["input_ids"][:, :96]
        batch["attention_mask"] = batch["attention_mask"][:, :96]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = random_params(jmodel, jbatch, seed=2)
    jout = jax.jit(lambda p, b: jmodel.apply(p, **b))(params, jbatch)
    tmodel = EncoderDecoder(port_config(enc), port_config(dec),
                            dtype=torch.float32)
    tmodel.load_state_dict(from_flax(jax.device_get(params)))
    with torch.no_grad():
        tout = tmodel.eval()(**{k: torch.as_tensor(v)
                                for k, v in batch.items()})
    for key in ("encoder_last_hidden_state", "logits"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   rtol=RTOL, atol=ATOL)


def _geometry_configs(hidden, heads):
    enc, dec = jax_configs(heads)
    enc = enc.replace(hidden_size=hidden, intermediate_size=2 * hidden)
    dec = dec.replace(hidden_size=hidden, intermediate_size=2 * hidden)
    return enc, dec


@pytest.mark.parametrize("hidden,heads", [(256, 2), (640, 10)],
                         ids=["h2d128", "hidden640"])
def test_wide_heads_and_hidden_sizes_match_jax(hidden, heads, monkeypatch):
    """Heads of 128 and a hidden size of 640, shapes the JAX package runs
    in its Pallas kernels: the port's model sends both ops through their
    wrappers (the kernels on the card, the plain versions here) and equals
    the JAX twin with converted weights."""
    from textreact_tpu_torch.models import layers
    enc, dec = _geometry_configs(hidden, heads)
    jmodel = JaxEncoderDecoder(encoder_config=enc, decoder_config=dec,
                               dtype=jnp.float32)
    batch = make_batch(seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = random_params(jmodel, jbatch, seed=3)
    jout = jax.jit(lambda p, b: jmodel.apply(p, **b))(params, jbatch)
    tmodel = EncoderDecoder(port_config(enc), port_config(dec),
                            dtype=torch.float32)
    tmodel.load_state_dict(from_flax(jax.device_get(params)))
    calls = {"attention": 0, "layernorm": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(layers, "fused_dropout_attention",
                        counted("attention", layers.fused_dropout_attention))
    monkeypatch.setattr(layers, "fused_residual_layernorm",
                        counted("layernorm", layers.fused_residual_layernorm))
    with torch.no_grad():
        tout = tmodel.eval()(**{k: torch.as_tensor(v)
                                for k, v in batch.items()})
    for key in ("encoder_last_hidden_state", "logits"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   rtol=RTOL, atol=ATOL)
    assert calls["attention"] > 0 and calls["layernorm"] > 0, calls


@pytest.mark.parametrize("hidden,heads,attention,layernorm,refused", [
    (256, 2, "flash", "fused", False), (640, 10, "flash", "fused", False),
    (384, 4, "flash", "xla", False), (384, 4, "xla", "fused", False),
    (1536, 12, "xla", "fused", False), (1536, 12, "flash", "xla", False),
    (1000, 8, "xla", "fused", False), (400, 4, "flash", "xla", True),
    (1088, 8, "flash", "xla", True), (8320, 65, "xla", "fused", True),
    (8192, 64, "flash", "fused", False)],
    ids=["d128", "hidden640", "d96", "d96-plain", "hidden1536",
         "hidden1536-plain", "hidden1000-unaligned", "d100", "d136",
         "hidden8320", "hidden8192"])
def test_kernel_shape_rule_refuses_before_any_batch(hidden, heads, attention,
                                                    layernorm, refused):
    """On the card `build_model` refuses a model that would reach a kernel
    with a shape the port's kernels do not take (a head dim that is no
    multiple of 8 or past 128; an aligned hidden size past 8192) rather than
    run a plain version in its place; heads of 96 and hidden sizes past 1024
    have kernels. The plain functions, the reference's own rule for
    unaligned hidden sizes, and attention that never reaches the kernels
    (the decoder's) pass."""
    from textreact_tpu_torch.models.factory import check_kernel_shapes
    cfg = TransformerConfig(hidden_size=hidden, num_attention_heads=heads,
                            attention_impl=attention,
                            layernorm_impl=layernorm)
    if refused:
        with pytest.raises(ValueError, match="take"):
            check_kernel_shapes(cfg)
    else:
        check_kernel_shapes(cfg)
    if attention == "flash":
        check_kernel_shapes(cfg.replace(layernorm_impl="xla"),
                            attention=False)


class _Tok:
    pad_token_id, bos_token_id, eos_token_id = 0, 12, 13

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def test_build_model_rcr_geometry_and_seeded_init(tmp_path):
    """The RCR recipe's geometry from the experiment config, and weights
    that depend only on the generator's seed (not on the dtype). Parameters
    are float32 unless cfg.param_dtype asks for pre-cast serving weights;
    the module comes back in eval mode on the device asked for, and with no
    device named and no card the factory raises."""
    import json
    enc_json = tmp_path / "enc.json"
    enc_json.write_text(json.dumps(dict(
        vocab_size=50, hidden_size=128, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=256,
        max_position_embeddings=64, type_vocab_size=2)))
    dec_json = tmp_path / "dec.json"
    dec_json.write_text(json.dumps(dict(
        vocab_size=20, hidden_size=128, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=256,
        max_position_embeddings=16)))
    cfg = ExperimentConfig(encoder=str(enc_json), decoder=str(dec_json),
                           max_length=128, max_dec_length=24, mlm=True,
                           mlm_layer="mlp", compute_dtype="float32")
    m32, enc_cfg, dec_cfg = build_model(cfg, _Tok(70), _Tok(30),
                                        torch.Generator().manual_seed(0),
                                        device="cpu")
    assert not m32.training
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg, _Tok(70), _Tok(30))
    assert enc_cfg.max_position_embeddings == 128
    assert enc_cfg.vocab_size == 70 and dec_cfg.vocab_size == 30
    assert dec_cfg.max_position_embeddings == 24
    assert (dec_cfg.bos_token_id, dec_cfg.eos_token_id) == (12, 13)
    assert enc_cfg.attention_impl == "flash"
    assert enc_cfg.layernorm_impl == "fused"
    assert hasattr(m32, "mlm_head") and m32.mlm_head.mlp
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    train16, _, _ = build_model(cfg16, _Tok(70), _Tok(30),
                                torch.Generator().manual_seed(0),
                                device="cpu")
    w32 = m32.encoder.layers[0].ffn.intermediate.weight
    # bf16 compute keeps float32 parameters (what the optimizer updates)
    assert train16.encoder.layers[0].ffn.intermediate.weight.dtype \
        == torch.float32
    torch.testing.assert_close(
        train16.encoder.layers[0].ffn.intermediate.weight, w32)
    m16, _, _ = build_model(
        dataclasses.replace(cfg16, param_dtype="bfloat16"), _Tok(70),
        _Tok(30), torch.Generator().manual_seed(0), device="cpu")
    w16 = m16.encoder.layers[0].ffn.intermediate.weight
    assert w16.dtype == torch.bfloat16
    torch.testing.assert_close(w16.float(), w32.bfloat16().float())
    assert m16.encoder.layers[0].attention_norm.weight.dtype == torch.float32
    std = float(w32.detach().std())
    assert 0.015 < std < 0.025
    # the template branch: the encoder and three f32 heads sized from the
    # tables, drawn normal(0, initializer_range) with zero biases, and no
    # decoder
    from textreact_tpu_torch.data import TemplateTables
    from textreact_tpu_torch.models import TemplateBasedModel
    tables = TemplateTables(["a"] * 300, ["b"] * 40)
    tcfg = dataclasses.replace(cfg, template_based=True, template_path="x",
                               mlm=False, compute_dtype="bfloat16")
    tm, t_enc, t_dec = build_model(tcfg, _Tok(70), tables,
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
    assert isinstance(tm, TemplateBasedModel) and t_dec is None
    assert not tm.training and not hasattr(tm, "mlm_head")
    assert t_enc.max_position_embeddings == 128 and t_enc.vocab_size == 70
    head = tm.head
    assert head.atom_head.weight.shape == (301, 128)
    assert head.bond_head_left.weight.shape == (41, 128)
    assert head.bond_head_right.bias is None
    assert head.atom_head.weight.dtype == torch.float32
    for w in (head.atom_head.weight, head.bond_head_left.weight,
              head.bond_head_right.weight):
        assert 0.015 < float(w.detach().std()) < 0.025
    assert not head.atom_head.bias.any() and not head.bond_head_left.bias.any()
    # the encoder draws what the seq2seq model's encoder draws from the seed
    torch.testing.assert_close(tm.encoder.layers[0].ffn.intermediate.weight,
                               w32)


def test_port_imports_no_jax_or_pandas():
    """The port's modules (the curation's and the measurement tools' too),
    chip_smoke, chip_profile,
    the multi-process tests' rank bodies (tests/_torch_parallel_worker.py,
    tests/_torch_decode_worker.py)
    and the port's parity_run.py and check_artifacts.py (scripts/torch_port/)
    load where JAX, pandas, safetensors, transformers and the JAX package
    are absent: nothing of them is in sys.modules afterwards."""
    import pkgutil
    import subprocess
    import sys

    import textreact_tpu_torch
    names = sorted(m.name for m in pkgutil.walk_packages(
        textreact_tpu_torch.__path__, "textreact_tpu_torch."))
    assert "textreact_tpu_torch.train.step" in names
    assert "textreact_tpu_torch.tokenizers.text" in names
    for name in ("ops.topk", "retrieval.engine", "retrieval.cli",
                 "retrieval.debug_cli", "retrieval.fingerprints",
                 "retrieval.convert", "chem.mol", "chem.canon",
                 "chem.aromatic", "chem.rdkit_bridge", "chem.fingerprints",
                 "utils.logging", "utils.table", "utils.profiling",
                 "data.corpus", "data.neighbors", "data.datasets",
                 "data.loader", "evaluation.condition", "evaluation.retro",
                 "train.checkpoint", "train.trainer", "cli.main",
                 "chem.smarts", "chem.reaction", "data.templates",
                 "evaluation.edit_rank", "evaluation.template_decode",
                 "evaluation._own_template_apply", "__main__", "parallel",
                 "parallel.mesh", "parallel.multihost", "parallel.sharding",
                 "entry", "models.import_hf", "tokenizers.native",
                 "chem.native", "preprocess", "preprocess.aides",
                 "preprocess.augment", "preprocess.cli",
                 "preprocess.condition_extraction",
                 "preprocess.condition_splits", "preprocess.corpus_tools",
                 "preprocess.frequency_baseline", "preprocess.ionic",
                 "preprocess.retro_tools", "templates",
                 "templates.smarts_canon", "templates.labeling",
                 "templates.native_labeling", "templates.native_extractor",
                 "templates.extractor", "templates.processor", "bench",
                 "bench_train", "inference.beam", "inference.graphs",
                 "inference.predictor", "train.graphs", "ops.launches"):
        assert "textreact_tpu_torch." + name in names
    # the template decode and the template preprocessing have one engine,
    # the own one: no RDKit twin, and no RDKit half copied into a module
    assert "textreact_tpu_torch.evaluation._rdkit_template_apply" not in names
    import inspect
    from textreact_tpu_torch.preprocess import retro_tools
    from textreact_tpu_torch.templates import extractor, labeling, processor
    for module in (extractor, labeling, processor, retro_tools):
        source = inspect.getsource(module)
        assert not any(word in source for word in (
            "from rdkit", "import rdkit", "HAS_RDKIT", "Chem.")), module
    code = ("import sys, importlib, importlib.util\n"
            "sys.path.insert(0, 'tests')\n"
            f"for name in {names!r} + ['chip_smoke', 'chip_profile', "
            "'_torch_parallel_worker', '_torch_decode_worker']:\n"
            "    importlib.import_module(name)\n"
            "for path in ('scripts/torch_port/parity_run.py', "
            "'scripts/torch_port/check_artifacts.py'):\n"
            "    spec = importlib.util.spec_from_file_location('s', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            "bad = [m for m in sys.modules if m == 'textreact_tpu' "
            "or m.startswith('textreact_tpu.') "
            "or m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', "
            "'orbax', 'pandas', 'safetensors', 'transformers', "
            "'ml_dtypes')]\n"
            "assert not bad, bad\n")
    root = str(__import__("pathlib").Path(__file__).resolve().parent.parent)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)
