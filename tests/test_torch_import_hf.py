"""The port's HF checkpoint import (textreact_tpu_torch/models/import_hf.py)
against the JAX package's, on the CPU, from directories the tests write
(random weights in HF's names; nothing is downloaded):
(a) tests/test_import_hf.py's fake checkpoint, as `pytorch_model.bin` with
    the `bert.` prefix and as `model.safetensors` without it, imported into
    the encoder and the decoder: every parameter equal to the JAX import
    carried over with `from_flax`, to the bit;
(b) the port's safetensors reader against `safetensors.numpy.load_file`;
(c) the port's encoder from a `transformers` BertModel directory against
    HF's own forward: within 1e-5 under the tanh GELU, and the erf GELU
    that SciBERT's config names kept apart (a quirk of the reference,
    mirrored);
(d) the command line with both halves pretrained, and the trainer's first
    optimizer steps against the JAX trainer's from the same directories;
(e) the two refusals of --decoder_pretrained."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import textreact_tpu.config as jax_config
import textreact_tpu_torch.config as port_config
from chip_smoke import (SCIBERT_HF_CONFIG, before_fit,
                        check_pretrained_import, hf_bert_tensors,
                        hf_port_name, write_hf_checkpoint, write_safetensors)
from fixtures import make_condition_data
from test_import_hf import CFG as JAX_CFG
from test_import_hf import _fake_hf_checkpoint
from textreact_tpu.models import Decoder as JaxDecoder
from textreact_tpu.models import Encoder as JaxEncoder
from textreact_tpu.models.import_hf import (load_pretrained_decoder as
                                            jax_load_decoder)
from textreact_tpu.models.import_hf import (load_pretrained_encoder as
                                            jax_load_encoder)
from textreact_tpu.train.trainer import Trainer as JaxTrainer
from textreact_tpu_torch.cli.main import main as port_main
from textreact_tpu_torch.cli.main import parse_config
from textreact_tpu_torch.models import (Decoder, Encoder, TransformerConfig,
                                        build_model, from_flax)
from textreact_tpu_torch.models.config import resolve_config
from textreact_tpu_torch.models.import_hf import (load_pretrained_decoder,
                                                  load_pretrained_encoder,
                                                  read_safetensors,
                                                  read_state_dict)
from textreact_tpu_torch.train.trainer import Trainer

TOL = 1e-4   # f32 losses of the two trainers (test_torch_trainer_parity.py)
HF_TOL = 1e-5
PORT_CFG = TransformerConfig(**{k: getattr(JAX_CFG, k)
                                for k in TransformerConfig.__dataclass_fields__})
POOLER = {"bert.pooler.dense.weight": (16, 16), "bert.pooler.dense.bias": (16,)}


def _write_both_ways(root, with_mlm_head):
    """The fake checkpoint with a pooler: `bin/pytorch_model.bin` with the
    `bert.` prefix, `st/model.safetensors` without it. Returns the tensors
    under each file's names."""
    from safetensors.torch import save_file
    (root / "bin").mkdir()
    (root / "st").mkdir()
    sd = _fake_hf_checkpoint(str(root / "bin"), with_mlm_head=with_mlm_head)
    g = torch.Generator().manual_seed(1)
    sd.update({k: torch.randn(shape, generator=g)
               for k, shape in POOLER.items()})
    torch.save(sd, root / "bin" / "pytorch_model.bin")
    plain = {k.removeprefix("bert."): v for k, v in sd.items()}
    save_file(plain, str(root / "st" / "model.safetensors"),
              metadata={"format": "pt"})
    return {"bin": sd, "st": plain}


def _jax_and_port(part):
    """(JAX init tree of `part`, the port's module holding the same values)."""
    if part == "encoder":
        module = JaxEncoder(JAX_CFG, dtype=jnp.float32)
        init = module.init(jax.random.PRNGKey(0),
                           input_ids=jnp.zeros((1, 8), jnp.int32),
                           attention_mask=jnp.ones((1, 8), jnp.int32))
        port = Encoder(PORT_CFG, torch.float32)
    else:
        cfg = JAX_CFG.replace(is_decoder=True, add_cross_attention=True)
        module = JaxDecoder(cfg, dtype=jnp.float32)
        init = module.init(jax.random.PRNGKey(5), jnp.zeros((1, 6), jnp.int32),
                           jnp.zeros((1, 8, 16), jnp.float32))
        port = Decoder(PORT_CFG.replace(is_decoder=True,
                                        add_cross_attention=True),
                       torch.float32)
    result = port.load_state_dict(from_flax(init["params"]))
    assert not result.missing_keys and not result.unexpected_keys
    return init["params"], port


@pytest.mark.parametrize("fmt", ["bin", "st"])
@pytest.mark.parametrize("part,with_mlm_head", [
    ("encoder", False), ("decoder", True), ("decoder", False)])
def test_import_equals_the_jax_import(tmp_path, fmt, part, with_mlm_head):
    files = _write_both_ways(tmp_path, with_mlm_head)
    ckpt = str(tmp_path / fmt)
    init, port = _jax_and_port(part)
    jax_load = jax_load_encoder if part == "encoder" else jax_load_decoder
    want = from_flax(jax_load({"params": {part: init}}, ckpt,
                              JAX_CFG)["params"][part])
    seeded = {k: v.detach().clone() for k, v in port.named_parameters()}
    load = load_pretrained_encoder if part == "encoder" else \
        load_pretrained_decoder
    read = load(port, ckpt, PORT_CFG)
    got = dict(port.named_parameters())
    assert got.keys() == want.keys()
    for name, value in want.items():
        assert torch.equal(got[name].detach(), value), name
    # the same statement in the chip check's terms: the file's tensors to
    # the bit, the rest (cross-attention, the tables' tail rows) seeded
    prefix = {f"{part}.{k}": v.detach() for k, v in got.items()}
    imported, kept = check_pretrained_import(
        prefix, {f"{part}.{k}": v for k, v in seeded.items()},
        {part: files[fmt]}, {part: read})
    assert imported > 0 and kept > 0
    assert set(files[fmt]) - read == {k for k in files[fmt] if "pooler" in k}
    if with_mlm_head:
        assert "cls.predictions.bias" in read


def test_safetensors_reader_reads_what_the_library_reads(tmp_path):
    from safetensors.numpy import load_file, save_file
    rng = np.random.default_rng(0)
    tensors = {
        "f16": rng.standard_normal((3, 5)).astype(np.float16),
        "f32": rng.standard_normal((7,)).astype(np.float32),
        "f64": rng.standard_normal((2, 2, 3)),
        "i64": rng.integers(-9, 9, (4,)),
        "u8": rng.integers(0, 255, (5,)).astype(np.uint8),
        "flag": rng.integers(0, 2, (3,)).astype(bool),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.array(2.5, np.float32),
    }
    path = str(tmp_path / "model.safetensors")
    save_file(tensors, path, metadata={"format": "pt", "note": "x"})
    want, got = load_file(path), read_safetensors(path)
    assert got.keys() == want.keys() == tensors.keys()
    for name, value in want.items():
        assert got[name].numpy().dtype == value.dtype, name
        assert got[name].shape == value.shape, name
        np.testing.assert_array_equal(got[name].numpy(), value)
    # the chip check's writer gives files the library reads back
    torch_tensors = {"w": torch.randn(4, 3), "b": torch.arange(5),
                     "h": torch.randn(2).half()}
    write_safetensors(tmp_path / "own.safetensors", torch_tensors,
                      {"format": "pt"})
    back = load_file(str(tmp_path / "own.safetensors"))
    for name, value in torch_tensors.items():
        np.testing.assert_array_equal(back[name], value.numpy())


def test_bfloat16_is_read_where_the_jax_importer_reads_it(tmp_path):
    """With JAX imported, numpy knows bfloat16 (ml_dtypes), so the JAX
    importer reads a BF16 `model.safetensors` (safetensors.numpy) and
    refuses a BF16 `pytorch_model.bin` (torch's `.numpy()`); so does the
    port. Sharded checkpoints are refused by both."""
    from safetensors.torch import save_file
    init, port = _jax_and_port("encoder")
    files = _write_both_ways(tmp_path, with_mlm_head=False)
    half = {k: v.bfloat16() for k, v in files["st"].items()}
    save_file(half, str(tmp_path / "st" / "model.safetensors"))
    want = from_flax(jax_load_encoder({"params": {"encoder": init}},
                                      str(tmp_path / "st"),
                                      JAX_CFG)["params"]["encoder"])
    load_pretrained_encoder(port, str(tmp_path / "st"), PORT_CFG)
    for name, value in want.items():
        assert torch.equal(dict(port.named_parameters())[name].detach(),
                           value), name
    assert torch.equal(port.layers[0].ffn.output.weight.detach(),
                       half["encoder.layer.0.output.dense.weight"].float())
    torch.save({k: v.bfloat16() for k, v in files["bin"].items()},
               tmp_path / "bin" / "pytorch_model.bin")
    with pytest.raises(TypeError):
        jax_load_encoder({"params": {"encoder": init}}, str(tmp_path / "bin"),
                         JAX_CFG)
    with pytest.raises(TypeError, match="bfloat16"):
        load_pretrained_encoder(port, str(tmp_path / "bin"), PORT_CFG)
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    (sharded / "model.safetensors.index.json").write_text("{}")
    with pytest.raises(FileNotFoundError):
        jax_load_encoder({"params": {"encoder": init}}, str(sharded), JAX_CFG)
    with pytest.raises(FileNotFoundError, match="sharded"):
        read_state_dict(str(sharded))


@pytest.mark.parametrize("act,within", [("gelu_pytorch_tanh", True),
                                        ("gelu", False)])
def test_encoder_matches_transformers_bert(tmp_path, act, within):
    """A BertModel written by save_pretrained, weights redrawn from N(0,
    0.5^2) so that the two GELUs part: the port's 'gelu' is flax's tanh
    form, HF's 'gelu' the erf form."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(
        vocab_size=60, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=40, type_vocab_size=2, hidden_act=act,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    model = transformers.BertModel(hf_cfg).eval()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    assert (tmp_path / "model.safetensors").exists()

    # the port names the tanh form 'gelu' (flax's nn.gelu)
    config = resolve_config(str(tmp_path), hidden_act="gelu")
    assert config.layer_norm_eps == hf_cfg.layer_norm_eps
    encoder = Encoder(config, torch.float32).eval()
    read = load_pretrained_encoder(encoder, str(tmp_path), config)
    assert {k for k in model.state_dict() if k not in read} == {
        "pooler.dense.weight", "pooler.dense.bias"}
    rng = np.random.default_rng(1)
    ids = torch.tensor(rng.integers(5, 60, (3, 17)))
    mask = torch.ones(3, 17, dtype=torch.long)
    mask[1, 11:] = 0
    mask[2, 4:] = 0
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask).last_hidden_state
        got = encoder(ids, mask)
    keep = mask.bool()
    gap = float((got - want)[keep].abs().max())
    if within:
        assert gap <= HF_TOL, gap
    else:
        assert gap > 1e-4, gap   # the erf form is not what the port computes


# ---------------------------------------------------------------------------
# the command line and the trainer
# ---------------------------------------------------------------------------

ENC_HF = dict(SCIBERT_HF_CONFIG, vocab_size=20, hidden_size=32,
              num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=64, max_position_embeddings=48,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
DEC_HF = dict(ENC_HF, vocab_size=300, max_position_embeddings=12)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """The condition fixture and two HF directories: the encoder as
    model.safetensors (vocab 20 of the text vocab's 28, 48 positions of
    64), the decoder as pytorch_model.bin with `bert.` and the MaskedLM
    head (vocab 300 of 314, 12 positions of 16)."""
    root = tmp_path_factory.mktemp("pretrained")
    data = make_condition_data(str(root / "data"))
    files = {"encoder": hf_bert_tensors(ENC_HF, seed=1, std=0.2),
             "decoder": hf_bert_tensors(DEC_HF, seed=2, prefix="bert.",
                                        mlm_head=True, std=0.2)}
    write_hf_checkpoint(root / "enc", ENC_HF, files["encoder"], "safetensors")
    write_hf_checkpoint(root / "dec", DEC_HF, files["decoder"], "bin")
    return root, data, files


def _argv(root, data, save, *extra):
    return ["--task", "condition", "--data_path", data,
            "--train_file", "train.csv", "--valid_file", "val.csv",
            "--test_file", "test.csv",
            "--corpus_file", os.path.join(data, "corpus.csv"),
            "--nn_path", data, "--train_nn_file", "train_nn.json",
            "--valid_nn_file", "val_nn.json", "--test_nn_file", "test_nn.json",
            "--text_vocab_file", os.path.join(data, "text_vocab.txt"),
            "--encoder", str(root / "enc"), "--encoder_pretrained",
            "--decoder", str(root / "dec"), "--decoder_pretrained",
            "--encoder_tokenizer", "text", "--num_neighbors", "2",
            "--use_gold_neighbor", "--max_length", "64",
            "--max_dec_length", "16", "--batch_size", "8",
            "--test_batch_size", "8", "--epochs", "1", "--lr", "1e-3",
            "--num_beams", "3", "--compute_dtype", "float32",
            "--precision", "32", "--mlm", "--mlm_layer", "mlp",
            "--log_every", "1", "--debug", "--save_path", str(root / save),
            *extra]


def test_command_line_trains_from_both_checkpoints(pretrained):
    """python -m textreact_tpu_torch with --encoder_pretrained and
    --decoder_pretrained: the import checked as the chip check does it,
    when fit starts, then a finite loss."""
    root, data, files = pretrained
    checked = []

    def check(trainer):
        seeded, _, _ = build_model(trainer.cfg, trainer.enc_tokenizer,
                                   trainer.dec_tokenizer, device="cpu")
        params = {k: v.detach() for k, v in
                  trainer.module.named_parameters()}
        checked.append(check_pretrained_import(
            params, dict(seeded.named_parameters()), files,
            trainer.pretrained_keys))

    with before_fit(check):
        port_main(_argv(root, data, "cli", "--do_train", "--device", "cpu"))
    assert len(checked) == 1 and all(n > 0 for n in checked[0])
    with open(root / "cli" / "metrics.jsonl") as f:
        losses = [r["train_loss"] for r in map(json.loads, f)
                  if "train_loss" in r]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_first_steps_equal_the_jax_trainer_from_the_same_directories(
        pretrained):
    """Both trainers import from the same two directories: the port's
    imported elements equal the JAX import's (through from_flax) to the
    bit; with the JAX package's draws in the rest (the seeds' generators
    differ), one epoch logs the same losses and gradient norms."""
    root, data, _ = pretrained
    argv = _argv(root, data, "fit", "--do_train")
    pcfg = parse_config(argv)
    fields = {f: getattr(pcfg, f) for f in pcfg.__dataclass_fields__}
    jcfg = jax_config.ExperimentConfig(
        **dict(fields, save_path=str(root / "fit_jax")))
    jtrainer = JaxTrainer(jcfg)
    ptrainer = Trainer(pcfg, device="cpu")
    want = from_flax(jax.device_get(jtrainer._init_params()))
    got = {k: v.detach() for k, v in ptrainer.module.named_parameters()}
    assert got.keys() == want.keys()
    for part, ckpt in (("encoder", "enc"), ("decoder", "dec")):
        read = ptrainer.pretrained_keys[part]
        for name, src in read_state_dict(str(root / ckpt)).items():
            port = hf_port_name(part, name)
            assert (port is None) == (name not in read), name
            if port is not None:
                n = min(src.shape[0], got[port].shape[0])
                assert torch.equal(got[port][:n], want[port][:n]), port
    ptrainer.module.load_state_dict(want)
    rows = []
    for t in (jtrainer, ptrainer):
        t.prepare_data()
        t.fit()
        with open(os.path.join(t.cfg.save_path, "metrics.jsonl")) as f:
            rows.append([r for r in map(json.loads, f) if "train_loss" in r])
    assert [r["step"] for r in rows[0]] == [r["step"] for r in rows[1]]
    for a, b in zip(*rows):
        for key in ("train_loss", "mlm_loss", "total_loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= TOL, (key, a, b)


@pytest.mark.parametrize("flags,match", [
    (["--template_based", "--template_path", "x"], "seq2seq decoder"),
    (["--decoder", "bert_l6"], "local HF checkpoint directory")])
def test_decoder_pretrained_refusals(pretrained, flags, match):
    root, data, _ = pretrained
    cfg = parse_config(_argv(root, data, "refused", *flags))
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, device="cpu")
