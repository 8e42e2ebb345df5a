"""Plain reference of the encoder-decoder that the `rcr` and `retro_tf`
configurations run: a BERT encoder (post-LN blocks), a BERT decoder with
causal self-attention and cross-attention and an LM head tied to its word
table, and the encoder's MLM head. Plain PyTorch over a dict of tensors
keyed by the parameter names the benchmark makes (`weights.py`); it imports
nothing of the program under test.

Precision: every product goes through `Products`. 'f32' computes in
float32 with TF32 off (`strict_f32`); 'fp8' rounds both operands of every
product to float8 (e4m3 in the forward, e5m2 for gradients in the
backward, one scale a tensor) and accumulates in float32: the control that
a sound comparison has to tell apart from the program.

Departures from the published models, as the program makes them: GELU is
the tanh approximation (flax's default, which the port keeps); a masked
key scores -1e9, not -inf; LayerNorm is float32 over float32 inputs.

Dropout (training): `Draws` makes the keep masks the program draws for a
micro-batch, in its order, from a generator seeded as the program seeds
it. On a CUDA device the attention and residual-LayerNorm masks come from
one 64-bit seed a call, expanded by Philox4x32-10 over the element's
coordinates (the port's documented rule, `philox`); elsewhere every mask
is one `torch.rand` draw of the mask's shape.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e9
IGNORE_INDEX = -100


def strict_f32() -> None:
    """float32 products in float32: no TF32, no reduced-precision sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# --- float8 products (the control) ---------------------------------------

def _round8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = 448.0 if dtype == torch.float8_e4m3fn else 57344.0
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return (x.float() / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _round8(a, torch.float8_e4m3fn), _round8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _round8(g, torch.float8_e5m2)
        return (torch.matmul(g8, b8.transpose(-1, -2)),
                torch.matmul(a8.transpose(-1, -2), g8))


class Products:
    """a @ b in the precision of the reference ('f32') or the control
    ('fp8')."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _Fp8Matmul.apply(a.float(), b.float())
        return torch.matmul(a.float(), b.float())


# --- the program's dropout draws ------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of m * c, c an int64 tensor of 32-bit values,
    in int64 arithmetic without overflow."""
    t = c * (m & 0xFFFF)
    u = c * (m >> 16)
    hi = (u + (t >> 16)) >> 16
    lo = (((u & 0xFFFF) << 16) + t) & _MASK32
    return hi, lo


def philox(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 (Salmon et al., SC'11) keyed by a 64-bit seed; the
    counter words are int64 tensors (or ints) of 32-bit values."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def threshold(p: float) -> int:
    return min(int(p * (1 << 32)), (1 << 32) - 1)


def attention_keep(seed: int, B: int, H: int, Lq: int, Lk: int, p: float,
                   device) -> torch.Tensor:
    """(B, H, Lq, Lk) keep mask of one attention call: element (b, h, q, k)
    takes word k % 4 of Philox(k // 4, q, b * H + h, 0)."""
    out = torch.empty((B * H, Lq, Lk), dtype=torch.bool, device=device)
    col4 = torch.arange(Lk // 4, device=device, dtype=torch.long)
    row = torch.arange(Lq, device=device, dtype=torch.long)
    thr = threshold(p)
    step = max(1, (1 << 22) // (Lq * Lk // 4))   # ~4M counters at a time
    for lo in range(0, B * H, step):
        bh = torch.arange(lo, min(lo + step, B * H), device=device,
                          dtype=torch.long)
        words = philox(col4[None, None, :], row[None, :, None],
                       bh[:, None, None], 0, seed)
        bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
        out[lo:lo + len(bh)] = bits.reshape(len(bh), Lq, Lk) >= thr
    return out.view(B, H, Lq, Lk)


def row_keep(seed: int, rows: int, hidden: int, p: float,
             device) -> torch.Tensor:
    """(rows, hidden) keep mask of one residual LayerNorm call: element
    (r, c) takes word c % 4 of Philox(c // 4, r low, r high, 1)."""
    col4 = torch.arange(hidden // 4, device=device, dtype=torch.long)
    row = torch.arange(rows, device=device, dtype=torch.long)
    words = philox(col4[None, :], (row & _MASK32)[:, None],
                   (row >> 32)[:, None], 1, seed)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    return bits.reshape(rows, hidden) >= threshold(p)


def dropout_seed(train_seed: int, counter: int) -> int:
    """The seed of a micro-batch's dropout generator: the run's seed and
    the micro-batch's counter folded as the program folds them."""
    return (train_seed * 0x9E3779B97F4A7C15 + counter) & ((1 << 63) - 1)


class Draws:
    """The keep masks of one micro-batch, drawn in the program's order from
    `generator` (already seeded). `kernels`: the program's attention and
    residual-LayerNorm kernels draw them (a CUDA device): one seed a call,
    expanded by Philox; otherwise each is a `torch.rand` of its shape."""

    def __init__(self, generator: torch.Generator, kernels: bool):
        self.gen, self.kernels = generator, kernels
        self.device = generator.device

    def rand(self, shape, p: float) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen,
                          device=self.device) >= p

    def _seed(self) -> int:
        return int(torch.randint(0, 1 << 62, (1,), generator=self.gen,
                                 device=self.device, dtype=torch.int64))

    def fused_attention(self, shape, p: float) -> torch.Tensor:
        if not self.kernels:
            return self.rand(shape, p)
        return attention_keep(self._seed(), *shape, p, self.device)

    def residual(self, shape, p: float) -> torch.Tensor:
        if not self.kernels:
            return self.rand(shape, p)
        rows, hidden = math.prod(shape[:-1]), shape[-1]
        return row_keep(self._seed(), rows, hidden, p,
                        self.device).view(shape)


# --- the model ------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def layer_norm(x, w, b, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


class EncDec:
    """The reference over `params` (name -> tensor; any float dtype, used
    as float32). `enc`, `dec`: the configuration's sizes. `draws`, per
    call, turns dropout on."""

    def __init__(self, params: Dict[str, torch.Tensor], enc: dict, dec: dict,
                 products: Products):
        self.P, self.enc, self.dec, self.mm = params, enc, dec, products

    def w(self, name: str) -> torch.Tensor:
        return self.P[name].float()

    def linear(self, x, prefix: str) -> torch.Tensor:
        return (self.mm(x, self.w(prefix + ".weight").t())
                + self.w(prefix + ".bias"))

    def _drop(self, x, keep, p):
        return torch.where(keep, x / (1.0 - p), 0.0)

    def embed(self, prefix, table, ids, pos, cfg, draws):
        x = (F.embedding(ids, table) + F.embedding(pos, self.w(
            prefix + ".position_embeddings.weight")))
        if cfg["type_vocab_size"] > 0:
            x = x + self.w(prefix + ".token_type_embeddings.weight")[0]
        x = layer_norm(x, self.w(prefix + ".layer_norm.weight"),
                       self.w(prefix + ".layer_norm.bias"),
                       cfg["layer_norm_eps"])
        if draws is not None:
            p = cfg["hidden_dropout_prob"]
            x = self._drop(x, draws.rand(x.shape, p), p)
        return x

    def attention(self, x, kv, prefix, bias, cfg, keep):
        B, Lq, d = x.shape
        Lk = kv.shape[1]
        H = cfg["num_attention_heads"]
        D = d // H
        q = self.linear(x, prefix + ".query").view(B, Lq, H, D).transpose(1, 2)
        k = self.linear(kv, prefix + ".key").view(B, Lk, H, D).transpose(1, 2)
        v = self.linear(kv, prefix + ".value").view(B, Lk, H, D).transpose(1, 2)
        s = self.mm(q, k.transpose(-1, -2)) / math.sqrt(D) + bias
        probs = torch.softmax(s, dim=-1)
        if keep is not None:
            probs = self._drop(probs, keep, cfg["attention_probs_dropout_prob"])
        ctx = self.mm(probs, v).transpose(1, 2).reshape(B, Lq, d)
        return self.linear(ctx, prefix + ".output")

    def residual_norm(self, x, res, prefix, cfg, draws):
        if draws is not None:
            p = cfg["hidden_dropout_prob"]
            res = self._drop(res, draws.residual(res.shape, p), p)
        return layer_norm(x + res, self.w(prefix + ".weight"),
                          self.w(prefix + ".bias"), cfg["layer_norm_eps"])

    def ffn(self, x, prefix):
        return self.linear(gelu(self.linear(x, prefix + ".intermediate")),
                           prefix + ".output")

    def encode(self, ids, mask, pos=None, draws: Optional[Draws] = None):
        cfg = self.enc
        B, L = ids.shape
        if pos is None:
            pos = torch.arange(L, device=ids.device)[None].expand(B, L)
        x = self.embed("encoder.embeddings",
                       self.w("encoder.embeddings.word_embeddings.weight"),
                       ids, pos, cfg, draws)
        bias = ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]
        H = cfg["num_attention_heads"]
        for i in range(cfg["num_hidden_layers"]):
            p = f"encoder.layers.{i}"
            keep = (None if draws is None else draws.fused_attention(
                (B, H, L, L), cfg["attention_probs_dropout_prob"]))
            x = self.residual_norm(
                x, self.attention(x, x, p + ".attention", bias, cfg, keep),
                p + ".attention_norm", cfg, draws)
            x = self.residual_norm(x, self.ffn(x, p + ".ffn"),
                                   p + ".ffn_norm", cfg, draws)
        return x

    def decode(self, ids, enc_states, enc_mask, dec_mask=None,
               draws: Optional[Draws] = None):
        """Teacher-forced logits (B, Ld, V), float32."""
        cfg = self.dec
        B, Ld = ids.shape
        H = cfg["num_attention_heads"]
        pos = torch.arange(Ld, device=ids.device)[None].expand(B, Ld)
        table = self.w("decoder.word_embedding")
        x = self.embed("decoder.embeddings", table, ids, pos, cfg, draws)
        causal = torch.where(
            torch.arange(Ld, device=ids.device)[None, :]
            <= torch.arange(Ld, device=ids.device)[:, None], 0.0, NEG_INF)
        self_bias = causal[None, None]
        if dec_mask is not None:
            self_bias = self_bias + ((1.0 - dec_mask.float())
                                     * NEG_INF)[:, None, None, :]
        cross_bias = ((1.0 - enc_mask.float()) * NEG_INF)[:, None, None, :]
        Lk = enc_states.shape[1]
        for i in range(cfg["num_hidden_layers"]):
            p = f"decoder.layers.{i}"
            p_attn = cfg["attention_probs_dropout_prob"]
            keep = None if draws is None else draws.rand((B, H, Ld, Ld),
                                                         p_attn)
            x = self.residual_norm(
                x, self.attention(x, x, p + ".attention", self_bias, cfg,
                                  keep), p + ".attention_norm", cfg, draws)
            keep = None if draws is None else draws.rand((B, H, Ld, Lk),
                                                         p_attn)
            x = self.residual_norm(
                x, self.attention(x, enc_states, p + ".crossattention",
                                  cross_bias, cfg, keep),
                p + ".crossattention_norm", cfg, draws)
            x = self.residual_norm(x, self.ffn(x, p + ".ffn"),
                                   p + ".ffn_norm", cfg, draws)
        h = layer_norm(gelu(self.linear(x, "decoder.lm_head.transform")),
                       self.w("decoder.lm_head.transform_norm.weight"),
                       self.w("decoder.lm_head.transform_norm.bias"),
                       cfg["layer_norm_eps"])
        return self.mm(h, table.t()) + self.w("decoder.lm_head.bias")

    def mlm_logits(self, states):
        h = layer_norm(gelu(self.linear(states, "mlm_head.transform")),
                       self.w("mlm_head.transform_norm.weight"),
                       self.w("mlm_head.transform_norm.bias"),
                       self.enc["layer_norm_eps"])
        return self.linear(h, "mlm_head.decoder")


def cross_entropy(logits, labels, ignore: int) -> torch.Tensor:
    """Mean NLL over the labels that are not `ignore` (at least one
    counted)."""
    valid = labels != ignore
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def train_loss(model: EncDec, batch: Dict[str, torch.Tensor],
               mlm_lambda: float, dec_pad: int,
               draws: Optional[Draws]) -> torch.Tensor:
    """One micro-batch's loss: the decoder's CE over the shifted targets
    (pad ignored) plus mlm_lambda times the MLM CE over the masked prefix."""
    enc = model.encode(batch["input_ids"], batch["attention_mask"],
                       batch["position_ids"], draws)
    logits = model.decode(batch["decoder_input_ids"], enc,
                          batch["attention_mask"],
                          batch["decoder_attention_mask"], draws)
    loss = cross_entropy(logits[:, :-1], batch["decoder_input_ids"][:, 1:],
                         dec_pad)
    M = batch["mlm_labels"].shape[1]
    mlm = cross_entropy(model.mlm_logits(enc[:, :M]), batch["mlm_labels"],
                        IGNORE_INDEX)
    return loss + mlm_lambda * mlm
