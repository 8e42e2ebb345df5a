"""Plain reference of the template-based model that the `retro_tb`
configuration runs (TextReact's TemplateBasedModel, reference model.py):
the BERT encoder of `encdec.py` under the example's attention mask, the
MLM head, the atom states gathered at the atom tokens, an atom head, and
the bond head in its published form: logits of bond (i, j) are
W [h_i; h_j] + b over the concatenated pair (model.py:80-90), one product
of the pair's 2d features, where the program sums two d-wide maps at the
pair's atoms. The loss is the atom CE plus the bond CE over the labels
that are not IGNORE_INDEX, plus mlm_lambda times the MLM CE. Plain PyTorch
over a dict of tensors in the program's parameter names; it imports
nothing of the program under test.

A (B, L, L) mask (the bond mask, --unattend_nonbonds) is an additive
bias on each query's scores; a (B, L) mask the key mask of `encdec.py`.
Precision and the float8 control as `encdec.Products`.

Departures from the published model, as the program makes them: those of
`encdec.py` (GELU's tanh form, a barred key at -1e9, not -inf, LayerNorm in
float32); the bond head's weight is held as its two d-wide halves,
`head.bond_head_left.weight` and `head.bond_head_right.weight`, joined
here into W, with the bias `head.bond_head_left.bias`.

Dropout (training): `encdec.Draws`, in the program's order. Under a (B, L,
L) mask every self-attention takes the program's plain path, which draws
its probabilities' mask as one `torch.rand` of (B, H, L, L) from the
micro-batch's generator (`Draws.rand`), on the card too; under a (B, L)
mask the fused kernel's masks (`Draws.fused_attention`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .encdec import (IGNORE_INDEX, NEG_INF, Draws, EncDec, Products,
                     cross_entropy)


class TemplateModel(EncDec):
    """The reference over `params`; `enc`: the encoder's sizes."""

    def __init__(self, params: Dict[str, torch.Tensor], enc: dict,
                 products: Products):
        super().__init__(params, enc, None, products)

    def encode(self, ids, mask, pos=None, draws: Optional[Draws] = None):
        if mask.dim() == 2:
            return super().encode(ids, mask, pos, draws)
        cfg = self.enc
        B, L = ids.shape
        if pos is None:
            pos = torch.arange(L, device=ids.device)[None].expand(B, L)
        x = self.embed("encoder.embeddings",
                       self.w("encoder.embeddings.word_embeddings.weight"),
                       ids, pos, cfg, draws)
        bias = ((1.0 - mask.float()) * NEG_INF)[:, None]
        H = cfg["num_attention_heads"]
        p_attn = cfg["attention_probs_dropout_prob"]
        for i in range(cfg["num_hidden_layers"]):
            p = f"encoder.layers.{i}"
            keep = None if draws is None else draws.rand((B, H, L, L), p_attn)
            x = self.residual_norm(
                x, self.attention(x, x, p + ".attention", bias, cfg, keep),
                p + ".attention_norm", cfg, draws)
            x = self.residual_norm(x, self.ffn(x, p + ".ffn"),
                                   p + ".ffn_norm", cfg, draws)
        return x

    def heads(self, states, atom_indices, bond_pairs):
        """(atom logits (B, A, n_a + 1), bond logits (B, MB, n_b + 1)),
        float32."""
        d = states.shape[-1]
        atoms = torch.gather(states, 1,
                             atom_indices[:, :, None].expand(-1, -1, d))
        atom_logits = self.linear(atoms, "head.atom_head")
        w = torch.cat([self.w("head.bond_head_left.weight"),
                       self.w("head.bond_head_right.weight")], dim=1)
        rows = torch.arange(atoms.shape[0], device=atoms.device)[:, None]
        pair = torch.cat([atoms[rows, bond_pairs[..., 0]],
                          atoms[rows, bond_pairs[..., 1]]], dim=-1)
        bond_logits = (self.mm(pair, w.t())
                       + self.w("head.bond_head_left.bias"))
        return atom_logits, bond_logits


def train_loss(model: TemplateModel, batch: Dict[str, torch.Tensor],
               mlm_lambda: float, draws: Optional[Draws]) -> torch.Tensor:
    """One micro-batch's loss: the atom and bond template CEs plus
    mlm_lambda times the MLM CE over the masked prefix."""
    enc = model.encode(batch["input_ids"], batch["attention_mask"],
                       batch.get("position_ids"), draws)
    atom_logits, bond_logits = model.heads(enc, batch["atom_indices"],
                                           batch["bond_pairs"])
    loss = (cross_entropy(atom_logits, batch["atom_template_labels"],
                          IGNORE_INDEX)
            + cross_entropy(bond_logits, batch["bond_template_labels"],
                            IGNORE_INDEX))
    if "mlm_labels" in batch:
        M = batch["mlm_labels"].shape[1]
        loss = loss + mlm_lambda * cross_entropy(
            model.mlm_logits(enc[:, :M]), batch["mlm_labels"], IGNORE_INDEX)
    return loss
