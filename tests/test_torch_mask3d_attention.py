"""Self-attention under a per-example (B, L, L) admission mask on the fused
tensor-core kernels (ops/fused_attention.py::masked_attention,
csrc/mask3d_attention.cu, csrc/mask3d_attention_bwd.cu), the template
model's bond mask under --unattend_nonbonds.

On the CPU (tier 1): the packed layout (`pack_bits_reference`) bit by bit,
the routing predicate (`layers.mask_3d_route`), a packed mask refused
outside an encoder's self-attention, and CPU tensors keeping
the plain path with its counter.

On the card (the `cuda` marker; they skip from a fixture without one):
- the packing kernels equal the layout's plain statement, the keep bits
  equal `torch.rand(...) >= p` from the same generator state, and the
  generator stands where the plain path leaves it;
- forward and dQ, dK, dV at the template cell's shape (32 x 512, 12 heads
  of 64) and a small one, under masks of the data's bond rule
  (`RetrosynthesisDataset._bond_mask`), a dummy example and a query row
  with every key barred, at p = 0 and 0.1: every element within the
  kernels' rounding statement's bound, and as close to a float64
  evaluation as the plain path of `MultiHeadAttention.forward` is;
- a tensor-parallel rank's heads;
- a CUDA graph replayed under two masks and two generator seeds, each
  replay equal to the eager call.

    python -m pytest tests/test_torch_mask3d_attention.py -q -m cuda
"""

import _torch_threads  # noqa: F401  (before torch runs)
import math

import numpy as np
import pytest
import torch

from chip_smoke import ROUNDING_GRAD_TOL, ROUNDING_TOL
from textreact_tpu_torch.data.datasets import RetrosynthesisDataset
from textreact_tpu_torch.models import TransformerConfig, layers
from textreact_tpu_torch.models.encoder import Encoder
from textreact_tpu_torch.ops import fused_attention as fa

# the template cell's attention shape and a small one: (B, L, H, D)
CELL, SMALL = (32, 512, 12, 64), (3, 256, 2, 64)
P = 0.1


# --- the CPU: layout, route, plain path ------------------------------------

def _words(bits: torch.Tensor) -> np.ndarray:
    return fa.pack_bits_reference(bits).numpy().view(np.uint32)


@pytest.mark.parametrize("L", [64, 128, 256])
def test_packed_layout_puts_each_element_at_its_bit(L):
    """Element (p, q, k) is bit k % 32 of word (k % 64) // 32 of
    [p, k // 64, q], one element set at a time, and a full mask reads all
    ones."""
    rng = np.random.default_rng(L)
    for p, q, k in zip(rng.integers(0, 3, 40), rng.integers(0, L, 40),
                       rng.integers(0, L, 40)):
        bits = torch.zeros(3, L, L, dtype=torch.bool)
        bits[p, q, k] = True
        words = _words(bits)
        assert words.shape == (3, L // 64, L, 2)
        want = np.zeros_like(words)
        want[p, k // 64, q, (k % 64) // 32] = np.uint32(1) << np.uint32(k % 32)
        assert np.array_equal(words, want)
    assert (_words(torch.ones(2, L, L, dtype=torch.bool))
            == np.uint32(0xFFFFFFFF)).all()


def test_packed_layout_against_a_loop():
    rng = np.random.default_rng(5)
    bits = rng.random((2, 128, 128)) < 0.3
    words = _words(torch.as_tensor(bits))
    for p in range(2):
        for q in range(0, 128, 7):
            for k in range(128):
                w = int(words[p, k // 64, q, (k // 32) % 2])
                assert bool(w >> (k % 32) & 1) == bits[p, q, k]


@pytest.mark.parametrize("case,want", [
    (dict(), True),
    (dict(mask_rank=2), False),                      # the key mask's route
    (dict(attention_impl="xla"), False),
    (dict(length=200), False),                       # not 128-aligned
    (dict(dtype=torch.float32), False),              # the kernels' bf16
    (dict(device=torch.device("cpu")), False),       # CPU tensors
    (dict(head_dim=60), False),                      # no kernel width
])
def test_the_route_predicate(case, want):
    args = dict(attention_impl="flash", mask_rank=3, length=256,
                dtype=torch.bfloat16, device=torch.device("cuda"),
                head_dim=64)
    args.update(case)
    assert layers.mask_3d_route(**args) is want


@pytest.mark.parametrize("call", ["cross", "causal", "bias"])
def test_a_packed_mask_only_takes_an_encoder_self_attention(call):
    """A cross-attention, a decoder's causal call or a call with a bias of
    its own refuses a `PackedMask` before any kernel runs."""
    cfg = TransformerConfig(vocab_size=50, hidden_size=64,
                            num_hidden_layers=1, num_attention_heads=1,
                            intermediate_size=128,
                            max_position_embeddings=128,
                            attention_impl="flash")
    mha = layers.MultiHeadAttention(cfg, torch.float32,
                                    causal_hint=call == "causal")
    x = torch.zeros(2, 128, 64)
    packed = fa.PackedMask(fa.pack_bits_reference(
        torch.ones(2, 128, 128, dtype=torch.bool)))
    kw = dict(kv=x if call == "cross" else None,
              bias=torch.zeros(2, 1, 128, 128) if call == "bias" else None)
    with pytest.raises(ValueError, match="packed"):
        mha(x, mask_kv=packed, mask_3d=True, **kw)


def test_the_kernels_take_only_bf16_on_a_card():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert fa.takes_packed_mask(torch.bfloat16, cuda, 64)
    assert not fa.takes_packed_mask(torch.float32, cuda, 64)
    assert not fa.takes_packed_mask(torch.bfloat16, cpu, 64)
    assert not fa.takes_packed_mask(torch.bfloat16, cuda, 60)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_keep_the_plain_path(dtype):
    """An aligned (B, L, L) mask under 'flash' on the CPU: every layer takes
    the plain path and is counted there; no packed-mask launch."""
    cfg = TransformerConfig(vocab_size=50, hidden_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=128,
                            max_position_embeddings=128,
                            attention_impl="flash")
    torch.manual_seed(0)
    enc = Encoder(cfg, dtype=dtype)
    ids = torch.randint(1, 50, (2, 128))
    mask = torch.ones(2, 128, 128, dtype=torch.long)
    mask[:, 5:20, 5:20] = torch.eye(15, dtype=torch.long)
    plain, launches = layers.PLAIN_MASK_3D_CALLS, dict(fa.MASK_3D_LAUNCHES)
    with torch.no_grad():
        out = enc(ids, attention_mask=mask)
    assert torch.isfinite(out).all()
    assert layers.PLAIN_MASK_3D_CALLS - plain == cfg.num_hidden_layers
    assert fa.MASK_3D_LAUNCHES == launches


# --- the card ---------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def bond_masks(B: int, L: int, seed: int) -> torch.Tensor:
    """(B, L, L) int64 masks by the data's rule: a prompt of n tokens whose
    product atoms attend to themselves and their bonded neighbours only,
    padding rows and keys barred; example 0 a dummy row (every key barred)
    and one query row of example 1 barred whole."""
    rng = np.random.default_rng(seed)
    out = np.zeros((B, L, L), np.int64)
    for b in range(1, B):
        n = int(rng.integers(L // 2, L + 1))
        atoms = np.sort(rng.choice(np.arange(1, n), int(rng.integers(
            12, min(60, n - 1))), replace=False))
        chain = np.stack([np.arange(len(atoms) - 1),
                          np.arange(1, len(atoms))], 1)
        bonds = np.concatenate([chain, chain[:, ::-1]])
        out[b, :n, :n] = RetrosynthesisDataset._bond_mask(
            {"attention_mask": [1] * n, "atom_indices": atoms.tolist(),
             "bonds": bonds.tolist()})
    if B > 1:
        out[1, 3, :] = 0
    return torch.as_tensor(out)


def inputs(shape, dev, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(4)]


def plain(q, k, v, mask, p, gen):
    """The plain path of MultiHeadAttention.forward under a 3-D mask: f32
    scores plus the mask's bias, softmax, the layer's dropout draw, bf16
    weights against v."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(
        q.shape[-1])
    probs = layers.dropout(torch.softmax(s + layers.mask_to_bias(mask), -1),
                           p, gen)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(),
                        v.float()).to(q.dtype)


def exact(q, k, v, mask, keep, p):
    """float64 evaluation of the same function under the keep mask `keep`."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    probs = torch.softmax(s + (1.0 - mask[:, None].double()) * -1e9, -1)
    if keep is not None:
        probs = torch.where(keep, probs / (1.0 - p), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def run(fn, q, k, v, do):
    """(out, dq, dk, dv) of fn over leaves of q, k, v."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    out.backward(do)
    return (out.detach(), *(t.grad for t in leaves))


def rel(a, ref) -> float:
    return float((a.double() - ref).norm() / ref.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_mask_bits_equal_the_layout(dev, dtype):
    mask = bond_masks(4, 256, 1).to(dtype)
    words = fa.pack_mask_bits(mask.to(dev)).words
    assert torch.equal(words.cpu(), fa.pack_bits_reference(mask > 0))


@pytest.mark.cuda
@pytest.mark.parametrize("offset,heads,total", [(0, 4, 4), (2, 2, 4)])
def test_keep_bits_are_the_plain_paths_draw(dev, offset, heads, total):
    B, L = 3, 256
    g = torch.Generator(device=dev).manual_seed(2**40 + 11)
    state = g.get_state()
    u = layers.dropout_uniforms((B, total, L, L), g, dev)
    words = fa.pack_keep_bits(u, P, offset, heads)
    after = g.get_state()
    g.set_state(state)
    keep = torch.rand((B, total, L, L), generator=g, device=dev) >= P
    assert torch.equal(g.get_state(), after)
    want = fa.pack_bits_reference(
        keep[:, offset:offset + heads].reshape(B * heads, L, L).cpu())
    assert torch.equal(words.cpu().view(B * heads, L // 64, L, 2), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SMALL, CELL], ids=["small", "cell"])
@pytest.mark.parametrize("p", [0.0, P])
def test_forward_and_backward_against_the_plain_path(dev, shape, p):
    B, L, H, D = shape
    q, k, v, do = inputs(shape, dev, 3)
    mask = bond_masks(B, L, 4).to(dev)
    packed = fa.pack_mask_bits(mask)
    g = torch.Generator(device=dev).manual_seed(2**33 + 7)
    state = g.get_state()
    before = dict(fa.MASK_3D_LAUNCHES)

    def kernel(*a):
        u = None if p == 0.0 else layers.dropout_uniforms((B, H, L, L), g,
                                                          dev)
        return fa.masked_attention(*a, packed, p, u, 1.0 / math.sqrt(D))

    got = run(kernel, q, k, v, do)
    assert fa.MASK_3D_LAUNCHES == {"fwd": before["fwd"] + 1,
                                   "bwd": before["bwd"] + 1}
    after = g.get_state()
    g.set_state(state)
    ref = run(lambda *a: plain(*a, mask, p, g), q, k, v, do)
    assert torch.equal(g.get_state(), after)   # the same draw, no other
    keep = None
    if p > 0.0:
        g.set_state(state)
        keep = torch.rand((B, H, L, L), generator=g, device=dev) >= p
    # every element within the bound of the kernels' rounding statement,
    # whose backward reads the kernel's own output
    want = fa.attention_rounding_reference(q, k, v, do, mask, D ** -0.5,
                                           keep, p, out=got[0])
    for name, a, w, (atol, rtol) in zip(
            ("out", "dq", "dk", "dv"), got, want,
            (ROUNDING_TOL, *[ROUNDING_GRAD_TOL] * 3)):
        assert torch.isfinite(a).all(), name
        w = w.float()
        assert ((a.float() - w).abs() <= atol + rtol * w.abs()).all(), name
    # as close to the float64 answer as the plain path is
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    out64 = exact(*leaves, mask, keep, p)
    out64.backward(do.double())
    truth = (out64.detach(), *(t.grad for t in leaves))
    for name, a, b, t in zip(("out", "dq", "dk", "dv"), got, ref, truth):
        assert rel(a, t) <= max(2 * rel(b, t), 2 ** -8), (
            name, rel(a, t), rel(b, t))
    # the barred rows average v, as the plain path's do
    assert torch.allclose(got[0][0].float(), ref[0][0].float(), atol=2e-2)


@pytest.mark.cuda
def test_a_tensor_parallel_ranks_heads(dev):
    """Heads 2, 3 of a layer of 4 take that layer's draw for those heads."""
    B, L, H, D = 2, 256, 2, 64
    q, k, v, do = inputs((B, L, H, D), dev, 8)
    mask = bond_masks(B, L, 9).to(dev)
    packed = fa.pack_mask_bits(mask)
    g = torch.Generator(device=dev).manual_seed(31)
    state = g.get_state()

    def kernel(*a):
        u = layers.dropout_uniforms((B, 4, L, L), g, dev)
        return fa.masked_attention(*a, packed, P, u, D ** -0.5,
                                   head_offset=2)

    got = run(kernel, q, k, v, do)
    g.set_state(state)
    keep = (torch.rand((B, 4, L, L), generator=g, device=dev) >= P)[:, 2:]
    want = fa.attention_rounding_reference(q, k, v, do, mask, D ** -0.5,
                                           keep, P, out=got[0])
    for a, w, (atol, rtol) in zip(got, want, (ROUNDING_TOL,
                                              *[ROUNDING_GRAD_TOL] * 3)):
        assert ((a.float() - w.float()).abs()
                <= atol + rtol * w.float().abs()).all()


@pytest.mark.cuda
def test_graph_replays_follow_the_mask_and_the_generator(dev):
    """One captured forward and backward, replayed under two masks and two
    seeds: each replay equals the eager call under the same mask and seed,
    and the two differ."""
    B, L, H, D = SMALL
    q, k, v, do = inputs(SMALL, dev, 12)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    masks = [bond_masks(B, L, s).to(dev) for s in (20, 21)]
    static_mask = masks[0].clone()
    g = torch.Generator(device=dev)

    def step():
        for t in leaves:
            t.grad = None
        u = layers.dropout_uniforms((B, H, L, L), g, dev)
        out = fa.masked_attention(*leaves, fa.pack_mask_bits(static_mask),
                                  P, u, D ** -0.5)
        out.backward(do)
        return (out.detach(), *(t.grad for t in leaves))

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        g.manual_seed(0)
        step()   # the warm-up a capture needs
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g)
    with torch.cuda.graph(graph):
        static_out = step()
    replays = []
    for mask, seed in zip(masks, (101, 202)):
        static_mask.copy_(mask)
        g.manual_seed(seed)
        graph.replay()
        replays.append([t.clone() for t in static_out])
        g.manual_seed(seed)
        eager = step()
        for a, b in zip(replays[-1], eager):
            assert torch.equal(a, b)
    assert not torch.equal(replays[0][0], replays[1][0])
