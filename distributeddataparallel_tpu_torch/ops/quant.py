"""Weight-only int8 quantization for the decode path.

Counterpart of ``distributeddataparallel_tpu/ops/quant.py``: the serving
half (``QuantLeaf`` .. ``dequantize`` and ``quantized_bytes``) and, at the
end, the training half, the low-bit optimizer moments that
``parallel.zero.LowBitMoments`` stores between steps (``MOMENT_BLOCK`` ..
``stochastic_round_bf16``).

Decode at small batch streams every matrix from memory each step.  Storing
the matrices as int8 with absmax scales halves those bytes against bf16.
The trees here are the reference's param layout (``models.io.jax_layout``:
nested dicts of tensors, ``DenseGeneral`` kernels ``(d_model, H, D)``,
stacked ``layers/block`` leaves under ``scan_layers``), because which
elements share a scale is a function of the leaf's shape in that layout
(``_scale_reduce_axes``).  So the port's int8 tree equals the reference's
bit for bit: both scale by the f32 reciprocal of 127, divide in f32 and
round half to even.

The decode twin (``models.transformer``, ``quant_serving``) dequantizes one
layer's leaves inside that layer's call (``models.io.layer_weights``): the
int8 stack stays resident and no whole-model copy in the compute dtype is
ever built.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

Pytree = Any

#: Leaves smaller than this stay in their source dtype: biases, norm
#: scales, and tiny matrices are a rounding error of the byte budget,
#: and per-channel scales would cost a larger fraction of their size.
MIN_QUANT_ELEMS = 16384

_INV_127 = 1.0 / 127.0  # applied to f32 tensors as the f32 value of 1/127


@dataclasses.dataclass
class QuantLeaf:
    """An int8-quantized matrix leaf: ``q`` keeps the original shape,
    ``scale`` is the f32 dequant factor with keepdims shape (broadcasts
    against ``q``)."""

    q: torch.Tensor
    scale: torch.Tensor

    def __getitem__(self, i) -> "QuantLeaf":
        """Slice of a stacked leaf (scales keep the layer dim)."""
        return QuantLeaf(self.q[i], self.scale[i])


def tree_map(fn, tree: Pytree) -> Pytree:
    """``fn`` over the leaves (tensors and ``QuantLeaf``s) of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Pytree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _quantizable(leaf) -> bool:
    return (
        isinstance(leaf, torch.Tensor)
        and leaf.dim() >= 2
        and leaf.numel() >= MIN_QUANT_ELEMS
        and leaf.is_floating_point()
    )


def _scale_reduce_axes(shape: tuple[int, ...], stacked: bool = False) -> tuple[int, ...]:
    """Axes the absmax reduces over, i.e. which elements share a scale
    (the reference's rule): the trailing channel, and the leading axis of
    ndim >= 3 or stacked leaves (a scanned stack's layer dim), coarsened by
    dropping the largest kept axis until the f32 scales cost <= 1/16 of the
    int8 payload.  Stacked trees never drop axis 0."""
    nd = len(shape)
    keep = {nd - 1} | ({0} if (nd >= 3 or stacked) else set())
    size = math.prod(shape)
    fixed = {0} if stacked else set()
    while keep - fixed:
        if 4 * math.prod(shape[a] for a in keep) <= size / 16:
            break
        keep.remove(max(keep - fixed, key=lambda a: shape[a]))
    return tuple(a for a in range(nd) if a not in keep)


def quantize_int8(params: Pytree, *, stacked_first_dim: bool = False) -> Pytree:
    """Symmetric absmax int8 quantization of every matrix leaf; other
    leaves pass through unchanged.  ``stacked_first_dim``: the tree is a
    scanned layer stack, and every scale keeps the layer dim."""

    def _q(leaf):
        if not _quantizable(leaf):
            return leaf
        f = leaf.float()
        axes = _scale_reduce_axes(tuple(leaf.shape), stacked_first_dim)
        absmax = f.abs().amax(dim=axes, keepdim=True) if axes else f.abs()
        # Times the f32 reciprocal: XLA compiles the reference's division
        # by the constant 127 into this product (its jitted quantization
        # is what decode runs).
        scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax)) * _INV_127
        q = torch.round(f / scale).clamp(-127, 127).to(torch.int8)
        return QuantLeaf(q=q, scale=scale)

    return tree_map(_q, params)


def quantize_for_decode(params: Pytree, scan_layers: bool = False) -> Pytree:
    """The decode-side convention in one place: scanned models quantize the
    stacked ``layers`` subtree in stacked mode (per-layer scales),
    everything else channel-wise."""
    if not scan_layers:
        return quantize_int8(params)
    return {k: quantize_int8(v, stacked_first_dim=(k == "layers")) for k, v in params.items()}


def is_quantized(params: Pytree) -> bool:
    """True when the tree carries any ``QuantLeaf``."""
    return any(isinstance(leaf, QuantLeaf) for leaf in tree_leaves(params))


def _dequantize_leaf(leaf, dtype):
    if isinstance(leaf, QuantLeaf):
        return (leaf.q.float() * leaf.scale).to(dtype)
    if leaf.is_floating_point():
        return leaf.to(dtype)
    return leaf


def dequantize(qparams: Pytree, dtype=torch.bfloat16) -> Pytree:
    """``QuantLeaf`` -> ``dtype`` matrices (``q * scale`` in f32, then
    cast); float pass-through leaves cast to ``dtype`` (decode computes in
    the model dtype either way)."""
    return tree_map(lambda leaf: _dequantize_leaf(leaf, dtype), qparams)


def dequantize_rows(leaf, index: torch.Tensor, dtype) -> torch.Tensor:
    """``dequantize(leaf)[index]`` without the whole table: an embedding
    lookup reads only its rows (the values are the same elementwise)."""
    if isinstance(leaf, QuantLeaf):
        scale = leaf.scale if leaf.scale.shape[0] == 1 else leaf.scale[index]
        if leaf.scale.shape[0] == 1:
            scale = scale.reshape(leaf.scale.shape[1:])
        return (leaf.q[index].float() * scale).to(dtype)
    return leaf[index].to(dtype)


def quantized_bytes(qparams: Pytree) -> dict:
    """Byte ledger of a (possibly) quantized tree: what decode streams from
    memory per step."""
    total = n_q = n_dense = 0
    for leaf in tree_leaves(qparams):
        if isinstance(leaf, QuantLeaf):
            total += leaf.q.numel() + leaf.scale.numel() * 4
            n_q += 1
        else:
            total += leaf.numel() * leaf.element_size()
            n_dense += 1
    return {"bytes": int(total), "n_quantized_leaves": n_q, "n_passthrough_leaves": n_dense}


# --------------------------------------------------------------------------
# Low-bit optimizer moments (the training half).
#
# Moment compression is a lossy round trip every step: state -> low-bit ->
# state.  Its error compensation is stochastic rounding, E[sr(x)] == x, so
# the quantization error enters the moments' running averages as zero-mean
# noise instead of a bias toward zero that would stall small updates.  Each
# quantizer is a pure function of ``(x, noise)``; a thin wrapper draws the
# noise from an explicit ``torch.Generator``.  Given the reference's draws
# (``jax.random.bits(key, shape, uint32) & 0xFFFF`` for bf16,
# ``jax.random.uniform(key, (blocks, MOMENT_BLOCK))`` for int8) the pure
# functions return the reference's values bit for bit.
# --------------------------------------------------------------------------

#: Block length of the blockwise-absmax int8 moments: one outlier poisons
#: only its 2048 neighbours' scale, and the f32 scales cost 0.2% of the
#: int8 payload.
MOMENT_BLOCK = 2048

#: Smallest magnitude of the int8 dynamic codebook relative to the block's
#: absmax, in the sqrt domain (so absmax * 1e-14 linear).  A geometric grid
#: bounds the relative error: a linear int8 grid would zero every element
#: of Adam's second moment below absmax / 127 and the update m / (sqrt(v) +
#: eps) would blow up.
Q8_DYNAMIC_MIN = 1e-7


def _q8_codebook(device=None) -> torch.Tensor:
    """The sorted signed codebook, 255 f32 entries: 0 and +/-127 magnitudes
    log-spaced over [Q8_DYNAMIC_MIN, 1].  An element is stored as its index
    minus 127, which fits int8."""
    import numpy as np

    mag = Q8_DYNAMIC_MIN ** ((126 - np.arange(127)) / 126.0)
    code = np.concatenate([-mag[::-1], [0.0], mag]).astype(np.float32)
    return torch.from_numpy(code).to(device)


@dataclasses.dataclass
class Q8Moment:
    """A flat f32 moment vector as int8 codebook indices (minus 127) and a
    per-block f32 absmax; ``n`` is the unpadded length (the vector is
    zero-padded to a multiple of ``MOMENT_BLOCK``)."""

    q: torch.Tensor      # int8, (blocks * MOMENT_BLOCK,)
    scale: torch.Tensor  # f32, (blocks,)
    n: int

    def nbytes(self) -> int:
        return self.q.numel() + self.scale.numel() * 4


def moment_blocks(n: int) -> int:
    return -(-n // MOMENT_BLOCK)


def quantize_moment_int8_with(x: torch.Tensor, uniform: torch.Tensor) -> Q8Moment:
    """Flat f32 vector -> ``Q8Moment`` given ``uniform`` draws in [0, 1) of
    shape ``(blocks, MOMENT_BLOCK)``.  Each block is scaled by its absmax,
    mapped to sign(v) sqrt(|v|) (so Adam's second moment, a squared
    quantity, shares the first moment's range) and rounded stochastically
    between the two neighbouring codebook entries: up with probability
    equal to its distance from the lower one."""
    n = x.shape[0]
    f = torch.nn.functional.pad(x.float(), (0, (-n) % MOMENT_BLOCK)).view(-1, MOMENT_BLOCK)
    absmax = f.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    v = f / scale[:, None]
    y = torch.sign(v) * torch.sqrt(torch.abs(v))
    code = _q8_codebook(x.device)
    hi = torch.searchsorted(code, y).clamp_(1, code.shape[0] - 1)
    lo = hi - 1
    c_lo, c_hi = code[lo], code[hi]
    p = (y - c_lo) / (c_hi - c_lo)
    idx = torch.where(uniform < p, hi, lo)
    return Q8Moment(q=(idx - 127).to(torch.int8).view(-1), scale=scale, n=n)


def quantize_moment_int8(x: torch.Tensor, generator: torch.Generator) -> Q8Moment:
    """``quantize_moment_int8_with`` on uniform draws from ``generator``."""
    u = torch.rand((moment_blocks(x.shape[0]), MOMENT_BLOCK), generator=generator,
                   device=x.device, dtype=torch.float32)
    return quantize_moment_int8_with(x, u)


def dequantize_moment(m: Q8Moment) -> torch.Tensor:
    """``Q8Moment`` -> the flat f32 vector of its unpadded length."""
    code = _q8_codebook(m.q.device)
    z = code[m.q.long() + 127].view(-1, MOMENT_BLOCK)
    f = torch.sign(z) * z * z * m.scale[:, None]
    return f.view(-1)[: m.n]


def stochastic_round_bf16_with(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16, rounding up with probability equal to the dropped
    fraction: ``noise`` (integers in [0, 65536), ``x``'s shape) is added to
    the f32 bit pattern below the 16 bits that bf16 keeps.  Non-finite
    values are cast plainly (noise on an inf or NaN pattern would walk into
    other NaN encodings)."""
    f = x.float()
    # int32 arithmetic: for finite f the sum does not overflow, and the low
    # 16 bits of (bits + noise) >> 16 are those of the unsigned sum's.
    top = ((f.view(torch.int32) + noise.to(torch.int32)) >> 16) & 0xFFFF
    top = top - ((top >> 15) << 16)  # as a signed 16-bit value
    rounded = top.to(torch.int16).view(torch.bfloat16)
    return torch.where(torch.isfinite(f), rounded, f.to(torch.bfloat16))


def stochastic_round_bf16(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``stochastic_round_bf16_with`` on 16-bit draws from ``generator``."""
    noise = torch.randint(0, 1 << 16, x.shape, generator=generator, device=x.device,
                          dtype=torch.int32)
    return stochastic_round_bf16_with(x, noise)
