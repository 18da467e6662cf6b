"""Compressed cross-pod gradient reduction with error feedback, the port of
``repro/optim/grad_compress.py``.

The paper's setting has a fast local network and a slow inter-environment
hop; its §6 proposes data reduction before the slow link. The multi-pod
training analogue: the in-pod gradient reduce rides the fast link, the
cross-pod hop the slow one. Exactly that hop is compressed:

  * the train step computes grads on this pod's rows and takes their f32
    mean over ``data`` within the pod;
  * an int8 block-quantized reduce-scatter + all-gather over ``pod``
    (``train.train_step._pod_reduce``), with per-(pod, block) scales and a
    local error-feedback residual, so the quantization error is re-injected
    next step (convergence-safe; the standard EF-SGD result).

Wire bytes across pods: 2·N·1 B (int8 RS+AG) vs 2·N·4 B for an fp32 ring
all-reduce -> 4x reduction (+ scales, 4 B a block of 4096).

``quant_blocks`` is the staging pack's quantize: the hand-written pack
kernel on a CUDA tensor, its plain version on the CPU. Each block is a row
of 4096 consecutive values, which is the pack's tile (32, 128), so the pack
computes the reference's ``_quant_blocks`` byte for byte on normal values.
The two part only where a block's amax/127 underflows: the pack (like the
host codec) sets scale 1 there, the reference where amax == 0.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.staging_pack import ops as pack_ops
from repro_torch.models.layers import tree_leaves, tree_map

Tree = Any
QBLOCK = 4096
# rows of (., QBLOCK) f32 taken at a time by the elementwise passes below:
# 64 MiB, so that no pass holds a second copy of the whole flat
CHUNK_ROWS = 4096


def quant_blocks(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n_blocks, QBLOCK) f32 -> (int8 (n_blocks, QBLOCK), scales f32
    (n_blocks,)), scale = amax/127 and q = clip(rint(x/scale), ±127)."""
    return pack_ops.quantize_blocks(x.contiguous(), block_elems=QBLOCK)


def dequant_blocks(q: torch.Tensor, s: torch.Tensor,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """q.float() * s[:, None], into ``out`` when given; a chunk of rows at
    a time (each element the same product as the whole-array one)."""
    if out is None:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for a in range(0, q.shape[0], CHUNK_ROWS):
        b = a + CHUNK_ROWS
        torch.mul(q[a:b].to(torch.float32), s[a:b, None], out=out[a:b])
    return out


def _rows(n: int, n_pods: int) -> int:
    rows = -(-n // QBLOCK)
    return rows + (-rows) % max(n_pods, 1)   # ring reduce-scatter row padding


def flatten(tree: Tree, n_pods: int = 1) -> tuple[torch.Tensor, int]:
    """The leaves (``tree_leaves`` order) as one f32 (rows, QBLOCK) array,
    zero-padded to whole blocks and to a multiple of ``n_pods`` rows, so the
    ring reduce-scatter shards evenly; the shape mirrors ``error_state``.
    Returns (flat2d, pad), pad the number of padding values. A list of
    leaves is flattened in its order, and emptied as it goes, so that a
    caller holding no other reference frees each leaf once it is copied."""
    leaves = tree if isinstance(tree, list) else tree_leaves(tree)
    n = sum(l.numel() for l in leaves)
    rows = _rows(n, n_pods)
    flat = torch.empty(rows * QBLOCK, dtype=torch.float32, device=leaves[0].device)
    off = 0
    for i in range(len(leaves)):
        leaf = leaves[i]
        flat[off:off + leaf.numel()].copy_(leaf.reshape(-1))
        off += leaf.numel()
        if tree is leaves:
            leaves[i] = None
    flat[off:].zero_()
    return flat.view(rows, QBLOCK), rows * QBLOCK - n


def unflatten(flat2d: torch.Tensor, pad: int, tree: Tree) -> Tree:
    """``tree``'s leaves read back from ``flat2d`` (views of it where the
    leaf is f32, else cast to the leaf's dtype), in ``tree``'s shape."""
    flat = flat2d.reshape(-1)
    off = 0

    def take(leaf):
        nonlocal off
        v = flat[off:off + leaf.numel()].view(leaf.shape)
        off += leaf.numel()
        return v if leaf.dtype == torch.float32 else v.to(leaf.dtype)

    out = tree_map(take, tree)
    assert off + pad == flat.numel(), (off, pad, flat.numel())
    return out


def error_state(grads_abstract: Tree, n_pods: int = 1) -> tuple[int, int]:
    """The shape (rows, QBLOCK) of the error-feedback residual for a tree of
    that many values (tensors or anything with ``.shape``)."""
    n = 0
    for leaf in tree_leaves(grads_abstract):
        k = 1
        for d in leaf.shape:
            k *= d
        n += k
    return _rows(n, n_pods), QBLOCK


def compressed_pod_allreduce(grads: Tree, err: torch.Tensor, mesh):
    """Mean-reduce ``grads`` over the mesh's ``pod`` axis with int8
    compression + error feedback. ``err``: this pod's f32 (rows, QBLOCK)
    residual carried across steps (zeros of ``error_state``'s shape at
    first). Returns (reduced_grads, new_err)."""
    from repro_torch.train.train_step import _pod_reduce   # the ring lives there
    group = mesh.groups["pod"]
    flat, pad = flatten(grads, group.size)
    red, new_err = _pod_reduce(flat, err, group)
    return unflatten(red, pad, grads), new_err
