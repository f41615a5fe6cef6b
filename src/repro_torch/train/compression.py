"""Gradient compression for the slow cross-pod hop, as in the JAX
package's `train/compression.py`.

Two schemes, both meant to run under error feedback so the compression
noise is unbiased over time:

  * int8 quantized all-reduce: per-tensor symmetric scale, reduce in
    int32-widened space, dequantize (4x fewer wire bytes than fp32);
  * top-k sparsification (magnitude): keep the k largest entries per
    tensor, then int8.

A mesh axis here is one process's entries (`launch.mesh.FleetMesh`), so
`compressed_psum` takes the participants' tensors along the axis as a
list and returns each participant's result on its own device: every
participant quantizes its own tensor, the int32 sum and the max of the
scales are taken over all of them, and the sum is dequantized with the
largest scale and divided by the count.

`pod_mean_compressed` takes the reference's mean over the pod axis of a
gradient tree that the pod's entries hold alike (the reference's global
arrays, replicated over the pod axis in its `shard_map`). The reference's
`TrainConfig.compress_pod_grads` is read by no train step of that
package, so the port's train step refuses it
(`configs.base.check_train_config`); the functions are ported and held to
the reference on their own.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.models.param import tree_map

F32 = torch.float32


def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q int8, scale fp32
    0-d): scale = max|x| / 127 in x's dtype (1 for an all-zero x), q =
    round-half-even(x / scale) clipped to [-127, 127]."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones((), dtype=amax.dtype,
                                   device=amax.device)).to(F32)
    q = torch.clamp(torch.round(x.to(F32) / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(F32) * scale


def topk_mask(x, frac: float):
    """Keep the `frac` largest-magnitude entries (per tensor); an entry
    tied with the k-th largest magnitude is kept too."""
    flat = x.reshape(-1).abs()
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k).values[-1]
    return torch.where(x.abs() >= thresh, x, torch.zeros_like(x))


def compressed_psum(parts: Sequence[torch.Tensor], *, scheme: str = "int8",
                    topk_frac: float = 0.01) -> List[torch.Tensor]:
    """Mean over a mesh axis with wire compression. `parts` holds each
    participant's tensor along the axis; returns each participant's mean
    on its own device, in its dtype.

    int8: each participant quantizes, the sum runs on the int32-widened
    tensors, the largest scale dequantizes it, and it is divided by the
    count. topk: sparsify, then int8. none: the plain mean."""
    n = len(parts)
    if scheme == "none":
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        return [(total / n).to(p.device) for p in parts]
    if scheme == "topk":
        parts = [topk_mask(p, topk_frac) for p in parts]
    elif scheme != "int8":
        raise ValueError(f"unknown scheme {scheme!r}; use int8, topk or "
                         f"none")
    qs = [quantize_int8(p) for p in parts]
    # int8 sums can overflow int8: widen to int32 for the reduction
    home = parts[0].device
    total = qs[0][0].to(torch.int32)
    smax = qs[0][1]
    for q, s in qs[1:]:
        total = total + q.to(home).to(torch.int32)
        smax = torch.maximum(smax, s.to(home))
    mean = (total.to(F32) * smax / n).to(parts[0].dtype)
    return [mean.to(p.device) for p in parts]


def with_error_feedback(grads, residual, compress_fn):
    """Classic error feedback: g' = compress(g + r); r' = (g + r) - g'.
    grads / residual: trees. Returns (compressed grads, new residual)."""
    if residual is None:
        residual = tree_map(torch.zeros_like, grads)
    corrected = tree_map(torch.add, grads, residual)
    compressed = tree_map(compress_fn, corrected)
    new_residual = tree_map(torch.sub, corrected, compressed)
    return compressed, new_residual


def pod_mean_compressed(grads, mesh, *, scheme: str = "int8",
                        axis: str = "pod"):
    """The compressed mean over the pod axis of a gradient tree that every
    pod entry holds alike (already reduced over the in-pod data axis):
    each leaf goes to each pod entry's device (a view where that is the
    leaf's own) and through `compressed_psum`; the result comes back on
    the leaf's device. A no-op when the mesh has no pod axis or one of
    size 1."""
    if axis not in mesh.shape or mesh.shape[axis] == 1:
        return grads
    devs = [mesh.device_at(**{axis: i}) for i in range(mesh.shape[axis])]

    def reduce_leaf(g):
        out = compressed_psum([g.to(d) for d in devs], scheme=scheme)
        return out[0].to(g.device)

    return tree_map(reduce_leaf, grads)


def wire_bytes_saved(num_params: int, pods: int = 2) -> dict:
    """fp32 vs int8 ring all-reduce over the pod axis (2 (p - 1) / p x N
    bytes per participant)."""
    ring = 2 * (pods - 1) / pods * num_params
    return {"fp32_bytes": 4 * ring, "int8_bytes": 1 * ring,
            "reduction": 4.0}
