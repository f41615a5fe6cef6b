"""The dense decoder (OLMo), written from its published description: token
embedding, then per layer a non-parametric (or RMS) norm, multi-head
causal attention with rotary embeddings (the two halves of each head
rotate together), a residual add, a norm, a SwiGLU MLP and a residual
add; a final norm. The unembedding is `common.logits`; the operation
counts are the plain decoder's of `common`."""
from __future__ import annotations

import torch

from bench.reference import common as C


def matmul_params(cfg) -> int:
    return C.decoder_params(cfg)


def forward_flops(cfg, batch: int, seq: int, logit_rows=None) -> float:
    return C.decoder_forward_flops(cfg, matmul_params(cfg), batch, seq,
                                   logit_rows)


def decode_flops(cfg, positions) -> float:
    return C.decoder_decode_flops(cfg, matmul_params(cfg), positions)


def hidden(cfg, params, tokens: torch.Tensor, quant: C.Quant = None):
    """The final-normed hidden states (B, S, d) of token ids (B, S)."""
    x = params["embed"]["table"][tokens].to(C.F32)
    pos = torch.arange(x.shape[1], device=x.device)
    for seg, i, w in C.layers(cfg):
        p = C.pick(params["segments"][seg], i)
        h = C.norm(cfg, p.get("ln1", {}), x)
        x = x + C.attention(cfg, p["attn"], h, pos, w, 0, quant)
        x = x + C.mlp(p["mlp"], C.norm(cfg, p.get("ln2", {}), x), quant)
    return C.final_norm(cfg, params, x)
